"""Input, parameter and decode-state specs per (arch family x shape kind).

Counterpart of `repro.configs.specs`: every spec is a tensor on the
`meta` device, with the reference's shape and dtype and no storage, so a
full-width config's layout can be planned (`dist.sharding`) on any host.
The modality frontends are stubs, as the reference's: whisper receives
precomputed frame embeddings (b, t, d_model); chameleon's VQ image tokens
are ordinary ids in its unified vocab.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.layers.common import ModelConfig, ShapeConfig

META = torch.device("meta")


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
  return torch.empty(shape, dtype=dtype, device=META)


def _lm_train(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  b, s = shape.global_batch, shape.seq_len
  return {"tokens": _spec((b, s), torch.int32),
          "targets": _spec((b, s), torch.int32)}


def _lm_decode(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  b = shape.global_batch
  return {"token": _spec((b, 1), torch.int32),
          "positions": _spec((b,), torch.int32)}


def _whisper_train(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  b, s = shape.global_batch, shape.seq_len
  dec = max(s // 4, 64)     # text tokens per audio window
  return {"frames": _spec((b, s, cfg.d_model), cfg.dtype),
          "tokens": _spec((b, dec), torch.int32),
          "targets": _spec((b, dec), torch.int32)}


def _speech_train(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  b, t = shape.global_batch, shape.seq_len
  lab = max(t // 16, 8)
  return {"feats": _spec((b, t, cfg.feat_dim), cfg.dtype),
          "feat_lengths": _spec((b,), torch.int32),
          "labels": _spec((b, lab), torch.int32),
          "label_lengths": _spec((b,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
  """Step inputs (excluding params and decode state) as meta tensors."""
  fam = cfg.family
  if shape.kind == "train":
    if fam == "whisper":
      return _whisper_train(cfg, shape)
    if fam == "deepspeech":
      return _speech_train(cfg, shape)
    return _lm_train(cfg, shape)
  if shape.kind == "prefill":
    b, s = shape.global_batch, shape.seq_len
    if fam == "whisper":
      return {"frames": _spec((b, s, cfg.d_model), cfg.dtype)}
    if fam == "deepspeech":
      return {"feats": _spec((b, s, cfg.feat_dim), cfg.dtype)}
    return {"tokens": _spec((b, s), torch.int32)}
  if shape.kind == "decode":
    if fam == "deepspeech":
      # streaming frame step: one post-frontend feature frame
      freq_after = ((cfg.feat_dim + 1) // 2 + 1) // 2
      return {"x_t": _spec((shape.global_batch,
                            freq_after * cfg.conv_channels), cfg.dtype)}
    return _lm_decode(cfg, shape)
  raise ValueError(f"unknown shape kind: {shape.kind}")


def decode_state_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
  """The decode state as meta tensors (the family's init on `meta`)."""
  from repro_torch.models.api import get_model
  api = get_model(cfg)
  if api.init_decode_state is None:
    raise ValueError(f"{cfg.name} has no decode state")
  return api.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                               device=META)


def param_specs(cfg: ModelConfig) -> Any:
  """The model's parameters as meta tensors: its init on `meta`, which
  draws nothing."""
  from repro_torch.models.api import get_model
  return get_model(cfg).init(cfg, generator=torch.Generator(), device=META)
