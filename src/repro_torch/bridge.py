"""Weights carried across from the JAX reference.

`from_reference` turns a `{path: np.ndarray}` dict into the port's DS2
params. Keys are the reference's checkpoint path strings
(`repro.checkpoint.manager`): "conv1", "grus/gru0/nonrec/w",
"grus/gru0/bias", "fc/u", "out/w_q", ... The leaf type comes from the
field names (w -> dense, u/v -> factored, w_q/u_q/... -> quantized);
`name` and `group` are rebuilt from the path as `init_model` sets them.
Conv weights stay HWIO, the reference's layout.

bf16 arrives either as an `ml_dtypes.bfloat16` array or as its `uint16`
view plus the dtype string "bfloat16" (the checkpoint layout); both are
reinterpreted bit for bit. Reading a checkpoint directory from disk
comes with the training slice.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.factored import FactoredLinear
from repro_torch.device import resolve_device
from repro_torch.layers.common import ModelConfig
from repro_torch.layers.gru import GRU
from repro_torch.models.deepspeech import DeepSpeech2
from repro_torch.quant.leaf import QuantizedLinear

_FLOAT_FIELDS = {"w", "u", "v"}
_QUANT_FIELDS = {"w_q", "w_scale", "u_q", "u_scale", "v_q", "v_scale",
                 "act_scale"}


def to_tensor(a: np.ndarray, dtype: Optional[str] = None) -> torch.Tensor:
  """One reference array as a CPU tensor with the same bits. `dtype` is
  the checkpoint's dtype string for arrays stored as raw views."""
  a = np.asarray(a)
  name = dtype or str(a.dtype)
  if name == "bfloat16":
    return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                            ).view(torch.bfloat16)
  if a.dtype.kind not in "biuf":
    raise TypeError(f"unsupported array dtype {a.dtype} ({name})")
  return torch.from_numpy(np.array(a, copy=True))


def _leaf(fields: dict, *, name: str, group: str, cfg: ModelConfig):
  keys = set(fields)
  if keys and keys <= _FLOAT_FIELDS:
    return FactoredLinear(**fields, name=name, group=group)
  if keys and keys <= _QUANT_FIELDS:
    return QuantizedLinear(**fields, name=name, group=group,
                           orig_dtype=cfg.dtype)
  raise ValueError(f"GEMM leaf {name!r}: unknown field set {sorted(keys)}")


def from_reference(arrays: Mapping[str, np.ndarray], cfg: ModelConfig, *,
                   dtypes: Optional[Mapping[str, str]] = None,
                   device=None) -> DeepSpeech2:
  """Build a `DeepSpeech2` on `device` (default: the GPU) from the
  reference's path-keyed arrays. `dtypes` maps paths to dtype strings
  where an array is a raw view (bf16 as uint16). Every key must be used:
  an unknown or missing one raises."""
  device = resolve_device(device)
  dtypes = dtypes or {}
  rest = {k: to_tensor(v, dtypes.get(k)).to(device)
          for k, v in arrays.items()}

  def take(prefix: str) -> dict:
    out = {k[len(prefix) + 1:]: rest.pop(k) for k in list(rest)
           if k.startswith(prefix + "/")}
    if not out:
      raise KeyError(f"no arrays under {prefix!r}")
    return out

  def pop(key: str) -> torch.Tensor:
    if key not in rest:
      raise KeyError(f"missing array {key!r}")
    return rest.pop(key)

  grus = {}
  for i in range(len(cfg.gru_dims)):
    p = f"grus/gru{i}"
    grus[f"gru{i}"] = GRU(
        nonrec=_leaf(take(f"{p}/nonrec"), name=f"gru{i}/nonrec",
                     group="nonrec", cfg=cfg),
        rec=_leaf(take(f"{p}/rec"), name=f"gru{i}/rec", group="rec",
                  cfg=cfg),
        bias=pop(f"{p}/bias"))
  model = DeepSpeech2(
      pop("conv1"), pop("conv2"), grus,
      fc=_leaf(take("fc"), name="fc", group="nonrec", cfg=cfg),
      out=_leaf(take("out"), name="out", group="nonrec", cfg=cfg))
  if rest:
    raise KeyError(f"unused arrays: {sorted(rest)}")
  return model
