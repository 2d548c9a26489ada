"""Weights carried across from the JAX reference.

`from_reference` turns a `{path: np.ndarray}` dict into the port's
params, of the family `cfg.family` names. Keys are the reference's
checkpoint path strings (`repro.checkpoint.manager`):
  deepspeech:  "conv1", "grus/gru0/nonrec/w", "grus/gru0/bias", "fc/u",
               "out/w_q", ...
  transformer: "embedding/table", "embedding/head/w", "final_norm",
               "dense_layers/ln1", "dense_layers/attn/wq/w",
               "dense_layers/ffn/w_gate/w", ... (layer-stacked, as the
               reference stores them), with qk-norm (qwen3) also
               "dense_layers/attn/q_norm" and ".../k_norm"; DeepSeek's
               MLA "*/attn/wq/w" or "*/attn/wq_a/w", "*/attn/q_a_norm",
               "*/attn/wq_b/w", then "*/attn/w_dkv/w", "*/attn/kv_a_norm",
               "*/attn/w_uk/w", "*/attn/w_uv/w", "*/attn/wo/w"; the MoE
               stack's "moe_layers/ln1", "moe_layers/moe/router" (a raw
               f32 (L, d, E) array), "moe_layers/moe/w_gate/w" (L, E, d,
               f), "moe_layers/moe/shared/w_gate/w", ...; the MTP head's
               "mtp/proj/w", "mtp/layer/attn/...", "mtp/layer/ffn/...",
               "mtp/layer/ln1" and "mtp/norm" (unstacked)
  zamba:       "embedding/table", "embedding/head/w", "final_norm",
               "main/in_zx/w" (groups, attn_every, d, 2 * d_inner),
               "main/in_bcdt/w", "main/out_proj/w", "main/conv_w",
               "main/A_log", "main/D", "main/dt_bias", "main/norm",
               "main/norm_in" (stacked two levels deep), the same under
               "tail/" (one level), "shared_attn/ln1",
               "shared_attn/attn/wq/w", "shared_attn/ffn/w_gate/w", ...
               (unstacked)
  whisper:     "embedding/table" (tied), "pos_dec", "enc_layers/ln1/scale",
               "enc_layers/attn/wq/w", "enc_layers/ffn/w_in/w",
               "enc_layers/ffn/b_in", "enc_ln/bias", "dec_layers/xattn/wk/w",
               "dec_layers/ln3/scale", "dec_ln/scale", ... (layer-stacked)
The leaf type comes from the field names (w -> dense, u/v -> factored,
w_q/u_q/... -> quantized); `name` and `group` are rebuilt from the path
as the model's init sets them. Conv weights stay HWIO, the reference's
layout.

bf16 arrives either as an `ml_dtypes.bfloat16` array or as its `uint16`
view plus the dtype string "bfloat16" (the checkpoint layout); both are
reinterpreted bit for bit.

`to_reference` is the inverse: a model's `{path: np.ndarray}` (bf16 as
the `uint16` view), and
`load_checkpoint` builds a model from the params of a checkpoint
directory either package wrote.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from torch import nn

from repro_torch.checkpoint.manager import (CheckpointManager, flatten,
                                            from_host, to_host)
from repro_torch.core.factored import FactoredLinear
from repro_torch.device import resolve_device
from repro_torch.layers.attention import Attention
from repro_torch.layers.common import ModelConfig
from repro_torch.layers.embedding import Embedding
from repro_torch.layers.ffn import GeluFFN, SwiGLU
from repro_torch.layers.gru import GRU
from repro_torch.layers.mla import MLA
from repro_torch.layers.moe import MoE
from repro_torch.layers.norms import LayerNorm
from repro_torch.models.deepspeech import DeepSpeech2
from repro_torch.models.transformer import (MTP, DenseLayer, LayerStack,
                                            MoELayerStack, TransformerLM,
                                            depths)
from repro_torch.models.whisper import Whisper, WhisperLayers
from repro_torch.models.zamba import MambaStack, ZambaLM, _plan
from repro_torch.quant.leaf import QuantizedLinear

_FLOAT_FIELDS = {"w", "u", "v"}
_QUANT_FIELDS = {"w_q", "w_scale", "u_q", "u_scale", "v_q", "v_scale",
                 "act_scale"}


def to_tensor(a: np.ndarray, dtype: Optional[str] = None) -> torch.Tensor:
  """One reference array as a CPU tensor with the same bits. `dtype` is
  the checkpoint's dtype string for arrays stored as raw views."""
  a = np.asarray(a)
  name = dtype or str(a.dtype)
  if name != "bfloat16" and a.dtype.kind not in "biuf":
    raise TypeError(f"unsupported array dtype {a.dtype} ({name})")
  return from_host(a, name)


def _leaf(fields: dict, *, name: str, group: str, cfg: ModelConfig):
  keys = set(fields)
  if keys and keys <= _FLOAT_FIELDS:
    return FactoredLinear(**fields, name=name, group=group)
  if keys and keys <= _QUANT_FIELDS:
    return QuantizedLinear(**fields, name=name, group=group,
                           orig_dtype=cfg.dtype)
  raise ValueError(f"GEMM leaf {name!r}: unknown field set {sorted(keys)}")


class _Arrays:
  """The path-keyed arrays as tensors on one device; every key must be
  used exactly once."""

  def __init__(self, arrays, dtypes, device):
    dtypes = dtypes or {}
    self.rest = {k: to_tensor(v, dtypes.get(k)).to(device)
                 for k, v in arrays.items()}

  def take(self, prefix: str) -> dict:
    out = {k[len(prefix) + 1:]: self.rest.pop(k) for k in list(self.rest)
           if k.startswith(prefix + "/")}
    if not out:
      raise KeyError(f"no arrays under {prefix!r}")
    return out

  def pop(self, key: str) -> torch.Tensor:
    if key not in self.rest:
      raise KeyError(f"missing array {key!r}")
    return self.rest.pop(key)

  def done(self) -> None:
    if self.rest:
      raise KeyError(f"unused arrays: {sorted(self.rest)}")


def _deepspeech(a: _Arrays, cfg: ModelConfig) -> DeepSpeech2:
  grus = {}
  for i in range(len(cfg.gru_dims)):
    p = f"grus/gru{i}"
    grus[f"gru{i}"] = GRU(
        nonrec=_leaf(a.take(f"{p}/nonrec"), name=f"gru{i}/nonrec",
                     group="nonrec", cfg=cfg),
        rec=_leaf(a.take(f"{p}/rec"), name=f"gru{i}/rec", group="rec",
                  cfg=cfg),
        bias=a.pop(f"{p}/bias"))
  return DeepSpeech2(
      a.pop("conv1"), a.pop("conv2"), grus,
      fc=_leaf(a.take("fc"), name="fc", group="nonrec", cfg=cfg),
      out=_leaf(a.take("out"), name="out", group="nonrec", cfg=cfg))


def _transformer(a: _Arrays, cfg: ModelConfig) -> TransformerLM:
  def gemm_leaf(path: str, name: str):
    return _leaf(a.take(path), name=name, group="nonrec", cfg=cfg)

  def attn(p: str):
    if cfg.mla is not None:
      if cfg.mla.q_lora_rank:
        q = dict(wq_a=gemm_leaf(f"{p}/wq_a", "layers/mla_q_a"),
                 q_a_norm=a.pop(f"{p}/q_a_norm"),
                 wq_b=gemm_leaf(f"{p}/wq_b", "layers/mla_q_b"))
      else:
        q = dict(wq=gemm_leaf(f"{p}/wq", "layers/mla_q"))
      return MLA(**q, w_dkv=gemm_leaf(f"{p}/w_dkv", "layers/mla_dkv"),
                 kv_a_norm=a.pop(f"{p}/kv_a_norm"),
                 w_uk=gemm_leaf(f"{p}/w_uk", "layers/mla_uk"),
                 w_uv=gemm_leaf(f"{p}/w_uv", "layers/mla_uv"),
                 wo=gemm_leaf(f"{p}/wo", "layers/mla_o"))
    norms = ({k: a.pop(f"{p}/{k}") for k in ("q_norm", "k_norm")}
             if cfg.qk_norm else {})
    return Attention(*(gemm_leaf(f"{p}/w{x}", f"layers/attn_{x}")
                       for x in "qkvo"), **norms)

  def swiglu(p: str, prefix: str = "layers") -> SwiGLU:
    return SwiGLU(*(gemm_leaf(f"{p}/w_{x}", f"{prefix}/ffn_{x}")
                    for x in ("gate", "up", "down")))

  def moe(p: str) -> MoE:
    shared = (swiglu(f"{p}/shared", "layers/shared")
              if cfg.moe.num_shared else None)
    return MoE(a.pop(f"{p}/router"),
               *(gemm_leaf(f"{p}/w_{x}", f"layers/expert_{x}")
                 for x in ("gate", "up", "down")), shared)

  table = a.pop("embedding/table")
  head = None if cfg.tie_embeddings else gemm_leaf("embedding/head",
                                                   "lm_head")
  n_dense, n_moe = depths(cfg)
  dense_layers = moe_layers = mtp = None
  if n_dense:
    p = "dense_layers"
    dense_layers = LayerStack(a.pop(f"{p}/ln1"), a.pop(f"{p}/ln2"),
                              attn(f"{p}/attn"), swiglu(f"{p}/ffn"))
  if n_moe:
    p = "moe_layers"
    moe_layers = MoELayerStack(a.pop(f"{p}/ln1"), a.pop(f"{p}/ln2"),
                               attn(f"{p}/attn"), moe(f"{p}/moe"))
  if cfg.mtp:
    p = "mtp/layer"
    layer = DenseLayer(a.pop(f"{p}/ln1"), a.pop(f"{p}/ln2"),
                       attn(f"{p}/attn"), swiglu(f"{p}/ffn"))
    mtp = MTP(gemm_leaf("mtp/proj", "mtp/proj"), layer, a.pop("mtp/norm"))
  return TransformerLM(Embedding(table, head), a.pop("final_norm"),
                       dense_layers, moe_layers, mtp)


def _whisper(a: _Arrays, cfg: ModelConfig) -> Whisper:
  def ln(path: str) -> LayerNorm:
    return LayerNorm(a.pop(f"{path}/scale"), a.pop(f"{path}/bias"))

  def attn(path: str, prefix: str, kind: str) -> Attention:
    return Attention(*(_leaf(a.take(f"{path}/w{x}"),
                             name=f"{prefix}/{kind}_{x}", group="nonrec",
                             cfg=cfg) for x in "qkvo"))

  def stack(path: str, prefix: str, decoder: bool) -> WhisperLayers:
    ffn = GeluFFN(*(_leaf(a.take(f"{path}/ffn/w_{x}"),
                          name=f"{prefix}/ffn_{x}", group="nonrec", cfg=cfg)
                    for x in ("in", "out")),
                  a.pop(f"{path}/ffn/b_in"), a.pop(f"{path}/ffn/b_out"))
    extra = {}
    if decoder:
      extra = dict(xattn=attn(f"{path}/xattn", prefix, "xattn"),
                   ln3=ln(f"{path}/ln3"))
    return WhisperLayers(ln(f"{path}/ln1"), attn(f"{path}/attn", prefix,
                                                 "attn"),
                         ln(f"{path}/ln2"), ffn, **extra)

  return Whisper(Embedding(a.pop("embedding/table")), a.pop("pos_dec"),
                 stack("enc_layers", "enc", False), ln("enc_ln"),
                 stack("dec_layers", "dec", True), ln("dec_ln"))


def _zamba(a: _Arrays, cfg: ModelConfig) -> ZambaLM:
  def gemm_leaf(path: str, name: str):
    return _leaf(a.take(path), name=name, group="nonrec", cfg=cfg)

  def mamba(p: str) -> MambaStack:
    return MambaStack(
        gemm_leaf(f"{p}/in_zx", "mamba/ssm_in_zx"),
        gemm_leaf(f"{p}/in_bcdt", "mamba/ssm_in_bcdt"),
        gemm_leaf(f"{p}/out_proj", "mamba/ssm_out"),
        *(a.pop(f"{p}/{k}") for k in ("conv_w", "A_log", "D", "dt_bias",
                                      "norm", "norm_in")))

  p = "shared_attn"
  shared = DenseLayer(
      a.pop(f"{p}/ln1"), a.pop(f"{p}/ln2"),
      Attention(*(gemm_leaf(f"{p}/attn/w{x}", f"shared/attn_{x}")
                  for x in "qkvo")),
      SwiGLU(*(gemm_leaf(f"{p}/ffn/w_{x}", f"shared/ffn_{x}")
               for x in ("gate", "up", "down"))))
  table = a.pop("embedding/table")
  head = None if cfg.tie_embeddings else gemm_leaf("embedding/head",
                                                   "lm_head")
  return ZambaLM(Embedding(table, head), a.pop("final_norm"), mamba("main"),
                 shared, mamba("tail") if _plan(cfg)[2] else None)


_FAMILIES = {"deepspeech": _deepspeech, "transformer": _transformer,
             "whisper": _whisper, "zamba": _zamba}


def from_reference(arrays: Mapping[str, np.ndarray], cfg: ModelConfig, *,
                   dtypes: Optional[Mapping[str, str]] = None,
                   device=None) -> nn.Module:
  """Build the `cfg.family` model (a `DeepSpeech2`, a `TransformerLM`, a
  `ZambaLM` or a `Whisper`) on `device` (default: the GPU) from the reference's
  path-keyed arrays.
  `dtypes` maps paths to dtype strings where an array is a raw view
  (bf16 as uint16). Every key must be used: an unknown or missing one
  raises."""
  if cfg.family not in _FAMILIES:
    raise ValueError(f"no bridge for model family {cfg.family!r}")
  a = _Arrays(arrays, dtypes, resolve_device(device))
  model = _FAMILIES[cfg.family](a, cfg)
  a.done()
  return model


def to_reference(model: nn.Module) -> dict[str, np.ndarray]:
  """The model's leaves keyed by the reference's path strings, as numpy
  arrays on the host (bf16 as its uint16 view, as checkpoints store
  it): `from_reference` of them, given the bf16 leaves' dtype strings,
  rebuilds `m`."""
  return {p: to_host(x)[0] for p, x in flatten(model)}


def load_checkpoint(directory: str, cfg: ModelConfig, *,
                    step: Optional[int] = None, device=None) -> nn.Module:
  """The model stored under "params/" in a checkpoint directory written
  by either package (`step` default: the latest), built on `device`
  (default: the GPU)."""
  ckpt = CheckpointManager(directory)
  arrays, dtypes = {}, {}
  for path in ckpt.manifest(step)["leaves"]:
    if path.startswith("params/"):
      key = path[len("params/"):]
      arrays[key], dtypes[key] = ckpt.read(path, step)
  return from_reference(arrays, cfg, dtypes=dtypes, device=device)
