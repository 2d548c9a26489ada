"""Shared config dataclass and the GEMM application helper.

Counterpart of `repro.layers.common` for the ported families:
`ModelConfig` (its `dtype` is a `torch.dtype`) with DeepSeek's
`MoEConfig` and `MLAConfig`, `ShapeConfig` and the assigned `SHAPES`,
the sharding-constraint contract (`Constraint`, `identity_constraint`)
and `gemm`, which applies
a GEMM leaf (`FactoredLinear`, `QuantizedLinear` or a raw weight tensor)
and, given a `kernels.dispatch.KernelPolicy`, routes it through the CUDA
kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.factored import FactoredLinear, matmul_ref
from repro_torch.quant.leaf import QuantizedLinear

# The sharding-constraint contract every model function threads through its
# layers: cs(x, logical_name) -> x. Hosted here, where all layer and model
# code already imports from, so model code never depends on repro_torch.dist;
# dist.sharding re-exports both names, and its make_constraint returns
# identity_constraint when called without a mesh.
Constraint = Callable[[torch.Tensor, str], torch.Tensor]


def identity_constraint(x, name: str):
  """The no-mesh constraint: every `cs` call is a pass-through."""
  return x


def gemm(leaf, x: torch.Tensor, policy=None) -> torch.Tensor:
  """y[..., n] = x[..., m] @ W(m, n); factored path = (x @ U) @ V.

  With no policy this is the plain path: leaves apply their own math
  (`FactoredLinear.apply`, the w8a8 oracle of `QuantizedLinear`), raw
  tensors follow `core.factored.matmul_ref`. A policy hands the call to
  `kernels.dispatch.gemm`, which picks the regime."""
  if policy is not None:
    from repro_torch.kernels import dispatch
    return dispatch.gemm(leaf, x, policy)
  if isinstance(leaf, (FactoredLinear, QuantizedLinear)):
    return leaf.apply(x)
  return matmul_ref(x, leaf)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
  num_experts: int = 0          # routed experts
  num_shared: int = 0           # always-on shared experts
  top_k: int = 2
  d_expert: int = 0             # per-expert FFN hidden dim
  capacity_factor: float = 1.25
  router_aux_weight: float = 1e-3   # load-balance auxiliary loss
  first_dense_layers: int = 0   # leading layers use dense FFN (deepseek)
  dispatch_groups: int = 1      # token groups routed and dispatched apart


@dataclasses.dataclass(frozen=True)
class MLAConfig:
  kv_lora_rank: int = 512
  q_lora_rank: int = 0          # 0 => dense q projection
  qk_nope_dim: int = 128
  qk_rope_dim: int = 64
  v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
  """The reference's `ModelConfig`, cut to the fields the ported
  families read: the transformer (qwen3's `qk_norm`, DeepSeek's MoE,
  MLA and MTP head included), zamba's Mamba2 hybrid, xLSTM, Whisper's
  encoder-decoder and DS2."""
  name: str
  family: str    # transformer | zamba | xlstm | whisper | deepspeech
  num_layers: int
  d_model: int
  num_heads: int
  num_kv_heads: int
  d_ff: int
  vocab_size: int
  head_dim: Optional[int] = None          # default d_model // num_heads
  qk_norm: bool = False                   # qwen3
  rope_theta: float = 10000.0
  tie_embeddings: bool = False
  norm_eps: float = 1e-5
  dtype: torch.dtype = torch.bfloat16
  # -- MoE / MLA (deepseek) --
  moe: Optional[MoEConfig] = None
  mla: Optional[MLAConfig] = None
  mtp: bool = False                       # multi-token prediction head (dsv3)
  # -- hybrid / ssm --
  ssm_state: int = 0                      # mamba2 state dim (zamba2)
  attn_every: int = 0                     # zamba: shared attn block period
  # -- enc-dec (whisper) --
  encoder_layers: int = 0
  max_source_positions: int = 1500
  # -- speech (deepspeech2) --
  feat_dim: int = 80                      # mel bins (paper B.3)
  gru_dims: tuple = ()                    # growing sizes (paper B.1)
  fc_dim: int = 0
  conv_channels: int = 32
  time_stride: int = 2
  # -- attention blocking (the plain blockwise attention's tiles) --
  attn_block_q: int = 512
  attn_block_kv: int = 512
  remat: str = "full"                     # training knob, kept for parity

  @property
  def resolved_head_dim(self) -> int:
    return self.head_dim if self.head_dim else self.d_model // self.num_heads

  def with_(self, **kw) -> "ModelConfig":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
  """One assigned input-shape cell."""
  name: str                     # train_4k | prefill_32k | decode_32k | long_500k
  kind: str                     # "train" | "prefill" | "decode"
  seq_len: int
  global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
