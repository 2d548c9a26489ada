"""QuantizedLinear — the int8-quantized GEMM leaf (paper §4).

Counterpart of `repro.quant.leaf`: the same logical name/group namespace
as `FactoredLinear`, with weights stored as symmetric per-column int8
plus f32 scales — the operand format `kernels/int8_gemm` consumes.

Buffers (absent ones are None and stay out of `state_dict()`):
  unfactored: w_q (m, n) int8, w_scale (n,) f32
  factored:   u_q (m, r) int8, u_scale (r,) f32; v_q (r, n), v_scale (n,)
  act_scale:  optional () f32 — a calibrated static activation range;
              None means dynamic per-row activation quantization.

Arithmetic: w8a8, one flow (`_apply`) for both paths, parameterized by
the int8 GEMM — the plain `ref.int8_gemm` (`ref_apply`) or the kernel
wrapper (`kernel_apply`) — so the two agree bit for bit by construction.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.factored import register_gemm_leaf
from repro_torch.kernels import ops, ref

_FIELDS = ("w_q", "w_scale", "u_q", "u_scale", "v_q", "v_scale", "act_scale")


def _act_quantize(x: torch.Tensor, act_scale: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
  """Calibrated static scale if present, dynamic per-row otherwise."""
  if act_scale is None:
    return ref.quantize_rowwise(x)
  return ref.quantize_static(x, act_scale)


@register_gemm_leaf
class QuantizedLinear(nn.Module):
  """An int8 GEMM weight, unfactored (w_q) or factored (u_q @ v_q), with
  per-column scales stored alongside."""

  def __init__(self, *, w_q=None, w_scale=None, u_q=None, u_scale=None,
               v_q=None, v_scale=None, act_scale=None, name: str = "gemm",
               group: str = "nonrec",
               orig_dtype: torch.dtype = torch.float32):
    super().__init__()
    if (w_q is None) == (u_q is None):
      raise ValueError("QuantizedLinear holds either w_q, or u_q and v_q")
    for key, val in zip(_FIELDS, (w_q, w_scale, u_q, u_scale, v_q, v_scale,
                                  act_scale)):
      self.register_buffer(key, val)
    self.name = name
    self.group = group
    #: float type the weight was quantized from
    self.orig_dtype = orig_dtype

  # -- structure ------------------------------------------------------------
  @property
  def is_factored(self) -> bool:
    return self.u_q is not None

  @property
  def in_dim(self) -> int:
    return self.u_q.shape[-2] if self.is_factored else self.w_q.shape[-2]

  @property
  def out_dim(self) -> int:
    return self.v_q.shape[-1] if self.is_factored else self.w_q.shape[-1]

  @property
  def num_params(self) -> int:
    if self.is_factored:
      return self.u_q.numel() + self.v_q.numel()
    return self.w_q.numel()

  @property
  def dtype(self) -> torch.dtype:
    return self.orig_dtype

  def extra_repr(self) -> str:
    return f"name={self.name!r}, group={self.group!r}"

  # -- math -----------------------------------------------------------------
  def product(self) -> torch.Tensor:
    """The dequantized W (in the float type it was quantized from),
    batched over leading dims: the float form the MoE's stacked experts
    and MLA's absorbed w_uk / w_uv take."""
    if self.is_factored:
      u = self.u_q.float() * self.u_scale[..., None, :]
      v = self.v_q.float() * self.v_scale[..., None, :]
      return torch.matmul(u, v).to(self.orig_dtype)
    return (self.w_q.float() * self.w_scale[..., None, :]).to(self.orig_dtype)

  def apply(self, x: torch.Tensor, policy=None) -> torch.Tensor:
    """y = x @ W in w8a8 arithmetic (the plain path of the int8_gemm
    regime); `policy` routes through kernels.dispatch."""
    if policy is not None:
      from repro_torch.kernels import dispatch
      return dispatch.gemm(self, x, policy)
    lead = x.shape[:-1]
    y = ref_apply(self, x.reshape(-1, x.shape[-1]))
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.apply(x)

  def layer(self, i: int) -> "QuantizedLinear":
    """Layer i of a layer-stacked leaf (w_q (L, m, n), scales (L, n)),
    sharing storage; a scalar act_scale is shared by every layer."""
    fields = {k: (None if t is None else t if t.ndim == 0 else t[i])
              for k, t in ((k, getattr(self, k)) for k in _FIELDS)}
    return QuantizedLinear(**fields, name=self.name, group=self.group,
                           orig_dtype=self.orig_dtype)


def _apply(leaf: QuantizedLinear, x2: torch.Tensor, int8_gemm
           ) -> torch.Tensor:
  """One w8a8 flow for both paths. x2 (b, m) -> f32 (b, n). The factored
  path requantizes the rank intermediate per row."""
  x_q, x_s = _act_quantize(x2, leaf.act_scale)
  if leaf.is_factored:
    t = int8_gemm(x_q, leaf.u_q, x_s, leaf.u_scale)
    t_q, t_s = ref.quantize_rowwise(t)
    return int8_gemm(t_q, leaf.v_q, t_s, leaf.v_scale)
  return int8_gemm(x_q, leaf.w_q, x_s, leaf.w_scale)


def ref_apply(leaf: QuantizedLinear, x2: torch.Tensor) -> torch.Tensor:
  """The plain int8 oracle for one quantized GEMM."""
  return _apply(leaf, x2, ref.int8_gemm)


def kernel_apply(leaf: QuantizedLinear, x2: torch.Tensor) -> torch.Tensor:
  """The kernel path for one quantized GEMM: activations quantize per
  call, stored weight scales are consumed directly."""
  return _apply(leaf, x2, ops.int8_gemm)
