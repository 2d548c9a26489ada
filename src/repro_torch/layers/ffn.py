"""Gated FFN (SwiGLU) — counterpart of `repro.layers.ffn` (the GELU FFN
comes with Whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.factored import dense
from repro_torch.layers.common import gemm


class SwiGLU(nn.Module):
  """w_gate, w_up (d, f) and w_down (f, d); layer-stacked in a model."""

  def __init__(self, w_gate: nn.Module, w_up: nn.Module, w_down: nn.Module):
    super().__init__()
    self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down


def init_swiglu(d: int, f: int, *, layer_prefix: str, dtype: torch.dtype,
                stack: tuple = (), generator: torch.Generator,
                device) -> SwiGLU:
  kw = dict(dtype=dtype, stack=stack, generator=generator, device=device)
  return SwiGLU(dense(d, f, name=f"{layer_prefix}/ffn_gate", **kw),
                dense(d, f, name=f"{layer_prefix}/ffn_up", **kw),
                dense(f, d, name=f"{layer_prefix}/ffn_down", **kw))


def swiglu_forward(p, x: torch.Tensor, policy=None) -> torch.Tensor:
  """`p` maps "w_gate", "w_up", "w_down" to 2-D leaves. silu runs in
  f32 and rounds to x.dtype before the product with u, as the
  reference rounds in bf16."""
  g = gemm(p["w_gate"], x, policy)
  u = gemm(p["w_up"], x, policy)
  h = F.silu(g.to(torch.float32)).to(x.dtype) * u
  return gemm(p["w_down"], h, policy)
