"""Normalization (f32 statistics, output in the input's dtype).

Counterpart of `repro.layers.norms` for the dense transformer:
`rms_norm` and `init_rms`. `layer_norm` comes with Whisper.
"""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
  xf = x.to(torch.float32)
  var = torch.mean(xf * xf, dim=-1, keepdim=True)
  y = xf * torch.rsqrt(var + eps)
  return (y * scale.to(torch.float32)).to(x.dtype)


def init_rms(d: int, *, stack: tuple = (), device=None) -> torch.Tensor:
  """A unit f32 scale of shape stack + (d,)."""
  return torch.ones(tuple(stack) + (d,), dtype=torch.float32, device=device)
