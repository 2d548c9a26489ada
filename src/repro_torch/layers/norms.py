"""Normalization (f32 statistics, output in the input's dtype).

Counterpart of `repro.layers.norms`: `rms_norm` and `init_rms` (the
dense transformer), `layer_norm` and `init_ln` (Whisper). A LayerNorm's
params are a `LayerNorm` module holding `scale` and `bias`, so
`state_dict()` keys are the reference's paths ("enc_ln/scale").
"""
from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
  xf = x.to(torch.float32)
  var = torch.mean(xf * xf, dim=-1, keepdim=True)
  y = xf * torch.rsqrt(var + eps)
  return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
  xf = x.to(torch.float32)
  mean = torch.mean(xf, dim=-1, keepdim=True)
  var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
  y = (xf - mean) * torch.rsqrt(var + eps)
  return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def init_rms(d: int, *, stack: tuple = (), device=None) -> torch.Tensor:
  """A unit f32 scale of shape stack + (d,)."""
  return torch.ones(tuple(stack) + (d,), dtype=torch.float32, device=device)


class LayerNorm(nn.Module):
  """`scale` and `bias`, f32, of shape stack + (d,)."""

  def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
    super().__init__()
    self.scale = nn.Parameter(scale, requires_grad=False)
    self.bias = nn.Parameter(bias, requires_grad=False)


def init_ln(d: int, *, stack: tuple = (), device=None) -> LayerNorm:
  """Unit scale, zero bias."""
  shape = tuple(stack) + (d,)
  return LayerNorm(torch.ones(shape, dtype=torch.float32, device=device),
                   torch.zeros(shape, dtype=torch.float32, device=device))
