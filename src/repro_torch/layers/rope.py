"""Rotary position embeddings — counterpart of `repro.layers.rope`.

Half-split rotation (the first and second halves of the head dimension
pair up, not neighbouring elements), frequencies theta^(-2i/d) with no
llama3 frequency scaling: the reference's form, not Hugging Face's.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
  """Inverse frequencies, shape (head_dim // 2,), float32."""
  exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                          device=device) / head_dim
  return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
  """Rotate x (..., seq, heads, head_dim) by positions (..., seq)."""
  hd = x.shape[-1]
  freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
  angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
  cos = torch.cos(angles)[..., :, None, :]                 # (..., S, 1, hd/2)
  sin = torch.sin(angles)[..., :, None, :]
  x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
  out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
  return out.to(x.dtype)
