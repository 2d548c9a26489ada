"""gru_cell — launcher of `csrc/gru_cell.cu` (one fused GRU step, paper
eq. 10, gate order [z, r, hcand], r gating only U_h h).

Replaces the Pallas kernel `repro/kernels/gru_cell.py:36`. The new state
is written to a fresh buffer: every block reads all of h.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gru_cell(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
  """xw: (b, 3H), h: (b, H), u: (H, 3H) in one float type; bias: (3H,)
  f32. Returns h' (b, H) in h.dtype."""
  _build.require("gru_cell", xw, h, u, bias)
  code = _build.dtype_code("gru_cell", xw, h, u)
  b, hidden = h.shape
  if xw.shape != (b, 3 * hidden) or u.shape != (hidden, 3 * hidden) or \
      bias.shape != (3 * hidden,):
    raise ValueError(f"gru_cell: shapes xw {tuple(xw.shape)}, h "
                     f"{tuple(h.shape)}, u {tuple(u.shape)}, bias "
                     f"{tuple(bias.shape)}")
  if bias.dtype != torch.float32:
    raise TypeError(f"gru_cell: bias must be f32, got {bias.dtype}")
  xw, h, u, bias = (t.contiguous() for t in (xw, h, u, bias))
  out = torch.empty_like(h)
  with torch.cuda.device(h.device):
    err = _build.library().rk_gru_cell(
        xw.data_ptr(), h.data_ptr(), u.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, hidden, code, _build.stream(h))
  _build.check(err, "gru_cell")
  return out
