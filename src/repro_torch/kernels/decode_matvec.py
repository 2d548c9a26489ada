"""decode_matvec — launcher of `csrc/decode_matvec.cu` (y = x @ w at
serving batch, f32 accumulation, output in x.dtype).

Replaces the Pallas kernel `repro/kernels/decode_matvec.py:38`. The
design note (what bounds it, what the design does) heads the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def decode_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """x: (b, m), w: (m, n), both f32 or both bf16, on one CUDA device."""
  _build.require("decode_matvec", x, w)
  code = _build.dtype_code("decode_matvec", x, w)
  if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
    raise ValueError(f"decode_matvec: shapes {tuple(x.shape)} @ "
                     f"{tuple(w.shape)}")
  x, w = x.contiguous(), w.contiguous()
  (b, m), n = x.shape, w.shape[1]
  y = torch.empty((b, n), dtype=x.dtype, device=x.device)
  with torch.cuda.device(x.device):
    err = _build.library().rk_decode_matvec(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, m, n, code,
        _build.stream(x))
  _build.check(err, "decode_matvec")
  return y
