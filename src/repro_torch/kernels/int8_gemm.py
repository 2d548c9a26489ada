"""int8_gemm — launcher of `csrc/int8_gemm.cu` (w8a8: s8 x s8 -> s32,
then `float(acc) * x_scale[b] * w_scale[n]`, f32 output, bit-equal to
the plain version).

Replaces the Pallas kernel `repro/kernels/int8_gemm.py:41`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor) -> torch.Tensor:
  """x_q: (b, m) int8, w_q: (m, n) int8, x_scale: (b,) f32, w_scale:
  (n,) f32, on one CUDA device. Returns (b, n) f32."""
  _build.require("int8_gemm", x_q, w_q, x_scale, w_scale)
  if x_q.dtype != torch.int8 or w_q.dtype != torch.int8 or \
      x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
    raise TypeError("int8_gemm: takes int8 operands and f32 scales, got "
                    f"{[str(t.dtype) for t in (x_q, w_q, x_scale, w_scale)]}")
  b, m = x_q.shape
  n = w_q.shape[1]
  if w_q.shape[0] != m or x_scale.shape != (b,) or w_scale.shape != (n,):
    raise ValueError(f"int8_gemm: shapes x_q {tuple(x_q.shape)}, w_q "
                     f"{tuple(w_q.shape)}, x_scale {tuple(x_scale.shape)}, "
                     f"w_scale {tuple(w_scale.shape)}")
  x_q, w_q, x_scale, w_scale = (
      t.contiguous() for t in (x_q, w_q, x_scale, w_scale))
  y = torch.empty((b, n), dtype=torch.float32, device=x_q.device)
  with torch.cuda.device(x_q.device):
    err = _build.library().rk_int8_gemm(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), b, m, n, _build.stream(x_q))
  _build.check(err, "int8_gemm")
  return y
