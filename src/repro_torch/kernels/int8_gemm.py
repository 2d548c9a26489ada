"""int8_gemm — launcher of `csrc/int8_gemm.cu` (w8a8: s8 x s8 -> s32,
then `float(acc) * x_scale[b] * w_scale[n]`, f32 output, bit-equal to
the plain version), and `plan`, its tiling and split-K.

Replaces the Pallas kernel `repro/kernels/int8_gemm.py:41`. The design
note heads the CUDA source.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_matvec import (H100_SMS, Plan, address,
                                               batch_rows, counters,
                                               sm_count, split_plan,
                                               workspace)

#: copies of the kernel's constants (held to the sources by
#: tests/test_torch_kernels.py): threads a block (matvec.cuh's, which
#: int8_gemm.cu shares), and UNROLL quads (4 rows) of w_q a lane has in
#: flight
THREADS, UNROLL = 256, 2
#: blocks an SM holds at once, by the batch rows R a block holds
#: (Resident<R>)
RESIDENT = {1: 2, 2: 2, 4: 2, 8: 1, 16: 1}


def cols_a_lane(rows: int) -> int:
  """Columns (bytes of a row of w_q) a lane owns at R batch rows
  (Lane<R>): 8 at R = 16, to keep 128 accumulators a thread."""
  return 16 if rows <= 8 else 8


def k_min(lanes: int) -> int:
  """Fewest rows a k range takes: one unrolled pass of every quad slot."""
  return THREADS // lanes * UNROLL * 4


@functools.lru_cache(maxsize=4096)
def plan(b: int, m: int, n: int, *, sms: int = H100_SMS) -> Plan:
  """The tiling of one int8 GEMM: decode_matvec's one-wave rule with k
  ranges of multiples of 16 rows (whole quads)."""
  if min(b, m, n) <= 0:
    raise ValueError(f"plan: b={b} m={m} n={n}")
  return split_plan(b, m, n, vec=cols_a_lane(batch_rows(b)),
                    resident=RESIDENT, k_min=k_min, k_align=16, sms=sms)


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
  p = plan(b, m, n, sms=sm_count(x_q.device.index or 0))
  part = workspace(x_q, p, torch.int32)
  count = counters(x_q, p)
  y = torch.empty((b, n), dtype=torch.float32, device=x_q.device)
  with torch.cuda.device(x_q.device):
    err = _build.library().rk_int8_gemm(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
        w_scale.data_ptr(), y.data_ptr(), address(part), address(count), b,
        m, n, p.lanes, p.split, p.k_per_split, _build.stream(x_q))
  _build.check(err, "int8_gemm")
  return y
