"""lowrank_gemm — launcher of `csrc/lowrank_gemm.cu` (y = (x @ U) @ V,
the rank intermediate kept in f32, output in x.dtype).

Replaces the Pallas kernel `repro/kernels/lowrank_gemm.py:44`. The TPU
kernel keeps t = x @ U in VMEM across its sequential grid; Hopper blocks
carry nothing between them, so this launcher allocates t (b, r) in f32
and the library runs the skinny-GEMM template twice on one stream (each
phase tiled and split along its k axis as `decode_matvec.plan` chooses,
the two sharing one partial-sum workspace): t goes through the L2, not
through registers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_matvec import (address, counters, plan_for,
                                               workspace)


def lowrank_gemm(x: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
  """x: (b, m), u: (m, r), v: (r, n), one float type, one CUDA device."""
  _build.require("lowrank_gemm", x, u, v)
  code = _build.dtype_code("lowrank_gemm", x, u, v)
  if x.ndim != 2 or u.ndim != 2 or v.ndim != 2 or \
      x.shape[1] != u.shape[0] or u.shape[1] != v.shape[0]:
    raise ValueError(f"lowrank_gemm: shapes {tuple(x.shape)} @ "
                     f"{tuple(u.shape)} @ {tuple(v.shape)}")
  x, u, v = x.contiguous(), u.contiguous(), v.contiguous()
  (b, m), (r, n) = x.shape, v.shape
  p1, p2 = plan_for(x, u), plan_for(x, v)
  part, count = workspace(x, p1, p2), counters(x, p1, p2)
  t = torch.empty((b, r), dtype=torch.float32, device=x.device)
  y = torch.empty((b, n), dtype=x.dtype, device=x.device)
  with torch.cuda.device(x.device):
    err = _build.library().rk_lowrank_gemm(
        x.data_ptr(), u.data_ptr(), v.data_ptr(), t.data_ptr(), y.data_ptr(),
        address(part), address(count), b, m, r, n, p1.lanes, p1.split,
        p1.k_per_split, p2.lanes, p2.split, p2.k_per_split, code,
        _build.stream(x))
  _build.check(err, "lowrank_gemm")
  return y
