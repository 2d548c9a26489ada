"""lowrank_gemm — launcher of `csrc/lowrank_gemm.cu` (y = (x @ U) @ V,
the rank intermediate t kept in f32, output in x.dtype), and
`lowrank_plan`, the work items of its one fused launch.

Replaces the Pallas kernel `repro/kernels/lowrank_gemm.py:44`. The TPU
kernel keeps t = x @ U in VMEM across its sequential grid; here one grid
holds both phases as work items taken by ticket, phase 1 (split-K tiles
of t) first, and a phase-2 block stages its slab of V in shared memory
while it waits for t. The design note heads the CUDA source.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_matvec import (BATCH_TILE, H100_SMS,
                                               address, batch_rows, counters,
                                               k_min, sm_count, workspace)

#: copies of csrc/lowrank_gemm.cu's constants (held to the source by
#: tests/test_torch_kernels.py): lanes across a row in both phases, the
#: largest slab of V a block stages, and the ints of the counter buffer
#: ahead of the tile counters (ticket, published t tiles, phase-2 blocks
#: past their wait)
LANES, SLAB_BYTES, HEAD = 8, 32768, 3
#: blocks an SM holds at once, by the batch rows R a block holds
#: (Resident<R> in the source)
RESIDENT = {1: 2, 2: 2, 4: 2, 8: 2, 16: 1}
#: floats of x (here t) a block stages at a time (kXsFloats, matvec.cuh):
#: a range with a slab must fit one chunk
XS_FLOATS = 4096


@dataclasses.dataclass(frozen=True)
class LowrankPlan:
  """The work items of one fused call. Phase 1 tiles t (b, r) = x @ U
  like `decode_matvec.Plan` (column tiles of `cols`, `split1` k ranges of
  `kper1` rows of m, batch tiles of 16); phase 2 tiles y (b, n) = t @ V
  the same way over r (`split2`, `kper2`). Tickets 0 .. items1 - 1 are
  phase 1's, the rest phase 2's (`item`). `slab`: a phase-2 block stages
  its k range of V in shared memory before it waits for t."""
  b: int
  m: int
  r: int
  n: int
  rows: int     # R: batch rows a block holds
  vec: int      # columns a lane owns (16 bytes)
  split1: int
  kper1: int
  split2: int
  kper2: int
  slab: bool

  @property
  def cols(self) -> int:
    return LANES * self.vec

  @property
  def tiles(self) -> tuple[int, int, int]:
    """(column tiles of t, column tiles of y, batch tiles)."""
    return (math.ceil(self.r / self.cols), math.ceil(self.n / self.cols),
            math.ceil(self.b / BATCH_TILE))

  @property
  def items1(self) -> int:
    gx1, _, gz = self.tiles
    return gx1 * self.split1 * gz

  @property
  def blocks(self) -> int:
    _, gx2, gz = self.tiles
    return self.items1 + gx2 * self.split2 * gz

  def item(self, ticket: int) -> tuple[int, int, int, int]:
    """(phase, column tile, k range, batch tile) of a ticket, decoded as
    the kernel decodes it."""
    gx1, gx2, _ = self.tiles
    phase, gx, split = 1, gx1, self.split1
    if ticket >= self.items1:
      phase, gx, split, ticket = 2, gx2, self.split2, ticket - self.items1
    return phase, ticket % gx, ticket // gx % split, ticket // gx // split

  def k_ranges(self, phase: int) -> list[tuple[int, int]]:
    k, split, kper = ((self.m, self.split1, self.kper1) if phase == 1 else
                      (self.r, self.split2, self.kper2))
    return [(i * kper, min(k, (i + 1) * kper)) for i in range(split)]

  @property
  def slab_bytes(self) -> int:
    """Dynamic shared memory a phase-2 block takes for its slab of V."""
    return self.kper2 * self.cols * (16 // self.vec) if self.slab else 0

  @property
  def workspace_shape(self) -> tuple[int]:
    """f32: t (b, r), then each phase's split-K partial sums, (split1, b,
    r) and (split2, b, n), where that phase splits."""
    size = self.b * self.r
    if self.split1 > 1:
      size += self.split1 * self.b * self.r
    if self.split2 > 1:
      size += self.split2 * self.b * self.n
    return (size,)

  @property
  def counters(self) -> int:
    """HEAD ints, then one counter a (column tile, batch tile) of each
    phase."""
    gx1, gx2, gz = self.tiles
    return HEAD + gz * (gx1 + gx2)


def _range(k: int, tiles: int, budget: int) -> tuple[int, int]:
  """(split, rows a range) of a k axis of `k` rows over `tiles` column and
  batch tiles, with about `budget` blocks: ranges of a multiple of 8 rows,
  at least one unrolled pass of the row slots."""
  rows = math.ceil(k / max(1, budget // tiles))
  rows = min(k, max(k_min(LANES), rows + (-rows) % 8))
  return math.ceil(k / rows), rows


@functools.lru_cache(maxsize=4096)
def lowrank_plan(b: int, m: int, r: int, n: int, *, w_bytes: int = 2,
                 sms: int = H100_SMS) -> LowrankPlan:
  """Work items in one wave of resident blocks, each block one pass of
  loads: phase 2 takes r in one k range where a slab holds it
  (SLAB_BYTES, and one chunk of staged t; at the DS2 shapes it does), so
  it has no partial sums; phase 1 gets the wave's other slots, in k
  ranges of at least `k_min(LANES)` rows. V whose rows are not whole
  16-byte vectors (n % vec) streams from global memory instead of a
  slab."""
  if min(b, m, r, n) <= 0 or w_bytes not in (2, 4):
    raise ValueError(f"lowrank_plan: b={b} m={m} r={r} n={n} "
                     f"w_bytes={w_bytes}")
  rows, vec = batch_rows(b), 16 // w_bytes
  plan = LowrankPlan(b=b, m=m, r=r, n=n, rows=rows, vec=vec, split1=1,
                     kper1=m, split2=1, kper2=r, slab=False)
  gx1, gx2, gz = plan.tiles
  slab_rows = min(SLAB_BYTES // (plan.cols * w_bytes), XS_FLOATS // rows)
  kper2 = min(r, slab_rows - slab_rows % 8)
  split2 = math.ceil(r / kper2)
  split1, kper1 = _range(m, gx1 * gz,
                         RESIDENT[rows] * sms - gx2 * split2 * gz)
  return dataclasses.replace(plan, split1=split1, kper1=kper1, split2=split2,
                             kper2=kper2, slab=n % vec == 0)


def lowrank_gemm(x: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
  """x: (b, m), u: (m, r), v: (r, n), one float type, one CUDA device."""
  _build.require("lowrank_gemm", x, u, v)
  if x.ndim != 2 or u.ndim != 2 or v.ndim != 2 or \
      x.shape[1] != u.shape[0] or u.shape[1] != v.shape[0]:
    raise ValueError(f"lowrank_gemm: shapes {tuple(x.shape)} @ "
                     f"{tuple(u.shape)} @ {tuple(v.shape)}")
  (b, m), (r, n) = x.shape, v.shape
  return _launch(x, u, v, lowrank_plan(b, m, r, n, w_bytes=x.element_size(),
                                       sms=sm_count(x.device.index or 0)))


def _launch(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            p: LowrankPlan) -> torch.Tensor:
  """The fused launch of plan `p` (`lowrank_gemm`'s, or a grid the tests
  force) on CUDA operands of `lowrank_gemm`'s shapes."""
  _build.require("lowrank_gemm", x, u, v)
  code = _build.dtype_code("lowrank_gemm", x, u, v)
  x, u, v = x.contiguous(), u.contiguous(), v.contiguous()
  (b, m), (r, n) = x.shape, v.shape
  if (p.b, p.m, p.r, p.n, p.vec) != (b, m, r, n, 16 // x.element_size()):
    raise ValueError(f"lowrank_gemm: {p} is not a plan for these operands")
  work, count = workspace(x, p), counters(x, p)
  y = torch.empty((b, n), dtype=x.dtype, device=x.device)
  with torch.cuda.device(x.device):
    err = _build.library().rk_lowrank_gemm(
        x.data_ptr(), u.data_ptr(), v.data_ptr(), y.data_ptr(),
        address(work), address(count), b, m, r, n, p.split1, p.kper1,
        p.split2, p.kper2, int(p.slab), code, _build.stream(x))
  _build.check(err, "lowrank_gemm")
  return y
