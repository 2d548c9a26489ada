"""decode_matvec — launcher of `csrc/decode_matvec.cu` (y = x @ w at
serving batch, f32 accumulation, output in x.dtype), and `plan`, the
tiling and split-K it passes to the kernel, on the one-wave rule
`split_plan` that `int8_gemm.plan` shares.

Replaces the Pallas kernel `repro/kernels/decode_matvec.py:38`. The
design note (what bounds it, what the design does) heads
`csrc/matvec.cuh`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Callable

import torch

from repro_torch.kernels import _build

#: the kernel's fixed shape (csrc/matvec.cuh, namespace mv): threads a
#: block, and UNROLL rows of W a lane has in flight. These constants are
#: copies of the CUDA source's; tests/test_torch_kernels.py reads them
#: out of the source and holds the copies to them.
THREADS, UNROLL = 256, 4
#: lanes side by side across a row of W (G): a block owns G x 16 bytes of
#: columns and reads THREADS / G rows at once; the widest first
LANES = (32, 16, 8)
#: batch rows a block holds at most (blockIdx.z walks the rest)
BATCH_TILE = 16
#: blocks an SM holds at once, by the batch rows R a block holds (the
#: kernel's __launch_bounds__, Resident<R> in matvec.cuh)
RESIDENT = {1: 4, 2: 4, 4: 3, 8: 2, 16: 1}
#: rows a k range should get before the plan narrows the column tile
K_PREF = 256
#: SMs of an H100 SXM; the launchers pass the card's own count
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Plan:
  """How the kernel cuts y (b, n) = x (b, m) @ W (m, n).

  Block (x, y, z) owns columns [x * cols, (x + 1) * cols) (`lanes` lanes
  of `vec` columns side by side), k range y (`k_ranges()[y]`) and batch
  rows [16 z, 16 z + rows). With split > 1 each block writes its partial
  sums (f32; int8_gemm: s32) to workspace[y, row, col] (a (split, b, n)
  tensor) and counts itself in counter [z, x]; the last block of a tile
  sums the k ranges in order and zeroes the counter."""
  b: int
  m: int
  n: int
  rows: int          # R: batch rows a block holds (power of two <= 16)
  vec: int           # columns a lane owns (16 bytes of W; int8: 8 at R = 16)
  lanes: int         # G: lanes side by side across a row, in LANES
  split: int         # k ranges
  k_per_split: int   # rows of W a k range takes (the last may take fewer)

  @property
  def cols(self) -> int:
    """Columns a block owns."""
    return self.lanes * self.vec

  @property
  def grid(self) -> tuple[int, int, int]:
    return (math.ceil(self.n / self.cols), self.split,
            math.ceil(self.b / BATCH_TILE))

  @property
  def blocks(self) -> int:
    return math.prod(self.grid)

  @property
  def workspace_shape(self) -> tuple[int, ...]:
    """The partial sums the kernel writes: (split, b, n), or none."""
    return (self.split, self.b, self.n) if self.split > 1 else (0,)

  @property
  def counters(self) -> int:
    """Tile counters the kernel uses: one a (column tile, batch tile)."""
    gx, _, gz = self.grid
    return gx * gz if self.split > 1 else 0

  def k_ranges(self) -> list[tuple[int, int]]:
    return [(i * self.k_per_split, min(self.m, (i + 1) * self.k_per_split))
            for i in range(self.split)]


def k_min(lanes: int) -> int:
  """Fewest rows a k range takes: one unrolled pass of every row slot."""
  return THREADS // lanes * UNROLL


def batch_rows(b: int) -> int:
  """R: the batch rows a block holds, b rounded up to a power of two <= 16
  (RK_DISPATCH_ROWS in csrc/common.cuh)."""
  return min(BATCH_TILE, 1 << (b - 1).bit_length())


def split_plan(b: int, m: int, n: int, *, vec: int, resident: dict,
               k_min: Callable[[int], int], k_align: int, sms: int,
               groups: int = 1) -> Plan:
  """The one-wave split-K rule of the skinny GEMMs (decode_matvec's,
  int8_gemm's and gru_cell's): as many k ranges as fit the SMs'
  `resident` blocks once (two when the column tiles alone overflow them),
  each a multiple of `k_align` rows and at least `k_min(lanes)`. The
  widest column tile (`vec` columns a lane) whose ranges keep K_PREF rows
  wins (fewer partial sums); else the narrowest. `groups`: the columns
  are that many groups of n, each tiled on its own (gru_cell's three
  gates)."""
  rows = batch_rows(b)
  slots = resident[rows] * sms
  for lanes in LANES:
    tiles = (groups * math.ceil(n / (lanes * vec))
             * math.ceil(b / BATCH_TILE))
    split = slots // tiles if tiles <= slots else 2
    k = math.ceil(m / split)
    k = min(m, max(k_min(lanes), k + (-k) % k_align))
    if k >= K_PREF:
      break
  return Plan(b=b, m=m, n=n, rows=rows, vec=vec, lanes=lanes,
              split=math.ceil(m / k), k_per_split=k)


@functools.lru_cache(maxsize=4096)
def plan(b: int, m: int, n: int, *, w_bytes: int = 2,
         sms: int = H100_SMS) -> Plan:
  """The tiling of one y = x @ W (f32 or bf16): `split_plan` with a lane
  owning 16 bytes of a row and k ranges of multiples of 8 rows."""
  if min(b, m, n) <= 0 or w_bytes not in (2, 4):
    raise ValueError(f"plan: b={b} m={m} n={n} w_bytes={w_bytes}")
  return split_plan(b, m, n, vec=16 // w_bytes, resident=RESIDENT,
                    k_min=k_min, k_align=8, sms=sms)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
  """`plan` for x @ w on x's card."""
  return plan(x.shape[0], w.shape[0], w.shape[1], w_bytes=w.element_size(),
              sms=sm_count(x.device.index or 0))


def workspace(x: torch.Tensor, p, dtype=torch.float32) -> torch.Tensor | None:
  """The partial-sum buffer of plan `p` (its `workspace_shape`), or None
  when it needs none."""
  size = math.prod(p.workspace_shape)
  if size == 0:
    return None
  return torch.empty((size,), dtype=dtype, device=x.device)


#: (device index, stream handle) -> zeroed int32 tile counters, shared by
#: the launches on that stream (each leaves the counters it used at zero)
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def counters(x: torch.Tensor, p) -> torch.Tensor | None:
  """Zeroed counters for plan `p` (its `counters` ints) on x's current
  stream, or None when it needs none."""
  need = p.counters
  if need == 0:
    return None
  key = (x.device.index, _build.stream(x))
  buf = _COUNTERS.get(key)
  if buf is None or buf.numel() < need:
    buf = torch.zeros((max(need, 1024),), dtype=torch.int32, device=x.device)
    _COUNTERS[key] = buf
  return buf


def address(t: torch.Tensor | None) -> int | None:
  """A tensor's address for ctypes; None (NULL) for no tensor."""
  return None if t is None else t.data_ptr()


def decode_matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """x: (b, m), w: (m, n), both f32 or both bf16, on one CUDA device."""
  _build.require("decode_matvec", x, w)
  code = _build.dtype_code("decode_matvec", x, w)
  if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
    raise ValueError(f"decode_matvec: shapes {tuple(x.shape)} @ "
                     f"{tuple(w.shape)}")
  x, w = x.contiguous(), w.contiguous()
  (b, m), n = x.shape, w.shape[1]
  p = plan_for(x, w)
  part, count = workspace(x, p), counters(x, p)
  y = torch.empty((b, n), dtype=x.dtype, device=x.device)
  with torch.cuda.device(x.device):
    err = _build.library().rk_decode_matvec(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), address(part),
        address(count), b, m, n, p.lanes, p.split, p.k_per_split, code,
        _build.stream(x))
  _build.check(err, "decode_matvec")
  return y
