"""gru_cell — launcher of `csrc/gru_cell.cu` (one fused GRU step, paper
eq. 10, gate order [z, r, hcand], r gating only U_h h), and `plan`, the
gate column tiles and split-K it passes to the kernel.

Replaces the Pallas kernel `repro/kernels/gru_cell.py:36`. The new state
is written to a fresh buffer: every block reads all of h. The design note
heads the CUDA source.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_matvec import (BATCH_TILE, H100_SMS,
                                               RESIDENT, address, counters,
                                               k_min, sm_count, split_plan,
                                               workspace)

#: the column groups of U, one a gate (z, r, hcand): kGates in the source
#: (held to it by tests/test_torch_kernels.py)
GATES = 3


@dataclasses.dataclass(frozen=True)
class GruPlan:
  """How the kernel cuts hu = h (b, H) @ U (H, 3H) and applies the gates.

  Block (x, y, z) owns gate x % 3's columns of unit tile x // 3 (units
  [t * cols, (t + 1) * cols) below H; `tile`), k range y (`k_ranges()[y]`)
  and batch rows [16 z, 16 z + rows). Every block writes its partial sums
  to workspace[y, row, gate * H + unit] (a (split, b, 3H) f32 tensor) and
  counts itself in counter [z, t]; the last of the tile's 3 * split
  blocks sums each gate's k ranges in order, applies the gates and zeroes
  the counter."""
  b: int
  hidden: int
  rows: int          # R: batch rows a block holds (power of two <= 16)
  vec: int           # columns a lane owns (16 bytes of U)
  lanes: int         # G: lanes side by side across a row
  split: int         # k ranges
  k_per_split: int   # rows of U a k range takes (the last may take fewer)

  @property
  def cols(self) -> int:
    """Units (columns of one gate) a block owns."""
    return self.lanes * self.vec

  @property
  def unit_tiles(self) -> int:
    return math.ceil(self.hidden / self.cols)

  @property
  def grid(self) -> tuple[int, int, int]:
    return (GATES * self.unit_tiles, self.split,
            math.ceil(self.b / BATCH_TILE))

  @property
  def blocks(self) -> int:
    return math.prod(self.grid)

  def tile(self, x: int) -> tuple[int, int]:
    """(gate, unit tile) of column tile x, decoded as the kernel does."""
    return x % GATES, x // GATES

  @property
  def workspace_shape(self) -> tuple[int, int, int]:
    """The partial sums the kernel writes: (split, b, 3H), also with one
    k range (the three gates of a unit meet in the tail)."""
    return (self.split, self.b, GATES * self.hidden)

  @property
  def counters(self) -> int:
    """Tile counters the kernel uses: one a (unit tile, batch tile)."""
    return self.unit_tiles * self.grid[2]

  def k_ranges(self) -> list[tuple[int, int]]:
    return [(i * self.k_per_split,
             min(self.hidden, (i + 1) * self.k_per_split))
            for i in range(self.split)]


@functools.lru_cache(maxsize=4096)
def plan(b: int, hidden: int, *, w_bytes: int = 2,
         sms: int = H100_SMS) -> GruPlan:
  """The tiling of one step (U in f32 or bf16): decode_matvec's one-wave
  rule (`split_plan`) over the 3 * ceil(H / cols) gate column tiles, a
  lane owning 16 bytes of a row of U, k ranges of multiples of 8 rows."""
  if min(b, hidden) <= 0 or w_bytes not in (2, 4):
    raise ValueError(f"plan: b={b} hidden={hidden} w_bytes={w_bytes}")
  p = split_plan(b, hidden, hidden, vec=16 // w_bytes, resident=RESIDENT,
                 k_min=k_min, k_align=8, sms=sms, groups=GATES)
  return GruPlan(b=b, hidden=hidden, rows=p.rows, vec=p.vec, lanes=p.lanes,
                 split=p.split, k_per_split=p.k_per_split)


def gru_cell(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
  """xw: (b, 3H), h: (b, H), u: (H, 3H) in one float type; bias: (3H,)
  f32. Returns h' (b, H) in h.dtype."""
  _build.require("gru_cell", xw, h, u, bias)
  _build.dtype_code("gru_cell", xw, h, u)
  if h.ndim != 2:
    raise ValueError(f"gru_cell: h must be (b, H), got {tuple(h.shape)}")
  b, hidden = h.shape
  return _launch(xw, h, u, bias, plan(b, hidden, w_bytes=h.element_size(),
                                      sms=sm_count(h.device.index or 0)))


def _launch(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
            bias: torch.Tensor, p: GruPlan,
            stamps: torch.Tensor | None = None) -> torch.Tensor:
  """The launch of plan `p` (`gru_cell`'s, or a grid the tests force) on
  CUDA operands of `gru_cell`'s shapes. `stamps`: None, or an int64
  tensor of 3 * p.blocks on the card, into which thread 0 of block i
  writes %globaltimer (ns) at [3 i] its start, [3 i + 1] after its
  partial sums and [3 i + 2] its end."""
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
  if (p.b, p.hidden, p.vec) != (b, hidden, 16 // h.element_size()):
    raise ValueError(f"gru_cell: {p} is not a plan for these operands")
  if stamps is not None and (stamps.dtype != torch.int64 or
                             stamps.device != h.device or
                             not stamps.is_contiguous() or
                             stamps.numel() < 3 * p.blocks):
    raise ValueError("gru_cell: stamps must be a contiguous int64 tensor of "
                     f"{3 * p.blocks} on {h.device}")
  xw, h, u, bias = (t.contiguous() for t in (xw, h, u, bias))
  part, count = workspace(h, p), counters(h, p)
  out = torch.empty_like(h)
  with torch.cuda.device(h.device):
    err = _build.library().rk_gru_cell(
        xw.data_ptr(), h.data_ptr(), u.data_ptr(), bias.data_ptr(),
        out.data_ptr(), address(part), address(count), address(stamps), b,
        hidden, p.lanes, p.split, p.k_per_split, code, _build.stream(h))
  _build.check(err, "gru_cell")
  return out
