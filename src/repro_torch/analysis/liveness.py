"""Peak live bytes of one program, by last use over the op walk.

Counterpart of `repro/analysis/liveness.py`. The reference estimates a
decode step's resident bytes from its jaxpr without running it; eager
PyTorch has no program to read, so the estimate runs over the stream of
ops an `OpWalk(keep_trace=True)` saw while the program ran once, by
storage (a view allocates nothing; a storage is what the allocator
hands out):

* every storage an op read before any op returned it (parameters,
  decode state, inputs) is resident for the whole program —
  `input_bytes`;
* a storage an op returned for the first time is allocated at that op
  and freed after the last op that reads or returns it; a storage the
  program returns is never freed;
* a state written in place (the KV cache's `index_put_`, a carry's
  `copy_`) returns a storage already resident, and allocates nothing:
  the torch form of the reference's donation credit.

Storages are followed through weak references, so an address the
allocator hands out again after its storage died counts as a new
allocation. The result is an estimate: the caching allocator rounds
blocks up and a kernel wrapper's workspace is not an op. On the card
`chip_smoke.py` prints it beside `torch.cuda.max_memory_allocated`'s
rise over the same warmed step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from repro_torch.analysis.op_walk import OpWalk, WalkResult


@dataclasses.dataclass(frozen=True)
class LivenessReport:
  input_bytes: int                 # resident storages the program read
  output_bytes: int                # storages the program allocated and returned
  transient_bytes: int             # peak bytes of op-allocated storages
  peak_bytes: int                  # input_bytes + transient_bytes
  n_ops: int


def estimate(result: WalkResult, walk: OpWalk,
             outputs: Iterable[torch.Tensor] = ()) -> LivenessReport:
  """Last-use liveness over `result.trace` (the walk's, kept with
  `keep_trace=True`); `outputs` are the program's results, whose
  storages stay live to the end."""
  kept = set()
  for t in outputs:
    sid, _, new = walk.storage_id(t)
    if sid is not None and not new:
      kept.add(sid)
  last: dict = {}
  for i, (_, read, wrote, _) in enumerate(result.trace):
    for sid in read + wrote:
      last[sid] = i
  frees: list = [[] for _ in result.trace]
  for sid, i in last.items():
    if sid not in kept:
      frees[i].append(sid)
  live = peak = 0
  owned: dict = {}
  for i, (_, _, _, alloc) in enumerate(result.trace):
    for sid, nbytes in alloc.items():
      owned[sid] = nbytes
      live += nbytes
    peak = max(peak, live)
    for sid in frees[i]:
      live -= owned.pop(sid, 0)
  input_bytes = sum(result.resident.values())
  out_bytes = sum(owned.get(sid, 0) for sid in kept)
  return LivenessReport(input_bytes=input_bytes, output_bytes=out_bytes,
                        transient_bytes=peak,
                        peak_bytes=input_bytes + peak,
                        n_ops=len(result.trace))
