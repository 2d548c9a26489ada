"""Peak live bytes of one program, by last use over the op walk.

Counterpart of `repro/analysis/liveness.py`. The reference estimates a
decode step's resident bytes from its jaxpr without running it; eager
PyTorch has no program to read, so the estimate runs over the
`OpRecord`s an `OpWalk(keep_trace=True)` kept while the program ran
once, by storage (a view allocates nothing; a storage is what the
allocator hands out):

* every program argument (`inputs`: parameters, decode state, tokens),
  read or not, is resident for the whole program, as the reference's
  jaxpr invars are, and so is any other storage an op read before any
  op returned it (a constant the program closes over) —
  `input_bytes`;
* a storage an op returned for the first time is allocated at that op
  and freed after the last op that reads or returns it; a storage the
  program returns is never freed;
* a state written in place (the KV cache's `index_put_`, a carry's
  `copy_`) returns a storage already resident, and allocates nothing:
  the torch form of the reference's donation credit. `donated_bytes`
  are the bytes of the state's storages (`donated`), `credited_bytes`
  those of the ones the program wrote in place;
* a kernel scope is one op (its operands and result): the plain
  version's intermediates that the CPU runs inside it are not counted,
  so the estimate reads alike on the CPU and on the card.

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
  input_bytes: int                 # program arguments, resident throughout
  output_bytes: int                # storages the program returns
  transient_bytes: int             # peak bytes of op-allocated storages
  peak_bytes: int                  # input_bytes + transient_bytes
  n_ops: int
  donated_bytes: int = 0           # the state's storages
  credited_bytes: int = 0          # state storages written in place


def _leaves(tree) -> Iterable[torch.Tensor]:
  if isinstance(tree, torch.Tensor):
    yield tree
  elif isinstance(tree, torch.nn.Module):
    yield from tree.parameters()
    yield from tree.buffers()
  elif isinstance(tree, dict):
    for v in tree.values():
      yield from _leaves(v)
  elif isinstance(tree, (list, tuple)):
    for v in tree:
      yield from _leaves(v)


def _storages(walk: OpWalk, tree) -> dict:
  """{storage id: bytes} of every tensor of `tree`."""
  out = {}
  for t in _leaves(tree):
    sid, nbytes, _ = walk.storage_id(t)
    if sid is not None:
      out[sid] = nbytes
  return out


def estimate(result: WalkResult, walk: OpWalk, outputs=(),
             inputs=None, donated=None) -> LivenessReport:
  """Last-use liveness over `result.trace` (the walk's, kept with
  `keep_trace=True`). `outputs` are the program's results, whose
  storages stay live to the end; `inputs` its arguments (any nest of
  tensors, modules, dicts and lists); `donated` the part of them the
  program may write in place (the decode state)."""
  kept = _storages(walk, outputs)
  resident = dict(result.resident)
  resident.update(_storages(walk, inputs))
  last: dict = {}
  for i, rec in enumerate(result.trace):
    for sid in rec.read + rec.wrote:
      last[sid] = i
  frees: list = [[] for _ in result.trace]
  for sid, i in last.items():
    if sid not in kept:
      frees[i].append(sid)
  live = peak = 0
  owned: dict = {}
  written: set = set()
  for i, rec in enumerate(result.trace):
    written.update(rec.mutated)
    for sid, nbytes in rec.alloc.items():
      if sid in resident:
        continue
      owned[sid] = nbytes
      live += nbytes
    peak = max(peak, live)
    for sid in frees[i]:
      live -= owned.pop(sid, 0)
  input_bytes = sum(resident.values())
  state = _storages(walk, donated) if donated is not None else {}
  return LivenessReport(
      input_bytes=input_bytes, output_bytes=sum(kept.values()),
      transient_bytes=peak, peak_bytes=input_bytes + peak,
      n_ops=len(result.trace), donated_bytes=sum(state.values()),
      credited_bytes=sum(b for sid, b in state.items() if sid in written))

