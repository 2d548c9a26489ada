"""Which GEMMs a compression (or quantization) plan touches.

Counterpart of `repro.core.compress`, ported as far as PTQ needs it:
`FactorizationPlan.matches`. The truncation spec and the stage-1/2
passes (`to_stage1`, `to_stage2`) come with the training slice.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class FactorizationPlan:
  """Which GEMMs to factor, matched on the leaves' logical-name globs."""
  include: Sequence[str] = ("*",)       # glob patterns of GEMM names
  exclude: Sequence[str] = ()           # exceptions (e.g. "*embed*")
  min_dim: int = 128                    # don't factor tiny GEMMs

  def matches(self, leaf) -> bool:
    name = leaf.name
    if any(fnmatch.fnmatch(name, p) for p in self.exclude):
      return False
    if not any(fnmatch.fnmatch(name, p) for p in self.include):
      return False
    return min(leaf.in_dim, leaf.out_dim) >= self.min_dim
