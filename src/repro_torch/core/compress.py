"""Model-level compression — the paper's technique as a framework
feature.

Counterpart of `repro.core.compress`. A `FactorizationPlan` declares, by
logical GEMM name pattern, which weights of a model are factored and how
their stage-2 rank is chosen. Models expose their GRU recurrent weights
as one GEMM named `*/rec` and the non-recurrent ones as `*/nonrec`
(Appendix B.2's partially joint grouping), so the plan and the
regularizer's lambda_rec/lambda_nonrec split work at the granularity the
paper chose.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Sequence

from torch import nn

from repro_torch.core import svd
from repro_torch.core.factored import (FactoredLinear, count_params,
                                       iter_factored_leaves,
                                       map_factored_leaves)
from repro_torch.core.svd import TruncationSpec


@dataclasses.dataclass(frozen=True)
class FactorizationPlan:
  """Which GEMMs to factor, matched on the leaves' logical-name globs."""
  include: Sequence[str] = ("*",)       # glob patterns of GEMM names
  exclude: Sequence[str] = ()           # exceptions (e.g. "*embed*")
  min_dim: int = 128                    # don't factor tiny GEMMs
  truncation: TruncationSpec = TruncationSpec()

  def matches(self, leaf) -> bool:
    name = leaf.name
    if any(fnmatch.fnmatch(name, p) for p in self.exclude):
      return False
    if not any(fnmatch.fnmatch(name, p) for p in self.include):
      return False
    return min(leaf.in_dim, leaf.out_dim) >= self.min_dim


def to_stage1(params: nn.Module, plan: FactorizationPlan) -> nn.Module:
  """Factor every matching GEMM at full rank (balanced SVD split); the
  stage-1 model is then trained with `RegularizerConfig(kind="trace")`."""
  def f(leaf: FactoredLinear) -> FactoredLinear:
    if not plan.matches(leaf) or leaf.is_factored:
      return leaf
    return svd.factorize_leaf(leaf)
  return map_factored_leaves(f, params)


def to_stage2(params: nn.Module, plan: FactorizationPlan,
              truncation: Optional[TruncationSpec] = None,
              calib: Optional[dict] = None) -> nn.Module:
  """Warmstart a stage-2 model: truncated SVD of every matching GEMM.

  `calib` maps a leaf name to its input Gram matrix E[x x^T] ((m, m), or
  (L, m, m) a layer for stacked leaves), or to an object whose
  `.second_moment` holds it. Leaves with stats get the activation-weighted
  truncation (`svd.activation_split`); the others the weight spectrum."""
  spec = truncation or plan.truncation
  calib = calib or {}

  def f(leaf: FactoredLinear) -> FactoredLinear:
    if not plan.matches(leaf):
      return leaf
    cov = calib.get(leaf.name)
    cov = getattr(cov, "second_moment", cov)
    return svd.truncate_leaf(leaf, spec, cov=cov)
  return map_factored_leaves(f, params)


def compression_report(before: nn.Module, after: nn.Module,
                       calib: Optional[dict] = None) -> dict:
  """The params/rank table of a compression: one row a GEMM, and the
  totals. With `calib` (the mapping handed to `to_stage2`) each row says
  whether its rank was activation-calibrated."""
  rows = []
  b = {leaf.name: leaf for leaf in iter_factored_leaves(before)}
  for leaf in iter_factored_leaves(after):
    orig = b.get(leaf.name)
    rows.append({
        "name": leaf.name,
        "group": leaf.group,
        "shape": (leaf.in_dim, leaf.out_dim),
        "rank": leaf.rank if leaf.is_factored else None,
        "params": leaf.num_params,
        "params_before": orig.num_params if orig is not None else None,
        "calibrated": bool(calib) and leaf.name in calib,
    })
  return {
      "gemms": rows,
      "total_params_before": count_params(before),
      "total_params_after": count_params(after),
      "calibrated_gemms": sorted(calib.keys()) if calib else [],
  }


def leaf_names(params: nn.Module) -> list[str]:
  return [leaf.name for leaf in iter_factored_leaves(params)]
