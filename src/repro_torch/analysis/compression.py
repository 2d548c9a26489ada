"""Static compression ledger: param count and bytes per (family, plan,
PTQ).

Counterpart of `repro/analysis/compression.py`: "the compressed model
is actually smaller" (the paper's §3/§4 product claim) is a static
property, fixed by shapes and dtypes, so the ledger is computed at
PRODUCTION scale on `meta` tensors (`configs.specs.param_specs`): no
weight is drawn. Four variants of every family:

  float         the full-rank float tree (`specs.param_specs`)
  int8          one-shot PTQ of it (`quant.quantize_params` on meta)
  lowrank       a stage-2 shaped tree: every plan-matched GEMM carried
                as (m, r) x (r, n) factors at the *ledger rank* below
  lowrank_int8  PTQ of the lowrank tree (factored u/v int8 + scales)

The ledger rank is the reference's shape-only stand-in for stage-2
truncation, r = max(8, round8(min(m, n) / 4)); the default plan matches
GEMMs with min(m, n) >= 128 only, so r(m + n) < mn holds structurally.

`param_count`, `param_bytes`, `device_bytes` (per device on the audit
mesh, `RuleMesh(data=2, model=4)`, through `dist.sharding.rule_coverage`)
and `n_factored_gemms` are the reference's numbers exactly. `n_leaves`
counts the tensors of an `nn.Module` (its parameters and buffers), where
the reference counts the array leaves of a pytree: a tree that held an
array in one package and not in the other (a tensor-valued attribute
the other keeps as a Python number) would count differently. On the
five default configs the two counts are equal
(`tests/test_torch_analysis.py`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import configs
from repro_torch.configs import specs
from repro_torch.core.compress import FactorizationPlan
from repro_torch.core.factored import (FactoredLinear, count_params,
                                       iter_factored_leaves,
                                       map_factored_leaves)
from repro_torch.dist.sharding import rule_coverage
from repro_torch.quant.ptq import quantize_params

#: the ledger's canonical stage-2 scope: every GEMM with min dim >= 128
DEFAULT_PLAN = FactorizationPlan()

VARIANTS = ("float", "int8", "lowrank", "lowrank_int8")

_META = torch.device("meta")


def ledger_rank(m: int, n: int) -> int:
  """Shape-only stage-2 rank: min(m, n)/4, rounded down to a multiple
  of 8 (the TruncationSpec.round_to default), floored at 8."""
  return max(8, (min(m, n) // 4) // 8 * 8)


def _tensors(tree: nn.Module) -> list:
  seen, out = set(), []
  for t in list(tree.parameters()) + list(tree.buffers()):
    if id(t) not in seen:
      seen.add(id(t))
      out.append(t)
  return out


def tree_bytes(tree: nn.Module) -> int:
  """Total parameter bytes of a model (real or meta tensors)."""
  return sum(t.numel() * t.element_size() for t in _tensors(tree))


def device_bytes(tree: nn.Module, mesh=None) -> int:
  """Per-device parameter bytes on the audit mesh: each leaf's bytes
  divided by the shard factor its gated rule actually achieves."""
  total = 0
  for e in rule_coverage(tree, mesh=mesh):
    f = max(int(e["shard_factor"]), 1)
    total += (int(e["bytes"]) + f - 1) // f
  return total


def lowrank_tree(params: nn.Module,
                 plan: Optional[FactorizationPlan] = None) -> nn.Module:
  """Project a float tree to its stage-2 *shape*: plan-matched GEMMs
  become (m, r) x (r, n) meta factors at the ledger rank; a
  layer-stacked (L, m, n) leaf factors per layer to (L, m, r) x
  (L, r, n), the shape `svd.truncate_leaf` gives a stack."""
  plan = DEFAULT_PLAN if plan is None else plan

  def f(leaf: FactoredLinear):
    arr = leaf.u if leaf.is_factored else leaf.w
    if not plan.matches(leaf):
      return leaf
    lead = tuple(arr.shape[:-2])
    m, n = leaf.in_dim, leaf.out_dim
    r = ledger_rank(m, n)
    return FactoredLinear(
        u=torch.empty(lead + (m, r), dtype=arr.dtype, device=_META),
        v=torch.empty(lead + (r, n), dtype=arr.dtype, device=_META),
        name=leaf.name, group=leaf.group)
  return map_factored_leaves(f, params)


def _variant_stats(tree: nn.Module) -> dict:
  return dict(
      param_count=int(count_params(tree)),
      n_leaves=len(_tensors(tree)),
      param_bytes=tree_bytes(tree),
      device_bytes=device_bytes(tree),
  )


def compression_ledger(config_name: str,
                       plan: Optional[FactorizationPlan] = None) -> dict:
  """The four-variant ledger for one family at production scale."""
  plan = DEFAULT_PLAN if plan is None else plan
  cfg = configs.get_config(config_name)
  float_tree = specs.param_specs(cfg)
  lr_tree = lowrank_tree(float_tree, plan)
  trees = {
      "float": float_tree,
      "int8": quantize_params(float_tree),
      "lowrank": lr_tree,
      "lowrank_int8": quantize_params(lr_tree),
  }
  variants = {k: _variant_stats(t) for k, t in trees.items()}
  n_factored = sum(1 for leaf in iter_factored_leaves(lr_tree)
                   if leaf.is_factored)
  fb = variants["float"]["param_bytes"]
  lb = variants["lowrank"]["param_bytes"]
  return dict(
      variants=variants,
      n_factored_gemms=n_factored,
      ratios=dict(
          int8_vs_float=round(variants["int8"]["param_bytes"] / fb, 6),
          lowrank_vs_float=round(lb / fb, 6),
          lowrank_int8_vs_lowrank=round(
              variants["lowrank_int8"]["param_bytes"] / lb, 6),
      ),
  )


def strictness_violations(ledger: dict) -> list:
  """The acceptance-criteria assertions, as (key, detail) pairs: each
  compressed variant must be STRICTLY smaller in bytes than its
  uncompressed counterpart (whole-tree and per-device alike)."""
  v = ledger["variants"]
  pairs = (
      ("int8", "float"),
      ("lowrank", "float"),
      ("lowrank_int8", "lowrank"),
      ("lowrank_int8", "float"),
  )
  out = []
  for small, big in pairs:
    for metric in ("param_bytes", "device_bytes"):
      if not v[small][metric] < v[big][metric]:
        out.append((
            f"not-smaller:{small}-vs-{big}:{metric}",
            f"{small} {metric}={v[small][metric]} is not strictly "
            f"smaller than {big} {metric}={v[big][metric]}: the "
            f"compressed tree stopped being smaller"))
  return out
