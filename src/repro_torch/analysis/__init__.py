"""repro_torch.analysis: the static auditor of the serving hot path.

Counterpart of `repro.analysis`. `run_audit` runs the serving programs
of every requested (config x policy x quant x program) coordinate once,
at smoke scale, under the op walk (`op_walk.OpWalk`), and checks the
invariant registry (`report.CHECKS`):

  dispatch_coverage   every weight product routed through kernels.dispatch
                      (and, on the card, every kernel scope launched its
                      kernel)
  quant_integrity     no int8 weight turned into a float in a PTQ'd program
  retrace_stability   the engine's decode state keeps its shapes, dtypes
                      and storages across a serve cycle; steps launch
                      alike
  prefix_splice_stability  cached-splice greedy output == cold
  spec_window_stability  speculative greedy == vanilla across a rank walk
  speech_fleet_stability  fleet labels == serial labels
  transfer_lint       no host round trip in a step; the decode state
                      written in place; no sync on the card
  sharding_coverage   every production param leaf has a sharding rule
  cost_budget, memory_budget, compression_ledger  each program's cost
                      ledger (`dist.hlo_cost`) and memory ledger
                      (`liveness`), and each config's compression ledger,
                      against the port's committed `budgets.json`
                      (`budgets`)

Findings diff against the port's committed allowlist (`baseline.json`,
each entry with a reason); any ident not in it is a regression.
CLI: `python -m repro_torch.analysis {audit,budgets} [--device cpu]`.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch import configs
from repro_torch.analysis import budgets as budgets_mod
from repro_torch.analysis import checks, lifecycle
from repro_torch.analysis.report import (AuditReport, CHECKS, Finding,
                                         default_baseline_path,
                                         load_baseline, stable_key,
                                         write_baseline)
from repro_torch.analysis.targets import (DEFAULT_CONFIGS, POLICIES,
                                          PROGRAMS, QUANTS, iter_targets,
                                          normalize_config)
from repro_torch.configs import specs
from repro_torch.quant.ptq import quantize_params

__all__ = [
    "AuditReport", "CHECKS", "Finding", "run_audit", "iter_targets",
    "load_baseline", "write_baseline", "default_baseline_path",
    "stable_key", "DEFAULT_CONFIGS", "POLICIES", "QUANTS", "PROGRAMS",
]


def _sharding_findings(config_names, report: AuditReport) -> None:
  """sharding_coverage runs at PRODUCTION scale (meta tensors): rule
  gaps hide at smoke dims, where nothing is divisible anyway."""
  for name in config_names:
    cfg = configs.get_config(name)
    params = specs.param_specs(cfg)
    report.extend(checks.check_sharding_coverage(name, params, "float"))
    qparams = quantize_params(params)
    quants = ["float"]
    if any(t.dtype == torch.int8 for t in qparams.buffers()) or any(
        t.dtype == torch.int8 for t in qparams.parameters()):
      report.extend(checks.check_sharding_coverage(name, qparams, "int8"))
      quants.append("int8")
    for q in quants:
      report.targets.append(dict(
          config=name, policy="-", quant=q, program="params",
          n_param_leaves=len(list(params.parameters())) +
          len(list(params.buffers()))))


def run_audit(config_names: Iterable[str] = DEFAULT_CONFIGS,
              policies: Iterable[str] = POLICIES,
              quants: Iterable[str] = QUANTS,
              programs: Iterable[str] = PROGRAMS,
              *, device=None, run_lifecycle: bool = True,
              run_sharding: bool = True,
              run_budgets: bool = True,
              budgets_path=None) -> AuditReport:
  """Run + check the requested grid on `device` (default: the GPU);
  baseline NOT applied (the caller's job, so tests can assert on raw
  findings). `run_budgets` diffs every program's ledgers and every
  config's compression ledger against `budgets_path` (default: the
  committed `budgets.json`)."""
  config_names = [normalize_config(n) for n in config_names]
  report = AuditReport(meta=dict(
      configs=list(config_names), policies=list(policies),
      quants=list(quants), programs=list(programs),
      torch_version=torch.__version__, checks=list(CHECKS)))
  budget_audit = None
  if run_budgets:
    budget_audit = budgets_mod.BudgetAudit(
        budgets_mod.load_budgets(budgets_path))
  for target in iter_targets(config_names, policies, quants, programs,
                             device=device, ledgers=run_budgets):
    findings, info = checks.run_target_checks(target)
    if budget_audit is not None:
      info["budget"] = budget_audit.add_target(target)
    report.extend(findings)
    report.targets.append(info)
  report.meta["device"] = report.targets[0]["device"] if report.targets \
      else str(device)
  if run_lifecycle:
    for check in (lifecycle.check_retrace_stability,
                  lifecycle.check_prefix_splice_stability,
                  lifecycle.check_spec_window_stability,
                  lifecycle.check_speech_fleet_stability):
      found, infos = check(config_names, policies, device=device)
      report.extend(found)
      report.targets.extend(infos)
  if run_sharding:
    _sharding_findings(config_names, report)
  if budget_audit is not None:
    for name in config_names:
      budget_audit.add_compression(name)
    report.extend(budget_audit.findings)
    report.meta["budgets"] = budget_audit.fresh()
    report.meta["budget_ratchet_stale"] = budget_audit.warnings
  return report
