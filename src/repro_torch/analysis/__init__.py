"""repro_torch.analysis: the static auditor of the serving hot path.

Counterpart of `repro.analysis` (its audit half; the cost half —
`budgets`, `dist/hlo_cost.py`, `launch/dryrun.py` — is ROADMAP A7b and
not ported yet). `run_audit` runs the serving programs of every
requested (config x policy x quant x program) coordinate once, at smoke
scale, under the op walk (`op_walk.OpWalk`), and checks the invariant
registry (`report.CHECKS`):

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
  cost_budget, memory_budget, compression_ledger  A7b's budgets.json:
                      refused with `run_budgets=True`; the compression
                      ledger's strictness assertions run now

Findings diff against the port's committed allowlist (`baseline.json`,
each entry with a reason); any ident not in it is a regression.
CLI: `python -m repro_torch.analysis audit [--device cpu]`.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch import configs
from repro_torch.analysis import checks, compression, lifecycle
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
    "A7B_REFUSAL",
]

A7B_REFUSAL = (
    "the cost and memory budgets (analysis/budgets.py, dist/hlo_cost.py, "
    "budgets.json) are ROADMAP A7b, not ported yet: the audit command "
    "never runs them, and run_audit refuses run_budgets=True until A7b "
    "lands")


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


def _compression_findings(config_names, report: AuditReport) -> None:
  """The compression ledger's strictness assertions (each compressed
  variant strictly smaller); its committed numbers wait for A7b."""
  ledgers = {}
  for name in config_names:
    ledger = ledgers[name] = compression.compression_ledger(name)
    for key, detail in compression.strictness_violations(ledger):
      report.extend([Finding(check="compression_ledger", config=name,
                             program="params", key=key, detail=detail)])
  report.meta["compression"] = ledgers


def run_audit(config_names: Iterable[str] = DEFAULT_CONFIGS,
              policies: Iterable[str] = POLICIES,
              quants: Iterable[str] = QUANTS,
              programs: Iterable[str] = PROGRAMS,
              *, device=None, run_lifecycle: bool = True,
              run_sharding: bool = True,
              run_budgets: bool = False) -> AuditReport:
  """Run + check the requested grid on `device` (default: the GPU);
  baseline NOT applied (the caller's job, so tests can assert on raw
  findings). `run_budgets=True` raises: the budgets are A7b's."""
  if run_budgets:
    raise NotImplementedError(A7B_REFUSAL)
  config_names = [normalize_config(n) for n in config_names]
  report = AuditReport(meta=dict(
      configs=list(config_names), policies=list(policies),
      quants=list(quants), programs=list(programs),
      torch_version=torch.__version__, checks=list(CHECKS)))
  for target in iter_targets(config_names, policies, quants, programs,
                             device=device):
    findings, info = checks.run_target_checks(target)
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
  _compression_findings(config_names, report)
  return report
