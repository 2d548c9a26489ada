"""Static cost & memory budgets: per-program ledgers diffed against
committed numbers (`analysis/budgets.json`, the port's own) with
tolerance bands.

Counterpart of `repro/analysis/budgets.py`. For every audited program
the auditor builds two ledgers from the one walked run
(`targets.iter_targets(ledgers=True)`):

* a **cost ledger** from the op walk (`dist.hlo_cost`): FLOPs, dot
  FLOPs, HBM bytes, collective payload/wire bytes, arithmetic
  intensity, and the roofline-dominant term under the card's peaks;
* a **memory ledger** from the op walk (`analysis.liveness`): static
  peak live-storage bytes, with the state written in place credited.

The reference has a cost ledger only where it compiled the program
(decode, and the rest under `--deep`); the port runs every program, so
every coordinate has both ledgers.

Each gated metric diffs against the committed number with a per-metric
relative tolerance band:

  regression beyond the band   -> a `cost_budget` / `memory_budget`
                                  Finding (red; the audit fails)
  improvement beyond the band  -> a "ratchet stale" WARNING: the code
                                  got cheaper and the committed number
                                  no longer pins it — run
                                  `python -m repro_torch.analysis budgets
                                  --update` and commit the new floor
  missing committed entry      -> an `unbudgeted` Finding (the grid
                                  grew; --update to admit it)

The **compression ledger** (`analysis.compression`) is gated exactly,
tolerance 0: parameter counts and bytes are shape arithmetic, any drift
is a real model-size change. Its strictness assertions ("the compressed
tree is strictly smaller, whole-tree and per-device") are
`compression_ledger` findings independent of the committed numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Optional

import torch

from repro_torch.analysis import compression
from repro_torch.analysis.report import Finding
from repro_torch.analysis.targets import RunTarget
from repro_torch.dist import hlo_cost

#: relative tolerance band per gated metric; direction: higher is worse
TOLERANCES = {
    # cost_budget (the op walk's cost ledger)
    "flops": 0.05,
    "dot_flops": 0.05,
    "hbm_bytes": 0.10,
    "collective_bytes": 0.10,
    "collective_wire_bytes": 0.10,
    # memory_budget (liveness)
    "input_bytes": 0.0,
    "peak_live_bytes": 0.05,
}

#: which check each gated metric reports under
CHECK_OF = {
    "flops": "cost_budget",
    "dot_flops": "cost_budget",
    "hbm_bytes": "cost_budget",
    "collective_bytes": "cost_budget",
    "collective_wire_bytes": "cost_budget",
    "input_bytes": "memory_budget",
    "peak_live_bytes": "memory_budget",
}

#: exact-gated compression metrics per variant
COMPRESSION_METRICS = ("param_count", "param_bytes", "device_bytes")

_UPDATE = "`python -m repro_torch.analysis budgets --update --device cpu`"


def default_budgets_path() -> str:
  return os.path.join(os.path.dirname(__file__), "budgets.json")


def load_budgets(path: Optional[str] = None) -> dict:
  """Committed budgets; a missing file is empty (every coordinate is
  then `unbudgeted` — the bootstrap state before the first --update)."""
  path = default_budgets_path() if path is None else path
  if not os.path.exists(path):
    return {"meta": {}, "programs": {}, "compression": {}}
  with open(path) as f:
    data = json.load(f)
  for section in ("programs", "compression"):
    if not isinstance(data.get(section), dict):
      raise ValueError(f"budgets {path}: expected a {section!r} dict")
  return data


def write_budgets(data: dict, path: Optional[str] = None) -> None:
  path = default_budgets_path() if path is None else path
  with open(path, "w") as f:
    json.dump(data, f, indent=1, sort_keys=True)
    f.write("\n")


def merge_budgets(committed: dict, fresh: dict) -> dict:
  """--update semantics: refresh what this run measured, keep the rest
  (per-coordinate entries merge field-wise)."""
  out = {
      "meta": dict(committed.get("meta", {})),
      "programs": {k: dict(v)
                   for k, v in committed.get("programs", {}).items()},
      "compression": {k: v
                      for k, v in committed.get("compression", {}).items()},
  }
  out["meta"].update(fresh.get("meta", {}))
  for k, v in fresh.get("programs", {}).items():
    out["programs"][k] = {**out["programs"].get(k, {}), **v}
  out["compression"].update(fresh.get("compression", {}))
  return out


def coord_key(coord: dict) -> str:
  return "|".join((coord["config"], coord["policy"], coord["quant"],
                   coord["program"]))


# ---------------------------------------------------------------------------
# Ledger construction.
# ---------------------------------------------------------------------------

def program_ledger(target: RunTarget) -> dict:
  """Cost + memory ledger for one walked program (a target of
  `iter_targets(ledgers=True)`)."""
  rep, live = target.cost, target.live
  if rep is None or live is None:
    raise ValueError(f"{coord_key(target.coord)}: walked without its "
                     "trace (iter_targets(ledgers=True))")
  roof = hlo_cost.roofline_from_report(rep)
  return dict(
      input_bytes=live.input_bytes,
      donated_bytes=live.donated_bytes,
      credited_bytes=live.credited_bytes,
      output_bytes=live.output_bytes,
      transient_bytes=live.transient_bytes,
      peak_live_bytes=live.peak_bytes,
      flops=rep.flops,
      dot_flops=rep.dot_flops,
      hbm_bytes=rep.hbm_bytes,
      collective_bytes=rep.collective_bytes,
      collective_wire_bytes=rep.collective_wire_bytes,
      n_collectives=rep.n_collectives,
      arithmetic_intensity=round(rep.flops / rep.hbm_bytes, 4)
      if rep.hbm_bytes else 0.0,
      dominant=roof.dominant,
      roofline_fraction=round(roof.roofline_fraction, 4),
  )


# ---------------------------------------------------------------------------
# Diffing.
# ---------------------------------------------------------------------------

def _bf(coord: dict, check: str, key: str, detail: str) -> Finding:
  return Finding(check=check, config=coord["config"], key=key,
                 detail=detail, policy=coord["policy"],
                 quant=coord["quant"], program=coord["program"])


def diff_program(coord: dict, ledger: dict, committed_programs: dict
                 ) -> tuple:
  """(findings, ratchet_warnings) for one program vs its committed entry."""
  key = coord_key(coord)
  committed = committed_programs.get(key)
  findings: list = []
  warnings: list = []
  if committed is None:
    checks_hit = sorted({CHECK_OF[m] for m in TOLERANCES if m in ledger})
    for check in checks_hit:
      findings.append(_bf(
          coord, check, "unbudgeted",
          f"no committed budget entry for {key!r}: run {_UPDATE} and "
          f"commit budgets.json"))
    return findings, warnings

  for metric, tol in TOLERANCES.items():
    if metric not in ledger or metric not in committed:
      continue
    old = float(committed[metric])
    new = float(ledger[metric])
    if old == new:
      continue
    if old == 0.0:
      rel = float("inf") if new > 0 else float("-inf")
    else:
      rel = (new - old) / old
    if rel > tol:
      findings.append(_bf(
          coord, CHECK_OF[metric], f"over-budget:{metric}",
          f"{metric}: committed {committed[metric]}, now {ledger[metric]} "
          f"({rel:+.1%}, band ±{tol:.0%}) — a static "
          f"{'cost' if CHECK_OF[metric] == 'cost_budget' else 'memory'} "
          f"regression; if intentional, refresh with {_UPDATE}"))
    elif rel < -tol:
      warnings.append(dict(
          coord=key, metric=metric, committed=committed[metric],
          current=ledger[metric], rel=round(rel, 4),
          note=f"ratchet stale: improvement beyond the band — run "
               f"{_UPDATE} to pin it"))

  if "dominant" in ledger and "dominant" in committed \
      and ledger["dominant"] != committed["dominant"]:
    findings.append(_bf(
        coord, "cost_budget",
        f"dominant-flip:{committed['dominant']}->{ledger['dominant']}",
        f"roofline-dominant term flipped from {committed['dominant']!r} "
        f"to {ledger['dominant']!r}: the program's performance regime "
        f"changed — inspect, then --update if intentional"))
  return findings, warnings


def diff_compression(config: str, ledger: dict, committed_compression: dict
                     ) -> list:
  """Findings for one config's compression ledger: strictness violations
  plus exact drift against the committed numbers."""
  coord = dict(config=config, policy="-", quant="-", program="params")
  findings = [
      _bf(coord, "compression_ledger", key, detail)
      for key, detail in compression.strictness_violations(ledger)
  ]
  committed = committed_compression.get(config)
  if committed is None:
    findings.append(_bf(
        coord, "compression_ledger", "unbudgeted",
        f"no committed compression ledger for {config!r}: run "
        f"{_UPDATE}"))
    return findings
  for variant, stats in ledger["variants"].items():
    old = committed.get("variants", {}).get(variant, {})
    for metric in COMPRESSION_METRICS:
      if metric in old and old[metric] != stats[metric]:
        findings.append(_bf(
            coord, "compression_ledger", f"drift:{variant}:{metric}",
            f"{variant} {metric}: committed {old[metric]}, now "
            f"{stats[metric]} — the model's static size changed; if "
            f"intentional, --update and commit the new ledger"))
  return findings


# ---------------------------------------------------------------------------
# The budget audit driver (shared by run_audit and the CLI).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BudgetAudit:
  """Accumulates fresh ledgers and their diff against committed budgets."""
  committed: dict
  programs: dict = dataclasses.field(default_factory=dict)
  compression: dict = dataclasses.field(default_factory=dict)
  findings: list = dataclasses.field(default_factory=list)
  warnings: list = dataclasses.field(default_factory=list)

  def add_target(self, target: RunTarget) -> dict:
    ledger = program_ledger(target)
    self.programs[coord_key(target.coord)] = ledger
    f, w = diff_program(target.coord, ledger,
                        self.committed.get("programs", {}))
    self.findings.extend(f)
    self.warnings.extend(w)
    return ledger

  def add_compression(self, config: str) -> dict:
    ledger = compression.compression_ledger(config)
    self.compression[config] = ledger
    self.findings.extend(diff_compression(
        config, ledger, self.committed.get("compression", {})))
    return ledger

  def fresh(self) -> dict:
    """The measured numbers in budgets.json shape (for --update)."""
    return {
        "meta": dict(tolerances=TOLERANCES, torch_version=torch.__version__),
        "programs": self.programs,
        "compression": self.compression,
    }


def run_budget_audit(targets: Iterable[RunTarget],
                     config_names: Iterable[str],
                     committed: Optional[dict] = None) -> BudgetAudit:
  """Convenience driver: ledger + diff every target and config."""
  audit = BudgetAudit(load_budgets() if committed is None else committed)
  for t in targets:
    audit.add_target(t)
  for name in config_names:
    audit.add_compression(name)
  return audit
