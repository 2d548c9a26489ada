"""Structured audit findings, the report envelope, and baseline diffing.

Counterpart of `repro/analysis/report.py`, with the same `Finding`,
`ident` format (`config|policy|quant|program|check|key`), `CHECKS`
registry and baseline workflow, so the two packages' findings compare
by ident. The reference's policy names stay in idents: "jnp" is the
port's `KernelPolicy(mode="jnp_only")`, "pallas" its
`KernelPolicy(mode="decode")` (the CUDA kernels).

A Finding is one invariant violation at one audited coordinate
(config, policy, quant, program, check) plus a stable `key` naming the
violation site. The committed baseline (`analysis/baseline.json`, the
port's own) allowlists findings by their full `ident`: a known debt
stays visible in every report but does not fail the audit, while any
ident NOT in the baseline is a regression and the audit exits
non-zero. Keys never embed run-varying material: dispatch call ids
(`c<N>`) are masked to `c*` by `stable_key` before a key is formed.

Baseline workflow:
  python -m repro_torch.analysis audit --write-baseline  # accept debts
  # review the diff of analysis/baseline.json, give each entry a reason
  python -m repro_torch.analysis audit                   # green on it
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterable, Optional

#: the check registry — every Finding.check is one of these
CHECKS = (
    "dispatch_coverage",   # every product of a parameter under a dispatch
                           # scope (the op walk's DotSites)
    "quant_integrity",     # no int8 weight turned into a float type in a
                           # PTQ'd program (the op walk's ConvertSites)
    "retrace_stability",   # eager: the engine's decode state keeps its
                           # shapes, dtypes and storages across a serve
                           # cycle, and each step's launches per kernel
                           # stay constant (no jit cache to count)
    "prefix_splice_stability",  # cached-splice serving: token parity with
                                # cold serving, and the cache hit
    "spec_window_stability",    # speculative greedy == vanilla greedy
                                # across a draft-rank walk
    "speech_fleet_stability",   # continuous-batching speech fleet: fleet
                                # == serial per-utterance labels
    "transfer_lint",       # no host round trip in a step; the decode state
                           # written in place (the torch form of
                           # donation); no sync on the card
    "sharding_coverage",   # every param leaf resolves to a sharding rule
    "cost_budget",         # the cost ledger (dist/hlo_cost.py over the
                           # op walk) within its committed band
    "memory_budget",       # the liveness peak within its committed band
    "compression_ledger",  # static param count/bytes exactly as committed
)

_CALL_ID_RE = re.compile(r":c\d+")


def stable_key(text: str) -> str:
  """Mask run-varying dispatch call ids so keys survive re-running."""
  return _CALL_ID_RE.sub(":c*", text)


@dataclasses.dataclass(frozen=True)
class Finding:
  """One invariant violation at one audited coordinate."""
  check: str
  config: str
  key: str                  # stable violation-site id (see stable_key)
  detail: str = ""          # human explanation; NOT part of the ident
  policy: str = "-"         # "jnp" | "pallas" | "-" (policy-independent):
                            # the reference's names for "jnp_only" and
                            # "decode"
  quant: str = "-"          # "float" | "int8" | "-"
  program: str = "-"        # "decode" | "window" | "prefill" | "train" |
                            # "lifecycle" | "params"

  def __post_init__(self):
    if self.check not in CHECKS:
      raise ValueError(f"unknown check {self.check!r} (not in CHECKS)")

  @property
  def ident(self) -> str:
    return "|".join((self.config, self.policy, self.quant, self.program,
                     self.check, self.key))

  def to_dict(self) -> dict:
    d = dataclasses.asdict(self)
    d["ident"] = self.ident
    return d


@dataclasses.dataclass
class AuditReport:
  """Everything one audit run produced: per-target metadata, findings,
  and (after `apply_baseline`) the regression/allowed/stale partition."""
  findings: list = dataclasses.field(default_factory=list)
  targets: list = dataclasses.field(default_factory=list)
  meta: dict = dataclasses.field(default_factory=dict)
  new: list = dataclasses.field(default_factory=list)      # Finding
  allowed: list = dataclasses.field(default_factory=list)  # Finding
  stale: list = dataclasses.field(default_factory=list)    # ident str

  def extend(self, findings: Iterable[Finding]) -> None:
    self.findings.extend(findings)

  def apply_baseline(self, baseline: dict) -> None:
    """Partition findings into regressions vs. allowlisted debts, and
    report baseline entries the audit no longer reproduces (stale).
    Staleness only applies within the configs this run audited: a
    scoped run (e.g. a one-config audit) says nothing about the
    rest of the allowlist."""
    allow = {e["ident"] for e in baseline.get("allow", ())}
    seen = {f.ident for f in self.findings}
    self.new = [f for f in self.findings if f.ident not in allow]
    self.allowed = [f for f in self.findings if f.ident in allow]
    audited = {
        "|".join((t["config"], t["policy"], t["quant"], t["program"]))
        for t in self.targets if "program" in t}
    self.stale = sorted(
        i for i in allow - seen
        if not audited or "|".join(i.split("|")[:4]) in audited)

  @property
  def ok(self) -> bool:
    return not self.new

  def to_dict(self) -> dict:
    return {
        "meta": self.meta,
        "targets": self.targets,
        "findings": [f.to_dict() for f in self.findings],
        "new": [f.ident for f in self.new],
        "allowed": [f.ident for f in self.allowed],
        "stale_baseline_entries": list(self.stale),
        "ok": self.ok,
    }

  def save(self, path: str) -> None:
    with open(path, "w") as f:
      json.dump(self.to_dict(), f, indent=2, sort_keys=True)
      f.write("\n")

  def summary(self) -> str:
    lines = [
        f"audit: {len(self.targets)} targets, {len(self.findings)} "
        f"findings ({len(self.allowed)} allowlisted, {len(self.new)} new)"
    ]
    for f in self.new:
      lines.append(f"  NEW     {f.ident}\n          {f.detail}")
    for f in self.allowed:
      lines.append(f"  allowed {f.ident}")
    for ident in self.stale:
      lines.append(f"  stale   {ident}  (baseline entry no longer seen)")
    return "\n".join(lines)


def default_baseline_path() -> str:
  return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: Optional[str] = None) -> dict:
  """Load the allowlist; a missing file is an empty baseline (everything
  found is then a regression — the bootstrap state)."""
  path = default_baseline_path() if path is None else path
  if not os.path.exists(path):
    return {"allow": []}
  with open(path) as f:
    base = json.load(f)
  if not isinstance(base.get("allow"), list):
    raise ValueError(f"baseline {path}: expected an 'allow' list")
  for entry in base["allow"]:
    if "ident" not in entry:
      raise ValueError(f"baseline {path}: allow entry missing 'ident'")
  return base


def write_baseline(report: AuditReport, path: Optional[str] = None) -> dict:
  """Accept every current finding as a known debt. Reasons start as the
  finding detail — edit them into real justifications before committing."""
  path = default_baseline_path() if path is None else path
  # one entry per ident: a site can recur within a program (each of
  # the prefill's steps hits the same unrouted product)
  by_ident = {}
  for f in sorted(report.findings, key=lambda f: f.ident):
    by_ident.setdefault(f.ident, f.detail)
  base = {
      "note": ("Known-debt allowlist for `python -m repro_torch.analysis"
               " audit`."
               " Each entry names one finding ident that is understood and"
               " accepted; remove entries as debts are fixed (stale ones"
               " are reported). New findings NOT listed here fail the"
               " audit."),
      "allow": [{"ident": k, "reason": v} for k, v in by_ident.items()],
  }
  with open(path, "w") as f:
    json.dump(base, f, indent=2, sort_keys=True)
    f.write("\n")
  return base
