"""CLI: `python -m repro_torch.analysis {audit,budgets} [...]`.

Exit status is the contract: 0 when every finding is allowlisted in the
port's baseline, 1 when any NEW finding appears (a hot-path regression).

  # one family, on the CPU
  python -m repro_torch.analysis audit --configs qwen3_4b --device cpu

  # the full grid on the card + report artifact
  python -m repro_torch.analysis audit --report audit.json

  # accept current findings as known debt (then give each a reason)
  python -m repro_torch.analysis audit --write-baseline --device cpu

  # cost/memory/compression ledgers vs the committed budgets.json
  python -m repro_torch.analysis budgets --device cpu

  # refresh the committed numbers after an intentional change (on the
  # CPU: the committed file is the CPU's, and the card's ledgers must
  # fall within its bands)
  python -m repro_torch.analysis budgets --update --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import (DEFAULT_CONFIGS, POLICIES, PROGRAMS,
                                  QUANTS, load_baseline, run_audit,
                                  write_baseline)
from repro_torch.analysis import budgets as budgets_mod
from repro_torch.analysis.report import default_baseline_path
from repro_torch.analysis.targets import iter_targets, normalize_config


def _csv(text: str) -> list:
  return [t.strip() for t in text.split(",") if t.strip()]


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
  sub = parser.add_subparsers(dest="cmd", required=True)
  audit = sub.add_parser("audit", help="run + check the serving grid")
  audit.add_argument("--configs", type=_csv,
                     default=list(DEFAULT_CONFIGS),
                     help="comma list (underscores ok): qwen3_4b,...")
  audit.add_argument("--policies", type=_csv, default=list(POLICIES))
  audit.add_argument("--quants", type=_csv, default=list(QUANTS))
  audit.add_argument("--programs", type=_csv, default=list(PROGRAMS))
  audit.add_argument("--device", default=None,
                     help="cuda (default) or cpu")
  audit.add_argument("--baseline", default=None,
                     help=f"allowlist path (default: "
                          f"{default_baseline_path()})")
  audit.add_argument("--report", default=None,
                     help="write the full JSON report here")
  audit.add_argument("--write-baseline", action="store_true",
                     help="accept all current findings as known debt")
  audit.add_argument("--no-lifecycle", action="store_true",
                     help="skip the serve-cycle checks")
  audit.add_argument("--no-sharding", action="store_true",
                     help="skip production-scale sharding coverage")
  audit.add_argument("--no-budgets", action="store_true",
                     help="skip the cost/memory/compression budget gates")

  budgets = sub.add_parser(
      "budgets", help="cost/memory/compression ledgers vs budgets.json")
  budgets.add_argument("--configs", type=_csv,
                       default=list(DEFAULT_CONFIGS))
  budgets.add_argument("--policies", type=_csv, default=list(POLICIES))
  budgets.add_argument("--quants", type=_csv, default=list(QUANTS))
  budgets.add_argument("--programs", type=_csv, default=list(PROGRAMS))
  budgets.add_argument("--device", default=None,
                       help="cuda (default) or cpu")
  budgets.add_argument("--budgets", default=None,
                       help=f"committed numbers (default: "
                            f"{budgets_mod.default_budgets_path()})")
  budgets.add_argument("--report", default=None,
                       help="write ledgers + findings JSON here")
  budgets.add_argument("--update", action="store_true",
                       help="merge measured numbers into budgets.json")
  for flag in ("--shallow", "--deep"):
    budgets.add_argument(flag, action="store_true",
                         help="no effect: every program is run and "
                              "ledgered (the reference's choice of which "
                              "programs to compile)")
  args = parser.parse_args(argv)

  if args.cmd == "budgets":
    return _budgets_main(args)

  report = run_audit(args.configs, args.policies, args.quants,
                     args.programs, device=args.device,
                     run_lifecycle=not args.no_lifecycle,
                     run_sharding=not args.no_sharding,
                     run_budgets=not args.no_budgets)
  if args.write_baseline:
    path = args.baseline or default_baseline_path()
    base = write_baseline(report, path)
    print(f"wrote {len(base['allow'])} allowlist entries to {path}")
    return 0
  report.apply_baseline(load_baseline(args.baseline))
  if args.report:
    report.save(args.report)
  print(report.summary())
  for w in report.meta.get("budget_ratchet_stale", ()):
    print(f"  RATCHET {w['coord']} {w['metric']}: "
          f"{w['committed']} -> {w['current']} ({w['rel']:+.1%})")
  return 0 if report.ok else 1


def _budgets_main(args) -> int:
  committed = budgets_mod.load_budgets(args.budgets)
  audit = budgets_mod.BudgetAudit(committed)
  configs = [normalize_config(n) for n in args.configs]
  for target in iter_targets(configs, args.policies, args.quants,
                             args.programs, device=args.device,
                             ledgers=True):
    audit.add_target(target)
  for name in configs:
    audit.add_compression(name)

  if args.update:
    merged = budgets_mod.merge_budgets(committed, audit.fresh())
    budgets_mod.write_budgets(merged, args.budgets)
    path = args.budgets or budgets_mod.default_budgets_path()
    print(f"budgets: wrote {len(audit.programs)} program ledgers and "
          f"{len(audit.compression)} compression ledgers to {path}")
    return 0

  result = dict(audit.fresh(),
                findings=[f.to_dict() for f in audit.findings],
                ratchet_stale=audit.warnings,
                ok=not audit.findings)
  if args.report:
    with open(args.report, "w") as f:
      json.dump(result, f, indent=1, sort_keys=True)
      f.write("\n")
  print(f"budgets: {len(audit.programs)} programs, "
        f"{len(audit.compression)} compression ledgers, "
        f"{len(audit.findings)} findings, "
        f"{len(audit.warnings)} ratchet-stale")
  for f in audit.findings:
    print(f"  RED     {f.ident}\n          {f.detail}")
  for w in audit.warnings:
    print(f"  RATCHET {w['coord']} {w['metric']}: "
          f"{w['committed']} -> {w['current']} ({w['rel']:+.1%})")
  return 0 if not audit.findings else 1


if __name__ == "__main__":
  sys.exit(main())
