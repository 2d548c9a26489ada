"""CLI: `python -m repro_torch.analysis {audit,budgets} [...]`.

Exit status is the contract: 0 when every finding is allowlisted in the
port's baseline, 1 when any NEW finding appears (a hot-path regression).

  # one family, on the CPU
  python -m repro_torch.analysis audit --configs qwen3_4b --device cpu

  # the full grid on the card + report artifact
  python -m repro_torch.analysis audit --report audit.json

  # accept current findings as known debt (then give each a reason)
  python -m repro_torch.analysis audit --write-baseline --device cpu

The `budgets` command (cost, memory and compression ledgers against a
committed budgets.json) is ROADMAP A7b: it refuses with an error.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import (A7B_REFUSAL, DEFAULT_CONFIGS, POLICIES,
                                  PROGRAMS, QUANTS, load_baseline,
                                  run_audit, write_baseline)
from repro_torch.analysis.report import default_baseline_path


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
  sub.add_parser("budgets", help="A7b: not ported yet (refuses)")
  args = parser.parse_args(argv)

  if args.cmd == "budgets":
    print(f"budgets: {A7B_REFUSAL}", file=sys.stderr)
    return 2

  report = run_audit(args.configs, args.policies, args.quants,
                     args.programs, device=args.device,
                     run_lifecycle=not args.no_lifecycle,
                     run_sharding=not args.no_sharding)
  if args.write_baseline:
    path = args.baseline or default_baseline_path()
    base = write_baseline(report, path)
    print(f"wrote {len(base['allow'])} allowlist entries to {path}")
    return 0
  report.apply_baseline(load_baseline(args.baseline))
  if args.report:
    report.save(args.report)
  print(report.summary())
  return 0 if report.ok else 1


if __name__ == "__main__":
  sys.exit(main())
