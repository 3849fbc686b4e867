"""``python -m pcg_mpi_solver_tpu_torch.analysis`` — the contract-lint CLI.

Exit codes: 0 = clean (baselined findings allowed), 1 = findings,
2 = a rule or the engine crashed (a trip rule without a card and without
``--device cpu`` among them).  ``python -m pcg_mpi_solver_tpu_torch.cli
lint`` is the same runner.
"""

from __future__ import annotations

import argparse
import json
import sys


def add_lint_args(ap) -> None:
    """The ONE definition of the lint's options, shared by this module's
    parser and the CLI's ``lint`` subcommand."""
    ap.add_argument("--fast", action="store_true",
                    help="pre-window gate: source/artifact/config rules "
                         "plus the trip proofs on the reduced program "
                         "matrix (skips donation, overlap and fingerprint "
                         "sweeps)")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the machine-readable report here "
                         "('-' = stdout)")
    ap.add_argument("--baseline", metavar="FILE", default=None,
                    help="suppression file (default: the checked-in "
                         "analysis/baseline.json, which ships EMPTY); "
                         "entries need a documented reason")
    ap.add_argument("--rules", default=None, metavar="ID[,ID...]",
                    help="run only these rule ids")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the trip rules record (default: the card; "
                         "without one they fail unless 'cpu' is given)")


def build_parser(prog: str = "pcg_mpi_solver_tpu_torch.analysis"):
    ap = argparse.ArgumentParser(
        prog=prog,
        description="prove the port's performance/resilience contracts "
                    "(collective budgets a trip, host reads, dtype "
                    "discipline, carry handoff, fingerprint and key "
                    "completeness, source/artifact lints) on recorded "
                    "trips of real solves")
    add_lint_args(ap)
    return ap


def run(args) -> int:
    from pcg_mpi_solver_tpu_torch.analysis import engine

    if args.list_rules:
        for r in engine.list_rules():
            tag = "fast" if r.fast else "full"
            print(f"{r.id:26s} [{r.kind}/{tag}] {r.doc}")
        return 0
    baseline = args.baseline if args.baseline is not None \
        else engine.DEFAULT_BASELINE
    rule_ids = ([s for s in args.rules.split(",") if s]
                if args.rules else None)
    try:
        report = engine.run_lint(fast=args.fast, rule_ids=rule_ids,
                                 baseline_path=baseline,
                                 device=getattr(args, "device", None))
    except ValueError as e:           # unknown rule id / bad baseline
        print(f"pcg-tpu lint: {e}", file=sys.stderr)
        return 2
    if args.json:
        blob = json.dumps(report.to_dict(), indent=2, sort_keys=True)
        if args.json == "-":
            print(blob)
        else:
            try:
                with open(args.json, "w", encoding="utf-8") as f:
                    f.write(blob + "\n")
            except OSError as e:
                # an unwritable report path is an engine failure (exit 2),
                # not a lint verdict
                print(report.render())
                print(f"pcg-tpu lint: cannot write --json {args.json}: "
                      f"{e}", file=sys.stderr)
                return 2
    if args.json != "-":
        print(report.render())
    return report.exit_code


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
