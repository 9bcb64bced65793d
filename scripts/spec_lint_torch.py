#!/usr/bin/env python
"""Lint registered dataflow specs with the static verifier (DESIGN.md §12).

The PyTorch port's counterpart of ``scripts/spec_lint.py``: the same
arguments, exit codes and printed output, over the port's copy of the
dataflow stack (host numpy, no kernel).

Runs the full rule inventory (``repro_torch.dataflows.verify``) over one or
more suite scenarios and reports structured diagnostics; exits non-zero
when any error-tier rule fires, so CI can gate on it.

    PYTHONPATH=src python scripts/spec_lint_torch.py --all
    PYTHONPATH=src python scripts/spec_lint_torch.py matmul ssd-scan -v
    PYTHONPATH=src python scripts/spec_lint_torch.py --all --json report.json
    PYTHONPATH=src python scripts/spec_lint_torch.py --all --cross-check
    PYTHONPATH=src python scripts/spec_lint_torch.py --rules

``--cross-check`` additionally runs each scenario in the simulator with
event telemetry on and compares the analyzer's predicted TMU retirement
counts against measured ``RETIRE`` events per policy (the ground-truth
contract: a predicted-clean spec must retire exactly as the annotations
say, under every policy).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import sys

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.dataflows.suite import registry_keys
from repro_torch.dataflows.suite import suite_case
from repro_torch.dataflows.verify import cross_check_case
from repro_torch.dataflows.verify import rules_inventory
from repro_torch.dataflows.verify import verify_spec

EXIT_OK = 0
EXIT_ERRORS = 1
EXIT_USAGE = 2


def _print_rules() -> None:
    for r in rules_inventory():
        print(f"{r['code']} [{r['severity']:5s}] "
              f"[alloc:{r['allocator']:6s}] {r['title']}")
        print(f"    assumes:  {r['assumption']}")
        print(f"    consumer: {r['consumer']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenarios", nargs="*",
                    help="suite scenario keys (see --all for the sweep)")
    ap.add_argument("--all", action="store_true",
                    help="lint every registered scenario")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale shapes instead of the reduced grid")
    ap.add_argument("--json", type=Path, default=None,
                    help="write the full diagnostic report to this file")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule inventory and exit")
    ap.add_argument("--cross-check", action="store_true",
                    help="also compare predicted retirements against "
                         "simulator-measured TMU RETIRE events")
    ap.add_argument("--policies", default="lru,dbp,at+dbp",
                    help="policy set for --cross-check "
                         "(comma-separated, default %(default)s)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every diagnostic, not just summaries")
    args = ap.parse_args(argv)

    if args.rules:
        _print_rules()
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps(
                {"rules": rules_inventory()}, indent=2, sort_keys=True))
            print(f"# rule inventory written to {args.json}")
        return EXIT_OK

    keys = registry_keys() if args.all else args.scenarios
    if not keys:
        print("error: no scenarios given (use --all or name scenarios)",
              file=sys.stderr)
        return EXIT_USAGE
    known = set(registry_keys())
    bad = [k for k in keys if k not in known]
    if bad:
        print(f"error: unknown scenario(s) {bad}; have "
              f"{sorted(known)}", file=sys.stderr)
        return EXIT_USAGE

    policies = tuple(p for p in args.policies.split(",") if p)
    report = {"scenarios": {}, "n_errors": 0, "cross_check": {}}
    failed = False
    for key in keys:
        case = suite_case(key, full=args.full, gate=False)
        res = verify_spec(case.spec, sim_cfg=case.cfg)
        report["scenarios"][key] = res.to_dict()
        report["n_errors"] += len(res.errors)
        print(res.summary())
        shown = res.diagnostics if args.verbose else res.errors
        for d in shown:
            print(f"  {d.format()}")
        if res.has_errors:
            failed = True
        if args.cross_check:
            cc = cross_check_case(case, policies=policies)
            report["cross_check"][key] = cc
            if cc["agree"]:
                print(f"  cross-check OK: {cc['predicted_retirements']} "
                      f"retirements agree across {list(policies)}")
            else:
                failed = True
                print(f"  cross-check FAILED: {json.dumps(cc['policies'])}",
                      file=sys.stderr)

    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=2, sort_keys=True))
        print(f"# report written to {args.json}")

    if failed:
        print(f"spec lint: FAILED ({report['n_errors']} error-tier "
              f"diagnostic(s))", file=sys.stderr)
        return EXIT_ERRORS
    print(f"spec lint OK on {list(keys)}")
    return EXIT_OK


if __name__ == "__main__":
    raise SystemExit(main())
