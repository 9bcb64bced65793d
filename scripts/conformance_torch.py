#!/usr/bin/env python
"""Differential conformance gate: step vs compiled vs streaming engines.

The PyTorch port's counterpart of ``scripts/conformance.py``: the same
arguments, exit codes and printed output, over the port's copy of the
simulator stack (``repro_torch.conformance``, host numpy, no kernel).  It
runs the scenario×policy conformance matrix and verifies, per cell: (1) step
and compiled engines agree on the canonical event stream, (2) the
streaming/chunked compiled run concatenates bit-identically to the monolithic
one, (3) the canonical digest matches the golden frozen under
``tests/golden/conformance_digests.json``.

The goldens are read, never written: ``--update-golden`` is a usage error
(exit 2), since ``scripts/conformance.py`` alone freezes them.

Any failure prints the first-divergence event with round + surrounding
context and exits 1; ``--report`` additionally writes the full failure
report as JSON.

    PYTHONPATH=src python scripts/conformance_torch.py              # full matrix
    PYTHONPATH=src python scripts/conformance_torch.py --smoke      # CI subset
    PYTHONPATH=src python scripts/conformance_torch.py \\
        --scenario matmul --policy lru dbp
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import sys

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.conformance import golden_path
from repro_torch.conformance import load_golden
from repro_torch.conformance import matrix_entries
from repro_torch.conformance import run_matrix

GOLDEN_REFUSED = ("--update-golden: the goldens are frozen by scripts/conformance.py "
                  "alone; this script only reads them")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run only the CI smoke scenario subset")
    ap.add_argument("--scenario", nargs="*", default=None,
                    help="restrict the scenario axis")
    ap.add_argument("--policy", nargs="*", default=None,
                    help="restrict the policy axis")
    ap.add_argument("--update-golden", action="store_true",
                    help="refused: scripts/conformance.py alone freezes "
                         "tests/golden/conformance_digests.json")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the JSON failure/summary report here")
    ap.add_argument("--window", type=int, default=3,
                    help="context events around a divergence (default 3)")
    args = ap.parse_args(argv)
    if args.update_golden:
        ap.error(GOLDEN_REFUSED)

    golden = load_golden()
    if golden is None:
        print(f"warning: no golden digests at {golden_path()} (or "
              f"stale schema) — engine/streaming checks only; freeze them "
              f"with scripts/conformance.py --update-golden", file=sys.stderr)

    entries = list(matrix_entries(smoke=args.smoke,
                                  scenarios=args.scenario,
                                  policies=args.policy))

    def progress(cell):
        status = "ok" if cell.ok else f"FAIL[{cell.failure}]"
        print(f"  {cell.scenario:20s} {cell.policy:8s} "
              f"{cell.n_events:9d} events  {cell.seconds:6.1f}s  {status}",
              flush=True)

    print(f"conformance matrix: {len(entries)} cells", flush=True)
    results = run_matrix(entries, golden=golden, window=args.window)
    for cell in results:
        progress(cell)

    failures = [r for r in results if not r.ok]

    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps({
            "cells": [r.to_dict() for r in results],
            "failures": len(failures),
        }, indent=2) + "\n")
        print(f"report written to {args.report}")

    if failures:
        print(f"\n{len(failures)} conformance failure(s):")
        for r in failures:
            print(f"\n== {r.scenario}/{r.policy}: {r.failure}")
            if r.divergence is not None:
                print(r.divergence.render())
            elif r.failure == "golden":
                print(f"  digest   {r.digest}\n  golden   {r.golden}")
            elif r.failure == "missing-golden":
                print(f"  digest {r.digest} has no frozen golden — run "
                      f"--update-golden")
        return 1
    print(f"\nall {len(results)} cells conform")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
