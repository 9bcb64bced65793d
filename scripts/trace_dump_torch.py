#!/usr/bin/env python
"""Render or export one run's event trace (DESIGN.md §10).

The PyTorch port's counterpart of ``scripts/trace_dump_torch.py``: the same
arguments, exit codes and printed output, over the port's copy of the
simulator (host numpy, no kernel).

Runs a suite scenario under one policy with event telemetry on and
either prints a window of decoded events or exports the raw columns as
npz for offline analysis (the training substrate for learned-predictor
work).

    PYTHONPATH=src python scripts/trace_dump_torch.py matmul --policy at+dbp
    PYTHONPATH=src python scripts/trace_dump_torch.py decode-paged \
        --round 40 --window 2            # all events of rounds 38..42
    PYTHONPATH=src python scripts/trace_dump_torch.py mt-spec-ssd \
        --npz /tmp/events.npz            # export flat columns
"""

from __future__ import annotations

import argparse
from pathlib import Path
import sys

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import EventSink
from repro_torch.core import Simulator
from repro_torch.core.events import decode_event
from repro_torch.core.policies import named_policy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenario", help="suite scenario key "
                    "(see repro_torch.dataflows.suite.registry_keys)")
    ap.add_argument("--policy", default="at+dbp")
    ap.add_argument("--engine", default="compiled",
                    choices=("compiled", "steps"))
    ap.add_argument("--head", type=int, default=40,
                    help="print the first N events (default 40)")
    ap.add_argument("--round", type=int, default=None,
                    help="print events of this round instead of --head")
    ap.add_argument("--window", type=int, default=0,
                    help="with --round: also include +/- this many rounds")
    ap.add_argument("--canonical", action="store_true",
                    help="print in canonical order instead of emission "
                         "order")
    ap.add_argument("--npz", type=Path, default=None,
                    help="export the raw event columns to this npz file")
    args = ap.parse_args(argv)

    from repro_torch.dataflows import lower_to_trace
    from repro_torch.dataflows.suite import suite_case
    try:
        case = suite_case(args.scenario)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    try:
        policy = named_policy(args.policy, gqa=case.gqa)
    except (KeyError, ValueError):
        print(f"error: unknown policy {args.policy!r}", file=sys.stderr)
        return 2
    trace = lower_to_trace(case.spec)
    sink = EventSink()
    sim = Simulator(case.cfg, policy)
    res = sim.run(trace, record_history=False, engine=args.engine,
                  events=sink)

    print(f"# {args.scenario} / {res.policy} ({args.engine}): "
          f"{len(sink)} events, digest {sink.digest()}")
    for kind, count in sink.counts_by_kind().items():
        if count:
            print(f"#   {kind:7s} {count}")

    if args.npz is not None:
        sink.to_npz(args.npz)
        print(f"# exported to {args.npz}")
        return 0

    mat = sink.canonical() if args.canonical else sink.matrix()
    if args.round is not None:
        lo, hi = args.round - args.window, args.round + args.window
        sel = (mat[:, 0] >= lo) & (mat[:, 0] <= hi)
        rows = mat[sel]
        print(f"# rounds {lo}..{hi}: {rows.shape[0]} events")
    else:
        rows = mat[: args.head]
    for row in rows:
        print(decode_event(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
