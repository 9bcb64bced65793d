"""Differential event-stream comparison with first-divergence reports.

Three checks per (scenario, policy) cell, strongest first:

1. **engine agreement** — the step engine (reference oracle) and the
   compiled engine must produce byte-identical *canonical* event
   streams (``EventSink.canonical``: total order, engine-independent);
2. **streaming concatenation** — the compiled engine run segment-by-
   segment (``chunk_lines``) must produce a *raw* stream bit-identical
   to the monolithic compiled run (rounds are atomic, the round index
   is global, so not even reordering is tolerated);
3. **golden digest** — the canonical stream's SHA-256 must match the
   digest frozen under ``tests/golden/conformance_digests.json``
   (refreshed via ``scripts/conformance.py --update-golden``).

A failed check yields a :class:`Divergence`: the first differing event
with its round, the expected and actual rows decoded to text, and a
window of surrounding events from both streams — the debugging context
a bare ``assert digest == golden`` throws away.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
import json
from pathlib import Path
from typing import Dict
from typing import Iterable
from typing import List
from typing import Optional
from typing import Tuple

import numpy as np

from ..core import EventSink
from ..core import Simulator
from ..core.events import SCHEMA_VERSION
from ..core.events import decode_event
from ..core.events import stream_digest
from ..core.policies import named_policy

#: default segment count the streaming check splits each trace into
_N_SEGMENTS = 7


# ---------------------------------------------------------------------------
# first-divergence reporting
# ---------------------------------------------------------------------------
@dataclass
class Divergence:
    """First point where two event streams disagree, with context."""

    index: int                      # row index in the canonical stream
    round: int                      # simulation round of the divergence
    expected: Optional[List[int]]   # raw row (None: stream ended early)
    actual: Optional[List[int]]
    expected_text: str
    actual_text: str
    context: List[str] = field(default_factory=list)

    def render(self) -> str:
        lines = [
            f"first divergence at event #{self.index} (round {self.round}):",
            f"  expected: {self.expected_text}",
            f"  actual:   {self.actual_text}",
            "  context (expected | actual):",
        ]
        lines.extend(f"    {c}" for c in self.context)
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "index": self.index, "round": self.round,
            "expected": self.expected, "actual": self.actual,
            "expected_text": self.expected_text,
            "actual_text": self.actual_text, "context": self.context,
        }


def first_divergence(expected: np.ndarray, actual: np.ndarray,
                     window: int = 3) -> Optional[Divergence]:
    """Locate the first differing row of two event matrices; ``None``
    when they are identical.  ``window`` rows of context on each side
    are decoded from both streams."""
    n_e, n_a = expected.shape[0], actual.shape[0]
    n = min(n_e, n_a)
    if n:
        neq = (expected[:n] != actual[:n]).any(axis=1)
        idx = int(np.argmax(neq)) if neq.any() else n
    else:
        idx = 0
    if idx == n and n_e == n_a:
        return None

    def row(mat, i):
        if i >= mat.shape[0]:
            return None, "<stream ended>"
        r = [int(x) for x in mat[i]]
        return r, decode_event(r)

    exp_row, exp_text = row(expected, idx)
    act_row, act_text = row(actual, idx)
    rnd = (exp_row or act_row or [-1])[0]
    context = []
    for i in range(max(0, idx - window), min(max(n_e, n_a), idx + window + 1)):
        _, et = row(expected, i)
        _, at = row(actual, i)
        marker = ">>" if i == idx else "  "
        context.append(f"{marker} #{i}: {et}  |  {at}")
    return Divergence(index=idx, round=rnd, expected=exp_row,
                      actual=act_row, expected_text=exp_text,
                      actual_text=act_text, context=context)


# ---------------------------------------------------------------------------
# per-cell comparison
# ---------------------------------------------------------------------------
@dataclass
class CompareResult:
    scenario: str
    policy: str
    n_events: int = 0
    digest: str = ""
    golden: Optional[str] = None
    #: None = cell passed; otherwise the failed check's name
    failure: Optional[str] = None   # engine|streaming|golden|missing-golden
    divergence: Optional[Divergence] = None
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return self.failure is None

    def to_dict(self) -> dict:
        d = {
            "scenario": self.scenario, "policy": self.policy,
            "n_events": self.n_events, "digest": self.digest,
            "golden": self.golden, "failure": self.failure,
            "seconds": round(self.seconds, 3),
        }
        if self.divergence is not None:
            d["divergence"] = self.divergence.to_dict()
        return d


def _build_case(key: str):
    from ..dataflows import lower_to_trace
    from ..dataflows.suite import suite_case
    case = suite_case(key)
    return case, lower_to_trace(case.spec)


def compare_scenario(key: str, policies: Iterable[str],
                     golden: Optional[Dict[str, str]] = None,
                     window: int = 3) -> List[CompareResult]:
    """Run the three conformance checks for one scenario across
    ``policies`` (the trace is lowered once and shared)."""
    import time
    case, trace = _build_case(key)
    results: List[CompareResult] = []
    for pol in policies:
        t0 = time.perf_counter()
        res = CompareResult(scenario=key, policy=pol)
        sim = Simulator(case.cfg, named_policy(pol, gqa=case.gqa))
        s_step, s_comp, s_seg = EventSink(), EventSink(), EventSink()
        sim.run(trace, record_history=False, engine="steps",
                events=s_step)
        sim.run(trace, record_history=False, engine="compiled",
                events=s_comp)
        ct = trace.compiled(case.cfg.line_bytes)
        chunk = max(1, int(ct.n_acc_round.sum()) // _N_SEGMENTS)
        sim.run(trace, record_history=False, engine="compiled",
                chunk_lines=chunk, events=s_seg)

        res.n_events = len(s_comp)
        canon = s_comp.canonical()
        res.digest = stream_digest(canon)

        div = first_divergence(s_step.canonical(), canon, window)
        if div is not None:
            res.failure = "engine"
            res.divergence = div
        else:
            # streaming must match the monolithic *raw* stream
            div = first_divergence(s_comp.matrix(), s_seg.matrix(), window)
            if div is not None:
                res.failure = "streaming"
                res.divergence = div
            elif golden is not None:
                cell = f"{key}/{pol}"
                want = golden.get(cell)
                if want is None:
                    res.failure = "missing-golden"
                elif want != res.digest:
                    res.failure = "golden"
                res.golden = want
        res.seconds = time.perf_counter() - t0
        results.append(res)
    return results


def run_matrix(entries: Iterable[Tuple[str, str]],
               golden: Optional[Dict[str, str]] = None,
               window: int = 3,
               progress=None) -> List[CompareResult]:
    """Run the conformance checks over matrix ``entries``, grouping by
    scenario so each trace is lowered and compiled once."""
    by_scenario: Dict[str, List[str]] = {}
    for key, pol in entries:
        by_scenario.setdefault(key, []).append(pol)
    results: List[CompareResult] = []
    for key, pols in by_scenario.items():
        cells = compare_scenario(key, pols, golden, window)
        results.extend(cells)
        if progress is not None:
            for c in cells:
                progress(c)
    return results


# ---------------------------------------------------------------------------
# golden digests
# ---------------------------------------------------------------------------
def golden_path() -> Path:
    return (Path(__file__).resolve().parents[3] / "tests" / "golden"
            / "conformance_digests.json")


def load_golden(path: Optional[Path] = None) -> Optional[Dict[str, str]]:
    """The frozen ``cell → digest`` map, or ``None`` when absent or
    written under a different event schema (a schema bump obsoletes
    every digest at once)."""
    path = path or golden_path()
    try:
        blob = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if blob.get("schema_version") != SCHEMA_VERSION:
        return None
    return dict(blob.get("digests", {}))


def save_golden(digests: Dict[str, str],
                path: Optional[Path] = None) -> Path:
    path = path or golden_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    blob = {
        "schema_version": SCHEMA_VERSION,
        "digests": {k: digests[k] for k in sorted(digests)},
    }
    path.write_text(json.dumps(blob, indent=2) + "\n")
    return path
