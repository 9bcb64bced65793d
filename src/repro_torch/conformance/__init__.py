"""Differential conformance harness (DESIGN.md §10).

Pins the repo's execution engines against each other at the *event*
level: the step engine is the oracle, the compiled engine (monolithic
and streaming/chunked) must reproduce its canonical event stream byte
for byte on every registered suite scenario, and the resulting digests
are frozen as goldens under ``tests/golden/``.  On mismatch the harness
reports the first-divergence event with full context (round, expected
vs actual, surrounding window) rather than a bare assert — the RTL-
verification ``compare_traces`` idiom applied to the simulator stack.

This copy reads the same frozen digests as the JAX package's harness
(``golden_path``); refreshing them is the JAX package's
``scripts/conformance.py --update-golden``.  ``chip_smoke.py``'s
``simulator`` phase runs the whole matrix against them.  The scenario×policy matrix lives in
:mod:`.matrix` and grows automatically with
``repro_torch.dataflows.suite``'s registry.
"""

from .compare import CompareResult
from .compare import Divergence
from .compare import compare_scenario
from .compare import first_divergence
from .compare import golden_path
from .compare import load_golden
from .compare import run_matrix
from .compare import save_golden
from .matrix import CONFORMANCE_POLICIES
from .matrix import SMOKE_SCENARIOS
from .matrix import matrix_entries

__all__ = [
    "CompareResult", "Divergence", "compare_scenario", "first_divergence",
    "golden_path", "load_golden", "run_matrix", "save_golden",
    "CONFORMANCE_POLICIES", "SMOKE_SCENARIOS", "matrix_entries",
]
