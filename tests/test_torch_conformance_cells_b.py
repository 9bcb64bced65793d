"""The port's conformance matrix against the frozen goldens, one case per
(scenario, policy) cell: the step engine, the compiled engine and the
compiled engine fed in segments agree event for event, and the canonical
stream's digest equals ``tests/golden/conformance_digests.json`` (an equal
digest means an equal event stream).  The registered
scenarios from the eighth on; ``test_torch_conformance_cells.py`` holds
the first seven.
Tolerance: exact."""

import functools

import pytest

# the port
from repro_torch.conformance import CONFORMANCE_POLICIES
from repro_torch.conformance import compare_scenario
from repro_torch.conformance import load_golden
from repro_torch.dataflows.suite import registry_keys

SCENARIOS = registry_keys()[7:]
GOLDEN = load_golden()


@functools.lru_cache(maxsize=None)
def scenario_cells(key):
    """All four policies of one scenario (the trace is lowered once)."""
    return {r.policy: r for r in compare_scenario(key, CONFORMANCE_POLICIES, golden=GOLDEN)}


@pytest.mark.parametrize("policy", CONFORMANCE_POLICIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cell_equals_frozen_golden(scenario, policy):
    assert GOLDEN is not None, "tests/golden/conformance_digests.json missing or stale"
    res = scenario_cells(scenario)[policy]
    assert res.failure is None, (res.divergence.render() if res.divergence else res.failure)
    assert res.n_events > 0
    assert res.digest == res.golden == GOLDEN[f"{scenario}/{policy}"]
