"""Differential conformance harness (repro_torch.conformance, DESIGN.md §10).

Covers the first-divergence report (an injected divergence must come
back with round + event context, not a bare assert), golden digest
round-tripping and schema invalidation, matrix growth from the suite
registry, and one end-to-end cell.  Then the port against the JAX
package's harness: on the smoke scenarios, each package lowers its own
suite case and simulates it, and the event matrices must be equal row for
row; ``first_divergence`` reports the same divergence in both.
Tolerance: exact.
"""

import functools
import json

import numpy as np
import pytest

from repro.conformance import first_divergence as ref_first_divergence
from repro.core import EventSink as RefEventSink
from repro.core import Simulator as RefSimulator
from repro.core import named_policy as ref_named_policy
from repro.dataflows import lower_to_trace as ref_lower_to_trace
from repro.dataflows.suite import suite_case as ref_suite_case
# the port
from repro_torch.conformance import CONFORMANCE_POLICIES
from repro_torch.conformance import SMOKE_SCENARIOS
from repro_torch.conformance import compare_scenario
from repro_torch.conformance import first_divergence
from repro_torch.conformance import load_golden
from repro_torch.conformance import matrix_entries
from repro_torch.conformance import save_golden
from repro_torch.core import EventSink
from repro_torch.core import SimConfig
from repro_torch.core import Simulator
from repro_torch.core import named_policy
from repro_torch.core.events import SCHEMA_VERSION
from repro_torch.core.traces import build_matmul_trace
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows.suite import suite_case

def _tiny_stream():
    trace = build_matmul_trace(256, 256, 256, n_cores=4)
    sink = EventSink()
    sim = Simulator(SimConfig(llc_bytes=128 * 1024, llc_slices=8),
                    named_policy("at+dbp"))
    sim.run(trace, record_history=False, events=sink)
    return sink.canonical()


# ---------------------------------------------------------------------------
# first-divergence reporting
# ---------------------------------------------------------------------------
def test_identical_streams_have_no_divergence():
    m = _tiny_stream()
    assert first_divergence(m, m) is None
    assert first_divergence(m.copy(), m.copy()) is None


def test_injected_divergence_reports_round_and_context():
    expected = _tiny_stream()
    actual = expected.copy()
    idx = expected.shape[0] // 2
    actual[idx, 7] += 1                     # flip one event's aux
    div = first_divergence(expected, actual, window=2)
    assert div is not None
    assert div.index == idx
    assert div.round == int(expected[idx, 0])
    assert div.expected == [int(x) for x in expected[idx]]
    assert div.actual == [int(x) for x in actual[idx]]
    text = div.render()
    # a real report, not a bare assert: names the round, shows both
    # events decoded, and carries surrounding context lines
    assert "first divergence" in text
    assert f"round {div.round}" in text
    assert div.expected_text in text and div.actual_text in text
    assert len(div.context) == 5            # idx±2
    assert sum(c.startswith(">>") for c in div.context) == 1
    # round-trips to JSON for the CI artifact
    blob = json.dumps(div.to_dict())
    assert str(div.round) in blob


def test_divergence_on_truncated_stream():
    expected = _tiny_stream()
    actual = expected[:-3]
    div = first_divergence(expected, actual)
    assert div is not None
    assert div.index == expected.shape[0] - 3
    assert div.actual is None
    assert "<stream ended>" in div.actual_text


def test_divergence_window_clamps_at_edges():
    expected = _tiny_stream()[:4]
    actual = expected.copy()
    actual[0, 7] += 1
    div = first_divergence(expected, actual, window=3)
    assert div.index == 0
    assert len(div.context) == 4            # 0..3, clamped at the start


# ---------------------------------------------------------------------------
# golden digests
# ---------------------------------------------------------------------------
def test_golden_roundtrip(tmp_path):
    path = tmp_path / "golden.json"
    digests = {"b/x": "2" * 64, "a/y": "1" * 64}
    save_golden(digests, path)
    blob = json.loads(path.read_text())
    assert blob["schema_version"] == SCHEMA_VERSION
    assert list(blob["digests"]) == ["a/y", "b/x"]     # key-sorted
    assert load_golden(path) == digests


def test_golden_rejects_stale_schema(tmp_path):
    path = tmp_path / "golden.json"
    path.write_text(json.dumps({"schema_version": SCHEMA_VERSION + 1,
                                "digests": {"a/b": "0" * 64}}))
    assert load_golden(path) is None
    assert load_golden(tmp_path / "missing.json") is None


def test_frozen_goldens_cover_the_full_matrix():
    golden = load_golden()
    assert golden is not None, "tests/golden/conformance_digests.json " \
        "missing or stale — run scripts/conformance.py --update-golden"
    cells = {f"{k}/{p}" for k, p in matrix_entries()}
    assert cells <= set(golden)


# ---------------------------------------------------------------------------
# matrix growth
# ---------------------------------------------------------------------------
def test_matrix_grows_with_suite_registry():
    from repro_torch.dataflows.suite import registry_keys
    entries = list(matrix_entries())
    keys = registry_keys()
    assert {k for k, _ in entries} == set(keys)
    assert len(entries) == len(keys) * len(CONFORMANCE_POLICIES)
    assert set(SMOKE_SCENARIOS) <= set(keys)
    smoke = list(matrix_entries(smoke=True))
    assert {k for k, _ in smoke} == set(SMOKE_SCENARIOS)
    # explicit axes override both defaults
    assert list(matrix_entries(scenarios=["matmul"],
                               policies=["lru"])) == [("matmul", "lru")]


# ---------------------------------------------------------------------------
# end-to-end cells
# ---------------------------------------------------------------------------
def test_compare_scenario_cell_passes_against_frozen_golden():
    golden = load_golden()
    res, = compare_scenario("matmul", ("lru",), golden=golden)
    assert res.ok and res.failure is None
    assert res.n_events > 0 and len(res.digest) == 64
    if golden is not None:
        assert res.golden == res.digest


def test_compare_scenario_flags_corrupted_golden():
    res, = compare_scenario("matmul", ("lru",),
                            golden={"matmul/lru": "f" * 64})
    assert res.failure == "golden"
    res, = compare_scenario("matmul", ("lru",), golden={})
    assert res.failure == "missing-golden"




# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _smoke_traces(key):
    ref_case, port_case = ref_suite_case(key), suite_case(key)
    assert ref_case.fingerprint == port_case.fingerprint
    return ref_case, ref_lower_to_trace(ref_case.spec), port_case, lower_to_trace(port_case.spec)


@pytest.mark.parametrize("policy", CONFORMANCE_POLICIES)
@pytest.mark.parametrize("scenario", SMOKE_SCENARIOS)
def test_event_matrix_equals_the_reference(scenario, policy):
    ref_case, ref_trace, case, trace = _smoke_traces(scenario)
    ref_sink, sink = RefEventSink(), EventSink()
    RefSimulator(ref_case.cfg, ref_named_policy(policy, gqa=ref_case.gqa)).run(
        ref_trace, record_history=False, events=ref_sink)
    Simulator(case.cfg, named_policy(policy, gqa=case.gqa)).run(
        trace, record_history=False, events=sink)
    want, got = ref_sink.matrix(), sink.matrix()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert len(got) > 0
    div = first_divergence(want, got)
    assert div is None, div.render()
    assert np.array_equal(got, want)
    assert np.array_equal(sink.canonical(), ref_sink.canonical())


@pytest.mark.parametrize("where", ["first", "middle", "last", "truncated"])
def test_first_divergence_reports_as_the_reference_does(where):
    expected = _tiny_stream()
    actual = expected.copy()
    idx = {"first": 0, "middle": expected.shape[0] // 2, "last": expected.shape[0] - 1,
           "truncated": None}[where]
    if idx is None:
        actual = expected[:-3]
    else:
        actual[idx, 7] += 1
    got = first_divergence(expected, actual, window=2)
    want = ref_first_divergence(expected, actual, window=2)
    assert got is not None
    assert got.to_dict() == want.to_dict()
    assert got.render() == want.render()
