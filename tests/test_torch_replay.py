"""Traffic-scale serving replay (DESIGN.md §11): generator determinism,
streamed-vs-monolithic bit-identity, bounded-window memory, SLO metrics,
and the serve-loop truncation contract.  Then the port against the JAX
package: the same arrivals per seed, the same ``ReplayResult`` (SLO
metrics, rounds, segments, every simulator counter and series) in stream
and monolithic mode under both allocators, and the same truncation error.
Tolerance: exact, floats bit for bit."""

from _torch_same import assert_same
import numpy as np
import pytest

from repro.core.events import EventSink as RefEventSink
from repro.core.simulator import SimConfig as RefSimConfig
from repro.serve.replay import ReplayConfig as RefReplayConfig
from repro.serve.replay import replay_spec as ref_replay_spec
from repro.serve.replay import run_replay as ref_run_replay
from repro.serve.scheduler import ServeTruncation as RefServeTruncation
from repro.serve.traffic import RequestStream as RefRequestStream
from repro.serve.traffic import TrafficConfig as RefTrafficConfig
# the port
from repro_torch.core.events import EventSink
from repro_torch.core.simulator import SimConfig
from repro_torch.serve.replay import ReplayConfig
from repro_torch.serve.replay import replay_spec
from repro_torch.serve.replay import run_replay
from repro_torch.serve.scheduler import ServeTruncation
from repro_torch.serve.scheduler import SlotScheduler
from repro_torch.serve.traffic import RequestStream
from repro_torch.serve.traffic import TrafficConfig

# Hypothesis widens the seed coverage where installed (CI); the
# parametrized variants below keep the invariants exercised without it.
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

CFG = SimConfig(llc_bytes=128 * 1024)


def _counters(res):
    s = res.sim
    return (s.cycles, s.hits, s.mshr_hits, s.cold_misses,
            s.conflict_misses, s.bypassed, s.dram_lines, s.writebacks,
            s.dead_evictions, s.flops)


# ---------------------------------------------------------------------------
# Generator determinism
# ---------------------------------------------------------------------------
def _check_generator_deterministic(seed, process):
    cfg = TrafficConfig(n_requests=200, seed=seed, process=process)
    stream = RequestStream(cfg)
    first = list(stream)
    again = list(stream)                       # re-iteration re-seeds
    fresh = list(RequestStream(TrafficConfig(n_requests=200, seed=seed,
                                             process=process)))
    assert first == again == fresh
    arr = np.array([r.arrival_round for r in first])
    assert (np.diff(arr) >= 0).all()           # arrivals are ordered
    assert all(r.uid == i for i, r in enumerate(first))


@pytest.mark.parametrize("seed,process",
                         [(0, "poisson"), (42, "bursty"),
                          (2**31 - 1, "bursty")])
def test_generator_deterministic_under_seed(seed, process):
    """Two iterations of the same RequestStream — and a fresh stream
    built from an equal config — yield identical request populations."""
    _check_generator_deterministic(seed, process)


if HAVE_HYPOTHESIS:
    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           process=st.sampled_from(["poisson", "bursty"]))
    def test_generator_deterministic_property(seed, process):
        _check_generator_deterministic(seed, process)


def test_generator_prefix_populations():
    cfg = TrafficConfig(n_requests=400, seed=3, share_fraction=0.5)
    stream = RequestStream(cfg)
    reqs = list(stream)
    shared = [r for r in reqs if r.prefix_id >= 0]
    assert 0 < len(shared) < len(reqs)
    for pid in {r.prefix_id for r in shared}:
        info = stream.prefix_info(pid)
        members = [r for r in shared if r.prefix_id == pid]
        assert len(members) == info.members
        assert info.total_decode_steps == sum(r.decode_steps
                                              for r in members)
        assert info.uid_min == min(r.uid for r in members)
        assert info.uid_max == max(r.uid for r in members)


# ---------------------------------------------------------------------------
# Streamed replay ≡ monolithic replay (bit-identical)
# ---------------------------------------------------------------------------
def _check_stream_bit_identical(seed, process, policy):
    """The chunked emit→compile→run_stream pipeline must reproduce the
    monolithic spec→lower→run pipeline bit for bit: every counter and
    the canonical event-stream digest (chunk boundaries are invisible)."""
    traffic = TrafficConfig(n_requests=40, seed=seed, process=process)
    mono_sink, str_sink = EventSink(), EventSink()
    mono = run_replay(traffic, policy, CFG, mode="monolithic",
                      events=mono_sink)
    streamed = run_replay(traffic, policy, CFG, mode="stream",
                          chunk_lines=256, events=str_sink)
    assert streamed.segments > 1               # actually chunked
    assert _counters(streamed) == _counters(mono)
    assert streamed.rounds == mono.rounds
    assert str_sink.digest() == mono_sink.digest()
    np.testing.assert_array_equal(streamed.log.first_token,
                                  mono.log.first_token)
    np.testing.assert_array_equal(streamed.log.last_token,
                                  mono.log.last_token)


@pytest.mark.parametrize("seed,process,policy",
                         [(1, "poisson", "lru"), (7, "bursty", "all"),
                          (23, "bursty", "lru"), (5, "poisson", "all")])
def test_streamed_replay_bit_identical_to_monolithic(seed, process,
                                                     policy):
    _check_stream_bit_identical(seed, process, policy)


if HAVE_HYPOTHESIS:
    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 1000),
           process=st.sampled_from(["poisson", "bursty"]),
           policy=st.sampled_from(["lru", "all"]))
    def test_streamed_replay_bit_identical_property(seed, process,
                                                    policy):
        _check_stream_bit_identical(seed, process, policy)


@pytest.mark.parametrize("policy", ["lru", "at+dbp", "all"])
def test_pooled_streamed_replay_bit_identical_to_monolithic(policy):
    """The bit-identity property must survive address recycling: both
    emitters see the identical declare/retire sequence from the replay
    engine, so the pooled allocator hands out identical layouts and the
    chunked pipeline reproduces the monolithic one exactly."""
    traffic = TrafficConfig(n_requests=40, seed=7, process="bursty")
    rcfg = ReplayConfig(allocator="pooled")
    mono_sink, str_sink = EventSink(), EventSink()
    mono = run_replay(traffic, policy, CFG, rcfg, mode="monolithic",
                      events=mono_sink)
    streamed = run_replay(traffic, policy, CFG, rcfg, mode="stream",
                          chunk_lines=256, events=str_sink)
    assert streamed.segments > 1
    assert _counters(streamed) == _counters(mono)
    assert str_sink.digest() == mono_sink.digest()


def test_pooled_replay_address_footprint_bounded():
    """Bump mints fresh addresses forever; the pooled replay's address
    span stays within the configured pool (no overflow at this scale),
    so tag-derived TMU state keeps covering the live working set."""
    traffic = TrafficConfig(n_requests=200, seed=11, process="bursty")
    rcfg = ReplayConfig(allocator="pooled")
    bump_spec, _ = replay_spec(traffic, ReplayConfig())
    pooled_spec, _ = replay_spec(traffic, rcfg)
    assert pooled_spec.allocator == "pooled"
    assert bump_spec.allocator == "bump"
    # bump layouts stay implicit (the historical lowering assigns them);
    # pooled layouts are baked in and live inside the configured pool
    assert all(t.base is None for t in bump_spec.tensors)
    assert all(t.base is not None for t in pooled_spec.tensors)
    span = (max(t.base + t.size_bytes for t in pooled_spec.tensors)
            - min(t.base for t in pooled_spec.tensors))
    assert span <= rcfg.pool_pages * rcfg.page_bytes
    # lifetime footprint exceeds the span — regions were recycled
    assert sum(t.size_bytes for t in pooled_spec.tensors) > span


def test_streamed_replay_memory_bounded():
    """Seen-bitmap recycling keeps the dense window a fraction of the
    lifetime footprint — the property that makes 10⁵–10⁶-request
    replays feasible."""
    traffic = TrafficConfig(n_requests=300, seed=11, process="bursty")
    res = run_replay(traffic, "all", CFG, chunk_lines=4096)
    assert res.segments > 1
    assert res.peak_seen_lines < 0.5 * res.total_lines_declared
    assert res.slo["completed"]["n"] == 300


def test_replay_slo_metrics_sane():
    traffic = TrafficConfig(n_requests=120, seed=5)
    res = run_replay(traffic, "at+dbp", CFG)
    for metric in ("ttft_ms", "tpot_ms"):
        pct = res.slo[metric]
        assert 0.0 < pct["p50"] <= pct["p95"] <= pct["p99"]
        assert pct["mean"] > 0.0
    assert res.slo["completed"]["n"] == 120


def test_replay_spec_round_trip_and_policy_spread():
    """The monolithic replay spec is a well-formed DataflowSpec and the
    full mechanism stack beats LRU on the bursty serving mix (the
    suite-registry contract for the serve-replay scenario)."""
    traffic = TrafficConfig(n_requests=96, seed=7, process="bursty")
    spec, log = replay_spec(traffic)
    assert spec.n_rounds > 0 and len(spec.tensors) > 0
    assert (log.first_token >= log.arrival).all()
    assert (log.last_token >= log.first_token).all()
    lru = run_replay(traffic, "lru", CFG, record_history=False)
    atdbp = run_replay(traffic, "at+dbp", CFG, record_history=False)
    assert lru.sim.cycles / atdbp.sim.cycles > 1.1


# ---------------------------------------------------------------------------
# Truncation contract (scheduler + engines)
# ---------------------------------------------------------------------------
def test_replay_max_rounds_truncation():
    traffic = TrafficConfig(n_requests=64, seed=0)
    with pytest.raises(ServeTruncation) as exc:
        run_replay(traffic, "lru", CFG, rcfg=ReplayConfig(max_rounds=5))
    assert "truncated after 5 steps" in str(exc.value)
    assert exc.value.steps == 5
    assert exc.value.active + exc.value.queued > 0


def test_slot_scheduler_contract():
    sched = SlotScheduler(2)
    for item in "abc":
        sched.add(item)
    admitted = sched.admit()
    assert [s for s, _ in admitted] == [0, 1]
    assert sched.n_active == 2 and sched.n_queued == 1
    assert not sched.drained
    sched.release(0)
    assert sched.admit() == [(0, "c")]
    for slot in list(sched.active_slots()):
        sched.release(slot)
    assert sched.drained and sched.admit() == []




# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, process="bursty"),
                                dict(seed=3, share_fraction=0.0),
                                dict(seed=11, share_fraction=1.0, cohort=8),
                                dict(seed=5, mean_interarrival_rounds=0.2)],
                         ids=["poisson", "bursty", "unshared", "all-shared", "dense"])
def test_arrivals_equal_the_reference(kw):
    want = RefRequestStream(RefTrafficConfig(n_requests=300, **kw))
    got = RequestStream(TrafficConfig(n_requests=300, **kw))
    reqs = list(got)
    assert len(reqs) == 300
    assert_same(list(want), reqs, "requests")
    for pid in sorted({r.prefix_id for r in reqs if r.prefix_id >= 0}):
        assert_same(want.prefix_info(pid), got.prefix_info(pid), f"prefix {pid}")


@pytest.mark.parametrize("allocator", ["bump", "pooled"])
@pytest.mark.parametrize("mode", ["stream", "monolithic"])
@pytest.mark.parametrize("policy", ["lru", "at+dbp", "all"])
def test_replay_result_equals_the_reference(policy, mode, allocator):
    kw = dict(n_requests=48, seed=7, process="bursty")
    ref_sink, sink = RefEventSink(), EventSink()
    want = ref_run_replay(RefTrafficConfig(**kw), policy, RefSimConfig(llc_bytes=128 * 1024),
                          RefReplayConfig(allocator=allocator), mode=mode, chunk_lines=1024,
                          events=ref_sink, verify=True)
    got = run_replay(TrafficConfig(**kw), policy, SimConfig(llc_bytes=128 * 1024),
                     ReplayConfig(allocator=allocator), mode=mode, chunk_lines=1024,
                     events=sink, verify=True)
    assert got.rounds > 0 and got.slo and got.sim.accesses > 0
    assert got.diagnostics is not None and not got.diagnostics.has_errors
    events_want, events_got = want.sim.events, got.sim.events
    assert np.array_equal(events_got.matrix(), events_want.matrix())
    assert_same(want, got, f"{policy}/{mode}/{allocator}")
    assert got.slo == want.slo


@pytest.mark.parametrize("allocator", ["bump", "pooled"])
def test_replay_spec_equals_the_reference(allocator):
    kw = dict(n_requests=40, seed=2)
    assert_same(ref_replay_spec(RefTrafficConfig(**kw), RefReplayConfig(allocator=allocator)),
                replay_spec(TrafficConfig(**kw), ReplayConfig(allocator=allocator)), allocator)


@pytest.mark.parametrize("mode", ["stream", "monolithic"])
def test_truncation_equals_the_reference(mode):
    kw = dict(n_requests=64, seed=1)
    with pytest.raises(RefServeTruncation) as want:
        ref_run_replay(RefTrafficConfig(**kw), "lru", RefSimConfig(),
                       RefReplayConfig(max_rounds=20), mode=mode)
    with pytest.raises(ServeTruncation) as got:
        run_replay(TrafficConfig(**kw), "lru", SimConfig(), ReplayConfig(max_rounds=20),
                   mode=mode)
    assert str(got.value) == str(want.value)
    assert (got.value.steps, got.value.active, got.value.queued) == \
        (want.value.steps, want.value.active, want.value.queued)


@pytest.mark.parametrize("bad", [dict(n_requests=0), dict(n_requests=4, process="uniform"),
                                 dict(n_requests=4, share_fraction=1.5),
                                 dict(n_requests=4, prefix_group_size=1),
                                 dict(n_requests=4, cohort=2)])
def test_traffic_errors_equal_the_reference(bad):
    with pytest.raises(ValueError) as want:
        RefTrafficConfig(**bad)
    with pytest.raises(ValueError) as got:
        TrafficConfig(**bad)
    assert str(got.value) == str(want.value)
