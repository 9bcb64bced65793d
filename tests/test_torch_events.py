"""Event-trace telemetry layer (repro_torch.core.events, DESIGN.md §10).

Pins the tentpole contracts: engine agreement on the canonical stream,
bit-identical streaming concatenation, event↔counter conservation,
zero emission when disabled, timeline series/digests, and the
(set, tag) → address inversion the victim attribution rides on.
"""

import numpy as np
import pytest

# the port
from repro_torch.core import EventSink
from repro_torch.core import SimConfig
from repro_torch.core import Simulator
from repro_torch.core import named_policy
from repro_torch.core import run_policy
from repro_torch.core import timeline_digest
from repro_torch.core.cache import CacheGeometry
from repro_torch.core.events import COLUMNS
from repro_torch.core.events import EV_BYPASS
from repro_torch.core.events import EV_EVICT
from repro_torch.core.events import EV_FILL
from repro_torch.core.events import EV_GEAR
from repro_torch.core.events import EV_HIT
from repro_torch.core.events import EV_MSHR
from repro_torch.core.events import EV_RETIRE
from repro_torch.core.events import EV_WB
from repro_torch.core.events import SCHEMA_VERSION
from repro_torch.core.events import canonical_order
from repro_torch.core.events import decode_event
from repro_torch.core.events import stream_digest
from repro_torch.core.traces import build_fa2_trace
from repro_torch.core.traces import build_matmul_trace
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import TEMPORAL

CFG = SimConfig(llc_bytes=256 * 1024, llc_slices=8)
TINY_T = AttnWorkload("tiny-t", n_q_heads=8, n_kv_heads=4, head_dim=128,
                      seq_len=512, group_alloc=TEMPORAL)
TINY_S = AttnWorkload("tiny-s", n_q_heads=8, n_kv_heads=4, head_dim=128,
                      seq_len=512, group_alloc=SPATIAL)

POLICIES = ["lru", "dbp", "at+dbp", "all"]


def _run(trace, policy, engine, gqa=False, chunk_lines=None, cfg=CFG):
    sink = EventSink()
    sim = Simulator(cfg, named_policy(policy, gqa=gqa))
    res = sim.run(trace, record_history=False, engine=engine,
                  chunk_lines=chunk_lines, events=sink)
    return sink, res


# ---------------------------------------------------------------------------
# engine agreement + streaming concatenation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_step_and_compiled_agree_canonical(policy):
    trace = build_fa2_trace(TINY_T, n_cores=8)
    s_step, r_step = _run(trace, policy, "steps")
    s_comp, r_comp = _run(trace, policy, "compiled")
    assert np.array_equal(s_step.canonical(), s_comp.canonical())
    assert s_step.digest() == s_comp.digest()
    assert r_step.hits == r_comp.hits


def test_gqa_spatial_agreement():
    trace = build_fa2_trace(TINY_S, n_cores=8)
    s_step, _ = _run(trace, "all", "steps", gqa=True)
    s_comp, _ = _run(trace, "all", "compiled", gqa=True)
    assert s_step.digest() == s_comp.digest()


def test_mshr_merges_agree_across_engines():
    # cores sharing B tiles in the same round produce MSHR merges
    trace = build_matmul_trace(512, 512, 512, n_cores=8)
    s_step, r_step = _run(trace, "all", "steps")
    s_comp, r_comp = _run(trace, "all", "compiled")
    assert r_comp.mshr_hits > 0
    assert s_comp.counts_by_kind()["MSHR"] > 0
    assert s_step.digest() == s_comp.digest()


@pytest.mark.parametrize("chunk_lines", [64, 600, 10**9])
def test_streaming_concatenates_bit_identical(chunk_lines):
    trace = build_matmul_trace(512, 512, 512, n_cores=4)
    s_mono, _ = _run(trace, "at+dbp", "compiled")
    s_seg, _ = _run(trace, "at+dbp", "compiled", chunk_lines=chunk_lines)
    # raw emission order, not just canonical: segments must concatenate
    assert np.array_equal(s_mono.matrix(), s_seg.matrix())
    assert s_mono.digest() == s_seg.digest()


# ---------------------------------------------------------------------------
# event ↔ SimResult counter conservation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_event_counts_conserve_to_counters(policy):
    trace = build_fa2_trace(TINY_T, n_cores=8)
    sink, res = _run(trace, policy, "compiled")
    m = sink.matrix()
    kinds, aux = m[:, 6], m[:, 7]
    assert int((kinds == EV_HIT).sum()) == res.hits
    assert int(aux[kinds == EV_MSHR].sum()) == res.mshr_hits
    assert int((kinds == EV_BYPASS).sum()) == res.bypassed
    assert int((kinds == EV_WB).sum()) == res.writebacks
    # every miss either fills or bypasses
    assert (int((kinds == EV_FILL).sum()) + int((kinds == EV_BYPASS).sum())
            == res.cold_misses + res.conflict_misses)
    # EVICT aux LSB carries the dead verdict
    assert (int((aux[kinds == EV_EVICT] & 1).sum())
            == res.dead_evictions)
    # FILL aux LSB = seen (conflict): recounts the allocated conflicts
    fills_seen = int((aux[kinds == EV_FILL] & 1).sum())
    byp_seen = int((aux[kinds == EV_BYPASS]).sum())
    assert fills_seen + byp_seen == res.conflict_misses


def test_retire_events_present_under_dbp():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    sink, _ = _run(trace, "dbp", "compiled")
    assert sink.counts_by_kind()["RETIRE"] > 0


def test_gear_events_only_with_dynamic_bypass():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    s_lru, _ = _run(trace, "lru", "compiled")
    s_all, _ = _run(trace, "all", "compiled")
    assert s_lru.counts_by_kind()["GEAR"] == 0
    assert s_all.counts_by_kind()["GEAR"] > 0
    # gear rows carry slice in the set column and new gear in aux
    m = s_all.matrix()
    gear_rows = m[m[:, 6] == EV_GEAR]
    assert (gear_rows[:, 4] >= 0).all()
    assert (gear_rows[:, 7] >= 0).all()


# ---------------------------------------------------------------------------
# disabled by default / opt-in paths
# ---------------------------------------------------------------------------
def test_no_events_unless_requested():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    res = run_policy(trace, "at+dbp", CFG, record_history=False)
    assert res.events is None


def test_trace_events_config_flag():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    cfg = SimConfig(llc_bytes=256 * 1024, llc_slices=8,
                    trace_events=True)
    r1 = run_policy(trace, "at+dbp", cfg, record_history=False)
    r2 = run_policy(trace, "at+dbp", cfg, record_history=False)
    assert r1.events is not None and len(r1.events) > 0
    # determinism: same run → same digest
    assert r1.events.digest() == r2.events.digest()


def test_results_unchanged_by_tracing():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    plain = run_policy(trace, "all", CFG, record_history=False)
    sink, traced = _run(trace, "all", "compiled")
    for f in ("cycles", "hits", "mshr_hits", "cold_misses",
              "conflict_misses", "bypassed", "writebacks",
              "dead_evictions", "dram_lines"):
        assert getattr(plain, f) == getattr(traced, f), f


# ---------------------------------------------------------------------------
# timeline view
# ---------------------------------------------------------------------------
def test_timeline_series_sum_to_counters():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    res = run_policy(trace, "all", CFG, record_history=True)
    tl = res.timeline
    for key in ("round", "hits", "misses", "bypassed", "writebacks"):
        assert key in tl
    assert int(tl["hits"].sum()) == res.hits + res.mshr_hits
    assert int(tl["misses"].sum()) == res.cold_misses + res.conflict_misses
    assert int(tl["bypassed"].sum()) == res.bypassed
    assert int(tl["writebacks"].sum()) == res.writebacks
    assert (np.diff(tl["round"]) > 0).all()      # strictly monotone


def test_timeline_matches_across_engines_and_digest():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    sim = Simulator(CFG, named_policy("at+dbp"))
    r_step = sim.run(trace, record_history=True, engine="steps")
    r_comp = sim.run(trace, record_history=True, engine="compiled")
    d_step = timeline_digest(r_step.timeline)
    d_comp = timeline_digest(r_comp.timeline)
    assert d_step == d_comp
    # digest is content-sensitive
    mutated = dict(r_comp.timeline)
    mutated["hits"] = mutated["hits"] + 1
    assert timeline_digest(mutated) != d_comp


def test_timeline_off_without_history():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    res = run_policy(trace, "lru", CFG, record_history=False)
    assert res.timeline == {}


# ---------------------------------------------------------------------------
# canonical order, digest domain, decoding, export
# ---------------------------------------------------------------------------
def test_canonical_order_is_permutation_invariant():
    trace = build_fa2_trace(TINY_T, n_cores=8)
    sink, _ = _run(trace, "at+dbp", "compiled")
    m = sink.matrix()
    rng = np.random.default_rng(7)
    shuffled = m[rng.permutation(m.shape[0])]
    assert np.array_equal(canonical_order(shuffled), sink.canonical())


def test_digest_includes_schema_version():
    empty = np.empty((0, len(COLUMNS)), dtype=np.int64)
    d = stream_digest(empty)
    assert isinstance(d, str) and len(d) == 64
    # digest domain is versioned: a different payload changes it
    one = np.zeros((1, len(COLUMNS)), dtype=np.int64)
    assert stream_digest(one) != d


def test_decode_event_names_every_kind():
    rows = {
        "FILL": [3, 1, 0, 2, 5, 4, EV_FILL, 2 * 77 + 1],
        "HIT": [3, 1, 0, 2, 5, 4, EV_HIT, 0],
        "MSHR": [3, -1, 0, 2, 5, -1, EV_MSHR, 3],
        "BYPASS": [3, 1, 0, 2, 5, -1, EV_BYPASS, 1],
        "EVICT": [3, -1, 0, 2, 5, 4, EV_EVICT, 2 * 99],
        "WB": [3, -1, 0, 2, 5, 4, EV_WB, 99],
        "GEAR": [3, -1, 1, -1, 6, -1, EV_GEAR, 2],
        "RETIRE": [3, -1, 0, 7, -1, -1, EV_RETIRE, 11],
    }
    for name, row in rows.items():
        text = decode_event(row)
        assert name in text and "round=3" in text


def test_npz_export_roundtrip(tmp_path):
    trace = build_fa2_trace(TINY_T, n_cores=8)
    sink, _ = _run(trace, "dbp", "compiled")
    path = tmp_path / "events.npz"
    sink.to_npz(path)
    with np.load(path) as z:
        assert int(z["schema_version"][0]) == SCHEMA_VERSION
        m = sink.matrix()
        for i, name in enumerate(COLUMNS):
            assert np.array_equal(z[name], m[:, i])


# ---------------------------------------------------------------------------
# (set, tag) → line address inversion (victim attribution)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hash_sets", [True, False])
def test_line_addr_of_inverts_set_mapping(hash_sets):
    geom = CacheGeometry(256 * 1024, 128, 8, 8, hash_sets=hash_sets)
    rng = np.random.default_rng(3)
    addrs = (rng.integers(0, 1 << 32, size=4096) // 128) * 128
    sets = geom.set_of(addrs)
    tags = geom.tag_of(addrs)
    assert np.array_equal(geom.line_addr_of(sets, tags), addrs)


# ---------------------------------------------------------------------------
# live-region registration (allocator-aware overlap check)
# ---------------------------------------------------------------------------
def test_register_tensors_rejects_live_overlap_with_names():
    """A mid-stream registration colliding with a still-live region is
    an allocator bug; the error names the offender, its base, and the
    live region it collides with."""
    from repro_torch.core.tmu import TensorMeta

    def meta(tid, base, size):
        return TensorMeta(tensor_id=tid, base_addr=base, size_bytes=size,
                          tile_bytes=size, n_acc=1)

    sink = EventSink()
    sink.register_tensors([meta(1, 0x10000, 0x800)])
    with pytest.raises(ValueError) as exc:
        sink.register_tensors([meta(2, 0x10400, 0x800)])
    msg = str(exc.value)
    assert "tensor 2" in msg and "0x10400" in msg
    assert "[0x10000, 0x10800)" in msg and "tensor 1" in msg

    # released regions may be recycled...
    sink.release_tensors([1])
    sink.register_tensors([meta(3, 0x10000, 0x800)])
    # ...and a same-segment retirement exempts its region in-window
    with pytest.raises(ValueError):
        sink.register_tensors([meta(4, 0x10000, 0x800)])
    sink.register_tensors([meta(4, 0x10000, 0x800)],
                          retiring_tids=frozenset({3}))
