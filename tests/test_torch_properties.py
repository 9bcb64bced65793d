"""Hypothesis property tests on system invariants (beyond the per-module
properties in test_cache_policies)."""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st

# the port
from repro_torch.core import kept_fraction
from repro_torch.core import predict
from repro_torch.core.orchestrator import CacheOrchestrator
from repro_torch.core.tmu import TMU
from repro_torch.core.tmu import TMUParams
from repro_torch.core.tmu import TensorMeta
from repro_torch.core.traces import fa2_counts
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import DecodeWorkload
from repro_torch.core.workloads import MoEWorkload
from repro_torch.core.workloads import PrefixShareWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import SSDScanWorkload
from repro_torch.core.workloads import SpecDecodeWorkload
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import compose_time_sliced
from repro_torch.dataflows import decode_paged_spec
from repro_torch.dataflows import fa2_spec
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import matmul_spec
from repro_torch.dataflows import mlp_chain_spec
from repro_torch.dataflows import moe_ffn_spec
from repro_torch.dataflows import prefix_share_spec
from repro_torch.dataflows import spec_decode_spec
from repro_torch.dataflows import ssd_scan_spec
from repro_torch.dataflows import tenant_regions


# ---------------------------------------------------------------------------
# Orchestrator invariants
# ---------------------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(budget_kb=st.integers(16, 8192),
       seq=st.sampled_from([256, 512, 1024, 4096]),
       head_dim=st.sampled_from([64, 128, 256]))
def test_plan_kv_split_invariants(budget_kb, seq, head_dim):
    """The S_kept split always: partitions the sequence, stays
    block-aligned, fits the usable budget, and grows with the budget."""
    orch = CacheOrchestrator(vmem_budget_bytes=budget_kb * 1024)
    bpr = 2 * head_dim * 2
    pinned, streamed = orch.plan_kv_split(seq, 128, bpr)
    assert pinned + streamed == seq
    assert pinned % 128 == 0 and pinned >= 0 and streamed >= 0
    if streamed:        # not everything fits → pinned obeys the budget
        assert pinned * bpr <= budget_kb * 1024
    bigger = CacheOrchestrator(vmem_budget_bytes=2 * budget_kb * 1024)
    p2, _ = bigger.plan_kv_split(seq, 128, bpr)
    assert p2 >= pinned


@settings(max_examples=40, deadline=None)
@given(n_tensors=st.integers(1, 6),
       tiles=st.integers(1, 32),
       budget_tiles=st.integers(1, 64))
def test_orchestrator_plan_budget_and_partition(n_tensors, tiles,
                                                budget_tiles):
    tile_bytes = 16 * 1024
    orch = CacheOrchestrator(vmem_budget_bytes=budget_tiles * tile_bytes,
                             reserve_fraction=0.125)
    for t in range(n_tensors):
        orch.register(TensorMeta(t, base_addr=t * tiles * tile_bytes,
                                 size_bytes=tiles * tile_bytes,
                                 tile_bytes=tile_bytes, n_acc=4))
    plan = orch.plan()
    usable = int(orch.vmem_budget * (1 - orch.reserve_fraction))
    assert plan.pinned_bytes <= usable
    for e in plan.entries.values():
        got = sorted(e.pinned_tiles + e.streamed_tiles)
        assert got == list(range(tiles))       # exact partition


# ---------------------------------------------------------------------------
# Analytical model invariants
# ---------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(s_work=st.integers(1, 64), s_llc=st.integers(1, 64),
       b_bits=st.integers(1, 4))
def test_kept_fraction_bounds_and_policy_dominance(s_work, s_llc, b_bits):
    MB = 2 ** 20
    args = dict(s_work=s_work * MB, s_llc=s_llc * MB, assoc=8,
                b_bits=b_bits)
    for pol in ("lru", "dbp", "at+dbp", "bypass+dbp", "all"):
        f = kept_fraction(pol, **args)
        assert 0.0 <= f <= 1.0
    # optimal bypass dominates anti-thrashing (whole cache vs (A-1)/A)
    assert kept_fraction("all", **args) >= kept_fraction("at+dbp", **args)


@settings(max_examples=20, deadline=None)
@given(seq=st.sampled_from([1024, 2048, 4096]),
       kv=st.sampled_from([4, 8, 16]),
       alloc=st.sampled_from([TEMPORAL, SPATIAL]))
def test_prediction_positive_and_counts_consistent(seq, kv, alloc):
    wl = AttnWorkload("prop", n_q_heads=32, n_kv_heads=kv, head_dim=128,
                      seq_len=seq, group_alloc=alloc)
    counts = fa2_counts(wl)
    assert counts.n_kv_accesses >= counts.n_kv_distinct
    assert counts.n_temporal_reuse >= 0
    assert counts.n_intercore_reuse >= 0
    pred = predict(counts, 4 * 2 ** 20, "all", gqa=(alloc == SPATIAL),
                   n_rounds=counts.n_rounds)
    assert pred.cycles > 0
    assert pred.n_hit + pred.n_cold + pred.n_cf > 0


# ---------------------------------------------------------------------------
# Dataflow IR invariant: for every spec the suite can produce, the
# trace lowering and the closed-form counts lowering agree on totals
# (bytes touched, line accesses, flops, rounds) — one description, no
# hand-synced twins.
# ---------------------------------------------------------------------------
def _random_spec(draw, kinds=("fa2", "matmul", "decode", "moe", "mlp",
                              "specdec", "ssd", "prefix", "compose")):
    kind = draw(st.sampled_from(kinds))
    n_cores = draw(st.sampled_from([2, 4]))
    if kind == "compose":
        base = tuple(k for k in kinds if k != "compose")
        n_tenants = draw(st.integers(2, 3))
        tenants = [_random_spec(draw, kinds=base)
                   for _ in range(n_tenants)]
        return compose_time_sliced(
            tenants, quantum_rounds=draw(st.sampled_from([2, 8, 32])))
    if kind == "fa2":
        kv = draw(st.sampled_from([1, 2, 4]))
        gs = draw(st.sampled_from([1, 2, 4]))
        wl = AttnWorkload(
            "prop", n_q_heads=kv * gs, n_kv_heads=kv, head_dim=128,
            seq_len=draw(st.sampled_from([256, 512])),
            group_alloc=draw(st.sampled_from([TEMPORAL, SPATIAL])),
            n_batches=draw(st.sampled_from([1, 2])),
            causal=draw(st.booleans()))
        return fa2_spec(wl, n_cores)
    if kind == "matmul":
        dims = [128 * draw(st.integers(1, 3)) for _ in range(3)]
        return matmul_spec(*dims, tile=128, n_cores=n_cores)
    if kind == "decode":
        n_seqs = 2 * n_cores
        wl = DecodeWorkload(
            n_seqs=n_seqs, seq_len=draw(st.sampled_from([256, 512])),
            n_steps=3, retire_step=draw(st.sampled_from([1, 2])),
            n_short=draw(st.integers(0, n_seqs)))
        return decode_paged_spec(wl, n_cores)
    if kind == "moe":
        hot = n_cores // 2
        wl = MoEWorkload(n_experts=n_cores, n_hot=hot, d_model=128,
                         d_ff=128, tile_bytes=4096, n_steps=3,
                         warm_steps=draw(st.sampled_from([1, 2])))
        return moe_ffn_spec(wl, n_cores)
    if kind == "specdec":
        wl = SpecDecodeWorkload(
            n_seqs=n_cores * draw(st.sampled_from([1, 2])),
            target_len=draw(st.sampled_from([256, 512])),
            draft_len=draw(st.sampled_from([128, 256])),
            gamma=draw(st.integers(1, 3)),
            n_verify=draw(st.integers(1, 3)))
        return spec_decode_spec(wl, n_cores)
    if kind == "ssd":
        wl = SSDScanWorkload(
            n_seqs=n_cores * draw(st.sampled_from([1, 2])),
            n_chunks=draw(st.integers(2, 4)),
            n_heads=draw(st.sampled_from([2, 4])),
            d_head=64, d_state=64,
            chunk_len=draw(st.sampled_from([16, 32])))
        return ssd_scan_spec(wl, n_cores)
    if kind == "prefix":
        wl = PrefixShareWorkload(
            n_reqs=n_cores * draw(st.sampled_from([1, 2])),
            prefix_len=draw(st.sampled_from([256, 512])),
            suffix_len=draw(st.sampled_from([128, 256])),
            n_steps=draw(st.integers(1, 2)))
        return prefix_share_spec(wl, n_cores)
    dims = tuple(128 * draw(st.integers(1, 2)) for _ in range(4))
    return mlp_chain_spec(m=256, dims=dims, tile=128, n_cores=n_cores)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_ir_trace_totals_equal_closed_form_counts(data):
    spec = _random_spec(data.draw)
    trace = lower_to_trace(spec)
    counts = lower_to_counts(spec)
    ct = trace.compiled()
    assert counts.n_rounds == trace.n_rounds
    assert (counts.n_kv_accesses + counts.n_bypass_lines
            == int(ct.n_acc_round.sum()))
    assert float(ct.flops_round.sum()) == counts.flops_total
    # class assignment partitions the tensor set (reuse vs bypass bytes)
    bypass_bytes = sum(m.size_bytes for m in trace.tensors.values()
                       if m.bypass_all)
    assert (trace.total_bytes_touched()
            == counts.n_kv_distinct * trace.line_bytes + bypass_bytes)
    # per-tensor closed-form accesses match a literal trace walk
    per = spec.per_tensor_line_accesses()
    walked = {t.name: [0, 0] for t in spec.tensors}
    names = [t.name for t in spec.tensors]
    for steps in trace.core_steps:
        for step in steps:
            for tid, _ in step.loads:
                walked[names[tid]][0] += \
                    trace.tensors[tid].tile_bytes // trace.line_bytes
            for tid, _ in step.stores:
                walked[names[tid]][1] += \
                    trace.tensors[tid].tile_bytes // trace.line_bytes
    assert per == {k: tuple(v) for k, v in walked.items()}


# ---------------------------------------------------------------------------
# Reuse-profile invariant: for every spec the suite can produce, the
# profile lowering's total reuse mass equals the closed-form counts'
# temporal + inter-core reuse (and cold / bypass / flops totals agree) —
# the §V-C scalars are marginals of the reuse-distance histogram.
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_profile_reuse_mass_equals_closed_form_counts(data):
    spec = _random_spec(data.draw)
    counts = lower_to_counts(spec)
    prof = counts.reuse_profile
    assert (prof.total_reuse_mass()
            == counts.n_temporal_reuse + counts.n_intercore_reuse)
    assert prof.footprint_lines() == counts.n_kv_distinct
    assert (int(prof.byp_cold_round.sum() + prof.byp_rep_round.sum())
            == counts.n_bypass_lines)
    assert float(prof.flops_round.sum()) == counts.flops_total
    # live+dead split partitions every distance; MSHR mass is distance 0
    assert (prof.e_dlive >= 0).all() and (prof.e_ddead >= 0).all()
    assert int((prof.e_dlive + prof.e_ddead)[prof.e_mshr].sum()) == 0


# ---------------------------------------------------------------------------
# Multi-tenant invariants (DESIGN.md §8.4): for random 2–3-tenant
# composites, per-tenant simulator counters sum to the global stats,
# the composite reuse profile's per-tenant masses recount to the
# totals, and tenant address regions round-trip without overlap.
# ---------------------------------------------------------------------------
def _random_composite(draw):
    base = ("fa2", "matmul", "decode", "moe", "mlp", "specdec", "ssd",
            "prefix")
    tenants = [_random_spec(draw, kinds=base)
               for _ in range(draw(st.integers(2, 3)))]
    return compose_time_sliced(
        tenants, quantum_rounds=draw(st.sampled_from([2, 8, 32])))


@settings(max_examples=12, deadline=None)
@given(data=st.data())
def test_composite_tenant_conservation(data):
    from repro_torch.core import SimConfig, named_policy, run_policy

    spec = _random_composite(data.draw)
    # regions: disjoint, aligned, and covering every tensor
    regions = tenant_regions(spec)
    for (_, _, e0), (_, b1, _) in zip(regions, regions[1:]):
        assert e0 <= b1
    for _, base, _ in regions:
        assert base % spec.tenant_region_align == 0

    counts = lower_to_counts(spec)
    prof = counts.reuse_profile
    n_t = spec.n_tenants
    # interleaving-aware recount: per-tenant profile masses sum to the
    # composite totals (and bypass/cold masses partition likewise)
    e_ten = prof.e_tenant
    assert (sum(int(prof.e_mass[e_ten == i].sum()) for i in range(n_t))
            == prof.total_reuse_mass())
    assert int(prof.cold_rt.sum()) == counts.n_kv_distinct
    assert (int(prof.byp_cold_rt.sum() + prof.byp_rep_rt.sum())
            == counts.n_bypass_lines)

    pol = data.draw(st.sampled_from(["lru", "at+dbp", "at+bypass"]))
    per_tenant = data.draw(st.booleans())
    hw = SimConfig(n_cores=spec.n_cores, llc_bytes=256 * 1024,
                   llc_slices=8)
    res = run_policy(lower_to_trace(spec),
                     named_policy(pol, per_tenant_gears=per_tenant), hw,
                     record_history=False)
    assert set(res.tenants) == set(spec.tenant_names)
    for key in ("hits", "mshr_hits", "cold_misses", "conflict_misses",
                "bypassed", "writebacks"):
        assert (sum(t[key] for t in res.tenants.values())
                == getattr(res, key)), key


# ---------------------------------------------------------------------------
# Event layer extension of the §8.4 attribution invariant: slicing the
# event stream by its tenant column must recount every per-tenant
# SimResult counter exactly (and hence the globals) — telemetry and
# accounting attribute to the same owner.
# ---------------------------------------------------------------------------
@settings(max_examples=8, deadline=None)
@given(data=st.data())
def test_composite_event_stream_tenant_conservation(data):
    from repro_torch.core import EventSink, SimConfig, Simulator, named_policy
    from repro_torch.core.events import (EV_BYPASS, EV_FILL, EV_HIT, EV_MSHR,
                                   EV_WB)

    spec = _random_composite(data.draw)
    pol = data.draw(st.sampled_from(["lru", "at+dbp", "all"]))
    hw = SimConfig(n_cores=spec.n_cores, llc_bytes=256 * 1024,
                   llc_slices=8)
    sink = EventSink()
    res = Simulator(hw, named_policy(pol)).run(
        lower_to_trace(spec), record_history=False, events=sink)
    m = sink.matrix()
    kinds, ten, aux = m[:, 6], m[:, 2], m[:, 7]
    for i, name in enumerate(spec.tenant_names):
        t = res.tenants[name]
        sel = ten == i
        assert int((kinds[sel] == EV_HIT).sum()) == t["hits"], name
        assert (int(aux[sel & (kinds == EV_MSHR)].sum())
                == t["mshr_hits"]), name
        assert int((kinds[sel] == EV_BYPASS).sum()) == t["bypassed"], name
        assert int((kinds[sel] == EV_WB).sum()) == t["writebacks"], name
        # every one of the tenant's misses either fills or bypasses
        assert (int((kinds[sel] == EV_FILL).sum())
                + int((kinds[sel] == EV_BYPASS).sum())
                == t["cold_misses"] + t["conflict_misses"]), name
    # the tenant slices partition the globals (no orphaned events)
    assert int((kinds == EV_HIT).sum()) == res.hits
    assert int((kinds == EV_WB).sum()) == res.writebacks


# ---------------------------------------------------------------------------
# TMU invariant: retirement count never exceeds TLL accesses / nAcc
# ---------------------------------------------------------------------------
@settings(max_examples=30, deadline=None)
@given(n_acc=st.integers(1, 5), accesses=st.integers(0, 40))
def test_tmu_retirement_rate(n_acc, accesses):
    tmu = TMU(params=TMUParams(b_bits=3))
    meta = TensorMeta(0, 0, 8 * 1024, 1024, n_acc=n_acc)
    tmu.register(meta)
    for i in range(accesses):
        tile = i % meta.num_tiles
        tmu.on_access(meta.tile_last_line(tile, 128), tile)
    assert tmu.stats["tiles_retired"] <= max(accesses // n_acc,
                                             meta.num_tiles)
    assert tmu.stats["tll_accesses"] == accesses


# ---------------------------------------------------------------------------
# Streaming compilation invariant: for every spec the suite can produce
# and any chunk budget, the segment-fed compiled engine is bit-identical
# to the monolithic lowering — counters, per-tenant attribution, and the
# recorded gear history (boundaries that would split an MSHR-merge round
# cannot exist: rounds are atomic in the segmenter).
# ---------------------------------------------------------------------------
@settings(max_examples=15, deadline=None)
@given(data=st.data())
def test_chunked_compile_matches_monolithic(data):
    from repro_torch.core import SimConfig, Simulator, named_policy

    spec = _random_spec(data.draw)
    trace = lower_to_trace(spec)
    pol = named_policy(
        data.draw(st.sampled_from(["lru", "at+dbp", "at+bypass", "all"])))
    hw = SimConfig(n_cores=spec.n_cores, llc_bytes=256 * 1024,
                   llc_slices=8)
    mono = Simulator(hw, pol).run(trace)
    chunk = data.draw(st.sampled_from([1, 3, 17, 257, 4096, 1 << 20]))
    chunked = Simulator(hw, pol).run(lower_to_trace(spec),
                                     chunk_lines=chunk)
    for key in ("cycles", "hits", "mshr_hits", "cold_misses",
                "conflict_misses", "bypassed", "dram_lines", "writebacks",
                "dead_evictions", "flops"):
        assert getattr(mono, key) == getattr(chunked, key), key
    assert mono.tenants == chunked.tenants
    assert set(mono.history) == set(chunked.history)
    for k in mono.history:
        np.testing.assert_array_equal(mono.history[k], chunked.history[k])


# ---------------------------------------------------------------------------
# Static-verifier soundness (DESIGN.md §12): every spec the suite's
# builders can produce is error-free under the full rule inventory — no
# false positives on known-good specs, for any draw.
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_random_specs_carry_no_error_tier_diagnostics(data):
    from repro_torch.dataflows import verify_spec

    spec = _random_spec(data.draw)
    res = verify_spec(spec)
    assert not res.has_errors, res.summary()
