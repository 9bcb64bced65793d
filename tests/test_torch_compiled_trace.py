"""Compiled-trace IR: equivalence with the reference step engine, the
batched ``run_policies`` sweep API, and regression tests for the
simulator/cache fixes that rode along (MSHR write-intent merge, scalar
``seen_before`` broadcast, ``freq_ghz``-aware wall time)."""

import numpy as np
import pytest

# the port
from repro_torch.core import SimConfig
from repro_torch.core import SimResult
from repro_torch.core import Simulator
from repro_torch.core import Trace
from repro_torch.core import build_fa2_trace
from repro_torch.core import build_matmul_trace
from repro_torch.core import named_policy
from repro_torch.core import run_policies
from repro_torch.core import run_policy
from repro_torch.core.cache import COLD_MISS
from repro_torch.core.cache import CONFLICT_MISS
from repro_torch.core.cache import CacheGeometry
from repro_torch.core.cache import SharedLLC
from repro_torch.core.tmu import TMU
from repro_torch.core.tmu import TMUParams
from repro_torch.core.tmu import TensorMeta
from repro_torch.core.traces import Step
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import TEMPORAL

TINY_TEMPORAL = AttnWorkload("tiny-t", n_q_heads=8, n_kv_heads=4,
                             head_dim=128, seq_len=1024,
                             group_alloc=TEMPORAL)
TINY_SPATIAL = AttnWorkload("tiny-s", n_q_heads=16, n_kv_heads=4,
                            head_dim=128, seq_len=1024,
                            group_alloc=SPATIAL)
CFG = SimConfig(llc_bytes=512 * 1024, llc_slices=8)

COUNTERS = ("cycles", "hits", "mshr_hits", "cold_misses",
            "conflict_misses", "bypassed", "dram_lines", "writebacks",
            "dead_evictions", "flops")


def assert_results_equal(a: SimResult, b: SimResult) -> None:
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), f
    assert set(a.history) == set(b.history)
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k])


# ---------------------------------------------------------------------------
# engine equivalence: the compiled path must reproduce the step engine
# bit-for-bit on every trace shape and policy family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,gqa", [
    ("lru", False), ("at", False), ("at+dbp", False),
    ("at+bypass", False), ("all", False), ("fix4", True),
])
@pytest.mark.parametrize("trace_kind", ["matmul", "temporal", "spatial"])
def test_engines_bit_identical(trace_kind, policy, gqa):
    if trace_kind == "matmul":
        trace = build_matmul_trace(512, 512, 512, tile=128, n_cores=4)
    elif trace_kind == "temporal":
        trace = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    else:
        trace = build_fa2_trace(TINY_SPATIAL, n_cores=4)
    pol = named_policy(policy, gqa=gqa)
    ref = run_policy(trace, pol, CFG, engine="steps")
    got = run_policy(trace, pol, CFG, engine="compiled")
    assert_results_equal(ref, got)


@pytest.mark.parametrize("policy,per_tenant", [
    ("lru", False), ("at+dbp", False), ("at+bypass", False),
    ("at+bypass", True), ("all", True),
])
def test_engines_bit_identical_on_composite(policy, per_tenant):
    """Multi-tenant composites: the shared round ledger keeps both
    engines bit-identical including the per-tenant counter attribution
    and the (opt-in) per-tenant gear controller."""
    from repro_torch.core.workloads import DecodeWorkload
    from repro_torch.dataflows import (compose_time_sliced, decode_paged_spec,
                                 fa2_spec, lower_to_trace)
    wl = AttnWorkload("pf", 8, 4, 128, 512, group_alloc=TEMPORAL)
    dec = DecodeWorkload(n_seqs=8, seq_len=512, n_steps=3, retire_step=2,
                         n_short=4)
    trace = lower_to_trace(compose_time_sliced(
        [fa2_spec(wl, 4), decode_paged_spec(dec, 4)], quantum_rounds=8))
    pol = named_policy(policy, per_tenant_gears=per_tenant)
    ref = run_policy(trace, pol, CFG, engine="steps")
    got = run_policy(trace, pol, CFG, engine="compiled")
    assert_results_equal(ref, got)
    assert got.tenants and got.tenants == ref.tenants
    for f in ("hits", "mshr_hits", "cold_misses", "conflict_misses",
              "bypassed", "writebacks"):
        assert sum(t[f] for t in got.tenants.values()) == getattr(got, f)


def test_multibatch_dbp_equivalence():
    wl = AttnWorkload("tiny-mb", n_q_heads=4, n_kv_heads=4, head_dim=128,
                      seq_len=1024, group_alloc=TEMPORAL, n_batches=2)
    trace = build_fa2_trace(wl, n_cores=4)
    pol = named_policy("all")
    ref = run_policy(trace, pol, CFG, engine="steps")
    got = run_policy(trace, pol, CFG, engine="compiled")
    assert got.dead_evictions > 0      # the DBP path actually exercised
    assert_results_equal(ref, got)


# ---------------------------------------------------------------------------
# run_policies sweep API
# ---------------------------------------------------------------------------
def test_run_policies_matches_sequential():
    trace = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    pols = ["lru", "at", "at+dbp", "at+bypass", "all"]
    batch = run_policies(trace, pols, CFG, record_history=True)
    assert [r.policy for r in batch] == \
        [named_policy(p).name for p in pols]
    for p, got in zip(pols, batch):
        ref = run_policy(trace, named_policy(p), CFG)
        assert_results_equal(ref, got)


def test_run_policies_accepts_policy_configs():
    trace = build_matmul_trace(256, 256, 256, tile=128, n_cores=4)
    res = run_policies(trace, [named_policy("at", b_bits=4)], CFG)
    assert res[0].policy == "at"


def test_compiled_lowering_cached_on_trace():
    trace = build_matmul_trace(256, 256, 256, tile=128, n_cores=4)
    ct = trace.compiled(CFG.line_bytes)
    assert trace.compiled(CFG.line_bytes) is ct
    # plans are cached per geometry and shared across policies
    geom = CacheGeometry(CFG.llc_bytes, CFG.line_bytes, CFG.llc_assoc,
                         CFG.llc_slices)
    assert ct.plans_for(geom) is ct.plans_for(geom)
    other = CacheGeometry(2 * CFG.llc_bytes, CFG.line_bytes,
                          CFG.llc_assoc, CFG.llc_slices)
    assert ct.plans_for(other) is not ct.plans_for(geom)


def test_compiled_trace_structure():
    trace = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    ct = trace.compiled()
    assert ct.n_rounds == trace.n_rounds
    assert ct.round_off.shape == (ct.n_rounds + 1,)
    assert ct.round_off[-1] == ct.u_addrs.shape[0]
    # per-round line addresses are unique and ascending (merged MSHR view)
    for r in range(min(ct.n_rounds, 32)):
        a = ct.u_addrs[ct.round_off[r]:ct.round_off[r + 1]]
        assert (np.diff(a) > 0).all()
    # pre-merge counts can only exceed the merged ones
    assert (ct.n_acc_round >= np.diff(ct.round_off)).all()


# ---------------------------------------------------------------------------
# regression: MSHR merge must OR write intent across duplicates
# ---------------------------------------------------------------------------
def _one_tile_tensor(tid: int, base: int) -> TensorMeta:
    return TensorMeta(tensor_id=tid, base_addr=base, size_bytes=256,
                      tile_bytes=256, n_acc=1)


def _load_store_merge_trace() -> Trace:
    """Core 0 loads tile (tensor 0) while core 1 stores it in the same
    round; later rounds stream enough other tensors through a tiny cache
    to evict tensor 0's (dirty!) lines."""
    tensors = {i: _one_tile_tensor(i, (1 << 30) + 256 * i)
               for i in range(9)}
    core0 = [Step(loads=[(0, 0)])] + [Step(loads=[(i, 0)])
                                      for i in range(1, 9)]
    core1 = [Step(stores=[(0, 0)])]
    return Trace(name="load-store-merge", tensors=tensors,
                 core_steps=[core0, core1], core_group=[-1, -1],
                 core_is_leader=[True, True])


@pytest.mark.parametrize("engine", ["steps", "compiled"])
def test_mshr_merge_keeps_write_intent(engine):
    trace = _load_store_merge_trace()
    cfg = SimConfig(llc_bytes=1024, llc_assoc=2, llc_slices=4)
    res = run_policy(trace, named_policy("lru"), cfg, engine=engine)
    # the load+store merge is one MSHR hit, and the merged fill must be
    # dirty: evicting it later has to cost a writeback
    assert res.mshr_hits == 2
    assert res.writebacks > 0


def test_mismatched_line_bytes_rejected():
    trace = build_matmul_trace(256, 256, 256, tile=128, n_cores=4)
    with pytest.raises(ValueError, match="line_bytes"):
        run_policy(trace, named_policy("lru"), SimConfig(line_bytes=256))


# ---------------------------------------------------------------------------
# regression: scalar seen_before must broadcast like the other flags
# ---------------------------------------------------------------------------
def test_access_burst_scalar_seen_before():
    geom = CacheGeometry(64 * 1024, 128, 4, 4)
    a = np.arange(16, dtype=np.int64) * 128
    llc = SharedLLC(geom, named_policy("lru"))
    codes = llc.access_burst(a, seen_before=False)
    assert (codes == COLD_MISS).all()
    llc2 = SharedLLC(geom, named_policy("lru"))
    codes = llc2.access_burst(a, seen_before=True)
    assert (codes == CONFLICT_MISS).all()


# ---------------------------------------------------------------------------
# regression: SimResult wall time must honour SimConfig.freq_ghz
# ---------------------------------------------------------------------------
def test_time_ms_uses_config_frequency():
    trace = build_matmul_trace(256, 256, 256, tile=128, n_cores=4)
    res2 = run_policy(trace, named_policy("lru"), SimConfig(freq_ghz=2.0),
                      record_history=False)
    res1 = run_policy(trace, named_policy("lru"), SimConfig(freq_ghz=1.0),
                      record_history=False)
    assert res1.cycles == res2.cycles          # cycles are freq-agnostic
    assert res1.time_ms == pytest.approx(2 * res2.time_ms)
    assert res2.time_ms == pytest.approx(res2.cycles / 2.0e6)


# ---------------------------------------------------------------------------
# TMU batch interface
# ---------------------------------------------------------------------------
def test_tmu_on_access_batch_matches_sequential():
    params = TMUParams(d_lsb=0, d_msb=11, b_bits=3)
    metas = [TensorMeta(tensor_id=i, base_addr=(1 << 30) + i * 1024,
                        size_bytes=1024, tile_bytes=256, n_acc=3)
             for i in range(4)]
    seq_tmu = TMU(line_bytes=128, dead_fifo_depth=4, tile_entries=6,
                  params=params)
    bat_tmu = TMU(line_bytes=128, dead_fifo_depth=4, tile_entries=6,
                  params=params)
    for m in metas:
        seq_tmu.register(m)
        bat_tmu.register(m)

    rng = np.random.default_rng(0)
    tids = rng.integers(0, 4, size=200)
    tiles = rng.integers(0, 4, size=200)
    addrs = np.array([metas[t].tile_last_line(ti, 128)
                      for t, ti in zip(tids, tiles)], dtype=np.int64)
    tags = (addrs // 128) // 64
    naccs = np.full(200, 3, dtype=np.int64)

    for a, tg in zip(addrs, tags):
        seq_tmu.on_access(int(a), int(tg))
    bat_tmu.on_access_batch(tids, tiles, tags, naccs)

    assert seq_tmu.stats == bat_tmu.stats
    assert seq_tmu.dead_fifo.snapshot() == bat_tmu.dead_fifo.snapshot()
    assert seq_tmu._live == bat_tmu._live
    assert list(seq_tmu._live) == list(bat_tmu._live)   # LRU order too


# ---------------------------------------------------------------------------
# streaming (chunked) compilation: fixed-budget whole-round CSR segments
# fed incrementally must be bit-identical to the monolithic lowering
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_lines", [1, 7, 333, 1 << 20])
@pytest.mark.parametrize("policy", ["lru", "at+bypass", "all"])
def test_chunked_compile_bit_identical(policy, chunk_lines):
    pol = named_policy(policy)
    mono = run_policy(build_fa2_trace(TINY_TEMPORAL, n_cores=4), pol, CFG)
    # fresh trace: segments take the per-range build path (no cached
    # full lowering to slice)
    chunked = Simulator(CFG, pol).run(build_fa2_trace(TINY_TEMPORAL,
                                                      n_cores=4),
                                      chunk_lines=chunk_lines)
    assert_results_equal(mono, chunked)


def test_chunked_compile_slices_cached_lowering():
    """With the full lowering already cached, segments are sliced views
    of it — same counters, no rebuild."""
    trace = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    pol = named_policy("at+dbp")
    mono = Simulator(CFG, pol).run(trace)      # populates trace.compiled
    chunked = Simulator(CFG, pol).run(trace, chunk_lines=257)
    assert_results_equal(mono, chunked)


@pytest.mark.parametrize("chunk_lines", [1, 2, 3])
def test_chunked_split_around_mshr_merge_round(chunk_lines):
    """Chunk budgets small enough that every boundary candidate falls
    next to the load+store merge round: rounds are atomic in the
    segmenter, so the MSHR write-intent merge and the later dirty
    write-back survive any chunk size."""
    cfg = SimConfig(llc_bytes=1024, llc_assoc=2, llc_slices=4)
    mono = run_policy(_load_store_merge_trace(), named_policy("lru"), cfg)
    chunked = Simulator(cfg, named_policy("lru")).run(
        _load_store_merge_trace(), chunk_lines=chunk_lines)
    assert chunked.mshr_hits == 2 and chunked.writebacks > 0
    assert_results_equal(mono, chunked)


def test_chunked_compile_validation():
    trace = build_matmul_trace(256, 256, 256, tile=128, n_cores=4)
    with pytest.raises(ValueError, match="chunk_lines"):
        list(trace.compiled_segments(128, 0))
    with pytest.raises(ValueError, match="chunk_lines"):
        Simulator(SimConfig(), named_policy("lru")).run(
            trace, engine="steps", chunk_lines=64)


# ---------------------------------------------------------------------------
# run_policies capacity axis: [policy][capacity] nested sweep
# ---------------------------------------------------------------------------
def test_run_policies_capacity_axis():
    trace = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    pols = ["lru", "at+dbp"]
    caps = [256 * 1024, 512 * 1024]
    nested = run_policies(trace, pols, CFG, record_history=True,
                          capacities=caps)
    assert len(nested) == len(pols)
    assert all(len(per_pol) == len(caps) for per_pol in nested)
    for p, per_pol in zip(pols, nested):
        for c, got in zip(caps, per_pol):
            ref = run_policy(trace, named_policy(p),
                             SimConfig(llc_bytes=c,
                                       llc_slices=CFG.llc_slices))
            assert_results_equal(ref, got)
