"""Integration tests: trace generation + cycle-level simulation.

Uses reduced workloads (small seq/heads) so the suite stays fast; the
paper-scale runs live in benchmarks/.  Then the port against the JAX
package: every field of every ``SimResult`` (counters, history, timeline,
per-tenant attribution) equal for the suite's policies on the smoke
scenarios, from both engines, from ``run_policies`` and from sequential
runs, and along the capacity axis.  Tolerance: exact, floats bit for bit.
"""

import functools

from _torch_same import assert_same
import numpy as np
import pytest

from repro.core import SimConfig as RefSimConfig
from repro.core import build_fa2_trace as ref_build_fa2_trace
from repro.core import named_policy as ref_named_policy
from repro.core import run_policies as ref_run_policies
from repro.core import run_policy as ref_run_policy
from repro.core.workloads import AttnWorkload as RefAttnWorkload
from repro.dataflows import lower_to_trace as ref_lower_to_trace
from repro.dataflows.suite import suite_case as ref_suite_case
# the port
from repro_torch.conformance import SMOKE_SCENARIOS
from repro_torch.core import SimConfig
from repro_torch.core import build_fa2_trace
from repro_torch.core import build_matmul_trace
from repro_torch.core import fa2_counts
from repro_torch.core import named_policy
from repro_torch.core import run_policies
from repro_torch.core import run_policy
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import SUITE_POLICIES
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows.suite import suite_case

TINY_TEMPORAL = AttnWorkload("tiny-t", n_q_heads=8, n_kv_heads=4,
                             head_dim=128, seq_len=1024,
                             group_alloc=TEMPORAL)
TINY_SPATIAL = AttnWorkload("tiny-s", n_q_heads=16, n_kv_heads=4,
                            head_dim=128, seq_len=1024,
                            group_alloc=SPATIAL)
CFG = SimConfig(llc_bytes=1 * 2**20, llc_slices=8)


def test_trace_structure_temporal():
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    assert tr.n_cores == 4
    # all cores have identical step counts (lockstep)
    lens = {len(s) for s in tr.core_steps}
    assert len(lens) == 1
    # K/V tensors registered with nAcc = n_q_tiles
    kv = [m for m in tr.tensors.values() if not m.bypass_all]
    assert all(m.n_acc == TINY_TEMPORAL.n_q_tiles for m in kv)
    assert len(kv) == 2 * TINY_TEMPORAL.n_kv_heads
    # Q/O tensors always bypass (paper §V-C)
    qo = [m for m in tr.tensors.values() if m.bypass_all]
    assert len(qo) == 2 * TINY_TEMPORAL.n_q_heads


def test_trace_structure_spatial():
    tr = build_fa2_trace(TINY_SPATIAL, n_cores=4)
    kv = [m for m in tr.tensors.values() if not m.bypass_all]
    # spatial: each line touched by every group member per q-tile pass
    assert all(m.n_acc == TINY_SPATIAL.n_q_tiles * 4 for m in kv)
    # exactly one lagging (non-leader) core per group
    assert sum(not ldr for ldr in tr.core_is_leader) == 1  # gs=4, 4 cores=1 group


def test_counts_match_trace_totals():
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    counts = fa2_counts(TINY_TEMPORAL, n_cores=4)
    kv_lines = sum(m.size_bytes // 128 for m in tr.tensors.values()
                   if not m.bypass_all)
    assert counts.n_kv_distinct == kv_lines
    # simulate and compare request totals
    res = run_policy(tr, named_policy("lru"), CFG, record_history=False)
    assert res.accesses == counts.n_kv_accesses + counts.n_bypass_lines
    assert res.flops == pytest.approx(counts.flops_total, rel=1e-6)
    assert tr.n_rounds == counts.n_rounds


def test_lru_thrashes_when_working_set_exceeds_cache():
    wl = TINY_TEMPORAL
    tr = build_fa2_trace(wl, n_cores=4)
    counts = fa2_counts(wl, n_cores=4)
    small = SimConfig(llc_bytes=256 * 1024, llc_slices=8)
    res = run_policy(tr, named_policy("lru"), small, record_history=False)
    assert counts.s_work_active > small.llc_bytes
    assert res.hit_rate < 0.05          # classic LRU thrashing (paper §III-C)


def test_at_beats_lru_under_thrashing():
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    small = SimConfig(llc_bytes=512 * 1024, llc_slices=8)
    lru = run_policy(tr, named_policy("lru"), small, record_history=False)
    at = run_policy(tr, named_policy("at"), small, record_history=False)
    assert at.hit_rate > lru.hit_rate + 0.05
    assert at.cycles < lru.cycles


def test_policies_converge_when_cache_fits():
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    big = SimConfig(llc_bytes=8 * 2**20, llc_slices=8)
    lru = run_policy(tr, named_policy("lru"), big, record_history=False)
    at = run_policy(tr, named_policy("at"), big, record_history=False)
    assert at.cycles == pytest.approx(lru.cycles, rel=0.02)


def test_dynamic_bypass_near_best_static():
    """Paper §VI-E1: dynamic bypassing within a few % of the best static
    gear."""
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    cfg = SimConfig(llc_bytes=512 * 1024, llc_slices=8)
    static = [run_policy(tr, named_policy(f"fix{g}"), cfg,
                         record_history=False).cycles for g in range(9)]
    dyn = run_policy(tr, named_policy("at+bypass"), cfg,
                     record_history=False).cycles
    assert dyn <= min(static) * 1.10


def test_spatial_blind_bypass_loses_intercore_reuse():
    """Paper §IV-E: bypassing blindly misses inter-core reuses and adds
    DRAM traffic; the gqa variant avoids this."""
    tr = build_fa2_trace(TINY_SPATIAL, n_cores=4)
    cfg = SimConfig(llc_bytes=256 * 1024, llc_slices=8, n_cores=4)
    blind = run_policy(tr, named_policy("fix6"), cfg, record_history=False)
    gqa = run_policy(tr, named_policy("fix6", gqa=True), cfg,
                     record_history=False)
    assert blind.dram_lines > gqa.dram_lines
    assert blind.cycles > gqa.cycles


def test_dbp_helps_multibatch():
    """Paper §VI-F: DBP clears retired batches' data; at+bypass+dbp ≥
    at+bypass in the 2-batch scenario at moderate cache size."""
    wl = AttnWorkload("tiny-mb", n_q_heads=4, n_kv_heads=4, head_dim=128,
                      seq_len=1024, group_alloc=TEMPORAL, n_batches=2)
    tr = build_fa2_trace(wl, n_cores=4)
    cfg = SimConfig(llc_bytes=1 * 2**20, llc_slices=8, n_cores=4)
    base = run_policy(tr, named_policy("at+bypass"), cfg,
                      record_history=False)
    dbp = run_policy(tr, named_policy("all"), cfg, record_history=False)
    assert dbp.dead_evictions > 0
    assert dbp.cycles <= base.cycles * 1.02


def test_matmul_trace_runs():
    tr = build_matmul_trace(512, 512, 512, tile=128, n_cores=4)
    res = run_policy(tr, named_policy("lru"), CFG, record_history=False)
    assert res.accesses > 0
    assert res.flops == pytest.approx(2 * 512**3, rel=1e-6)


def test_history_monotone_and_hit_rate_consistent():
    tr = build_fa2_trace(TINY_TEMPORAL, n_cores=4)
    res = run_policy(tr, named_policy("at"), CFG, record_history=True)
    cyc = res.history["cycles"]
    assert (np.diff(cyc) > 0).all()
    assert res.history["hits"].sum() == res.hits + res.mshr_hits


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _pair(key):
    ref_case, case = ref_suite_case(key), suite_case(key)
    return ref_case, ref_lower_to_trace(ref_case.spec), case, lower_to_trace(case.spec)


@pytest.mark.parametrize("scenario", SMOKE_SCENARIOS)
def test_sim_results_equal_the_reference(scenario):
    ref_case, ref_trace, case, trace = _pair(scenario)
    assert_same(ref_case.cfg, case.cfg, "SimConfig")
    want = ref_run_policies(ref_trace, [ref_named_policy(p, gqa=ref_case.gqa)
                                        for p in SUITE_POLICIES], ref_case.cfg,
                            record_history=True)
    got = run_policies(trace, [named_policy(p, gqa=case.gqa) for p in SUITE_POLICIES],
                       case.cfg, record_history=True)
    assert len(got) == len(SUITE_POLICIES)
    for pol, w, g in zip(SUITE_POLICIES, want, got):
        assert g.accesses > 0 and g.history and g.timeline
        assert_same(w, g, f"{scenario}/{pol}")
        # run_policies against a sequential run of the same policy
        assert_same(g, run_policy(trace, named_policy(pol, gqa=case.gqa), case.cfg),
                    f"{scenario}/{pol} sequential")


@pytest.mark.parametrize("scenario", ["matmul", "mlp-chain", "mt-spec-ssd"])
def test_step_engine_equals_compiled_and_the_reference(scenario):
    ref_case, ref_trace, case, trace = _pair(scenario)
    for pol in SUITE_POLICIES:
        want = ref_run_policy(ref_trace, ref_named_policy(pol, gqa=ref_case.gqa), ref_case.cfg,
                              engine="steps")
        steps = run_policy(trace, named_policy(pol, gqa=case.gqa), case.cfg, engine="steps")
        compiled = run_policy(trace, named_policy(pol, gqa=case.gqa), case.cfg)
        assert_same(want, steps, f"{scenario}/{pol} steps")
        for f in ("cycles", "hits", "mshr_hits", "cold_misses", "conflict_misses",
                  "bypassed", "dram_lines", "writebacks", "dead_evictions", "flops"):
            assert getattr(steps, f) == getattr(compiled, f), f
        assert steps.tenants == compiled.tenants
        assert set(steps.history) == set(compiled.history)
        for k in steps.history:
            np.testing.assert_array_equal(steps.history[k], compiled.history[k])


def test_capacity_axis_equals_the_reference():
    kw = dict(n_q_heads=8, n_kv_heads=4, head_dim=128, seq_len=1024)
    ref_trace = ref_build_fa2_trace(RefAttnWorkload("tiny-t", group_alloc=TEMPORAL, **kw),
                                    n_cores=4)
    trace = build_fa2_trace(AttnWorkload("tiny-t", group_alloc=TEMPORAL, **kw), n_cores=4)
    pols, caps = ["lru", "at+dbp", "all"], [128 * 1024, 512 * 1024, 2 * 2**20]
    want = ref_run_policies(ref_trace, pols, RefSimConfig(llc_slices=8), capacities=caps)
    got = run_policies(trace, pols, SimConfig(llc_slices=8), capacities=caps)
    assert [len(x) for x in got] == [len(caps)] * len(pols)
    assert_same(want, got, "capacity axis")
    assert got[0][0].hits != got[0][-1].hits      # the axis moves the result
