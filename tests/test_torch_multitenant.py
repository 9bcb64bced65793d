"""Multi-tenant time-slicing (DESIGN.md §8.4): composition invariants,
per-tenant simulator attribution and conservation, per-slice gear
control in both engines and in the analytical emulation."""

import numpy as np
import pytest

# the port
from repro_torch.core import SimConfig
from repro_torch.core import gear_trajectory
from repro_torch.core import named_policy
from repro_torch.core import predict
from repro_torch.core import run_policy
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import DecodeWorkload
from repro_torch.core.workloads import SSDScanWorkload
from repro_torch.core.workloads import SpecDecodeWorkload
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import compose_time_sliced
from repro_torch.dataflows import decode_paged_spec
from repro_torch.dataflows import fa2_spec
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_plan
from repro_torch.dataflows import lower_to_reuse_profile
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import spec_decode_spec
from repro_torch.dataflows import ssd_scan_spec
from repro_torch.dataflows import suite_case
from repro_torch.dataflows import tenant_regions
from repro_torch.dataflows.compose import REGION_ALIGN_BYTES

PF = AttnWorkload("pf", 8, 4, 128, 512, group_alloc=TEMPORAL)
DEC = DecodeWorkload(n_seqs=8, seq_len=512, n_steps=3, retire_step=2,
                     n_short=4)
SPD = SpecDecodeWorkload(n_seqs=4, target_len=256, draft_len=128, gamma=2,
                        n_verify=2)
SSD = SSDScanWorkload(n_seqs=4, n_chunks=4, n_heads=4, d_head=64,
                      d_state=64, chunk_len=32)
HW = SimConfig(n_cores=4, llc_bytes=512 * 1024, llc_slices=8)


def _mix(quantum=8):
    return compose_time_sliced(
        [fa2_spec(PF, 4), decode_paged_spec(DEC, 4)],
        quantum_rounds=quantum)


# ---------------------------------------------------------------------------
# Composition invariants
# ---------------------------------------------------------------------------
def test_composite_is_valid_and_conserves_schedule():
    a, b = fa2_spec(PF, 4), decode_paged_spec(DEC, 4)
    comp = _mix()
    comp.validate()
    assert comp.n_tenants == 2
    assert comp.n_rounds == a.n_rounds + b.n_rounds
    # per-tensor access totals are exactly the tenants' own totals
    per = comp.per_tensor_line_accesses()
    for i, sp in enumerate((a, b)):
        own = sp.per_tensor_line_accesses()
        for name, tot in own.items():
            assert per[f"t{i}.{name}"] == tot
    assert comp.total_flops() == a.total_flops() + b.total_flops()


def test_tenant_regions_disjoint_and_aligned():
    comp = _mix()
    regions = tenant_regions(comp)
    assert [n for n, _, _ in regions] == comp.tenant_names
    for _, base, end in regions:
        assert base % REGION_ALIGN_BYTES == 0
        assert end > base
    for (_, _, e0), (_, b1, _) in zip(regions, regions[1:]):
        assert e0 <= b1                       # disjoint, ascending
    # round-trip: every tensor's addresses fall inside its tenant's region
    from repro_torch.dataflows import assign_addresses
    metas = assign_addresses(comp)
    for tid, t in enumerate(comp.tensors):
        ten = comp.tenant_of_tensor[t.name]
        _, base, end = regions[ten]
        assert base <= metas[tid].base_addr
        assert metas[tid].end_addr <= end


def test_all_four_lowerings_work_on_composite():
    comp = _mix()
    trace = lower_to_trace(comp)
    counts = lower_to_counts(comp)
    prof = lower_to_reuse_profile(comp)
    plan = lower_to_plan(comp, 1 << 20)
    assert trace.n_tenants == 2 and trace.tenant_region_starts() is not None
    assert counts.reuse_profile is not None
    assert prof.n_tenants == 2
    # profile mass identities hold on the composite exactly as on any
    # spec (the §V-C scalars stay marginals of the interleaved profile)
    assert (prof.total_reuse_mass()
            == counts.n_temporal_reuse + counts.n_intercore_reuse)
    assert prof.footprint_lines() == counts.n_kv_distinct
    # the plan covers the namespaced union tensor set
    assert len(plan.entries) == len(comp.tensors)


def test_composite_profile_masses_recount_per_tenant():
    """The interleaving-aware recount: per-tenant masses of the
    composite profile sum to the composite totals, and each tenant's
    cold mass equals its stand-alone footprint (interleaving moves
    reuse distances, never cold mass)."""
    a, b = fa2_spec(PF, 4), decode_paged_spec(DEC, 4)
    comp = _mix()
    prof = lower_to_reuse_profile(comp)
    e_ten = prof.e_tenant
    per_t = [int(prof.e_mass[e_ten == i].sum()) for i in range(2)]
    assert sum(per_t) == prof.total_reuse_mass()
    cold_t = prof.cold_rt.sum(axis=0)
    assert int(cold_t.sum()) == int(prof.cold_round.sum())
    for i, sp in enumerate((a, b)):
        own = lower_to_reuse_profile(sp)
        assert int(cold_t[i]) == own.footprint_lines()
        # reuse mass is invariant under interleaving too: the same
        # accesses repeat, only their distances change
        assert per_t[i] == own.total_reuse_mass()


def test_compose_rejects_bad_inputs():
    with pytest.raises(ValueError, match="at least one"):
        compose_time_sliced([])
    with pytest.raises(ValueError, match="quantum"):
        compose_time_sliced([fa2_spec(PF, 4)], quantum_rounds=0)


# ---------------------------------------------------------------------------
# Simulator: per-tenant attribution + conservation
# ---------------------------------------------------------------------------
TENANT_KEYS = ("hits", "mshr_hits", "cold_misses", "conflict_misses",
               "bypassed", "writebacks")


def assert_tenant_conservation(res):
    assert res.tenants
    for key in TENANT_KEYS:
        total = sum(t[key] for t in res.tenants.values())
        assert total == getattr(res, key), key


@pytest.mark.parametrize("pol", ["lru", "at+dbp", "at+bypass", "all"])
def test_per_tenant_counters_conserve(pol):
    trace = lower_to_trace(_mix())
    res = run_policy(trace, named_policy(pol), HW, record_history=False)
    assert_tenant_conservation(res)
    # both tenants actually produce traffic
    assert all(t["hits"] + t["cold_misses"] > 0
               for t in res.tenants.values())


def test_single_tenant_trace_has_no_tenant_counters():
    res = run_policy(lower_to_trace(fa2_spec(PF, 4)), named_policy("lru"),
                     HW, record_history=False)
    assert res.tenants == {}


# ---------------------------------------------------------------------------
# Per-slice gear control: simulator and analytical emulation
# ---------------------------------------------------------------------------
def test_per_tenant_gears_diverge_and_match_model():
    """One feedback loop per tenant: the simulator's opt-in per-tenant
    controller lets the tenants' gears diverge, and the per-slice
    trajectory emulation reproduces each tenant's trajectory against
    ``history["tenant_gear"]`` (final gear ±1, bounded mean gap)."""
    comp = _mix()
    trace = lower_to_trace(comp)
    counts = lower_to_counts(comp)
    pol = named_policy("at+bypass", per_tenant_gears=True)
    res = run_policy(trace, pol, HW, record_history=True)
    sim = res.history["tenant_gear"]
    assert sim.shape[1] == 2

    g = gear_trajectory(counts, HW.llc_bytes, "at+bypass", HW,
                        per_tenant=True)
    prof = counts.reuse_profile
    assert g.shape == (prof.n_rounds, 2)
    req = (np.bincount(prof.e_round, minlength=prof.n_rounds)
           + prof.cold_round + prof.byp_cold_round + prof.byp_rep_round)
    emu = g[np.nonzero(req)[0]]
    assert emu.shape[0] == sim.shape[0]
    for i in range(2):
        assert abs(float(emu[-1, i]) - float(sim[-1, i])) <= 1.0
        assert np.abs(emu[:, i] - sim[:, i]).mean() <= 1.0


def test_per_tenant_gear_requires_composite():
    counts = lower_to_counts(fa2_spec(PF, 4))
    with pytest.raises(ValueError, match="multi-tenant"):
        gear_trajectory(counts, HW.llc_bytes, "at+bypass", HW,
                        per_tenant=True)


def test_global_controller_unchanged_by_flag_on_single_tenant():
    """per_tenant_gears on a single-tenant trace is bit-identical to
    the global controller (the flag only engages with a tenant map)."""
    trace = lower_to_trace(fa2_spec(PF, 4))
    a = run_policy(trace, named_policy("at+bypass"), HW)
    b = run_policy(trace, named_policy("at+bypass",
                                       per_tenant_gears=True), HW)
    assert a.cycles == b.cycles and a.hits == b.hits
    np.testing.assert_array_equal(a.history["gear"], b.history["gear"])


# ---------------------------------------------------------------------------
# Analytical model: per-tenant breakdowns
# ---------------------------------------------------------------------------
def test_prediction_tenant_breakdowns_conserve():
    comp = compose_time_sliced(
        [spec_decode_spec(SPD, 4), ssd_scan_spec(SSD, 4)],
        quantum_rounds=8)
    counts = lower_to_counts(comp)
    for pol in ("lru", "at+dbp", "at+bypass"):
        pred = predict(counts, HW.llc_bytes, pol, HW,
                       n_rounds=counts.n_rounds)
        assert pred.n_hit_tenant is not None
        assert sum(pred.n_hit_tenant) == pytest.approx(pred.n_hit)
        assert sum(pred.n_miss_tenant) == pytest.approx(
            pred.n_cold + pred.n_cf)
        assert sum(pred.n_wb_tenant) == pytest.approx(pred.n_wb)


def test_single_tenant_prediction_has_no_breakdowns():
    counts = lower_to_counts(fa2_spec(PF, 4))
    pred = predict(counts, HW.llc_bytes, "lru", HW)
    assert pred.n_hit_tenant is None


# ---------------------------------------------------------------------------
# Suite mixes: registered and in the contended regime
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["mt-prefill-decode", "mt-spec-ssd"])
def test_suite_mixes_registered(key):
    case = suite_case(key, n_cores=4)
    assert case.spec.n_tenants == 2
    assert case.expect_dbp_win


def test_mt_mix_dbp_win_mini():
    """The mixes' reason to exist at miniature scale: dead pages /
    retired windows of both tenants pollute the shared LLC under LRU;
    DBP clears each tenant's region."""
    comp = compose_time_sliced(
        [spec_decode_spec(SPD, 4), ssd_scan_spec(SSD, 4)],
        quantum_rounds=8)
    trace = lower_to_trace(comp)
    hw = SimConfig(n_cores=4, llc_bytes=128 * 1024, llc_slices=8)
    lru = run_policy(trace, named_policy("lru"), hw, record_history=False)
    dbp = run_policy(trace, named_policy("at+dbp"), hw,
                     record_history=False)
    assert dbp.hits + dbp.mshr_hits > lru.hits + lru.mshr_hits
    assert lru.cycles > dbp.cycles
    assert_tenant_conservation(dbp)
