"""Reuse-profile engine: lowering invariants, a trace-measured stack
distance cross-check, the policy-transform model, and the accuracy win
over the closed forms (DESIGN.md §5)."""

import numpy as np
import pytest

# the port
from repro_torch.core import SimConfig
from repro_torch.core import fit_params
from repro_torch.core import gear_trajectory
from repro_torch.core import named_policy
from repro_torch.core import predict
from repro_torch.core import run_policies
from repro_torch.core import run_policy
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import DecodeWorkload
from repro_torch.core.workloads import PrefixShareWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import SSDScanWorkload
from repro_torch.core.workloads import SpecDecodeWorkload
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import decode_paged_spec
from repro_torch.dataflows import fa2_spec
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_reuse_profile
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import matmul_spec
from repro_torch.dataflows import mlp_chain_spec
from repro_torch.dataflows import prefix_share_spec
from repro_torch.dataflows import spec_decode_spec
from repro_torch.dataflows import ssd_scan_spec

TINY_T = AttnWorkload("tiny-t", 8, 4, 128, 1024, group_alloc=TEMPORAL)
TINY_S = AttnWorkload("tiny-s", 16, 4, 128, 1024, group_alloc=SPATIAL)
TINY_MB = AttnWorkload("tiny-mb", 4, 4, 128, 1024, group_alloc=TEMPORAL,
                       n_batches=2)
MINI_DECODE = DecodeWorkload(n_seqs=8, seq_len=1024, n_steps=4,
                             retire_step=2, n_short=4)
MINI_SPECDEC = SpecDecodeWorkload(n_seqs=4, target_len=256, draft_len=128,
                                  gamma=2, n_verify=2)
MINI_SSD = SSDScanWorkload(n_seqs=4, n_chunks=4, n_heads=4, d_head=64,
                           d_state=64, chunk_len=32)
MINI_PFX = PrefixShareWorkload(n_reqs=4, prefix_len=512, suffix_len=256,
                               n_steps=2)


# ---------------------------------------------------------------------------
# Lowering invariants against the closed-form counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    fa2_spec(TINY_T, 4), fa2_spec(TINY_S, 4), fa2_spec(TINY_MB, 4),
    matmul_spec(512, 512, 512, n_cores=4),
    decode_paged_spec(MINI_DECODE, 4),
    spec_decode_spec(MINI_SPECDEC, 4),
    ssd_scan_spec(MINI_SSD, 4),
    prefix_share_spec(MINI_PFX, 4),
], ids=lambda s: s.name)
def test_profile_mass_identities(spec):
    counts = lower_to_counts(spec)
    prof = counts.reuse_profile
    assert prof is not None
    # total reuse mass == temporal + inter-core reuse of the counts
    assert (prof.total_reuse_mass()
            == counts.n_temporal_reuse + counts.n_intercore_reuse)
    # cold mass == distinct reuse-carrier lines; bypass traffic matches
    assert int(prof.cold_round.sum()) == counts.n_kv_distinct
    assert prof.footprint_lines() == counts.n_kv_distinct
    assert (int(prof.byp_cold_round.sum() + prof.byp_rep_round.sum())
            == counts.n_bypass_lines)
    assert float(prof.flops_round.sum()) == counts.flops_total
    assert prof.n_rounds == counts.n_rounds
    # distances are well-formed
    assert (prof.e_dlive >= 0).all() and (prof.e_ddead >= 0).all()
    assert (prof.e_mass > 0).all()
    assert prof.e_dlive[prof.e_mshr].sum() == 0


# ---------------------------------------------------------------------------
# Cross-check: an independent LRU-stack walk over the lowered *trace*
# measures the same distances the profile derives from the schedule
# ---------------------------------------------------------------------------
def _measure_trace_distances(trace, dbp=False):
    """Tile-granular move-to-front stack walk (O(n²) oracle).

    ``dbp=True`` removes a tile from the stack the moment its load count
    reaches ``n_acc`` (TMU retirement) — measured distances then equal
    the profile's live component.
    """
    hist = {}
    stack = []                        # most recent first: (tid, tile)
    mass = {tid: m.tile_bytes // trace.line_bytes
            for tid, m in trace.tensors.items()}
    loads = {}
    for r in range(trace.n_rounds):
        this_round = {}
        for c, steps in enumerate(trace.core_steps):
            if r >= len(steps):
                continue
            step = steps[r]
            for (tid, tile), is_store in (
                    [(ld, False) for ld in step.loads]
                    + [(s, True) for s in step.stores]):
                if trace.tensors[tid].bypass_all:
                    continue
                key = (tid, tile)
                if not is_store:
                    loads[key] = loads.get(key, 0) + 1
                if key in this_round:
                    hist[0] = hist.get(0, 0) + mass[tid]
                    continue
                this_round[key] = True
                if key in stack:
                    d = sum(mass[k[0]] for k in
                            stack[:stack.index(key)])
                    hist[d] = hist.get(d, 0) + mass[tid]
                    stack.remove(key)
                retired = dbp and loads.get(key, 0) >= \
                    trace.tensors[tid].n_acc
                if not retired:
                    stack.insert(0, key)
    return hist


@pytest.mark.parametrize("dbp", [False, True], ids=["lru", "dbp"])
def test_trace_measured_distances_match_profile(dbp):
    """Simulator-trace-observed stack distances land in exactly the
    profile's histogram buckets (full distance without DBP, live
    distance with)."""
    spec = decode_paged_spec(MINI_DECODE, 4)
    prof = lower_to_reuse_profile(spec)
    trace = lower_to_trace(spec)
    measured = _measure_trace_distances(trace, dbp=dbp)
    assert measured == prof.histogram(dbp=dbp)


def test_epoch_aware_dead_mass():
    """Retired-generation lines show up as dead pollution, not reuse:
    the multi-batch dataflow carries dead mass in its distances and DBP
    strictly shortens them; the speculative-decoding draft windows all
    retire."""
    prof_mb = lower_to_reuse_profile(fa2_spec(TINY_MB, 4))
    assert int(prof_mb.e_ddead.sum()) > 0
    full = sum(d * m for d, m in prof_mb.histogram().items())
    live = sum(d * m for d, m in prof_mb.histogram(dbp=True).items())
    assert live < full

    spec = spec_decode_spec(MINI_SPECDEC, 4)
    prof = lower_to_reuse_profile(spec)
    # every reuse-carrier tile eventually reaches its nAcc (accurate
    # lifetimes), and the persistent target stream carries the retired
    # draft windows as dead pollution in its reuse windows
    assert prof.t_dies.all()
    t_sel = np.array([prof.tensor_names[t].startswith(("TK", "TV"))
                      for t in prof.e_tensor])
    assert int(prof.e_ddead[t_sel].sum()) > 0


# ---------------------------------------------------------------------------
# Profile model: transforms and orderings
# ---------------------------------------------------------------------------
def test_profile_model_monotone_in_cache_size():
    counts = lower_to_counts(fa2_spec(TINY_T, 4))
    hw = SimConfig(n_cores=4)
    fracs = [predict(counts, s * 2**20, "at+dbp", hw,
                     model="profile").kept_fraction
             for s in (1, 2, 4, 16)]
    assert all(a <= b + 1e-12 for a, b in zip(fracs, fracs[1:]))
    assert fracs[-1] == pytest.approx(1.0)


def test_profile_model_mechanism_orderings():
    """DBP never hurts (dead mass leaves the stack); anti-thrashing
    never loses to LRU in the thrashing regime."""
    counts = lower_to_counts(fa2_spec(TINY_T, 16))
    hw = SimConfig(n_cores=16)
    llc = 512 * 1024
    lru = predict(counts, llc, "lru", hw, model="profile")
    at = predict(counts, llc, "at+dbp", hw, model="profile")
    dbp = predict(counts, llc, "dbp", hw, model="profile")
    assert dbp.n_hit >= lru.n_hit
    assert at.n_hit >= lru.n_hit
    assert lru.cycles >= at.cycles


def test_profile_mshr_mass_always_hits():
    """Same-round co-streaming merges in the MSHRs under every policy —
    even full static bypass cannot lose that mass."""
    counts = lower_to_counts(fa2_spec(TINY_S, 4))
    prof = counts.reuse_profile
    mshr_mass = int(prof.e_mass[prof.e_mshr].sum())
    assert mshr_mass > 0
    hw = SimConfig(n_cores=4)
    pred = predict(counts, 256 * 1024, "bypass+dbp", hw,
                   bypass_variant="fix8", model="profile")
    assert pred.n_hit >= mshr_mass


def test_closed_fallback_without_profile():
    """model="profile" on counts lowered without a profile falls back to
    the closed forms bit-for-bit."""
    spec = fa2_spec(TINY_T, 4)
    bare = lower_to_counts(spec, with_profile=False)
    assert bare.reuse_profile is None
    hw = SimConfig(n_cores=4)
    a = predict(bare, 2**20, "at+dbp", hw, model="profile")
    b = predict(bare, 2**20, "at+dbp", hw, model="closed")
    assert a == b


def test_counts_equality_ignores_profile():
    spec = fa2_spec(TINY_T, 4)
    assert lower_to_counts(spec) == lower_to_counts(spec,
                                                    with_profile=False)


# ---------------------------------------------------------------------------
# Dirty-lifetime write-back model + gear-transient emulation (the PR-4
# blind spots: ROADMAP "write-back modeling" / "dynamic-gear transients")
# ---------------------------------------------------------------------------
def test_dirty_lifetime_profile_fields():
    """Structural invariants of the new dirty-lifetime facts."""
    prof = lower_to_reuse_profile(ssd_scan_spec(MINI_SSD, 4))
    # running states are produced by stores: dirty cold fills exist
    assert prof.t_cold_store.any()
    assert prof.e_store.shape == prof.e_mass.shape
    assert (prof.t_tail_dlive >= 0).all() and (prof.t_tail_ddead >= 0).all()
    assert (prof.t_last_round >= prof.t_cold_round).all()
    # every reuse entry's previous access precedes (or shares) its round
    assert (prof.e_prev_round <= prof.e_round).all()
    assert (prof.e_tile >= 0).all()
    assert prof.e_tile.max() < prof.t_mass.shape[0]


@pytest.mark.parametrize("spec,llc_kb", [
    (ssd_scan_spec(MINI_SSD, 4), 128),
    (mlp_chain_spec(m=512, dims=(256, 256, 256, 256), n_cores=4), 128),
    (prefix_share_spec(MINI_PFX, 4), 128),
    (spec_decode_spec(MINI_SPECDEC, 4), 128),
], ids=["ssd-scan", "mlp-chain", "prefix-share", "spec-decode"])
@pytest.mark.parametrize("pol", ["lru", "at", "at+dbp"])
def test_writeback_volume_matches_simulator(spec, llc_kb, pol):
    """The dirty-lifetime model's predicted write-back volume tracks the
    simulator's dirty-eviction count — per scenario and per policy,
    including the DBP case the old reuse-miss-fraction scaling got wrong
    (retired dirty tiles still write back when the dead FIFO evicts
    them)."""
    counts = lower_to_counts(spec)
    trace = lower_to_trace(spec)
    hw = SimConfig(n_cores=4, llc_bytes=llc_kb * 1024, llc_slices=8)
    res = run_policy(trace, named_policy(pol), hw, record_history=False)
    pred = predict(counts, hw.llc_bytes, pol, hw, n_rounds=counts.n_rounds)
    if res.writebacks == 0:
        # scenarios with no (evicted) dirty reuse carriers must not
        # invent write-back traffic
        assert pred.n_wb <= 0.02 * counts.n_kv_distinct
    else:
        rel = abs(pred.n_wb - res.writebacks) / res.writebacks
        assert rel <= 0.35, (pred.n_wb, res.writebacks)


def test_closed_model_carries_no_writeback_term():
    counts = lower_to_counts(ssd_scan_spec(MINI_SSD, 4))
    hw = SimConfig(n_cores=4)
    assert predict(counts, 2**20, "lru", hw, model="closed").n_wb == 0.0


@pytest.mark.parametrize("spec,llc_kb", [
    (fa2_spec(TINY_T, 4), 512),
    (mlp_chain_spec(m=512, dims=(256, 256, 256, 256), n_cores=4), 128),
    (prefix_share_spec(MINI_PFX, 4), 128),
], ids=["fa2", "mlp-chain", "prefix-share"])
def test_gear_trajectory_matches_history(spec, llc_kb):
    """The window-by-window §IV-D emulation reproduces the simulator's
    recorded gear trajectory: same ramp (mean absolute gear gap under a
    step) and a final gear within one step of the per-slice mean."""
    counts = lower_to_counts(spec)
    trace = lower_to_trace(spec)
    hw = SimConfig(n_cores=4, llc_bytes=llc_kb * 1024, llc_slices=8)
    res = run_policy(trace, named_policy("at+bypass"), hw,
                     record_history=True)
    g = gear_trajectory(counts, hw.llc_bytes, "at+bypass", hw)
    prof = counts.reuse_profile
    assert g.shape == (prof.n_rounds,)
    # history records only non-empty rounds; align the emulation to them
    req = (np.bincount(prof.e_round, minlength=prof.n_rounds)
           + prof.cold_round + prof.byp_cold_round + prof.byp_rep_round)
    emu = g[np.nonzero(req)[0]]
    sim = res.history["gear"]
    assert emu.shape[0] == sim.shape[0]
    assert abs(float(emu[-1]) - float(sim[-1])) <= 1.0
    assert np.abs(emu - sim).mean() <= 0.75


def test_gear_trajectory_requires_bypass_policy():
    counts = lower_to_counts(fa2_spec(TINY_T, 4))
    with pytest.raises(ValueError, match="does not bypass"):
        gear_trajectory(counts, 2**20, "lru")


def test_ssd_scan_dbp_win():
    """The scenario's reason to exist: retired chunk states are MRU dead
    mass under LRU; DBP frees them and keeps the live generation
    resident (sim-level pin of the suite-gated win)."""
    trace = lower_to_trace(ssd_scan_spec(MINI_SSD, 4))
    hw = SimConfig(n_cores=4, llc_bytes=64 * 1024, llc_slices=8)
    lru = run_policy(trace, named_policy("lru"), hw, record_history=False)
    dbp = run_policy(trace, named_policy("at+dbp"), hw,
                     record_history=False)
    assert dbp.hits + dbp.mshr_hits > lru.hits + lru.mshr_hits
    assert lru.cycles / dbp.cycles > 1.15


def test_prefix_share_intercore_mass():
    """The shared prefix shows up as the §IV-E population: same-round
    MSHR merges plus lagged-rank inter-core reuse riding LLC storage."""
    prof = lower_to_reuse_profile(prefix_share_spec(MINI_PFX, 4))
    assert int(prof.e_mass[prof.e_mshr].sum()) > 0
    assert int(prof.e_mass[prof.e_intercore].sum()) > 0
    # private suffixes are single-core streams: their entries carry no
    # inter-core mass
    suf = np.array([prof.tensor_names[t].startswith(("Ksuf", "Vsuf"))
                    for t in prof.e_tensor])
    assert not prof.e_intercore[suf].any()


# ---------------------------------------------------------------------------
# The refactor's reason to exist: the profile engine out-predicts the
# closed forms on the scenarios the ROADMAP called out (matmul-style
# weight-stationary reuse)
# ---------------------------------------------------------------------------
def test_profile_model_beats_closed_on_matmul_class():
    policies = ("lru", "at", "at+dbp", "all")
    hw = SimConfig(n_cores=4, llc_bytes=256 * 1024, llc_slices=8)
    pts = []
    for spec in (matmul_spec(512, 512, 512, n_cores=4),
                 mlp_chain_spec(m=512, dims=(256, 256, 256, 256),
                                n_cores=4)):
        trace = lower_to_trace(spec)
        counts = lower_to_counts(spec)
        for pol, res in zip(policies, run_policies(
                trace, [named_policy(p) for p in policies], hw)):
            pts.append((counts, hw.llc_bytes, pol, "optimal", False,
                        counts.n_rounds, res.cycles))

    errs = {}
    for model in ("closed", "profile"):
        params = fit_params(pts, hw, model=model)
        errs[model] = np.mean([
            abs(predict(c, sz, p, hw, params, v, g, n_rounds=r,
                        model=model).cycles - t) / t
            for (c, sz, p, v, g, r, t) in pts])
    assert errs["profile"] < errs["closed"], errs
    assert errs["profile"] < 0.25, errs
