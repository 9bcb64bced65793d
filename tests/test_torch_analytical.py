"""Tests for the analytical model (paper §V) and its validation metrics.
Then the port against the JAX package on the points the reference's tests
use (``tests/test_analytical.py``, ``tests/test_fit_batched.py``):
``kept_fraction``, ``predict``, ``predict_batch``, ``gear_trajectory``,
``fit_params``, ``r_squared`` and ``kendall_tau`` give the same floats, bit
for bit."""

import functools
import itertools

from _torch_same import assert_same
import numpy as np
import pytest

from repro.core import SimConfig as RefSimConfig
from repro.core import build_fa2_trace as ref_build_fa2_trace
from repro.core import fa2_counts as ref_fa2_counts
from repro.core import fit_params as ref_fit_params
from repro.core import gear_trajectory as ref_gear_trajectory
from repro.core import kendall_tau as ref_kendall_tau
from repro.core import kept_fraction as ref_kept_fraction
from repro.core import named_policy as ref_named_policy
from repro.core import predict as ref_predict
from repro.core import predict_batch as ref_predict_batch
from repro.core import r_squared as ref_r_squared
from repro.core import run_policies as ref_run_policies
from repro.core import run_policy as ref_run_policy
from repro.core.workloads import AttnWorkload as RefAttnWorkload
from repro.dataflows import lower_to_counts as ref_lower_to_counts
from repro.dataflows import lower_to_trace as ref_lower_to_trace
from repro.dataflows import suite_case as ref_suite_case
# the port
from repro_torch.core import SimConfig
from repro_torch.core import build_fa2_trace
from repro_torch.core import fa2_counts
from repro_torch.core import fit_params
from repro_torch.core import gear_trajectory
from repro_torch.core import kendall_tau
from repro_torch.core import kept_fraction
from repro_torch.core import named_policy
from repro_torch.core import predict
from repro_torch.core import predict_batch
from repro_torch.core import r_squared
from repro_torch.core import run_policies
from repro_torch.core import run_policy
from repro_torch.core.analytical import ModelParams
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import SUITE_POLICIES
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import suite_case

WL = AttnWorkload("tiny-t", n_q_heads=8, n_kv_heads=4, head_dim=128,
                  seq_len=1024, group_alloc=TEMPORAL)


def test_kept_fraction_lru_step_function():
    # LRU: all-or-nothing (paper §V-C)
    assert kept_fraction("lru", s_work=1000, s_llc=8000, assoc=8) == 1.0
    assert kept_fraction("lru", s_work=9000, s_llc=8000, assoc=8) == 0.0


def test_kept_fraction_at_skept_formula():
    # S_kept = S_work * M / 2^B <= S_LLC * (A-1)/A
    f = kept_fraction("at+dbp", s_work=8 * 2**20, s_llc=4 * 2**20, assoc=8,
                      b_bits=3)
    # S_eff = 3.5MB; tier = 1MB → M = 3 → f = 3/8
    assert f == pytest.approx(3 / 8)


def test_kept_fraction_optimal_bypass_uses_whole_cache():
    f_b = kept_fraction("bypass+dbp", s_work=8 * 2**20, s_llc=4 * 2**20,
                        assoc=8)
    f_at = kept_fraction("at+dbp", s_work=8 * 2**20, s_llc=4 * 2**20,
                         assoc=8)
    assert f_b > f_at                      # paper §VI-E3
    assert f_b == pytest.approx(0.5)


def test_kept_fraction_gqa_bypass_conservative():
    # under inter-core sharing the gqa variant pins nothing extra
    f = kept_fraction("bypass+dbp", s_work=8 * 2**20, s_llc=4 * 2**20,
                      assoc=8, gqa=True)
    assert f == 0.0
    f_all = kept_fraction("all", s_work=8 * 2**20, s_llc=4 * 2**20,
                          assoc=8, gqa=True)
    assert f_all == pytest.approx(3 / 8)   # falls back to at


def test_predict_kept_fraction_monotone_in_cache_size():
    """Bigger cache → larger kept fraction; thrashing end slower than the
    fits end.  (Total time is NOT strictly monotone by construction:
    Eq. 2 serializes t_hit while conflict misses overlap with compute.)"""
    counts = fa2_counts(WL, n_cores=4)
    hw = SimConfig(n_cores=4)
    preds = [predict(counts, s * 2**20, "at+dbp", hw)
             for s in (1, 2, 4, 16)]
    fracs = [p.kept_fraction for p in preds]
    assert all(a <= b for a, b in zip(fracs, fracs[1:]))
    assert fracs[-1] == 1.0


def test_predict_policy_ordering_under_thrash():
    # 16-core configuration (paper Table IV) → memory-bound regime, where
    # the policy ordering lru ≥ at ≥ optimal-bypass must hold
    counts = fa2_counts(WL, n_cores=16)
    hw = SimConfig(n_cores=16)
    llc = 512 * 1024
    lru = predict(counts, llc, "lru", hw).cycles
    at = predict(counts, llc, "at+dbp", hw).cycles
    opt = predict(counts, llc, "all", hw).cycles
    assert lru >= at >= opt


def test_metrics_perfect_and_degraded():
    x = np.array([1.0, 2.0, 3.0, 4.0])
    assert r_squared(x, x) == pytest.approx(1.0)
    assert kendall_tau(x, x) == pytest.approx(1.0)
    assert kendall_tau(-x, x) == pytest.approx(-1.0)
    assert abs(kendall_tau(np.array([1.0, 3.0, 2.0, 4.0]), x)) < 1.0


def test_kendall_tau_tie_adjusted():
    """τ-b: tied prediction pairs shrink the denominator instead of
    silently counting as disagreement (the paper's §VI-G1 τ = 0.934 is
    a τ-b figure).  One tied pair among n=4: 5 concordant pairs, none
    discordant → τ-b = 5/sqrt(5·6), NOT the τ-a value 5/6."""
    target = np.array([1.0, 2.0, 3.0, 4.0])
    pred = np.array([1.0, 1.0, 2.0, 3.0])
    assert kendall_tau(pred, target) == pytest.approx(
        5.0 / np.sqrt(5.0 * 6.0))
    # two independent ties, one in each input
    assert kendall_tau(np.array([1.0, 1.0, 2.0, 3.0]),
                       np.array([1.0, 2.0, 3.0, 3.0])) == pytest.approx(
        4.0 / np.sqrt(5.0 * 5.0))
    # a constant input carries no rank information; two constants agree
    assert kendall_tau(np.ones(4), target) == 0.0
    assert kendall_tau(np.ones(4), np.ones(4)) == 1.0
    # monotone agreement with ties must not be biased below 1-equivalent
    assert kendall_tau(pred, target) > (5.0 - 0.0) / 6.0


def test_closed_pollution_single_branch():
    """Behavior pin for the collapsed pollution condition: the two
    former ``n_batches > 1`` branches reduce to one ``"dbp" not in
    policy`` check — every policy either hit engine resolves must see
    exactly the pollution the original dual-branch logic assigned
    (including "all", whose closed §V-C treatment keeps the polluted
    stack)."""
    from repro_torch.core.analytical import _KNOWN_POLICIES
    counts = fa2_counts(WL.with_batches(2), n_cores=4)
    assert counts.n_batches == 2 and counts.reuse_profile is None
    hw = SimConfig(n_cores=4)
    llc = 2 * 2**20
    for policy in _KNOWN_POLICIES:
        # the original two-branch logic, verbatim
        pollution = 1.0
        if counts.n_batches > 1 and policy == "lru":
            pollution = 1.0 / counts.n_batches
        if counts.n_batches > 1 and "dbp" not in policy and policy != "lru":
            pollution = 1.0 / counts.n_batches
        expected = kept_fraction(policy, counts.s_work_active, llc,
                                 hw.llc_assoc, 3, "optimal", False,
                                 pollution)
        got = predict(counts, llc, policy, hw, model="closed")
        assert got.kept_fraction == pytest.approx(expected), policy


def test_model_validates_against_simulator():
    """Mini Fig-9: fit θ on a few sim points, check rank preservation."""
    hw = SimConfig(n_cores=4, llc_slices=8)
    pts = []
    for wl in (WL, AttnWorkload("tiny-s", 16, 4, 128, 1024,
                                group_alloc=SPATIAL)):
        tr = build_fa2_trace(wl, n_cores=4)
        counts = fa2_counts(wl, n_cores=4)
        gqa = wl.group_alloc == SPATIAL
        for llc in (512 * 1024, 1 * 2**20, 2 * 2**20):
            cfg = SimConfig(n_cores=4, llc_bytes=llc, llc_slices=8)
            for pol, sim_pol in (("lru", "lru"), ("at+dbp", "at"),
                                 ("all", "all")):
                res = run_policy(tr, named_policy(sim_pol, gqa=gqa), cfg,
                                 record_history=False)
                pts.append((counts, llc, pol, "optimal", gqa,
                            counts.n_rounds, res.cycles))
    params = fit_params(pts, hw)
    pred = np.array([predict(c, sz, p, hw, params, v, g, n_rounds=r).cycles
                     for (c, sz, p, v, g, r, _) in pts])
    target = np.array([t for *_, t in pts])
    r2 = r_squared(pred, target)
    tau = kendall_tau(pred, target)
    assert r2 > 0.80, f"R²={r2}"
    assert tau > 0.65, f"tau={tau}"


def test_fit_params_improves_loss():
    hw = SimConfig(n_cores=4, llc_slices=8)
    tr = build_fa2_trace(WL, n_cores=4)
    counts = fa2_counts(WL, n_cores=4)
    cfg = SimConfig(n_cores=4, llc_bytes=1 * 2**20, llc_slices=8)
    res = run_policy(tr, named_policy("lru"), cfg, record_history=False)
    pts = [(counts, 1 * 2**20, "lru", "optimal", False, counts.n_rounds,
            res.cycles)]
    fitted = fit_params(pts, hw)
    default_err = abs(predict(counts, 1 * 2**20, "lru", hw,
                              ModelParams(),
                              n_rounds=counts.n_rounds).cycles - res.cycles)
    fitted_err = abs(predict(counts, 1 * 2**20, "lru", hw, fitted,
                             n_rounds=counts.n_rounds).cycles - res.cycles)
    assert fitted_err <= default_err + 1e-6


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
KNOWN_POLICIES = ("lru", "at", "dbp", "at+dbp", "lru+bypass", "at+bypass", "bypass+dbp", "all")
MB = 2 ** 20


def test_kept_fraction_equals_the_reference():
    grid = itertools.product(KNOWN_POLICIES, (0, 1000, 3 * MB, 8 * MB, 9000 * 1024),
                             (512 * 1024, 4 * MB), (8, 16), (2, 3), ("optimal", "fix3"),
                             (False, True), (1.0, 0.5))
    n = 0
    for pol, work, llc, assoc, bits, variant, gqa, pollution in grid:
        args = (pol, work, llc, assoc, bits, variant, gqa, pollution)
        assert_same(ref_kept_fraction(*args), kept_fraction(*args), str(args))
        n += 1
    assert n == 8 * 5 * 2 * 2 * 2 * 2 * 2 * 2


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(0)
    pairs = [(np.array([1.0, 2.0, 3.0, 4.0]),) * 2,
             (np.array([1.0, 1.0, 2.0, 3.0]), np.array([1.0, 2.0, 3.0, 4.0])),
             (np.ones(4), np.ones(4)), (np.ones(4), np.arange(4.0)),
             (rng.normal(size=50), rng.normal(size=50)),
             (rng.integers(0, 5, 40).astype(float), rng.integers(0, 5, 40).astype(float))]
    for pred, target in pairs:
        assert_same(ref_r_squared(pred, target), r_squared(pred, target))
        assert_same(ref_kendall_tau(pred, target), kendall_tau(pred, target))


def _fa2_points(pkg):
    """The sweep of ``test_model_validates_against_simulator``."""
    if pkg == "ref":
        Wl, build, counts_of, Cfg, pol_of, run = (RefAttnWorkload, ref_build_fa2_trace,
                                                  ref_fa2_counts, RefSimConfig,
                                                  ref_named_policy, ref_run_policy)
    else:
        Wl, build, counts_of, Cfg, pol_of, run = (AttnWorkload, build_fa2_trace, fa2_counts,
                                                  SimConfig, named_policy, run_policy)
    pts = []
    for wl in (Wl("tiny-t", n_q_heads=8, n_kv_heads=4, head_dim=128, seq_len=1024,
                  group_alloc=TEMPORAL),
               Wl("tiny-s", 16, 4, 128, 1024, group_alloc=SPATIAL)):
        tr, counts = build(wl, n_cores=4), counts_of(wl, n_cores=4)
        gqa = wl.group_alloc == SPATIAL
        for llc in (512 * 1024, 1 * MB, 2 * MB):
            cfg = Cfg(n_cores=4, llc_bytes=llc, llc_slices=8)
            for pol, sim_pol in (("lru", "lru"), ("at+dbp", "at"), ("all", "all")):
                res = run(tr, pol_of(sim_pol, gqa=gqa), cfg, record_history=False)
                pts.append((counts, llc, pol, "optimal", gqa, counts.n_rounds, res.cycles))
    return pts, Cfg(n_cores=4, llc_slices=8)


def _suite_points(pkg):
    """The sweep of ``tests/test_fit_batched.py``'s fixture."""
    if pkg == "ref":
        case_of, counts_of, lower, run_all, pol_of = (ref_suite_case, ref_lower_to_counts,
                                                      ref_lower_to_trace, ref_run_policies,
                                                      ref_named_policy)
    else:
        case_of, counts_of, lower, run_all, pol_of = (suite_case, lower_to_counts,
                                                      lower_to_trace, run_policies, named_policy)
    cases = [case_of(k) for k in ("matmul", "decode-paged", "moe-ffn")]
    points, per_case = [], []
    for case in cases:
        counts = counts_of(case.spec)
        results = run_all(lower(case.spec), [pol_of(p, gqa=case.gqa) for p in SUITE_POLICIES],
                          case.cfg)
        per_case.append((case, counts))
        for pol, res in zip(SUITE_POLICIES, results):
            points.append((counts, case.cfg.llc_bytes, pol, "optimal", case.gqa,
                           counts.n_rounds, res.cycles))
    return points, cases[0].cfg, per_case


@functools.lru_cache(maxsize=None)
def sweeps(kind):
    make = _fa2_points if kind == "fa2" else _suite_points
    return make("ref"), make("port")


@pytest.mark.parametrize("model", ["profile", "closed"])
@pytest.mark.parametrize("kind", ["fa2", "suite"])
def test_fit_and_predict_equal_the_reference(kind, model):
    (ref_pts, ref_hw, *_), (pts, hw, *_) = sweeps(kind)
    assert_same([p[1:] for p in ref_pts], [p[1:] for p in pts], "simulated points")
    want, got = ref_fit_params(ref_pts, ref_hw, model=model), fit_params(pts, hw, model=model)
    assert_same(want, got, "fitted parameters")
    assert got != ModelParams()
    for (rc, sz, p, v, g, r, _), (c, *_rest) in zip(ref_pts, pts):
        for params_w, params_g in ((want, got), (None, None)):
            assert_same(ref_predict(rc, sz, p, ref_hw, params_w, v, g, n_rounds=r, model=model),
                        predict(c, sz, p, hw, params_g, v, g, n_rounds=r, model=model),
                        f"predict {p} {sz}")
    pred_w = np.array([ref_predict(c, sz, p, ref_hw, want, v, g, n_rounds=r, model=model).cycles
                       for (c, sz, p, v, g, r, _) in ref_pts])
    pred_g = np.array([predict(c, sz, p, hw, got, v, g, n_rounds=r, model=model).cycles
                       for (c, sz, p, v, g, r, _) in pts])
    target = np.array([t for *_, t in pts])
    assert_same(ref_r_squared(pred_w, target), r_squared(pred_g, target))
    assert_same(ref_kendall_tau(pred_w, target), kendall_tau(pred_g, target))


@pytest.mark.parametrize("model", ["profile", "closed"])
def test_predict_batch_equals_the_reference(model):
    (ref_pts, ref_hw, ref_cases), (pts, hw, per_case) = sweeps("suite")
    want_params = ref_fit_params(ref_pts, ref_hw, model=model)
    params = fit_params(pts, hw, model=model)
    for (rcase, rcounts), (case, counts) in zip(ref_cases, per_case):
        for ps in (SUITE_POLICIES, KNOWN_POLICIES):
            assert_same(ref_predict_batch(rcounts, rcase.cfg.llc_bytes, ps, ref_hw, want_params,
                                          "optimal", rcase.gqa, n_rounds=rcounts.n_rounds,
                                          model=model),
                        predict_batch(counts, case.cfg.llc_bytes, ps, hw, params, "optimal",
                                      case.gqa, n_rounds=counts.n_rounds, model=model),
                        f"{case.key} predict_batch")


@pytest.mark.parametrize("policy", ["at+bypass", "all", "lru+bypass", "bypass+dbp"])
def test_gear_trajectory_equals_the_reference(policy):
    (_, _, ref_cases), (_, _, per_case) = sweeps("suite")
    for (rcase, rcounts), (case, counts) in zip(ref_cases, per_case):
        for llc in (64 * 1024, case.cfg.llc_bytes, 8 * MB):
            want = ref_gear_trajectory(rcounts, llc, policy, rcase.cfg)
            got = gear_trajectory(counts, llc, policy, case.cfg)
            assert got.shape == (counts.n_rounds,)
            assert_same(want, got, f"{case.key} {llc}")
