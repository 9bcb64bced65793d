"""θ-batched calibration and batched prediction (DESIGN.md §8.5): the
vectorized ``fit_params`` grid search and ``predict_batch`` must be
bit-identical to the sequential reference scan / per-policy ``predict``
calls they replace — same floats, same tie-breaks, same NaN handling."""

import pytest

# the port
from repro_torch.core import ModelParams
from repro_torch.core import SimConfig
from repro_torch.core import named_policy
from repro_torch.core import predict
from repro_torch.core import predict_batch
from repro_torch.core import run_policies
from repro_torch.core.analytical import _fit_params_reference
from repro_torch.core.analytical import fit_params
from repro_torch.dataflows import SUITE_POLICIES
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import suite_case

#: a dynamic-gear scenario, a pure-streaming one, and a DBP one — the
#: three fit regimes (static, dynamic replay, closed fallback) are all on
CASE_KEYS = ("matmul", "decode-paged", "moe-ffn")


@pytest.fixture(scope="module")
def fit_fixture():
    cases = [suite_case(k) for k in CASE_KEYS]
    hw = cases[0].cfg
    points, per_case = [], {}
    for case in cases:
        counts = lower_to_counts(case.spec)
        results = run_policies(
            lower_to_trace(case.spec),
            [named_policy(p, gqa=case.gqa) for p in SUITE_POLICIES],
            case.cfg)
        per_case[case.key] = (case, counts)
        for pol, res in zip(SUITE_POLICIES, results):
            points.append((counts, case.cfg.llc_bytes, pol, "optimal",
                           case.gqa, counts.n_rounds, res.cycles))
    return hw, points, per_case


@pytest.mark.parametrize("model", ["closed", "profile"])
def test_fit_params_bit_identical_to_reference(fit_fixture, model):
    hw, points, _ = fit_fixture
    ref = _fit_params_reference(points, hw, model=model)
    got = fit_params(points, hw, model=model)
    assert (got.theta1, got.theta2, got.theta3, got.lam,
            got.round_overhead) == (ref.theta1, ref.theta2, ref.theta3,
                                    ref.lam, ref.round_overhead)


def test_fit_params_deterministic_and_loso_shares_cache(fit_fixture):
    """Refitting (the LOSO loop's access pattern: overlapping point
    subsets, same candidate grids) reuses the per-point caches and stays
    exactly reproducible."""
    hw, points, _ = fit_fixture
    full = fit_params(points, hw, model="profile")
    assert fit_params(points, hw, model="profile") == full
    subset = points[:-len(SUITE_POLICIES)]       # leave one scenario out
    loso = fit_params(subset, hw, model="profile")
    assert loso == _fit_params_reference(subset, hw, model="profile")


def test_fit_params_empty_points_returns_default():
    assert fit_params([], SimConfig(), model="profile") == ModelParams()
    assert (_fit_params_reference([], SimConfig(), model="profile")
            == ModelParams())


@pytest.mark.parametrize("model", ["profile", "closed"])
def test_predict_batch_matches_predict(fit_fixture, model):
    hw, points, per_case = fit_fixture
    params = fit_params(points, hw, model=model)
    for case, counts in per_case.values():
        singles = [predict(counts, case.cfg.llc_bytes, p, hw, params,
                           "optimal", case.gqa, n_rounds=counts.n_rounds,
                           model=model)
                   for p in SUITE_POLICIES]
        batched = predict_batch(counts, case.cfg.llc_bytes,
                                SUITE_POLICIES, hw, params, "optimal",
                                case.gqa, n_rounds=counts.n_rounds,
                                model=model)
        assert batched == singles          # full Prediction equality


def test_predict_batch_rejects_unknown_model(fit_fixture):
    hw, _, per_case = fit_fixture
    case, counts = next(iter(per_case.values()))
    with pytest.raises(KeyError):
        predict_batch(counts, case.cfg.llc_bytes, ["lru"], hw,
                      model="quantum")
