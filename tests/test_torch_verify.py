"""The static verifier (DESIGN.md §12): rule inventory, registry
cleanliness, corruption-injection detection, the tag-aliasing
repro, the streaming online mode, and the ground-truth cross-check."""

import dataclasses
import random

import pytest

# the port
from repro_torch.core.simulator import SimConfig
from repro_torch.dataflows import SpecBuilder
from repro_torch.dataflows import assign_addresses
from repro_torch.dataflows import verify_metas
from repro_torch.dataflows import verify_spec
from repro_torch.dataflows.inject import EXPECTED_CODE
from repro_torch.dataflows.inject import LAYOUT_KINDS
from repro_torch.dataflows.inject import SPEC_KINDS
from repro_torch.dataflows.inject import eligible_tensors
from repro_torch.dataflows.inject import inject_layout
from repro_torch.dataflows.inject import inject_spec
from repro_torch.dataflows.ir import DataflowSpec
from repro_torch.dataflows.ir import StepSpec
from repro_torch.dataflows.ir import TensorSpec
from repro_torch.dataflows.suite import registry_keys
from repro_torch.dataflows.suite import suite_case
from repro_torch.dataflows.verify import ERROR_CODES
from repro_torch.dataflows.verify import RULES
from repro_torch.dataflows.verify import SpecVerifyError
from repro_torch.dataflows.verify import StreamVerifier
from repro_torch.dataflows.verify import cross_check_case
from repro_torch.dataflows.verify import predicted_retirements
from repro_torch.dataflows.verify import rules_inventory
from repro_torch.dataflows.verify import structural_diagnostics



# ---------------------------------------------------------------------------
# rule inventory
# ---------------------------------------------------------------------------
def test_rules_inventory_well_formed():
    inv = rules_inventory()
    codes = [r["code"] for r in inv]
    assert len(codes) == len(set(codes))
    assert all(r["severity"] in ("error", "warn", "info") for r in inv)
    assert all(r["assumption"] and r["consumer"] for r in inv)
    # every injection class maps to a registered code
    assert set(EXPECTED_CODE.values()) <= set(codes)
    assert set(ERROR_CODES) == {c for c, r in RULES.items()
                                if r.severity == "error"}


# ---------------------------------------------------------------------------
# no false positives: every registered scenario is error-free
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", registry_keys())
def test_registry_scenarios_error_free(key):
    case = suite_case(key, gate=False)
    res = verify_spec(case.spec, sim_cfg=case.cfg)
    assert not res.has_errors, res.summary()


# ---------------------------------------------------------------------------
# corruption injection: 100% detection by the correct code
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", registry_keys())
def test_injected_corruptions_all_detected(key):
    case = suite_case(key, gate=False)
    clean = verify_spec(case.spec, sim_cfg=case.cfg)
    rng = random.Random(key)          # str seeding is process-stable
    n_hit = 0
    for kind in SPEC_KINDS:
        code = EXPECTED_CODE[kind]
        # attribute detection to the corrupted tensor: skip tensors that
        # already carry the expected code in the clean run
        avoid = sorted({d.tensor for d in clean.by_code(code)
                        if d.tensor})
        got = inject_spec(case.spec, kind, rng, avoid=avoid)
        if got is None:          # no eligible tensor (e.g. all n_acc=1)
            assert not eligible_tensors(case.spec, kind, avoid)
            continue
        corrupted, inj = got
        assert not clean.located(code, inj.tensor), inj
        res = verify_spec(corrupted, sim_cfg=case.cfg)
        assert res.located(code, inj.tensor), (
            f"{key}/{kind}: {inj.description} not caught "
            f"({res.summary()})")
        n_hit += 1
    assert n_hit >= 3            # every scenario offers most classes


@pytest.mark.parametrize("key", ["matmul", "ssd-scan", "mt-spec-ssd"])
@pytest.mark.parametrize("kind", LAYOUT_KINDS)
def test_injected_layout_corruptions_detected(key, kind):
    case = suite_case(key, gate=False)
    metas = [m for _, m in sorted(assign_addresses(case.spec).items())]
    assert not verify_metas(case.spec, metas).has_errors
    rng = random.Random(11)
    bad, inj = inject_layout(case.spec, metas, kind, rng)
    res = verify_metas(case.spec, bad)
    assert res.located(inj.expected_code, inj.tensor), inj


# ---------------------------------------------------------------------------
# the tier decay, minimally: two bump-allocated generations whose
# tag[B_BITS-1:0] tier values alias
# ---------------------------------------------------------------------------
def test_tag_tier_aliasing_fires_on_minimal_generation_repro():
    # 128 KB LLC at 128 B lines, assoc 8 -> 128 sets, so one tag covers
    # 16 KB and the 2^3 tier values wrap every 128 KB: each 128 KB
    # generation covers ALL tier values and the next generation (bump
    # allocation, disjoint epoch) reuses every one of them.
    tile = 16 * 1024
    b = SpecBuilder("tier-decay", n_cores=1)
    for gen in range(2):
        b.tensor(f"kv{gen}", size_bytes=128 * 1024, tile_bytes=tile,
                 n_acc=1, epoch=(gen, gen))
    for gen in range(2):
        for t in range(8):
            b.step(0, loads=[(f"kv{gen}", t)])
    spec = b.build()
    res = verify_spec(spec, sim_cfg=SimConfig(n_cores=1,
                                              llc_bytes=128 * 1024))
    assert res.located("DCO202", "kv0")
    assert res.located("DCO202", "kv1")
    assert not res.has_errors
    # same layout, same-epoch generations: no aliasing to report
    b2 = SpecBuilder("tier-clean", n_cores=1)
    for gen in range(2):
        b2.tensor(f"kv{gen}", size_bytes=128 * 1024, tile_bytes=tile,
                  n_acc=1)
    for gen in range(2):
        for t in range(8):
            b2.step(0, loads=[(f"kv{gen}", t)])
    res2 = verify_spec(b2.build(), sim_cfg=SimConfig(n_cores=1,
                                                     llc_bytes=128 * 1024))
    assert not res2.by_code("DCO202")


# ---------------------------------------------------------------------------
# structural tier + gates
# ---------------------------------------------------------------------------
def _raw_spec(tensors, programs):
    n = len(programs)
    return DataflowSpec(name="raw", tensors=tensors,
                        core_programs=programs, core_group=[-1] * n,
                        core_is_leader=[True] * n)


def test_structural_codes_fire():
    t = TensorSpec(name="a", size_bytes=256, tile_bytes=128, n_acc=1)
    dup = _raw_spec([t, t], [[StepSpec(loads=(("a", 0),))]])
    assert "DCO001" in {d.code for d in structural_diagnostics(dup)}
    ghost = _raw_spec([t], [[StepSpec(loads=(("b", 0),))]])
    assert "DCO003" in {d.code for d in structural_diagnostics(ghost)}
    oob = _raw_spec([t], [[StepSpec(loads=(("a", 2),))]])
    assert "DCO004" in {d.code for d in structural_diagnostics(oob)}
    with pytest.raises(ValueError, match="DCO003.*raw"):
        ghost.validate()


def test_build_gate_rejects_inconsistent_annotations():
    b = SpecBuilder("gated", n_cores=1)
    b.tensor("x", size_bytes=256, tile_bytes=128, n_acc=7)
    b.step(0, loads=[("x", 0), ("x", 1)])
    with pytest.raises(SpecVerifyError) as ei:
        b.build()
    assert any(d.code == "DCO102" for d in ei.value.result.errors)
    spec = b.build(verify=False)     # escape hatch for injection paths
    assert spec.tensor("x").n_acc == 7


# ---------------------------------------------------------------------------
# ground-truth cross-check: predictions == measured TMU RETIRE events
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["matmul", "decode-paged", "ssd-scan"])
def test_cross_check_agrees_with_simulated_retirements(key):
    case = suite_case(key, gate=False)
    cc = cross_check_case(case)
    assert cc["agree"], cc
    assert cc["predicted_retirements"] > 0
    assert cc["predicted_excess"] == 0
    for row in cc["policies"]:
        assert row["measured_retirements"] == cc["predicted_retirements"]
        assert row["measured_excess"] == 0


def test_cross_check_catches_understated_nacc():
    case = suite_case("matmul", gate=False)
    rng = random.Random(5)
    corrupted, inj = inject_spec(case.spec, "nacc_under", rng)
    bad_case = dataclasses.replace(case, spec=corrupted)
    cc = cross_check_case(bad_case, policies=("lru",))
    # the analyzer now predicts the premature retirements the simulator
    # actually produces -> still in agreement, but flagged not-clean
    assert not cc["predicted_clean"]
    assert cc["predicted_excess"] > 0
    assert cc["agree"], cc
    # predictions themselves shifted against the clean spec
    assert (sum(predicted_retirements(corrupted).values())
            > sum(predicted_retirements(case.spec).values()))


# ---------------------------------------------------------------------------
# streaming online mode
# ---------------------------------------------------------------------------
def _replay_segments(n_requests=24, seed=3, chunk_lines=2048):
    from repro_torch.dataflows.stream import StreamEmitter
    from repro_torch.serve.replay import ReplayConfig, ReplayEngine
    from repro_torch.serve.traffic import RequestStream, TrafficConfig

    rcfg = ReplayConfig()
    eng = ReplayEngine(
        RequestStream(TrafficConfig(n_requests=n_requests, seed=seed)),
        rcfg)
    em = StreamEmitter("stream-verify", rcfg.n_cores,
                       chunk_lines=chunk_lines)
    return list(eng.drive(em))


def test_stream_verifier_clean_on_replay_emission():
    v = StreamVerifier("stream-verify")
    for seg in _replay_segments():
        v.on_segment(seg)
    res = v.finish()
    assert not res.has_errors, res.summary()
    assert v.segments > 1


def test_stream_verifier_catches_corrupted_segments():
    segs = _replay_segments()
    # corrupt the 2nd declared tensor's base (bump invariant) and a
    # later tensor's n_acc (overstated -> cleared before retiring)
    seen = 0
    nacc_tid = None
    for seg in segs:
        for i, meta in enumerate(seg.new_tensors):
            seen += 1
            if seen == 2:
                seg.new_tensors[i] = dataclasses.replace(
                    meta, base_addr=meta.base_addr // 2)
            elif seen == 3 and not meta.bypass_all:
                nacc_tid = meta.tensor_id
                seg.new_tensors[i] = dataclasses.replace(
                    meta, n_acc=meta.n_acc + 64)
    v = StreamVerifier("stream-verify")
    for seg in segs:
        v.on_segment(seg)
    res = v.finish()
    assert res.has_errors
    codes = set(res.codes())
    assert "DCO211" in codes
    if nacc_tid is not None:
        assert res.located("DCO102", f"t{nacc_tid}")


def test_run_replay_verify_flag_end_to_end():
    from repro_torch.serve.replay import run_replay
    from repro_torch.serve.traffic import TrafficConfig

    t = TrafficConfig(n_requests=16, seed=2)
    r = run_replay(t, "lru", SimConfig(), verify=True)
    assert r.diagnostics is not None
    assert not r.diagnostics.has_errors
    r2 = run_replay(t, "lru", SimConfig())
    assert r2.diagnostics is None
    # auditing the segment stream must not perturb the measurement
    assert (r2.sim.hits, r2.sim.cold_misses, r2.sim.conflict_misses,
            r2.sim.cycles) == (r.sim.hits, r.sim.cold_misses,
                               r.sim.conflict_misses, r.sim.cycles)
