"""The port's dataflow stack against the JAX package's, on the same inputs:
every registered scenario builds the same spec; its lowerings (trace,
compiled trace, counts, plan, reuse profile, TMU metadata) are equal; the
static verifier gives the same diagnostics (codes and text) on clean specs,
on each corruption ``inject.py`` makes and on streamed replay segments; the
address allocators hand out the same regions; and the port's artifact cache
never reads an artifact the reference stored.  Tolerance: exact."""

import dataclasses
import functools
import random

from _torch_same import assert_same
from _torch_same import plain
import numpy as np
import pytest

from repro.dataflows import artifacts as ref_artifacts
from repro.dataflows import assign_addresses as ref_assign_addresses
from repro.dataflows import cross_check_case as ref_cross_check_case
from repro.dataflows import lower_to_counts as ref_lower_to_counts
from repro.dataflows import lower_to_plan as ref_lower_to_plan
from repro.dataflows import lower_to_reuse_profile as ref_lower_to_reuse_profile
from repro.dataflows import lower_to_trace as ref_lower_to_trace
from repro.dataflows import predicted_retirements as ref_predicted_retirements
from repro.dataflows import tmu_metadata as ref_tmu_metadata
from repro.dataflows import verify_metas as ref_verify_metas
from repro.dataflows import verify_spec as ref_verify_spec
from repro.dataflows.addr import make_allocator as ref_make_allocator
from repro.dataflows.inject import inject_layout as ref_inject_layout
from repro.dataflows.inject import inject_spec as ref_inject_spec
from repro.dataflows.stream import StreamEmitter as RefStreamEmitter
from repro.dataflows.suite import build_suite as ref_build_suite
from repro.dataflows.suite import suite_case as ref_suite_case
from repro.dataflows.verify import StreamVerifier as RefStreamVerifier
from repro.serve.replay import ReplayConfig as RefReplayConfig
from repro.serve.replay import ReplayEngine as RefReplayEngine
from repro.serve.traffic import RequestStream as RefRequestStream
from repro.serve.traffic import TrafficConfig as RefTrafficConfig
# the port
from repro_torch.core import hopper_pin_budget_bytes
from repro_torch.dataflows import SUITE_POLICIES
from repro_torch.dataflows import artifacts
from repro_torch.dataflows import assign_addresses
from repro_torch.dataflows import build_suite
from repro_torch.dataflows import cross_check_case
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_plan
from repro_torch.dataflows import lower_to_reuse_profile
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import predicted_retirements
from repro_torch.dataflows import registry_keys
from repro_torch.dataflows import tmu_metadata
from repro_torch.dataflows import verify_metas
from repro_torch.dataflows import verify_spec
from repro_torch.dataflows.addr import ALLOCATOR_NAMES
from repro_torch.dataflows.addr import make_allocator
from repro_torch.dataflows.inject import LAYOUT_KINDS
from repro_torch.dataflows.inject import SPEC_KINDS
from repro_torch.dataflows.inject import inject_layout
from repro_torch.dataflows.inject import inject_spec
from repro_torch.dataflows.stream import StreamEmitter
from repro_torch.dataflows.suite import suite_case
from repro_torch.dataflows.verify import StreamVerifier
from repro_torch.serve.replay import ReplayConfig
from repro_torch.serve.replay import ReplayEngine
from repro_torch.serve.traffic import RequestStream
from repro_torch.serve.traffic import TrafficConfig

KEYS = registry_keys()


@functools.lru_cache(maxsize=None)
def cases(key):
    """The reference's and the port's case for one key, ungated (the gate
    runs the verifier, which the tests below compare on its own)."""
    return ref_suite_case(key, gate=False), suite_case(key, gate=False)


def diagnostics(res):
    """A VerifyResult as a user sees it: each finding's fields and text, and
    the uncapped count of each rule."""
    return [(d.to_dict(), d.format()) for d in res.diagnostics], res.rule_counts


# ---------------------------------------------------------------------------
# specs and lowerings
# ---------------------------------------------------------------------------
def test_registry_keys_match():
    from repro.dataflows import registry_keys as ref_registry_keys
    assert KEYS == ref_registry_keys()
    assert SUITE_POLICIES == ("lru", "at", "at+bypass", "at+dbp", "all")


@pytest.mark.parametrize("key", KEYS)
def test_scenario_builds_the_same_spec(key):
    ref, port = cases(key)
    assert_same(ref, port, key)
    assert port.fingerprint == ref.fingerprint       # a content hash of every field


@pytest.mark.parametrize("key", KEYS)
def test_lowerings_equal_the_reference(key):
    ref, port = cases(key)
    ref_trace, trace = ref_lower_to_trace(ref.spec), lower_to_trace(port.spec)
    assert_same(ref_trace, trace, f"{key} trace")
    assert_same(ref_trace.compiled(128), trace.compiled(128), f"{key} compiled")
    assert_same(ref_lower_to_counts(ref.spec), lower_to_counts(port.spec), f"{key} counts")
    assert_same(ref_lower_to_counts(ref.spec, with_profile=False),
                lower_to_counts(port.spec, with_profile=False), f"{key} closed counts")
    assert_same(ref_lower_to_reuse_profile(ref.spec), lower_to_reuse_profile(port.spec),
                f"{key} profile")
    assert_same(ref_tmu_metadata(ref.spec), tmu_metadata(port.spec), f"{key} metadata")
    assert_same(ref_assign_addresses(ref.spec), assign_addresses(port.spec), f"{key} layout")


@pytest.mark.parametrize("key", KEYS)
def test_plans_equal_the_reference(key):
    """``lower_to_plan`` lowers through the orchestrator, whose port adds
    the Hopper shared-memory budget: the plan for the arguments the
    lowering passes stays the reference's, at the default tier and at a
    budget the flash kernel's planner would hand it."""
    ref, port = cases(key)
    budgets = (64 * 1024, 1 << 20, hopper_pin_budget_bytes(128, 2))
    for budget in budgets:
        for kw in ({}, dict(b_bits=2, reserve_fraction=0.25)):
            assert_same(ref_lower_to_plan(ref.spec, budget, **kw),
                        lower_to_plan(port.spec, budget, **kw), f"{key} plan {budget} {kw}")


def test_build_suite_equals_the_reference():
    """The whole registry through the verification gate."""
    assert_same(ref_build_suite(), build_suite(), "suite")


# ---------------------------------------------------------------------------
# the static verifier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", KEYS)
def test_verifier_diagnostics_equal_the_reference(key):
    """Clean specs, then each spec-level corruption of ``inject.py`` drawn
    from the same seed: the same corrupted spec and the same findings."""
    ref, port = cases(key)
    want = ref_verify_spec(ref.spec, sim_cfg=ref.cfg)
    got = verify_spec(port.spec, sim_cfg=port.cfg)
    assert diagnostics(got) == diagnostics(want)
    assert got.summary() == want.summary() and got.to_dict() == want.to_dict()
    assert predicted_retirements(port.spec) == ref_predicted_retirements(ref.spec)
    n_injected = 0
    for kind in SPEC_KINDS:
        rw = ref_inject_spec(ref.spec, kind, random.Random(f"{key}/{kind}"))
        rg = inject_spec(port.spec, kind, random.Random(f"{key}/{kind}"))
        assert (rw is None) == (rg is None), kind
        if rw is None:
            continue
        assert_same(rw, rg, f"{key}/{kind}")
        bad_want = ref_verify_spec(rw[0], sim_cfg=ref.cfg)
        bad_got = verify_spec(rg[0], sim_cfg=port.cfg)
        assert diagnostics(bad_got) == diagnostics(bad_want), kind
        assert bad_got.located(rg[1].expected_code, rg[1].tensor), kind
        n_injected += 1
    assert n_injected >= 3


@pytest.mark.parametrize("kind", LAYOUT_KINDS)
@pytest.mark.parametrize("key", ["matmul", "ssd-scan", "mt-spec-ssd", "serve-replay-pooled"])
def test_layout_injection_diagnostics_equal_the_reference(key, kind):
    ref, port = cases(key)
    ref_metas = [m for _, m in sorted(ref_assign_addresses(ref.spec).items())]
    metas = [m for _, m in sorted(assign_addresses(port.spec).items())]
    assert diagnostics(verify_metas(port.spec, metas)) == \
        diagnostics(ref_verify_metas(ref.spec, ref_metas))
    rw = ref_inject_layout(ref.spec, ref_metas, kind, random.Random(11))
    rg = inject_layout(port.spec, metas, kind, random.Random(11))
    assert_same(rw, rg, f"{key}/{kind}")
    got = verify_metas(port.spec, rg[0])
    assert diagnostics(got) == diagnostics(ref_verify_metas(ref.spec, rw[0]))
    assert got.located(rg[1].expected_code, rg[1].tensor)


def _segments(pkg, allocator, seed=3):
    if pkg == "ref":
        rcfg = RefReplayConfig(allocator=allocator)
        eng = RefReplayEngine(RefRequestStream(RefTrafficConfig(n_requests=24, seed=seed)), rcfg)
        alloc = None if allocator == "bump" else ref_make_allocator(allocator)
        em = RefStreamEmitter("stream-verify", rcfg.n_cores, chunk_lines=2048, allocator=alloc)
    else:
        rcfg = ReplayConfig(allocator=allocator)
        eng = ReplayEngine(RequestStream(TrafficConfig(n_requests=24, seed=seed)), rcfg)
        alloc = None if allocator == "bump" else make_allocator(allocator)
        em = StreamEmitter("stream-verify", rcfg.n_cores, chunk_lines=2048, allocator=alloc)
    return list(eng.drive(em))


def _corrupt(segs):
    """The reference test's corruption: the 2nd declared tensor's base
    halved, the 3rd's ``n_acc`` overstated."""
    seen = 0
    for seg in segs:
        for i, meta in enumerate(seg.new_tensors):
            seen += 1
            if seen == 2:
                seg.new_tensors[i] = dataclasses.replace(meta, base_addr=meta.base_addr // 2)
            elif seen == 3 and not meta.bypass_all:
                seg.new_tensors[i] = dataclasses.replace(meta, n_acc=meta.n_acc + 64)
    return segs


@pytest.mark.parametrize("corrupted", [False, True], ids=["clean", "corrupted"])
@pytest.mark.parametrize("allocator", ["bump", "pooled"])
def test_stream_verifier_equals_the_reference(allocator, corrupted):
    ref_segs, segs = _segments("ref", allocator), _segments("port", allocator)
    assert_same(ref_segs, segs, "segments")
    if corrupted:
        ref_segs, segs = _corrupt(ref_segs), _corrupt(segs)
    want = RefStreamVerifier("stream-verify", allocator=allocator)
    got = StreamVerifier("stream-verify", allocator=allocator)
    for a, b in zip(ref_segs, segs):
        want.on_segment(a)
        got.on_segment(b)
    rw, rg = want.finish(), got.finish()
    assert diagnostics(rg) == diagnostics(rw)
    assert got.segments == want.segments > 1
    assert rg.has_errors == rw.has_errors
    if allocator == "bump":
        assert rg.has_errors == corrupted


@pytest.mark.parametrize("key", ["matmul", "decode-paged"])
def test_cross_check_equals_the_reference(key):
    ref, port = cases(key)
    assert_same(ref_cross_check_case(ref), cross_check_case(port), key)


# ---------------------------------------------------------------------------
# address allocators
# ---------------------------------------------------------------------------
def _drive(make, seed, n_ops=500):
    """A seeded alloc/free sequence; every region, counter and error."""
    rng = np.random.default_rng(seed)
    al = make()
    live, out = [], []
    for _ in range(n_ops):
        op = rng.random()
        try:
            if op < 0.55 or not live:
                size = int(rng.integers(1, 40)) * int(rng.choice([64, 512, 2048]))
                tile = int(rng.choice([64, 256, 1024, 2048]))
                align = None if rng.random() < 0.8 else int(rng.choice([128, 4096]))
                r = al.alloc(size, tile, align=align)
                live.append(r)
                out.append(("alloc", r.base, r.size_bytes, r.end))
            elif op < 0.95:
                r = live.pop(int(rng.integers(len(live))))
                al.free(r)
                out.append(("free", r.base))
            else:
                r = live[int(rng.integers(len(live)))]
                al.free(type(r)(base=r.base + 64, size_bytes=r.size_bytes))
                out.append(("bad free", r.base))
        except ValueError as e:
            out.append(("error", str(e)))
        out.append(("stats", sorted(al.stats().items())))
    return out


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", ALLOCATOR_NAMES)
def test_allocators_equal_the_reference(name, seed):
    kw = dict(page_bytes=2048, pool_pages=64)
    want = _drive(lambda: ref_make_allocator(name, **kw), seed)
    got = _drive(lambda: make_allocator(name, **kw), seed)
    assert got == want
    assert any(x[0] == "alloc" for x in got)
    with pytest.raises(ValueError) as e_ref:
        ref_make_allocator("slab")
    with pytest.raises(ValueError) as e_port:
        make_allocator("slab")
    assert str(e_port.value) == str(e_ref.value)


# ---------------------------------------------------------------------------
# the artifact cache
# ---------------------------------------------------------------------------
def stored_arrays(ct):
    """What the artifact cache keeps of a compiled trace (not its key)."""
    return ([getattr(ct, name) for name in artifacts._CT_ARRAYS],
            ct.line_bytes, ct.n_rounds, ct.n_seen_lines)


def test_port_never_reads_a_reference_artifact(tmp_path, monkeypatch):
    """Both packages pointed at one directory: what the reference stores
    for a spec the port misses (its salt names the package), and what the
    port stores loads back bit-identical.  Without the environment
    variable the two default to directories of their own."""
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_ARTIFACTS", raising=False)
    ref, port = cases("fa2-temporal")
    assert port.fingerprint == ref.fingerprint
    key = artifacts.compiled_trace_key(port.fingerprint, 128)

    ref_trace = ref_lower_to_trace(ref.spec)
    ref_trace.compiled(128)                          # the reference stores its artifacts
    ref_lower_to_counts(ref.spec)
    stored = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert {n.split("-")[0] for n in stored} >= {"trace", "profile"}
    assert ref_artifacts.load_compiled_trace(key) is not None
    assert artifacts.code_version() != ref_artifacts.code_version()
    assert artifacts.load_compiled_trace(key) is None
    assert artifacts.load_reuse_profile(port.fingerprint) is None

    trace = lower_to_trace(port.spec)
    cold = trace.compiled(128)
    counts = lower_to_counts(port.spec)
    mine = sorted(p.name for p in tmp_path.glob("*.npz") if p.name not in stored)
    assert mine and all(artifacts.code_version() in n for n in mine)
    assert_same(stored_arrays(artifacts.load_compiled_trace(key)), stored_arrays(cold),
                "stored trace")
    assert_same(artifacts.load_reuse_profile(port.fingerprint), counts.reuse_profile,
                "stored profile")
    assert_same(ref_trace.compiled(128), cold, "compiled trace")

    monkeypatch.delenv("REPRO_ARTIFACT_DIR")
    assert artifacts.cache_dir() != ref_artifacts.cache_dir()
    assert artifacts.cache_dir().parent == ref_artifacts.cache_dir().parent


def test_plain_form_sees_a_one_bit_change():
    """The comparison the tests above rest on is not blind: one float bit,
    one array element or one field flips it."""
    _, port = cases("matmul")
    counts = lower_to_counts(port.spec)
    a = plain(counts)
    bumped = dataclasses.replace(counts, flops_total=np.nextafter(counts.flops_total, np.inf))
    assert plain(bumped) != a
    prof = counts.reuse_profile
    e = prof.e_mass.copy()
    e[len(e) // 2] += 1
    assert plain(dataclasses.replace(counts, reuse_profile=dataclasses.replace(prof, e_mass=e))) != a
    with pytest.raises(AssertionError, match="n_rounds"):
        assert_same(counts, dataclasses.replace(counts, n_rounds=counts.n_rounds + 1))
