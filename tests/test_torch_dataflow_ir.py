"""Dataflow IR: bit-identical equivalence with the pre-refactor builders,
counts/trace consistency, the four new scenarios through both engines and
the analytical model, plan lowering, and the suite registry."""

from pathlib import Path
import types

import numpy as np
import pytest

# the port
from repro_torch.core import DecodeWorkload
from repro_torch.core import MoEWorkload
from repro_torch.core import SimConfig
from repro_torch.core import SpecDecodeWorkload
from repro_torch.core import build_fa2_trace
from repro_torch.core import build_matmul_trace
from repro_torch.core import fa2_counts
from repro_torch.core import named_policy
from repro_torch.core import predict
from repro_torch.core import run_policies
from repro_torch.core import run_policy
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import SPATIAL
from repro_torch.core.workloads import TEMPORAL
from repro_torch.core.workloads import get_workload
from repro_torch.dataflows import SUITE_POLICIES
from repro_torch.dataflows import build_suite
from repro_torch.dataflows import decode_paged_spec
from repro_torch.dataflows import fa2_spec
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_plan
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import matmul_spec
from repro_torch.dataflows import mlp_chain_spec
from repro_torch.dataflows import moe_ffn_spec
from repro_torch.dataflows import spec_decode_spec
from repro_torch.dataflows import suite_case
from repro_torch.dataflows import tmu_metadata
from repro_torch.dataflows import transformer_layer_spec
from repro_torch.dataflows.ir import SpecBuilder


def _builders_for_the_port():
    """The frozen hand-written builders of ``tests/_reference_builders.py``,
    run on the port's classes (their own module imports the JAX
    package's ``Trace`` and ``Step``, which never compare equal to the
    port's)."""
    path = Path(__file__).with_name("_reference_builders.py")
    src = path.read_text().replace("from repro.", "from repro_torch.")
    mod = types.ModuleType("_torch_reference_builders")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


_REF = _builders_for_the_port()
build_fa2_trace_ref = _REF.build_fa2_trace_ref
build_matmul_trace_ref = _REF.build_matmul_trace_ref
fa2_counts_ref = _REF.fa2_counts_ref

TINY_T = AttnWorkload("tiny-t", 8, 4, 128, 1024, group_alloc=TEMPORAL)
TINY_S = AttnWorkload("tiny-s", 16, 4, 128, 1024, group_alloc=SPATIAL)
TINY_MB = AttnWorkload("tiny-mb", 4, 4, 128, 1024, group_alloc=TEMPORAL,
                       n_batches=2)
CFG4 = SimConfig(n_cores=4, llc_bytes=512 * 1024, llc_slices=8)

COUNTERS = ("cycles", "hits", "mshr_hits", "cold_misses",
            "conflict_misses", "bypassed", "dram_lines", "writebacks",
            "dead_evictions", "flops")

MINI_DECODE = DecodeWorkload(n_seqs=8, seq_len=1024, n_steps=4,
                             retire_step=2, n_short=4)
MINI_MOE = MoEWorkload(n_experts=8, n_hot=4, d_model=256, d_ff=256,
                       tile_bytes=8192, n_steps=6, warm_steps=2)
MOE_CFG = SimConfig(n_cores=8, llc_bytes=256 * 1024, llc_slices=8)
MINI_SPECDEC = SpecDecodeWorkload(n_seqs=4, target_len=384, draft_len=128,
                                  gamma=2, n_verify=3)


def assert_traces_identical(ref, got):
    assert got.name == ref.name
    assert got.core_group == ref.core_group
    assert got.core_is_leader == ref.core_is_leader
    assert set(got.tensors) == set(ref.tensors)
    for tid in ref.tensors:
        assert got.tensors[tid] == ref.tensors[tid], f"tensor {tid}"
    for c, (sr, sg) in enumerate(zip(ref.core_steps, got.core_steps)):
        assert sr == sg, f"core {c} schedule differs"


def trace_line_accesses(trace):
    """Per-tensor (line_reads, line_writes) by walking the trace steps —
    the trace-derived side of the counts pin."""
    out = {tid: [0, 0] for tid in trace.tensors}
    for steps in trace.core_steps:
        for step in steps:
            for tid, _ in step.loads:
                out[tid][0] += trace.tensors[tid].tile_bytes // trace.line_bytes
            for tid, _ in step.stores:
                out[tid][1] += trace.tensors[tid].tile_bytes // trace.line_bytes
    return {tid: tuple(v) for tid, v in out.items()}


# ---------------------------------------------------------------------------
# Pin: IR-lowered FA2/matmul traces are bit-identical to the pre-refactor
# hand-written builders (frozen in tests/_reference_builders.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wl,n_cores", [
    (TINY_T, 4), (TINY_S, 4), (TINY_MB, 4),
    (get_workload("gemma3-27b"), 16),
    (get_workload("qwen3-8b"), 16),
    (get_workload("llama3-70b"), 16),
    (AttnWorkload("causal-t", 8, 4, 128, 1024, group_alloc=TEMPORAL,
                  causal=True), 4),
    (AttnWorkload("causal-s", 8, 4, 128, 1024, group_alloc=SPATIAL,
                  causal=True), 4),
])
def test_fa2_trace_bit_identical_to_reference(wl, n_cores):
    assert_traces_identical(build_fa2_trace_ref(wl, n_cores),
                            build_fa2_trace(wl, n_cores))


def test_matmul_trace_bit_identical_to_reference():
    assert_traces_identical(
        build_matmul_trace_ref(512, 512, 512, tile=128, n_cores=4),
        build_matmul_trace(512, 512, 512, tile=128, n_cores=4))
    with pytest.raises(ValueError, match="tile-aligned"):
        build_matmul_trace(500, 512, 512)


@pytest.mark.parametrize("wl,n_cores", [
    (TINY_T, 4), (TINY_S, 4), (TINY_MB, 4),
    (get_workload("gemma3-27b"), 16),
    (get_workload("qwen3-8b"), 16),
    (get_workload("llama3-405b"), 16),
])
def test_fa2_counts_bit_identical_to_reference(wl, n_cores):
    """On every shape where the old closed-form was consistent with its
    own trace, the IR-derived counts reproduce it field for field."""
    assert fa2_counts(wl, n_cores) == fa2_counts_ref(wl, n_cores)


@pytest.mark.parametrize("wl,n_cores", [
    # shapes where the old hand-kept formula had drifted from its own
    # trace: causal extents, group_size > n_cores, uneven multi-batch
    (AttnWorkload("causal-t", 8, 4, 128, 1024, group_alloc=TEMPORAL,
                  causal=True), 4),
    (get_workload("llama3-405b"), 4),
    (TINY_MB, 16),
])
def test_fa2_counts_now_match_trace_where_formula_drifted(wl, n_cores):
    trace = build_fa2_trace(wl, n_cores)
    counts = fa2_counts(wl, n_cores)
    ct = trace.compiled()
    assert counts.n_rounds == trace.n_rounds
    assert (counts.n_kv_accesses + counts.n_bypass_lines
            == int(ct.n_acc_round.sum()))


def test_fa2_sim_counters_identical_to_reference():
    ref = run_policy(build_fa2_trace_ref(TINY_T, 4), named_policy("all"),
                     CFG4)
    got = run_policy(build_fa2_trace(TINY_T, 4), named_policy("all"), CFG4)
    for f in COUNTERS:
        assert getattr(ref, f) == getattr(got, f), f


# ---------------------------------------------------------------------------
# Counts lowering ≡ trace-derived totals (all scenarios)
# ---------------------------------------------------------------------------
def _all_specs():
    return [
        fa2_spec(TINY_T, 4), fa2_spec(TINY_S, 4), fa2_spec(TINY_MB, 4),
        matmul_spec(512, 512, 512, n_cores=4),
        decode_paged_spec(MINI_DECODE, 4),
        moe_ffn_spec(MINI_MOE, 8),
        mlp_chain_spec(m=512, dims=(256, 256, 256, 256), n_cores=4),
        transformer_layer_spec(AttnWorkload("tl", 4, 2, 128, 512),
                               d_ff=512, n_cores=4),
        spec_decode_spec(MINI_SPECDEC, 4),
    ]


@pytest.mark.parametrize("spec", _all_specs(), ids=lambda s: s.name)
def test_counts_lowering_matches_trace(spec):
    trace = lower_to_trace(spec)
    counts = lower_to_counts(spec)
    ct = trace.compiled()
    # totals
    assert counts.n_rounds == trace.n_rounds
    assert (counts.n_kv_accesses + counts.n_bypass_lines
            == int(ct.n_acc_round.sum()))
    assert float(ct.flops_round.sum()) == counts.flops_total
    # class assignment partitions the tensor set: every byte is counted
    # exactly once as either reuse-carrier (n_kv_distinct) or bypass
    bypass_bytes = sum(m.size_bytes for m in trace.tensors.values()
                      if m.bypass_all)
    assert (trace.total_bytes_touched()
            == counts.n_kv_distinct * trace.line_bytes + bypass_bytes)
    # per-tensor access counts: closed form vs trace walk
    name_of = {i: t.name for i, t in enumerate(spec.tensors)}
    from_trace = {name_of[tid]: v
                  for tid, v in trace_line_accesses(trace).items()}
    assert from_trace == spec.per_tensor_line_accesses()
    # derived invariants
    assert counts.n_kv_accesses >= counts.n_kv_distinct
    assert counts.n_temporal_reuse >= 0
    assert counts.n_intercore_reuse >= 0


# ---------------------------------------------------------------------------
# New scenarios: both engines bit-identical, DBP machinery exercised,
# analytical model runs
# ---------------------------------------------------------------------------
SCENARIOS = {
    "decode-paged": (lambda: decode_paged_spec(MINI_DECODE, 4), CFG4),
    "moe-ffn": (lambda: moe_ffn_spec(MINI_MOE, 8), MOE_CFG),
    "mlp-chain": (lambda: mlp_chain_spec(m=512, dims=(256, 256, 256, 256),
                                         n_cores=4),
                  SimConfig(n_cores=4, llc_bytes=256 * 1024, llc_slices=8)),
    "transformer-layer": (
        lambda: transformer_layer_spec(AttnWorkload("tl", 4, 2, 128, 512),
                                       d_ff=512, n_cores=4), CFG4),
    "spec-decode": (lambda: spec_decode_spec(MINI_SPECDEC, 4), CFG4),
}


@pytest.mark.parametrize("key", sorted(SCENARIOS))
@pytest.mark.parametrize("policy", ["lru", "at+dbp", "all"])
def test_scenario_engines_bit_identical(key, policy):
    build, cfg = SCENARIOS[key]
    trace = lower_to_trace(build())
    pol = named_policy(policy)
    ref = run_policy(trace, pol, cfg, engine="steps")
    got = run_policy(trace, pol, cfg, engine="compiled")
    for f in COUNTERS:
        assert getattr(ref, f) == getattr(got, f), f
    for k in ref.history:
        np.testing.assert_array_equal(ref.history[k], got.history[k])


@pytest.mark.parametrize("key", sorted(SCENARIOS))
def test_scenario_analytical_model_runs(key):
    build, cfg = SCENARIOS[key]
    counts = lower_to_counts(build())
    for policy in ("lru", "at", "at+dbp", "all"):
        pred = predict(counts, cfg.llc_bytes, policy, cfg,
                       n_rounds=counts.n_rounds)
        assert pred.cycles > 0
        assert 0.0 <= pred.kept_fraction <= 1.0


@pytest.mark.parametrize("key,build,cfg", [
    ("decode", lambda: decode_paged_spec(MINI_DECODE, 4), CFG4),
    ("moe", lambda: moe_ffn_spec(MINI_MOE, 8), MOE_CFG),
    ("specdec", lambda: spec_decode_spec(MINI_SPECDEC, 4), CFG4),
])
def test_dbp_beats_lru_on_retirement_scenarios(key, build, cfg):
    """The acceptance property of §VI-F transplanted to the new
    scenarios: with dead data polluting the LLC, the DBP-bearing policy
    must measurably beat plain LRU (and the trace must actually retire
    tiles into the dead FIFO)."""
    trace = lower_to_trace(build())
    pols = ("lru", "at+dbp")
    lru, dbp = run_policies(trace, [named_policy(p) for p in pols], cfg)
    assert dbp.dead_evictions > 0
    assert lru.cycles / dbp.cycles > 1.05, \
        f"{key}: dbp speedup only {lru.cycles / dbp.cycles:.3f}x"


def test_decode_retirement_counts():
    """Short sequences retire exactly their page tiles (K and V) into the
    TMU; long sequences retire at the very end of the run."""
    spec = decode_paged_spec(MINI_DECODE, 4)
    trace = lower_to_trace(spec)
    res = run_policy(trace, named_policy("at+dbp"), CFG4)
    assert res.dead_evictions > 0
    # every KV tile is eventually retired: n_seqs * 2 tensors * n_pages
    from repro_torch.core.simulator import Simulator
    sim = Simulator(CFG4, named_policy("at+dbp"))
    geom, tmu, llc = sim._fresh_state(trace)
    ct = trace.compiled()
    tmu.on_access_batch(ct.tll_tids, ct.tll_tiles, ct.tll_tags_for(geom),
                        ct.tll_nacc)
    expected = MINI_DECODE.n_seqs * 2 * MINI_DECODE.n_pages
    assert tmu.stats["tiles_retired"] == expected


# ---------------------------------------------------------------------------
# Plan lowering
# ---------------------------------------------------------------------------
def test_lower_to_plan_budget_and_partition():
    spec = moe_ffn_spec(MINI_MOE, 8)
    budget = 512 * 1024
    plan = lower_to_plan(spec, budget)
    usable = int(budget * (1 - 1.0 / 8.0))
    assert plan.pinned_bytes <= usable
    metas = {m.tensor_id: m for m in tmu_metadata(spec)}
    for tid, entry in plan.entries.items():
        got = sorted(entry.pinned_tiles + entry.streamed_tiles)
        assert got == list(range(metas[tid].num_tiles))
    # the most-reused (hot expert) tensors claim residency first
    hot_ids = [i for i, t in enumerate(spec.tensors)
               if t.name.startswith("W.e") and t.sharers > 1]
    assert any(plan.entries[i].pinned_tiles for i in hot_ids)
    # bypass activations are never pinned
    act_ids = [i for i, t in enumerate(spec.tensors) if t.bypass]
    assert all(not plan.entries[i].pinned_tiles for i in act_ids)


def test_tmu_metadata_registers_into_tmu():
    from repro_torch.core import TMU
    spec = mlp_chain_spec(m=512, dims=(256, 256, 256, 256), n_cores=4)
    tmu = TMU(tensor_entries=64)
    tmu.register_many(tmu_metadata(spec))
    meta = tmu_metadata(spec)[0]
    assert tmu.lookup_tensor(meta.base_addr) == meta


# ---------------------------------------------------------------------------
# IR validation and builder helpers
# ---------------------------------------------------------------------------
def test_spec_validation_rejects_bad_references():
    b = SpecBuilder("bad", 1)
    b.tensor("T", size_bytes=1024, tile_bytes=256, n_acc=1)
    b.step(0, loads=[("nope", 0)])
    with pytest.raises(ValueError, match="unknown tensor"):
        b.build()
    b2 = SpecBuilder("bad2", 1)
    b2.tensor("T", size_bytes=1024, tile_bytes=256, n_acc=1)
    b2.step(0, loads=[("T", 4)])
    with pytest.raises(ValueError, match="out of range"):
        b2.build()
    b3 = SpecBuilder("bad3", 1)
    b3.tensor("T", size_bytes=1024, tile_bytes=256, n_acc=1)
    b3.tensor("T", size_bytes=1024, tile_bytes=256, n_acc=1)
    with pytest.raises(ValueError, match="duplicate"):
        b3.build()


def test_transformer_layer_interleaves_groups_like_fa2_temporal():
    """A core owning several KV groups must interleave them at Q-tile
    granularity (fa2 temporal semantics: all owned streams concurrently
    live), not run one group to completion before the next."""
    wl = AttnWorkload("tli", 8, 8, 128, 512)     # 8 KV groups on 4 cores
    spec = transformer_layer_spec(wl, d_ff=512, n_cores=4)
    first_pass = 2 * (2 * wl.n_kv_tiles + 2)     # one Q tile × both groups
    seen = {name for step in spec.core_programs[0][:first_pass]
            for name, _ in step.loads if name.startswith("K.")}
    assert seen == {"K.g0", "K.g4"}


def test_moe_spec_rejects_core_expert_mismatch():
    # n_cold == 0 with more cores than experts must error, not index
    # past the expert list during the warm phase
    with pytest.raises(ValueError, match="n_cold"):
        moe_ffn_spec(MoEWorkload(n_experts=8, n_hot=8, d_model=256,
                                 d_ff=256, tile_bytes=8192), n_cores=16)
    # all-hot routing is fine when every core maps to an expert
    spec = moe_ffn_spec(MoEWorkload(n_experts=8, n_hot=8, d_model=256,
                                    d_ff=256, tile_bytes=8192), n_cores=8)
    assert spec.n_cores == 8


def test_pad_to_sync_aligns_cores():
    b = SpecBuilder("sync", 3)
    b.tensor("T", size_bytes=1024, tile_bytes=256, n_acc=1)
    b.step(0, loads=[("T", 0)])
    b.step(0, loads=[("T", 1)])
    b.step(2, loads=[("T", 2)])
    b.pad_to_sync()
    spec = b.build()
    assert [len(p) for p in spec.core_programs] == [2, 2, 2]


# ---------------------------------------------------------------------------
# Suite registry
# ---------------------------------------------------------------------------
def test_suite_registry_complete_and_unique():
    cases = build_suite()
    keys = [c.key for c in cases]
    assert len(set(keys)) == len(keys)
    for expected in ("fa2-temporal", "fa2-spatial", "matmul",
                     "decode-paged", "moe-ffn", "spec-decode",
                     "mlp-chain", "transformer-layer",
                     "ssd-scan", "prefix-share"):
        assert expected in keys
    # the speculative-decoding case exists to demonstrate the recurring
    # two-epoch DBP win — keep it flagged for the suite_bench emit line
    assert next(c for c in cases if c.key == "spec-decode").expect_dbp_win
    # ssd-scan exists for the chunk-state retirement win (gated in CI);
    # prefix-share runs under the conservative gqa_bypass variant
    assert next(c for c in cases if c.key == "ssd-scan").expect_dbp_win
    assert next(c for c in cases if c.key == "prefix-share").gqa
    assert "lru" in SUITE_POLICIES and "at+dbp" in SUITE_POLICIES
    with pytest.raises(KeyError, match="unknown suite scenario"):
        suite_case("not-a-scenario")
