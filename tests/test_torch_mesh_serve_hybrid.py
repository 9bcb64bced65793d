"""Serving under a mesh, as tests/test_torch_mesh_serve.py holds it, for the
reduced zamba2-7b (4 layers in 2 groups of 2 Mamba2 layers, each followed by
the weight-shared attention + MLP block, 4 heads MHA of 64): tensor-parallel
Mamba2 blocks and the shared block's heads, one K/V entry a rank for each
application of the shared block.

The ``kvseq`` cases hold the shared block's K/V sequence-sharded, the
Mamba2 state in its own layout (see tests/test_torch_mesh_serve.py)."""

from _torch_mesh_world import KV_MESHES
from _torch_mesh_world import case_id
from _torch_mesh_world import check_cache
from _torch_mesh_world import check_decode
from _torch_mesh_world import check_kvseq_layouts
from _torch_mesh_world import check_prefill_logits
from _torch_mesh_world import check_prefill_one_process
from _torch_mesh_world import held_by_share
from _torch_mesh_world import kvseq_case
from _torch_mesh_world import run_both
from _torch_mesh_world import serve_case
import pytest

ARCH = "zamba2-7b"
KVSEQ = [kvseq_case(ARCH, m) for m in KV_MESHES]
FP32 = [serve_case(ARCH, m, a, batch=b) for m, a, b in [
    ((1, 2), False, 4), ((1, 2), True, 4), ((2, 2), False, 4), ((1, 4), False, 4),
    ((2, 2), False, 2), ((2, 1), False, 1)]] + KVSEQ
BF16 = [serve_case(ARCH, m, a, dtype="bf16") for m, a in [((1, 2), False), ((1, 2), True)]]
CASES = FP32 + BF16
KVSEQ_AT = [i for i, c in enumerate(CASES) if c.get("layouts")]

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_decode_from_the_jax_cache_matches_jax(results, i):
    check_decode(*results[i])


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_fp32_prefill_matches_one_process(results, i):
    check_prefill_one_process(results[i][0])


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_fp32_prefill_logits_match_the_jax_forward(results, i):
    check_prefill_logits(*results[i])


@pytest.mark.parametrize("i", range(len(FP32), len(CASES)), ids=[case_id(c) for c in BF16])
def test_bf16_prefill_and_decode_match_jax_by_share(results, i):
    port, ref = results[i]
    held_by_share(port["prefill_logits"], ref["prefill_logits"], "prefill logits")
    check_cache(port["prefill_cache"], ref["prefill_cache"], "prefill cache", held_by_share)
    check_decode(port, ref, held_by_share)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_every_rank_gets_the_same_logits(results, i):
    assert all(results[i][0]["same_on_every_rank"])


@pytest.mark.parametrize("i", KVSEQ_AT, ids=[case_id(CASES[i]) for i in KVSEQ_AT])
def test_kvseq_decode_matches_the_heads_layout_and_one_process(results, i):
    check_kvseq_layouts(results[i][0])
