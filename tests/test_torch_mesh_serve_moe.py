"""Serving under a mesh, as tests/test_torch_mesh_serve.py holds it, for the
reduced deepseek-moe-16b (the dense layer and one MoE layer of 8 routed
experts, top-2, and 1 shared expert; 4 heads MHA of 64), expert-parallel
under a model axis; also at capacity factor 0.5, where the prompt's tokens
drop: on (1, 2) and (2, 2) each data shard's tokens compete for its own
slots, as the reference's expert-parallel ``shard_map`` has them (on
(2, 2) not one process's view, which is held against the JAX forward only),
and on (2, 1) the global batch's, as its GSPMD view has them.  fp32 only: in bf16
router near-ties flip between the ranks' sums and one device's.

The ``kvseq`` cases route the whole batch as the reference does, each rank
attending its slice of the rows (see tests/test_torch_mesh_serve.py)."""

from _torch_mesh_world import KV_MESHES
from _torch_mesh_world import case_id
from _torch_mesh_world import check_decode
from _torch_mesh_world import check_kvseq_layouts
from _torch_mesh_world import check_prefill_logits
from _torch_mesh_world import check_prefill_one_process
from _torch_mesh_world import kvseq_case
from _torch_mesh_world import run_both
from _torch_mesh_world import serve_case
import pytest

ARCH = "deepseek-moe-16b"
DROPS = {"capacity_factor": 0.5}
KVSEQ = [kvseq_case(ARCH, m) for m in KV_MESHES]
FP32 = [serve_case(ARCH, m, a, batch=b) for m, a, b in [
    ((1, 2), False, 4), ((1, 2), True, 4), ((2, 2), False, 4), ((1, 4), False, 4),
    ((2, 2), False, 2), ((2, 1), False, 1)]] + [
    serve_case(ARCH, m, changes=DROPS) for m in ((1, 2), (2, 2), (2, 1))] + KVSEQ
CASES = FP32
KVSEQ_AT = [i for i, c in enumerate(CASES) if c.get("layouts")]
# one process takes the global batch's capacity view: not (2, 2) at 0.5
ONE = [i for i, c in enumerate(FP32) if not (c.get("changes") and c["mesh"] == (2, 2))]

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_decode_from_the_jax_cache_matches_jax(results, i):
    check_decode(*results[i])


@pytest.mark.parametrize("i", ONE, ids=[case_id(FP32[i]) for i in ONE])
def test_fp32_prefill_matches_one_process(results, i):
    check_prefill_one_process(results[i][0])


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_fp32_prefill_logits_match_the_jax_forward(results, i):
    check_prefill_logits(*results[i])


@pytest.mark.parametrize("i", range(len(CASES)), ids=[case_id(c) for c in CASES])
def test_every_rank_gets_the_same_logits(results, i):
    assert all(results[i][0]["same_on_every_rank"])


@pytest.mark.parametrize("i", KVSEQ_AT, ids=[case_id(CASES[i]) for i in KVSEQ_AT])
def test_kvseq_decode_matches_the_heads_layout_and_one_process(results, i):
    check_kvseq_layouts(results[i][0])
