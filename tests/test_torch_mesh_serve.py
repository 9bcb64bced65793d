"""Serving under a mesh: the port's ``prefill`` and ``decode_step`` as gloo
ranks on the CPU against the JAX package's, jitted under the same (data,
model) mesh as ``launch/dryrun.py::build_cell`` compiles them, for the
reduced llama3.2-3b (2 layers, d_model 256, 4 query and 2 KV heads of 64,
vocab 512).

Meshes (1, 2), (1, 2) with ``ACT_SEQ``, (2, 2) and (1, 4) (the model axis
divides the query heads but not the KV heads: each rank keeps the KV head
its query head reads) with a batch of 4; (2, 2) with a batch of 2; and
(2, 1) with a batch of 1, which the data axis does not divide, so that
every rank holds the whole batch, as the reference's filter places it.  A
prompt of 32 tokens, then 3 decode steps.

The JAX package's prefill writes K/V into bf16 buffers whatever the
weights' type and attends over them, so an fp32 prefill of an attention
model cannot equal the reference's elementwise.  It is held four ways:

* fp32 prefill logits against the JAX package's forward under the same
  mesh at the prompt's last position, within 1e-5 of their scale;
* fp32 prefill against the port's own one-process call: logits and every
  gathered cache tensor within 1e-5 of their scale;
* fp32 decode against JAX: the reference's prefilled cache is sharded onto
  the ranks and each side takes 3 steps; each step's logits and the
  gathered cache within 1e-5 of their scale.  Its K/V are the reference's
  bf16 values widened to fp32 on both sides: with bf16 buffers a step's
  fp32 K/V, a rounding error apart on the two sides, land one bf16 step
  apart in 1 to 3 of the 3,072 elements that 3 steps write, and the later
  steps' logits then differ by up to 5e-5 of a scale of 3.58 (the reduced
  deepseek-moe-16b);
* bf16 prefill and decode (K/V in bf16 buffers) against JAX by the port's
  share rules.

Every rank must get the same logits, bit for bit.

The ``kvseq`` cases (``_torch_mesh_world.kvseq_case``) take the
sequence-sharded K/V layout that ``models.model.kv_layout`` picks, as the
reference's ``build_cell`` does: a batch of 1 on (1, 2), (2, 1), (2, 2) and
(1, 4), a batch of 4 on (1, 4) (the model axis does not divide the 2 KV
heads) and a batch of 2 on (2, 2) with ``REPRO_KV_HEAD_SHARD=0`` (the batch
over data, the rows over model).  A prompt of 30 tokens into a cache of 64
rows: the 3 decode steps write rows 30, 31 and 32, the last row of a slice
and the first of the next.  Held as the fp32 cases above against the JAX
package's ``decode_step`` under the same placement, and against the port's
heads layout and one process."""

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

ARCH = "llama3.2-3b"
# kvseq also where the model axis does not divide the KV heads at a batch of
# 4, and with the head sharding switched off at a batch the data axis splits
KVSEQ = [kvseq_case(ARCH, m) for m in KV_MESHES] + [
    kvseq_case(ARCH, (1, 4), batch=4), kvseq_case(ARCH, (2, 2), batch=2, kv_head_shard=False)]
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
