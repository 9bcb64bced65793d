"""``ServeEngine`` under a mesh: two gloo ranks on the CPU, (data, model) =
(1, 2), each with its parameter shards and its shard of the pooled cache,
serve the same 6 requests (prompts of 5 to 32 tokens, 3 to 8 new tokens,
4 slots: the fifth and sixth requests reuse retired slots) of the reduced
llama3.2-3b (also with ``ACT_SEQ``: prompts the model axis divides run
sequence-sharded, the others and every decode step keep the stream whole),
zamba2-7b and deepseek-moe-16b in fp32, greedy.  Every request's tokens
equal the one-process engine's on the whole weights, and both ranks' tokens
and decode calls equal each other.  On (1, 4) the model axis does not divide
the reduced llama's KV heads (zamba2, deepseek: the head sharding switched
off) and the pool takes the ``kvseq`` layout: every rank's tokens
equal the one-process engine's there too.  The engine's refusal of a data axis is
in tests/test_torch_mesh_train_ssm.py.

A model axis of 3 ranks divides neither the reduced mamba2-2.7b's d_model
(256) nor its 16 heads: the rules leave the embedding's columns and every
Mamba2 weight whole, the residual stream stays whole and each rank runs
every block whole, while the vocabulary (here 513) is split three ways.
Its prefill and 3 decode steps equal one process's in fp32, logits and
every gathered cache tensor within 1e-5 of their scale."""

from _torch_mesh_world import ENGINE_NEW
from _torch_mesh_world import case_id
from _torch_mesh_world import check_cache
from _torch_mesh_world import held
from _torch_mesh_world import run_both
import pytest

CASES = [dict(arch=a, mesh=(1, 2), act_seq=q, dtype="fp32", what=("engine",))
         for a, q in (("llama3.2-3b", False), ("llama3.2-3b", True), ("zamba2-7b", False),
                      ("deepseek-moe-16b", False))]
IDS = [case_id(c) for c in CASES]
# a model axis of 4 ranks does not divide the reduced llama's 2 KV heads
# (zamba2's and deepseek's 4 it does: there the head sharding is switched
# off): the pool's K/V take the kvseq layout, each slot's 64 rows split 16 a
# rank
KVSEQ = [dict(arch=a, mesh=(1, 4), act_seq=False, dtype="fp32", what=("engine",), **kw)
         for a, kw in (("llama3.2-3b", {}), ("zamba2-7b", {"kv_head_shard": False}),
                       ("deepseek-moe-16b", {"kv_head_shard": False}))]
KVSEQ_IDS = [case_id(c) for c in KVSEQ]
WHOLE = dict(arch="mamba2-2.7b", mesh=(1, 3), act_seq=False, dtype="fp32", what=("own",),
             changes={"vocab": 513})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return [port for port, _ in run_both(CASES + KVSEQ + [WHOLE],
                                         str(tmp_path_factory.mktemp("mesh")))]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_every_request_gets_the_one_process_tokens(results, i):
    tokens, calls = results[i]["ranks"][0]
    want, want_calls = results[i]["one"]
    assert [len(t) for t in tokens] == list(ENGINE_NEW)
    assert tokens == want and calls == want_calls


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_both_ranks_draw_the_same_tokens(results, i):
    first, *others = results[i]["ranks"]
    assert len(others) == 1 and all(r == first for r in others)


@pytest.mark.parametrize("call", range(4), ids=["prefill", "decode0", "decode1", "decode2"])
def test_blocks_the_model_axis_does_not_split_run_whole_on_each_rank(results, call):
    (got, got_cache), (want, want_cache) = results[-1]["mesh"][call], results[-1]["one"][call]
    held(got, want, "logits")
    check_cache(got_cache, want_cache, "cache")


@pytest.mark.parametrize("i", range(len(KVSEQ)), ids=KVSEQ_IDS)
def test_the_kvseq_pool_serves_the_one_process_tokens(results, i):
    """Prefills spliced into the pool's slices, decode steps by position
    group, the MoE step's put-back at the position on the rank that holds
    it: every rank's tokens and calls equal the one-process engine's."""
    got = results[len(CASES) + i]
    assert got["layout"] == "kvseq"
    want, want_calls = got["one"]
    assert all(r == (want, want_calls) for r in got["ranks"])
    assert [len(t) for t in want] == list(ENGINE_NEW)
