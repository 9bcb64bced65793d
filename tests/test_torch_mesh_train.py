"""The port's training step under a mesh of gloo ranks on the CPU, against
the JAX package's under the same (data, model) mesh: the reduced
llama3.2-3b (2 layers, d_model 256, 4 query and 2 KV heads of 64, d_ff 512,
vocab 512) on meshes (2, 1), (1, 2) and (2, 2), ``ACT_SEQ`` off and on where
the model axis has more than one rank.  tests/test_torch_mesh_train_tp4.py
holds (2, 2) with ``ACT_SEQ`` and (1, 4), where the model axis divides the
query heads but not the KV heads; the MoE and SSM files the other families.

One batch of 4 x 32 tokens (and its first 3 rows on (2, 1): a batch the
data axis does not divide), the weights of the port's ``init_params`` (seed
0).  The JAX side (``tests/_torch_mesh_jax.py``, one process for the
module) jits its train step with the sharding rules' ``in_shardings`` on an
Auto-axis mesh of 4 host devices; the port (``tests/_torch_mesh_world.py``)
runs as data x model processes, places the weights by the same rules and
gathers what it computed.  fp32: the loss and gradient norm within 1e-5,
every gathered gradient leaf, the logits and every parameter leaf after one
step elementwise within 1e-5 of the leaf's largest magnitude.  bf16: the
logits by the port's share rules (share within 3e-2 of their scale at least
0.99, RMS at most 1.5e-2, cap 0.5): the ranks' partial sums round in
another order than one device's, on both sides."""

from _torch_mesh_world import case
from _torch_mesh_world import case_id
from _torch_mesh_world import check_leaves
from _torch_mesh_world import check_loss
from _torch_mesh_world import held
from _torch_mesh_world import held_by_share
from _torch_mesh_world import run_both
import pytest

ARCH = "llama3.2-3b"
LAYOUTS = [((2, 1), False), ((1, 2), False), ((1, 2), True), ((2, 2), False)]
# and a batch of 3 on (2, 1), which the data axis does not split: every rank
# trains on all of it, as the reference repeats it, and sums no gradient
FP32 = [case(ARCH, m, a) for m, a in LAYOUTS] + [case(ARCH, (2, 1), batch=3)]
BF16 = [case(ARCH, m, a, dtype="bf16") for m, a in LAYOUTS]
CASES = FP32 + BF16


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_loss_and_grad_norm_match_jax(results, i):
    check_loss(*results[i])


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_every_gathered_gradient_matches_jax(results, i):
    port, ref = results[i]
    check_leaves(port["grads"], ref["grads"], "gradient")


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_fp32_logits_match_jax(results, i):
    port, ref = results[i]
    held(port["logits"], ref["logits"], "logits")


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_parameters_after_one_step_match_jax(results, i):
    port, ref = results[i]
    check_leaves(port["step_params"], ref["step_params"], "parameter")


@pytest.mark.parametrize("i", range(len(FP32), len(CASES)), ids=[case_id(c) for c in BF16])
def test_bf16_logits_match_jax_by_share(results, i):
    port, ref = results[i]
    held_by_share(port["logits"], ref["logits"], "bf16 logits")


@pytest.mark.parametrize("i", range(len(FP32)), ids=[case_id(c) for c in FP32])
def test_sharded_init_equals_the_sliced_whole_state(results, i):
    """``init_sharded_train_state`` (each rank's shards, the moments made a
    leaf at a time) equals ``shard_train_state(init_train_state(...))``."""
    port, _ = results[i]
    assert port["init_matches"]
    for got, want, equal in port["init_matches"]:
        assert got == want and equal
