"""tests/test_torch_mesh_train_moe.py's comparison with the JAX package on
the other layouts of the reduced deepseek-moe-16b: (2, 2) with ``ACT_SEQ``,
and (1, 4) with and without (2 of the 8 experts a rank, 16 of the shared
expert's 64 d_ff columns); and at capacity factor 0.5 on (2, 2), where the
reference's expert-parallel ``shard_map`` counts each data shard's tokens
alone: each shard's 64 tokens get 8 slots an expert where the global batch
gets 16, so the step differs from the single-device one, in the port as in
the reference, and the test shows that it does."""

from _torch_mesh_world import case
from _torch_mesh_world import case_id
from _torch_mesh_world import check_leaves
from _torch_mesh_world import check_loss
from _torch_mesh_world import held
from _torch_mesh_world import run_both
from _torch_mesh_world import single_device
import pytest

ARCH = "deepseek-moe-16b"
DROPS = {"capacity_factor": 0.5}
CASES = [case(ARCH, m, a) for m, a in [((2, 2), True), ((1, 4), False), ((1, 4), True)]] + \
    [case(ARCH, (2, 2), changes=DROPS)]
IDS = [case_id(c) for c in CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_loss_and_grad_norm_match_jax(results, i):
    check_loss(*results[i])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_every_gathered_gradient_matches_jax(results, i):
    port, ref = results[i]
    check_leaves(port["grads"], ref["grads"], "gradient")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_fp32_logits_match_jax(results, i):
    port, ref = results[i]
    held(port["logits"], ref["logits"], "logits")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_parameters_after_one_step_match_jax(results, i):
    port, ref = results[i]
    check_leaves(port["step_params"], ref["step_params"], "parameter")


def test_expert_parallel_drops_count_each_data_shard(results):
    """At capacity factor 0.5 on (2, 2) both packages' losses, equal to each
    other, differ from the single-device loss, and from the loss at 4.0."""
    port, ref = results[-1]
    loss, _ = single_device(CASES[-1])
    assert abs(port["loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
    assert abs(port["loss"] - loss) > 1e-3, (port["loss"], loss)
    assert abs(single_device(CASES[0])[0] - port["loss"]) > 1e-3
