"""The port's MoE training step under a mesh of gloo ranks on the CPU,
against the JAX package's under the same mesh (as
tests/test_torch_mesh_train.py): the reduced deepseek-moe-16b (the dense
layer and one MoE layer of 8 routed experts, top-2, and 1 shared expert;
d_model 256, 4 heads MHA of 64, vocab 512) on meshes (2, 1), (1, 2) and
(2, 2), ``ACT_SEQ`` off and on where the model axis has more than one rank,
at ``reduce_for_smoke``'s capacity factor 4.0 (nothing drops); and at 0.5 on
(2, 1), where tokens drop.  tests/test_torch_mesh_train_moe_tp4.py holds the
other layouts.

Under a model axis of more than one rank each rank runs its E/model experts
and its slice of the shared expert's d_ff (expert parallelism), and the
router's gradient sums every rank's.  With one rank on the model axis the
reference takes the global batch's view, so on (2, 1) at 0.5 the tokens of
the second data shard find the slots the first one's left: the step equals
the single-device one.  fp32 only: in bf16 router near-ties flip between
the ranks' sums and one device's."""

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
CASES = [case(ARCH, m, a) for m, a in [((2, 1), False), ((1, 2), False), ((1, 2), True),
                                        ((2, 2), False)]] + [case(ARCH, (2, 1), changes=DROPS)]
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


def test_data_parallel_drops_take_the_global_batch_view(results):
    """At capacity factor 0.5 on (2, 1) the loss and every gradient equal one
    device's on the whole batch, which drops tokens (its loss differs from
    the loss at 4.0, where nothing drops)."""
    port, _ = results[-1]
    loss, grads = single_device(CASES[-1])
    assert abs(port["loss"] - loss) <= 1e-5 * loss
    check_leaves(port["grads"], grads, "gradient against one device")
    assert abs(single_device(CASES[0])[0] - loss) > 1e-3
