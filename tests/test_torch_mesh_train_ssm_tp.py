"""mamba2-2.7b trained tensor-parallel: one fp32 step of the reduced mamba2-2.7b (2 layers, d_inner 512 in 16 heads of 32) on
meshes (1, 2), (1, 2) with ``ACT_SEQ``, (2, 2) and (1, 4) of gloo ranks on
the CPU against the JAX package's under the same mesh, held as
tests/test_torch_mesh_train.py holds the dense model: loss and gradient
norm within 1e-5, every gathered gradient leaf, the logits and every
parameter leaf after the step within 1e-5 of the leaf's scale.  Each rank
runs its heads of every Mamba2 block; the whole ``w_bc``, conv over
B/C and ``ln`` get the sum of every rank's gradient, and ``out_ln`` divides
by the whole ``d_inner``.

Two leaves are held otherwise, each measured:

* ``a_log``'s gradient sums terms of both signs over every token, and two
  fp32 evaluations of the port alone (on (1, 4) and in one process) differ
  by 1.2e-5 of its scale: it is held within 3e-5;
* on (2, 2) the JAX package's gradient of ``layers/conv_bc_w`` is twice its
  one-device gradient (the ratio of their norms is 2.000 in both SSM
  families; ROADMAP Queue 3): there the port's is held within 1e-5 of the
  port's one-process gradient, the reference's is shown to be twice it, and
  the leaf is left out of the parameters after the step."""

from _torch_mesh_world import case
from _torch_mesh_world import case_id
from _torch_mesh_world import check_leaves
from _torch_mesh_world import check_loss
from _torch_mesh_world import held
from _torch_mesh_world import run_both
from _torch_mesh_world import single_device
import numpy as np
import pytest

ARCH = "mamba2-2.7b"
CASES = [case(ARCH, m, a) for m, a in [((1, 2), False), ((1, 2), True), ((2, 2), False),
                                        ((1, 4), False)]]
IDS = [case_id(c) for c in CASES]
TOLS = {"a_log": 3e-5}
QUIRK = {(2, 2): ("layers/conv_bc_w",)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_loss_and_grad_norm_match_jax(results, i):
    check_loss(*results[i])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_every_gathered_gradient_matches_jax(results, i):
    port, ref = results[i]
    check_leaves(port["grads"], ref["grads"], "gradient", QUIRK.get(CASES[i]["mesh"], ()), TOLS)


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c["mesh"] in QUIRK],
                         ids=[case_id(c) for c in CASES if c["mesh"] in QUIRK])
def test_where_the_reference_doubles_a_gradient_the_port_gives_one_process(results, i):
    port, ref = results[i]
    _, one = single_device(CASES[i])
    for k in QUIRK[CASES[i]["mesh"]]:
        held(port["grads"][k], one[k], f"gradient {k} against one process")
        ratio = np.linalg.norm(ref["grads"][k]) / np.linalg.norm(one[k])
        assert abs(ratio - 2.0) < 1e-3, ratio


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_fp32_logits_match_jax(results, i):
    port, ref = results[i]
    held(port["logits"], ref["logits"], "logits")


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_parameters_after_one_step_match_jax(results, i):
    port, ref = results[i]
    check_leaves(port["step_params"], ref["step_params"], "parameter",
                 QUIRK.get(CASES[i]["mesh"], ()))
