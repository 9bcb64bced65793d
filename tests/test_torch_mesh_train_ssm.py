"""The SSM and hybrid families under a mesh: data-parallel only in this
slice.  The reduced mamba2-2.7b (2 layers) and zamba2-7b (one group of 2
Mamba2 layers, the shared attention + MLP block, and a tail of 2) train one
step on a (2, 1) mesh of gloo ranks on the CPU against the JAX package's on
the same mesh, held as tests/test_torch_mesh_train.py holds the dense model.
On (1, 2) the port refuses them with ``NotImplementedError``: ``out_ln``, an
RMSNorm over the tensor-parallel ``d_inner``, needs a cross-rank sum of
squares that a later slice brings.  ``prefill`` and ``decode_step`` refuse
every mesh, for every family (serving under a mesh is a later slice)."""

from _torch_mesh_world import case
from _torch_mesh_world import case_id
from _torch_mesh_world import check_leaves
from _torch_mesh_world import check_loss
from _torch_mesh_world import held
from _torch_mesh_world import run_both
import pytest
import torch
# the port
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import init_params
from repro_torch.models.ssm import mamba2_block
from repro_torch.sharding import ShapeMesh
from repro_torch.sharding import use_mesh

SSM_ARCHS = ("mamba2-2.7b", "zamba2-7b")
STEPS = [case(a, (2, 1)) for a in SSM_ARCHS]
REFUSALS = [dict(case(a, (1, 2)), what=("refusals",))
            for a in SSM_ARCHS + ("llama3.2-3b", "deepseek-moe-16b")]
CASES = STEPS + REFUSALS
IDS = [case_id(c) for c in STEPS]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_both(CASES, str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("i", range(len(STEPS)), ids=IDS)
def test_loss_and_grad_norm_match_jax(results, i):
    check_loss(*results[i])


@pytest.mark.parametrize("i", range(len(STEPS)), ids=IDS)
def test_every_gathered_gradient_matches_jax(results, i):
    port, ref = results[i]
    check_leaves(port["grads"], ref["grads"], "gradient")


@pytest.mark.parametrize("i", range(len(STEPS)), ids=IDS)
def test_fp32_logits_match_jax(results, i):
    port, ref = results[i]
    held(port["logits"], ref["logits"], "logits")


@pytest.mark.parametrize("i", range(len(STEPS)), ids=IDS)
def test_parameters_after_one_step_match_jax(results, i):
    port, ref = results[i]
    check_leaves(port["step_params"], ref["step_params"], "parameter")


@pytest.mark.parametrize("i", range(len(STEPS), len(CASES)),
                         ids=[c["arch"] for c in REFUSALS])
def test_what_the_slice_does_not_run_raises_on_a_model_axis(results, i):
    """On (1, 2): the SSM and hybrid forwards raise naming the SSM
    tensor-parallel slice; the dense and MoE forwards run; ``prefill`` and
    ``decode_step`` raise naming the serving slice, for every family."""
    port, _ = results[i]
    refused = port["refusals"]
    if CASES[i]["arch"] in SSM_ARCHS:
        assert "SSM tensor-parallel slice" in refused["forward"]
    else:
        assert refused["forward"] is None
    for entry in ("prefill", "decode_step"):
        assert "serving slice" in refused[entry], entry


def test_mamba2_block_refuses_a_model_axis_before_any_work():
    """The refusal comes first: on a shape-only mesh, which cannot run a
    collective, the block raises ``NotImplementedError``, not the mesh's
    error."""
    cfg = reduce_for_smoke(get_arch("mamba2-2.7b"))
    p = {k: v[0] for k, v in init_params(cfg, seed=0, device="cpu")["layers"].items()}
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    with use_mesh(ShapeMesh((1, 2), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="out_ln"):
            mamba2_block(p, x, cfg.ssm)
    with use_mesh(ShapeMesh((2, 1), ("data", "model"))):
        mamba2_block(p, x, cfg.ssm)          # data-parallel: runs
