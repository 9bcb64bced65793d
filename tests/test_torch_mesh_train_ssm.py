"""The SSM and hybrid families under a mesh.  The reduced mamba2-2.7b (2
layers) and zamba2-7b (one group of 2 Mamba2 layers, the shared attention +
MLP block, and a tail of 2) train one step on a (2, 1) mesh of gloo ranks on
the CPU against the JAX package's on the same mesh, held as
tests/test_torch_mesh_train.py holds the dense model;
tests/test_torch_mesh_train_ssm_tp.py and tests/test_torch_mesh_train_hybrid_tp.py
hold them tensor-parallel.  On (1, 2) every family's ``forward``,
``prefill`` and ``decode_step`` run.  What the port still refuses under a
mesh it refuses before any work."""

from dataclasses import replace

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
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import ShapeMesh
from repro_torch.sharding import use_mesh

SSM_ARCHS = ("mamba2-2.7b", "zamba2-7b")
STEPS = [case(a, (2, 1)) for a in SSM_ARCHS]
RUNS = [dict(case(a, (1, 2)), what=("runs",))
        for a in SSM_ARCHS + ("llama3.2-3b", "deepseek-moe-16b")]
CASES = STEPS + RUNS
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
                         ids=[c["arch"] for c in RUNS])
def test_each_family_runs_forward_prefill_and_decode_on_a_model_axis(results, i):
    """On (1, 2): ``forward``, ``prefill`` and ``decode_step`` of every
    family run and give finite logits."""
    port, _ = results[i]
    assert port["runs"] == {"forward": None, "prefill": None, "decode_step": None}


def test_the_remaining_refusals_come_before_any_work():
    """On a shape-only mesh, which cannot run a collective, the refusals
    that remain raise ``NotImplementedError``, not the mesh's error: a model
    axis that splits ``d_inner`` but not the heads (32 ranks: 512 channels,
    16 heads), and a serving engine under a data axis."""
    cfg = reduce_for_smoke(get_arch("mamba2-2.7b"))
    p = {k: v[0] for k, v in init_params(cfg, seed=0, device="cpu")["layers"].items()}
    m = 32
    d_inner = cfg.ssm.expand * cfg.d_model
    assert d_inner % m == 0 and (d_inner // cfg.ssm.head_dim) % m
    p = dict(p, **{k: p[k][..., :d_inner // m] for k in ("w_z", "w_x", "conv_x_w")})
    x = torch.zeros((1, 8, cfg.d_model // m), dtype=torch.bfloat16)
    with use_mesh(ShapeMesh((1, m), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="whole heads"):
            mamba2_block(p, x, cfg.ssm)
    params = init_params(replace(cfg, n_layers=1), seed=0, device="cpu")
    with use_mesh(ShapeMesh((2, 1), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="replicas behind a router"):
            ServeEngine(cfg, params, max_batch=2, max_seq=16, device="cpu")
