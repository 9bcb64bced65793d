"""``train/compression.py``: int8 gradient compression with error feedback.
The reference's two 1-device tests (tests/test_substrate.py) carried over
to the port on a 1-rank process group, and 2 gloo ranks on the CPU against
the JAX package's ``compressed_psum_mean`` inside ``shard_map`` over 2 host
devices, on the same two ranks' gradients: each call's mean and each rank's
error, two calls in a row (the second from the first's error)."""

from _torch_mesh_world import run_both
import numpy as np
import pytest
import torch
import torch.distributed as dist
# the port
from repro_torch.sharding import use_mesh
from repro_torch.train import compressed_psum_mean
from repro_torch.train import init_error_feedback


@pytest.fixture
def pod_of_one(tmp_path):
    """A 1-rank gloo process group in this process, and its ("pod",) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_single_shard_roundtrip(pod_of_one):
    """On a 1-rank axis the compressed mean must equal g up to int8
    quantization error, and error feedback must capture the residual."""
    g = {"w": torch.linspace(-1.0, 1.0, 64).reshape(8, 8)}
    e = init_error_feedback(g)
    with use_mesh(pod_of_one):
        out, err = compressed_psum_mean(g, e, "pod")
    q_err = (out["w"] - g["w"]).abs()
    assert float(q_err.max()) <= (1.0 / 127.0) + 1e-6
    np.testing.assert_allclose(err["w"].numpy(), (g["w"] - out["w"]).numpy(), atol=1e-6)


def test_compressed_psum_error_feedback_converges(pod_of_one):
    """Repeatedly syncing the same gradient with error feedback must
    average out the quantization bias (sum of dequantized ≈ sum of true)."""
    g = {"w": torch.tensor([[0.003, -0.7], [0.31, 0.02]])}
    e = init_error_feedback(g)
    total = torch.zeros_like(g["w"])
    with use_mesh(pod_of_one):
        for _ in range(50):
            out, e = compressed_psum_mean(g, e, "pod")
            total = total + out["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(), atol=2e-3)


CASES = [dict(mesh=(2, 1), act_seq=False, what=("compression",))]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    (port, ref), = run_both(CASES, str(tmp_path_factory.mktemp("mesh")))
    return port, ref


def job_grads():
    from _torch_mesh_world import make_job
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        return make_job([], f"{d}/job.pkl")["compression"]


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("what", ["mean", "err"])
def test_two_ranks_match_jax_shard_map(two_ranks, call, what):
    """Within 1e-6 of the leaf's largest gradient: the error is g + e less
    its dequantized value, where XLA may fuse the product into the
    subtraction and round once (an ulp of g apart)."""
    port, ref = two_ranks
    got, want = port[f"{what}{call}"], ref[f"{what}{call}"]
    assert sorted(got) == sorted(want)
    for k, g in job_grads().items():
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 * np.abs(g).max(),
                                   err_msg=k)


def test_two_ranks_mean_is_the_quantized_mean(two_ranks):
    """The mean is within one quantization step (the shared scale, the
    larger rank's max |g| / 127) of the plain mean of the two ranks'
    gradients; the second call's error differs from the first's."""
    port, _ = two_ranks
    for k, g in job_grads().items():
        step = np.abs(g).max() / 127.0
        assert np.abs(port["mean0"][k] - g.mean(0)).max() <= step
        assert not np.array_equal(port["err0"][k], port["err1"][k])


def test_make_test_mesh_takes_the_callers_group_and_checks_its_size(pod_of_one):
    """``launch/mesh.py`` builds on the process group the caller made, names
    its axes as the reference does, and refuses a shape whose rank count is
    not the group's."""
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(1, 1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_test_mesh(1, 2, device_type="cpu")
