"""The port's checkpoint manager: ports of the reference's checkpoint tests
(tests/test_substrate.py), and checkpoints crossing between the two
packages in both directions with the same keys (``.params/embed``,
``.opt/.m/...``, ``.opt/.step``: JAX's path keys, NamedTuple fields with a
leading dot)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import train as jt
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
# the port
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.data import SyntheticLM
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import tree_map

ARCH = "llama3.2-3b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_roundtrip_and_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        mgr.save(step, tree_map(lambda x: x * step, tree))
    assert mgr._steps() == [2, 3]            # pruned to keep_n
    step, restored = mgr.restore_latest(tree)
    assert step == 3
    np.testing.assert_allclose(restored["b"]["c"].numpy(), 3 * np.ones(4))
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"] * 3)


def test_checkpoint_survives_corruption(tmp_path):
    """Corrupting the newest checkpoint must fall back to the previous
    valid one (node-failure torn-write scenario)."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    tree = {"w": torch.ones(8)}
    mgr.save(1, tree)
    mgr.save(2, tree_map(lambda x: x * 2, tree))
    npz = os.path.join(str(tmp_path), "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(30)
        f.write(b"\x00" * 64)
    step, restored = mgr.restore_latest(tree)
    assert step == 1
    np.testing.assert_allclose(restored["w"].numpy(), np.ones(8))


def test_checkpoint_ignores_partial_and_mismatched(tmp_path):
    """A ``.tmp`` directory (a crash before the rename) and a checkpoint
    whose manifest is not complete are skipped; a template of another shape
    restores nothing."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones(8)}
    mgr.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_00000005.tmp"))
    mgr.save(2, tree)
    path = os.path.join(str(tmp_path), "step_00000002", "manifest.json")
    m = manifest(os.path.dirname(path))
    m["complete"] = False
    with open(path, "w") as f:
        json.dump(m, f)
    assert mgr.restore_latest(tree)[0] == 1
    assert mgr.restore_latest({"w": torch.ones(9)}) is None


def test_checkpoint_resume_training(tmp_path):
    """Kill-and-resume: state restored from disk continues bit-exactly."""
    cfg = reduce_for_smoke(get_arch(ARCH))
    params = tm.init_params(cfg, seed=0, device="cpu")
    state = tt.init_train_state(tree_map(torch.clone, params))
    opt = tt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step_fn = tt.make_train_step(cfg, opt, device="cpu")
    data = SyntheticLM(cfg.vocab, 32, 4)
    mgr = CheckpointManager(str(tmp_path))
    for i in range(3):
        state, _ = step_fn(state, data.batch(i))
    mgr.save(3, state)
    state_a = state
    for i in range(3, 5):
        state_a, _ = step_fn(state_a, data.batch(i))
    # simulated preemption: a fresh state restores and replays
    step0, state_b = mgr.restore_latest(tt.init_train_state(tree_map(torch.clone, params)))
    assert step0 == 3 and int(state_b.opt.step) == 3
    for i in range(3, 5):
        state_b, _ = step_fn(state_b, data.batch(i))
    for (ka, a), (kb, b) in zip(flatten_with_keys(state_a), flatten_with_keys(state_b)):
        assert ka == kb and torch.equal(a, b), ka


@pytest.fixture(scope="module")
def states():
    """A JAX ``TrainState`` and a port one of the reduced llama, with moments
    and step filled in (made, not trained)."""
    rng = np.random.default_rng(0)
    jparams = jm.init_params(jax_reduce(jax_get_arch(ARCH)), jax.random.key(0))

    def noise(a):
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))

    jstate = jt.TrainState(jparams, jt.OptState(jax.tree.map(noise, jparams),
                                                jax.tree.map(noise, jparams),
                                                jnp.asarray(5, jnp.int32)))
    params = tm.init_params(reduce_for_smoke(get_arch(ARCH)), seed=1, device="cpu")

    def tnoise(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    tstate = tt.TrainState(params, tt.OptState(tree_map(tnoise, params),
                                               tree_map(tnoise, params),
                                               torch.tensor(7, dtype=torch.int32)))
    return jstate, tstate


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf) for path, leaf in flat}


def test_both_packages_write_the_same_keys(states, tmp_path):
    jstate, tstate = states
    jpath = JaxCheckpointManager(str(tmp_path / "jax")).save(1, jstate)
    tpath = CheckpointManager(str(tmp_path / "torch")).save(1, tstate)
    jm_, tm_ = manifest(jpath), manifest(tpath)
    assert tm_["keys"] == jm_["keys"]
    assert len(tm_["keys"]) == 37
    assert {".params/embed", ".params/layers/attn/wq", ".opt/.m/embed",
            ".opt/.v/ln_f", ".opt/.step"} <= set(tm_["keys"])
    assert tm_["dtypes"] == jm_["dtypes"] and tm_["shapes"] == jm_["shapes"]


def test_jax_checkpoint_restores_into_the_port(states, tmp_path):
    jstate, tstate = states
    JaxCheckpointManager(str(tmp_path)).save(4, jstate)
    step, got = CheckpointManager(str(tmp_path)).restore_latest(tstate)
    assert step == 4
    want = jax_leaves(jstate)
    got = dict(flatten_with_keys(got))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        like = dict(flatten_with_keys(tstate))[k]
        assert t.dtype == like.dtype and tuple(t.shape) == want[k].shape, k
        np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point()
                                      else t.numpy(), want[k].astype(np.float32)
                                      if t.is_floating_point() else want[k], err_msg=k)
    assert int(got[".opt/.step"]) == 5


def test_port_checkpoint_restores_into_jax(states, tmp_path):
    jstate, tstate = states
    CheckpointManager(str(tmp_path)).save(6, tstate)
    step, got = JaxCheckpointManager(str(tmp_path)).restore_latest(jstate)
    assert step == 6
    got = jax_leaves(got)
    want = dict(flatten_with_keys(tstate))
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        t = want[k]
        ref = t.float().numpy() if t.is_floating_point() else t.numpy()
        np.testing.assert_array_equal(np.asarray(a, ref.dtype), ref, err_msg=k)
    assert int(got[".opt/.step"]) == 7
    assert str(jax.tree.leaves(jstate.params)[0].dtype) == "bfloat16"


# ---------------------------------------------------------------------------
# the SSM family: a mamba2 TrainState across the two packages
# ---------------------------------------------------------------------------
SSM_ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def ssm_states():
    """A JAX and a port ``TrainState`` of the reduced mamba2 (bf16 weights,
    ``a_log`` and ``d_skip`` fp32, fp32 moments), made, not trained."""
    rng = np.random.default_rng(1)
    jparams = jm.init_params(jax_reduce(jax_get_arch(SSM_ARCH)), jax.random.key(0))

    def noise(a):
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))

    jstate = jt.TrainState(jparams, jt.OptState(jax.tree.map(noise, jparams),
                                                jax.tree.map(noise, jparams),
                                                jnp.asarray(3, jnp.int32)))
    params = tm.init_params(reduce_for_smoke(get_arch(SSM_ARCH)), seed=2, device="cpu")

    def tnoise(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    tstate = tt.TrainState(params, tt.OptState(tree_map(tnoise, params),
                                               tree_map(tnoise, params),
                                               torch.tensor(9, dtype=torch.int32)))
    return jstate, tstate


def test_mamba2_state_keys_and_types_match_across_packages(ssm_states, tmp_path):
    jstate, tstate = ssm_states
    jm_ = manifest(JaxCheckpointManager(str(tmp_path / "jax")).save(1, jstate))
    tm_ = manifest(CheckpointManager(str(tmp_path / "torch")).save(1, tstate))
    assert tm_["keys"] == jm_["keys"]
    assert tm_["dtypes"] == jm_["dtypes"] and tm_["shapes"] == jm_["shapes"]
    dtypes = tm_["dtypes"]
    assert {".params/layers/a_log", ".params/layers/d_skip", ".params/layers/w_bc",
            ".opt/.m/layers/a_log", ".opt/.step"} <= set(dtypes)
    assert dtypes[".params/layers/a_log"] == dtypes[".params/layers/d_skip"] == "float32"


def test_mamba2_jax_checkpoint_restores_into_the_port(ssm_states, tmp_path):
    jstate, tstate = ssm_states
    JaxCheckpointManager(str(tmp_path)).save(4, jstate)
    step, got = CheckpointManager(str(tmp_path)).restore_latest(tstate)
    assert step == 4
    want = jax_leaves(jstate)
    like = dict(flatten_with_keys(tstate))
    got = dict(flatten_with_keys(got))
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.dtype == like[k].dtype and tuple(t.shape) == want[k].shape, k
        if t.is_floating_point():
            np.testing.assert_array_equal(t.float().numpy(), want[k].astype(np.float32),
                                          err_msg=k)
    assert got[".params/layers/a_log"].dtype == got[".params/layers/d_skip"].dtype == \
        torch.float32
    assert got[".params/layers/w_x"].dtype == torch.bfloat16
    assert int(got[".opt/.step"]) == 3


def test_mamba2_port_checkpoint_restores_into_jax(ssm_states, tmp_path):
    jstate, tstate = ssm_states
    CheckpointManager(str(tmp_path)).save(6, tstate)
    step, got = JaxCheckpointManager(str(tmp_path)).restore_latest(jstate)
    assert step == 6
    got = jax_leaves(got)
    want = dict(flatten_with_keys(tstate))
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        t = want[k]
        ref = t.float().numpy() if t.is_floating_point() else t.numpy()
        np.testing.assert_array_equal(np.asarray(a, ref.dtype), ref, err_msg=k)
    assert str(got[".params/layers/a_log"].dtype) == "float32"
    assert int(got[".opt/.step"]) == 9


# ---------------------------------------------------------------------------
# gemma2: a TrainState of the local/global model across the two packages
# ---------------------------------------------------------------------------
GEMMA2_ARCH = "gemma2-27b"


@pytest.fixture(scope="module")
def gemma2_states():
    """A JAX and a port ``TrainState`` of the reduced gemma2 (its gemma
    norms, a local and a global layer; bf16 weights, fp32 moments), made,
    not trained."""
    rng = np.random.default_rng(3)
    jparams = jm.init_params(jax_reduce(jax_get_arch(GEMMA2_ARCH)), jax.random.key(0))

    def noise(a):
        return jnp.asarray(rng.standard_normal(a.shape).astype(np.float32))

    jstate = jt.TrainState(jparams, jt.OptState(jax.tree.map(noise, jparams),
                                                jax.tree.map(noise, jparams),
                                                jnp.asarray(5, jnp.int32)))
    params = tm.init_params(reduce_for_smoke(get_arch(GEMMA2_ARCH)), seed=4, device="cpu")

    def tnoise(t):
        return torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    tstate = tt.TrainState(params, tt.OptState(tree_map(tnoise, params),
                                               tree_map(tnoise, params),
                                               torch.tensor(11, dtype=torch.int32)))
    return jstate, tstate


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_gemma2_state_round_trips_across_packages(gemma2_states, tmp_path, direction):
    """gemma2's state written by one package is read back, bit-equal and
    with the same keys, types and shapes, by the other."""
    jstate, tstate = gemma2_states
    if direction == "port_to_jax":
        CheckpointManager(str(tmp_path)).save(7, tstate)
        step, got = JaxCheckpointManager(str(tmp_path)).restore_latest(jstate)
        got, want = jax_leaves(got), dict(flatten_with_keys(tstate))
        assert int(got[".opt/.step"]) == 11
    else:
        JaxCheckpointManager(str(tmp_path)).save(7, jstate)
        step, got = CheckpointManager(str(tmp_path)).restore_latest(tstate)
        got, want = dict(flatten_with_keys(got)), jax_leaves(jstate)
        like = dict(flatten_with_keys(tstate))
        for k, t in got.items():
            assert t.dtype == like[k].dtype, k
        assert int(got[".opt/.step"]) == 5
    assert step == 7
    assert sorted(got) == sorted(want)
    assert {".params/layers/attn/wq", ".params/layers/mlp/w_gate", ".params/ln_f",
            ".opt/.v/lm_head"} <= set(got)
    for k, a in got.items():
        a = a.float().numpy() if isinstance(a, torch.Tensor) and a.is_floating_point() \
            else np.asarray(a)
        r = want[k]
        r = r.float().numpy() if isinstance(r, torch.Tensor) and r.is_floating_point() \
            else np.asarray(r)
        assert a.shape == r.shape, k
        np.testing.assert_array_equal(a.astype(np.float32), r.astype(np.float32), err_msg=k)
