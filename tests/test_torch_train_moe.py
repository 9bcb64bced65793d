"""The port's MoE training path against the JAX package's, from the same
weights and tokens: the loss and every gradient of ``forward`` + ``lm_loss``
for the reduced deepseek-moe-16b (the dense layer and one MoE layer of 8
routed experts, top-2, and 1 shared expert; d_model 256, 4 heads MHA of 64,
vocab 512) at deepseek-moe-16b's published capacity factor 1.25, one
``make_train_step`` with 1 and 2 microbatches, and the launcher.

``reduce_for_smoke`` sets the capacity factor to 4.0, which drops nothing;
at 1.25, 4 x 64 tokens give each expert max(int(1.25 x 256 x 2 / 8), 4) = 80
slots for 64 choices on average, and the tokens that overfill an expert are
dropped, in training as in serving.  The test counts the (token, expert)
choices that find no slot on both sides and asserts they are the same and
not 0: the gradients below are those of a step that drops tokens.

Weights come from the port's ``init_params`` (seed 0) and go to JAX with the
dtypes of the JAX package's own tree (the router ``w_gate`` fp32), as
tests/test_torch_moe.py does.  The JAX side is built once per module:
jitted for the gradients, op by op (``jax.disable_jit()``) where the drops
are counted.

Tolerances, as tests/test_torch_train_ssm.py: fp32 loss 1e-5, every gradient
leaf elementwise within 1e-4 of the leaf's largest magnitude.  In bf16 the
loss within 3e-2 and each gradient leaf by the share of its elements within
3e-2 of the leaf's largest magnitude (at least 0.99), the RMS of that
relative error (at most 3e-2 / 2) and a cap on it (0.5); the greedy tokens
of the logits agree wherever the reference's top-2 margin is clear of 3e-2.
A step's updated parameters are compared where the reference's gradient is
clear of the gradients' agreement, by the rule of tests/test_torch_train.py."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro import train as jt
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import moe as jmoe
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import moe as tmoe
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import leaves
from repro_torch.tree import unflatten

ARCH = "deepseek-moe-16b"
B, S = 4, 64
GRAD_TOL = 1e-4
SHARE_TOL = 3e-2
CAPACITY_FACTOR = 1.25   # deepseek-moe-16b's published one
CFG = reduce_for_smoke(get_arch(ARCH))
CFG = replace(CFG, moe=replace(CFG.moe, capacity_factor=CAPACITY_FACTOR))
JCFG = jax_reduce(jax_get_arch(ARCH))
JCFG = replace(JCFG, moe=replace(JCFG.moe, capacity_factor=CAPACITY_FACTOR))
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def jax_flat(tree):
    """{path key: fp32 numpy} of a JAX tree, keys as ``repro_torch.tree``'s."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(leaf, np.float32) for path, leaf in flat}


def torch_flat(tree):
    return {k: f32(v) for k, v in flatten_with_keys(tree)}


def held_by_share(got, want, what):
    """Share, RMS and cap of |got - want| / max |want| (see the docstring)."""
    scale = float(np.abs(want).max())
    assert scale > 0, what
    rel = np.abs(got - want) / scale
    share = float((rel <= SHARE_TOL).mean())
    rms = float(np.sqrt(np.mean(rel ** 2)))
    assert share >= 0.99 and rms <= SHARE_TOL / 2 and rel.max() <= 0.5, \
        f"{what}: share {share:.4f}, RMS {rms:.4f}, cap {rel.max():.4f}"


def greedy_tokens_agree(got, want):
    """The greedy token wherever the reference's top-2 margin is clear."""
    got, want = f32(got), f32(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (SHARE_TOL + SHARE_TOL * np.abs(top2[..., 1]))
    assert clear.sum() > 0
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def dropped(idx, n_experts, capacity):
    """(token, expert) choices that find no slot: an expert keeps the first
    min(capacity, T) tokens that chose it."""
    idx = np.asarray(idx)
    counts = np.bincount(idx.reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - min(capacity, idx.shape[0]), 0).sum())


@pytest.fixture(scope="module")
def setup():
    arrays = convert.params_to_numpy(tm.init_params(CFG, seed=0, device="cpu"))
    tokens = JaxSyntheticLM(CFG.vocab, S, B, seed=3).batch(0)
    return arrays, tokens


def params_in(arrays, dtype):
    """The weights as (JAX tree, port tree): all fp32, or bf16 with the JAX
    package's own leaf types (the router fp32)."""
    if dtype == torch.float32:
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), arrays)
    else:
        shapes = jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.key(0)))
        jp = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    return jp, convert.params_from_numpy(arrays, "cpu", dtype=dtype)


@jax.jit
def jax_value_and_grad(p, tok):
    """The reference's (loss, logits) of forward + lm_loss and its gradient."""
    def loss(q):
        logits = jm.forward(q, tok, JCFG, remat=False)
        return jm.lm_loss(logits, tok), logits
    return jax.value_and_grad(loss, has_aux=True)(p)


@pytest.fixture(scope="module")
def value_and_grads(setup):
    """{dtype: (JAX loss, JAX grads, JAX logits)} of forward + lm_loss,
    jitted, built once."""
    arrays, tokens = setup
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        (value, logits), grads = jax_value_and_grad(params_in(arrays, dtype)[0],
                                                    jnp.asarray(tokens))
        out[dtype] = (float(value), jax_flat(grads), f32(logits))
    return out


def port_value_and_grad(params, tokens, remat=True):
    """(loss, {key: gradient}, logits) of the port's forward + lm_loss."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tok = torch.from_numpy(np.asarray(tokens)).long()
    logits = tm.forward(unflatten(params, flat), tok, CFG, remat=remat)
    loss = tm.lm_loss(logits, tok)
    grads = torch.autograd.grad(loss, flat)
    return (loss.detach(), dict(zip([k for k, _ in flatten_with_keys(params)], grads)),
            logits.detach())


def test_fp32_loss_and_grads_match_jax_value_and_grad(setup, value_and_grads):
    arrays, tokens = setup
    want_loss, want, _ = value_and_grads[torch.float32]
    loss, grads, _ = port_value_and_grad(params_in(arrays, torch.float32)[1], tokens)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5, abs=1e-5)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        err = float(np.abs(f32(g) - want[k]).max())
        assert err <= GRAD_TOL * scale, \
            f"{k}: max abs err {err:.3e} beyond {GRAD_TOL} x {scale:.3e}"


def test_bf16_loss_and_grads_match_jax_value_and_grad(setup, value_and_grads):
    arrays, tokens = setup
    want_loss, want, want_logits = value_and_grads[torch.bfloat16]
    params = params_in(arrays, torch.bfloat16)[1]
    loss, grads, logits = port_value_and_grad(params, tokens)
    assert abs(float(loss) - want_loss) <= 3e-2
    greedy_tokens_agree(logits, want_logits)
    for k, g in grads.items():
        assert g.dtype == dict(flatten_with_keys(params))[k].dtype, k
        held_by_share(f32(g), want[k], k)


@pytest.mark.parametrize("name", list(DTYPES))
def test_tokens_drop_on_both_sides_alike(setup, monkeypatch, name):
    """The MoE layer's routed experts drop (token, expert) choices at the
    capacity, as many in the port's forward as in the reference's (op by
    op), and not 0."""
    dtype, _ = DTYPES[name]
    arrays, tokens = setup
    jp, params = params_in(arrays, dtype)
    seen = {"jax": [], "port": []}
    real_j, real_t = jmoe._routed_experts, tmoe._routed_experts

    def jax_routed(xt, w, idx, w1, w3, w2, e0, capacity, act):
        seen["jax"].append(dropped(idx, w1.shape[0], capacity))
        return real_j(xt, w, idx, w1, w3, w2, e0, capacity, act)

    def port_routed(xt, w, idx, w1, w3, w2, capacity, act):
        seen["port"].append(dropped(idx.numpy(), w1.shape[0], capacity))
        return real_t(xt, w, idx, w1, w3, w2, capacity, act)

    monkeypatch.setattr(jmoe, "_routed_experts", jax_routed)
    monkeypatch.setattr(tmoe, "_routed_experts", port_routed)
    with jax.disable_jit():
        jm.forward(jp, jnp.asarray(tokens), JCFG, remat=False)
    port_value_and_grad(params, tokens)     # forward, and again under remat
    assert len(seen["jax"]) == 1 and seen["jax"][0] > 0
    assert seen["port"] == seen["jax"] * 2


@pytest.mark.parametrize("name", list(DTYPES))
def test_every_leaf_gets_a_gradient(setup, name):
    """Every leaf, the router's (through the top-k weights) and every routed
    and shared expert's among them, gets a nonzero gradient; the router's
    stays fp32, and every routed expert takes some token."""
    dtype, _ = DTYPES[name]
    arrays, tokens = setup
    _, grads, _ = port_value_and_grad(params_in(arrays, dtype)[1], tokens)
    for k, g in grads.items():
        assert bool((g != 0).any()), k
    for leaf in ("w_gate", "w1", "w3", "w2", "sh_gate", "sh_up", "sh_down"):
        assert f"moe_layers/moe/{leaf}" in grads, leaf
    assert grads["moe_layers/moe/w_gate"].dtype == torch.float32
    per_expert = grads["moe_layers/moe/w2"][0].abs().sum(dim=(1, 2))
    assert bool((per_expert > 0).all())


def test_remat_on_and_off_bit_identical(setup):
    arrays, tokens = setup
    params = params_in(arrays, torch.float32)[1]
    loss_a, ga, _ = port_value_and_grad(params, tokens, remat=True)
    loss_b, gb, _ = port_value_and_grad(params, tokens, remat=False)
    assert torch.equal(loss_a, loss_b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(setup, value_and_grads, microbatches):
    """One ``make_train_step`` (fp32) against the reference's (jitted): loss,
    gradient norm and learning rate, and the updated parameters where the
    reference's full-batch gradient is clear of the gradients' agreement;
    everywhere else both moves are at most lr (1 + weight_decay |p|).  With
    2 microbatches each half of the batch competes for the experts' slots
    on its own, on both sides, so the step's gradient is the mean of the
    reference's gradients of the two halves, not that of the whole batch."""
    arrays, tokens = setup
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp, params = params_in(arrays, torch.float32)
    jstep = jax.jit(jt.make_train_step(JCFG, jt.AdamWConfig(**opt_kw), microbatches))
    js, jmet = jstep(jt.init_train_state(jp), jnp.asarray(tokens))
    p_before = torch_flat(params)
    step = tt.make_train_step(CFG, tt.AdamWConfig(**opt_kw), microbatches, device="cpu")
    ts, tmet = step(tt.init_train_state(params), tokens)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5, abs=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(ts.opt.step) == int(js.opt.step) == 1
    want, got, g = jax_flat(js.params), torch_flat(ts.params), value_and_grads[torch.float32][1]
    if microbatches > 1:
        halves = [jax_flat(jax_value_and_grad(jp, jnp.asarray(half))[1])
                  for half in np.split(np.asarray(tokens), microbatches)]
        g = {k: np.mean([h[k] for h in halves], axis=0) for k in g}
    n_clear = n_all = 0
    for k in want:
        clear = np.abs(g[k]) > 10 * GRAD_TOL * (1 + np.abs(g[k]).max())
        assert clear.any(), k
        n_clear, n_all = n_clear + clear.sum(), n_all + clear.size
        np.testing.assert_allclose(got[k][clear], want[k][clear], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        bound = opt_kw["lr"] * (1 + 0.1 * np.abs(p_before[k])) * (1 + 1e-5)
        for moved in (got[k] - p_before[k], want[k] - p_before[k]):
            assert (np.abs(moved) <= bound + 1e-7).all(), k
    # 0.489 of the elements (both cases): each routed expert's weights take
    # the gradient of its own tokens only, and more of them lie near 0 than
    # in the dense and SSM models' leaves, which pass a half
    assert n_clear > 0.45 * n_all


def test_launcher_trains_deepseek_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch deepseek-moe-16b --reduce
    --device cpu``: the reference's log lines, and the loss falls."""
    from repro_torch.launch import train as launch
    launch.main(["--arch", ARCH, "--reduce", "--device", "cpu", "--steps", "8", "--seq", "64",
                 "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "arch=deepseek-moe-16b" in out and "done in" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.5
