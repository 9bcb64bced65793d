"""The port's training path against the JAX package's, from the same weights
and tokens: the optimizer's pieces, the loss, the gradients of ``forward`` +
``lm_loss``, one ``make_train_step``, and ports of the reference's own
training tests (tests/test_substrate.py).

The model is the reduced llama3.2-3b (2 layers, d_model 256, 4 heads / 2 KV
heads of 64, vocab 512).  JAX runs op by op under ``jax.disable_jit()``, as
the port runs; its references are built once per module.

Tolerances: optimizer pieces and the loss function on shared inputs 1e-6
(fp32, the same arithmetic in another library).  Loss and gradients of the
model in fp32: loss 1e-5, gradients rtol = atol = 1e-4 (two fp32 evaluations
summing in other orders through two layers).  In bf16 the two packages round
activations at other places, so the loss is held within 3e-2 and each
gradient leaf by the share of its elements within 3e-2 of the leaf's largest
magnitude (at least 0.99), as the serving tests hold bf16 logits.

A whole step's updated parameters are compared only where the reference's
gradient is clear of the gradients' agreement: Adam's first step moves a
parameter by about lr * sign(g) whatever |g| is, so where the two packages'
gradients agree only to 1e-4 and |g| is below that, the signs, and the
moves, may differ by 2 lr.  The rule: compare where |g_ref| > 10 x 1e-4 x
(1 + max |g_ref| of the leaf); everywhere else both moves are checked to be
at most lr (1 + weight_decay |p|)."""

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
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.data import SyntheticLM
from repro_torch.data import make_batch
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import leaves

ARCH = "llama3.2-3b"
B, S = 8, 16
GRAD_TOL = 1e-4
SHARE_TOL = 3e-2


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
    scale = float(np.abs(want).max())
    assert scale > 0, what
    share = float((np.abs(got - want) <= SHARE_TOL * scale).mean())
    assert share >= 0.99, f"{what}: {share:.4f} within {SHARE_TOL} of {scale:.3e}"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def jax_op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce(jax_get_arch(ARCH))
    cfg = reduce_for_smoke(get_arch(ARCH))
    jparams = jm.init_params(jcfg, jax.random.key(0))
    tokens = JaxSyntheticLM(cfg.vocab, S, B, seed=3).batch(0)
    return jcfg, cfg, jparams, tokens


def params_in(jparams, dtype):
    """The JAX weights as (JAX tree, port tree) in ``dtype``."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda a: a.astype(jdt), jparams)
    return jp, convert.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
                                         "cpu", dtype=dtype)


@pytest.fixture(scope="module")
def value_and_grads(setup):
    """{dtype: (JAX loss, JAX grads)} of forward + lm_loss, built once."""
    jcfg, _, jparams, tokens = setup
    out = {}
    with jax.disable_jit():
        for dtype in (torch.float32, torch.bfloat16):
            jp, _ = params_in(jparams, dtype)

            def loss_fn(p):
                return jm.lm_loss(jm.forward(p, jnp.asarray(tokens), jcfg, remat=False),
                                  jnp.asarray(tokens))

            loss, grads = jax.value_and_grad(loss_fn)(jp)
            out[dtype] = (float(loss), jax_flat(grads))
    return out


def port_value_and_grad(cfg, params, tokens, remat=True):
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    from repro_torch.tree import unflatten
    tok = torch.from_numpy(np.asarray(tokens)).long()
    loss = tm.lm_loss(tm.forward(unflatten(params, flat), tok, cfg, remat=remat), tok)
    grads = torch.autograd.grad(loss, flat)
    keys = [k for k, _ in flatten_with_keys(params)]
    return loss.detach(), dict(zip(keys, grads))


# ---------------------------------------------------------------------------
# optimizer pieces and the loss function on shared inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg_kw", [dict(), dict(lr=1.0, warmup_steps=10, total_steps=100),
                                    dict(warmup_steps=0, total_steps=10)])
def test_lr_schedule_matches_reference(cfg_kw):
    jc, tc = jt.AdamWConfig(**cfg_kw), tt.AdamWConfig(**cfg_kw)
    for step in (0, 1, 5, 10, 55, 99, 100, 10_000, 20_000):
        want = float(jt.lr_schedule(jc, jnp.asarray(step, jnp.int32)))
        got = float(tt.lr_schedule(tc, step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def grad_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}


SHAPES = {"w": (3, 8, 5), "ln": (3, 8), "b": (5,), "e": (16, 4)}


def test_global_norm_matches_reference():
    g = grad_tree(np.random.default_rng(0), SHAPES)
    want = float(jt.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = float(tt.global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("slice_elements", [None, 7], ids=["whole", "sliced"])
def test_adamw_update_matches_reference(dtype, slice_elements, monkeypatch):
    """Two updates on shared gradients (the second with the moments of the
    first), clipping engaged; the updated parameters, moments and metrics
    against the reference's.  bf16 parameters within one bf16 step (the
    fp32 value may round either way near a tie); ``sliced`` walks each leaf
    in slices of 7 elements at most, which must change no number."""
    if slice_elements:
        monkeypatch.setattr(topt, "SLICE_ELEMENTS", slice_elements)
    rng = np.random.default_rng(1)
    p0 = grad_tree(rng, SHAPES)
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(dtype) for k, v in jp.items()}
    js, ts = jt.init_opt_state(jp), tt.init_opt_state(tp)
    for _ in range(2):
        g = grad_tree(rng, SHAPES)
        jp, js, jm_ = jt.adamw_update(jt.AdamWConfig(**cfg_kw), jp,
                                      {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts, tm_ = tt.adamw_update(tt.AdamWConfig(**cfg_kw), tp,
                                      {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        assert float(tm_["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)
        assert float(tm_["grad_norm"]) == pytest.approx(float(jm_["grad_norm"]), rel=1e-6)
        assert int(ts.step) == int(js.step)
        for k in SHAPES:
            np.testing.assert_allclose(f32(ts.m[k]), np.asarray(js.m[k]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(f32(ts.v[k]), np.asarray(js.v[k]), rtol=1e-6, atol=1e-6)
            want = np.asarray(jp[k], np.float32)
            tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
            np.testing.assert_allclose(f32(tp[k]), want, rtol=tol, atol=1e-6)
            assert tp[k].dtype == dtype


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 9, 40)).astype(np.float32) * 3
    tokens = rng.integers(0, 40, size=(3, 9))
    want = float(jm.lm_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(tm.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens)))
    assert got == pytest.approx(want, rel=1e-6)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    want = float(jm.lm_loss(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(tokens)))
    assert float(tm.lm_loss(bf, torch.from_numpy(tokens))) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------
def test_fp32_loss_and_grads_match_jax_value_and_grad(setup, value_and_grads):
    _, cfg, jparams, tokens = setup
    want_loss, want = value_and_grads[torch.float32]
    _, params = params_in(jparams, torch.float32)
    loss, grads = port_value_and_grad(cfg, params, tokens)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5, abs=1e-5)
    assert sorted(grads) == sorted(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(f32(g), want[k], rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_bf16_loss_and_grads_match_jax_value_and_grad(setup, value_and_grads):
    _, cfg, jparams, tokens = setup
    want_loss, want = value_and_grads[torch.bfloat16]
    _, params = params_in(jparams, torch.bfloat16)
    loss, grads = port_value_and_grad(cfg, params, tokens)
    assert abs(float(loss) - want_loss) <= 3e-2
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16
        held_by_share(f32(g), want[k], k)


def test_remat_on_and_off_bit_identical(setup):
    """Recomputing each layer in the backward pass changes memory, not
    numbers: loss and every gradient bit for bit, in fp32."""
    _, cfg, jparams, tokens = setup
    _, params = params_in(jparams, torch.float32)
    loss_a, ga = port_value_and_grad(cfg, params, tokens, remat=True)
    loss_b, gb = port_value_and_grad(cfg, params, tokens, remat=False)
    assert torch.equal(loss_a, loss_b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(setup, value_and_grads, microbatches):
    """One ``make_train_step`` (fp32) against the reference's: loss, gradient
    norm and learning rate, and the updated parameters under the rule in
    the module's docstring (g_ref: the reference's full-batch gradient)."""
    jcfg, cfg, jparams, tokens = setup
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp, params = params_in(jparams, torch.float32)
    with jax.disable_jit():
        js, jmet = jt.make_train_step(jcfg, jt.AdamWConfig(**opt_kw), microbatches)(
            jt.init_train_state(jp), jnp.asarray(tokens))
    p_before = torch_flat(params)
    step = tt.make_train_step(cfg, tt.AdamWConfig(**opt_kw), microbatches, device="cpu")
    ts, tmet = step(tt.init_train_state(params), tokens)
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5, abs=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(ts.opt.step) == int(js.opt.step) == 1
    want, got, g = jax_flat(js.params), torch_flat(ts.params), value_and_grads[torch.float32][1]
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
    assert n_clear > 0.5 * n_all      # most parameters are compared (embed rows of
                                      # tokens absent from the batch have no gradient)


# ---------------------------------------------------------------------------
# ports of the reference's training tests (tests/test_substrate.py)
# ---------------------------------------------------------------------------
def test_lr_schedule_shape():
    cfg = tt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(tt.lr_schedule(cfg, s)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


def test_train_loss_decreases():
    cfg = reduce_for_smoke(get_arch(ARCH))
    state = tt.init_train_state(tm.init_params(cfg, seed=0, device="cpu"))
    step = tt.make_train_step(cfg, tt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40),
                              device="cpu")
    data = SyntheticLM(cfg.vocab, seq_len=64, global_batch=8)
    losses = []
    for i in range(20):
        state, metrics = step(state, data.batch(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_grad_accumulation_matches_full_batch():
    cfg = reduce_for_smoke(get_arch(ARCH))
    tokens = make_batch(cfg.vocab, 8, 32)
    opt = tt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = []
    for mb in (1, 4):
        params = tm.init_params(cfg, seed=0, device="cpu")
        out.append(tt.make_train_step(cfg, opt, microbatches=mb, device="cpu")(
            tt.init_train_state(params), tokens))
    (s1, m1), (s2, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=2e-2, atol=2e-3)


def test_watchdog_flags_stragglers():
    evicted = []
    wd = tt.StepWatchdog(threshold=3.0, evict_after=2,
                         on_straggler=lambda s, d: evicted.append(s))
    for s in range(10):
        assert not wd.record(s, 1.0)
    assert wd.record(10, 10.0)
    assert wd.record(11, 12.0)
    assert evicted == [11]
    assert not wd.record(12, 1.0)      # recovery resets the streak


def test_step_timer_measures_the_block():
    with tt.StepTimer() as t:
        sum(range(1000))
    assert t.elapsed >= 0.0


def test_train_step_runs_where_it_is_asked():
    cfg = reduce_for_smoke(get_arch(ARCH))
    params = tm.init_params(cfg, seed=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.make_train_step(cfg, tt.AdamWConfig())
    step = tt.make_train_step(cfg, tt.AdamWConfig(), microbatches=3, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(tt.init_train_state(params), make_batch(cfg.vocab, 4, 8))


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    """``python -m repro_torch.launch.train --reduce --device cpu``: the
    reference's log lines, a checkpoint, and a resume from it."""
    from repro_torch.launch import train as launch
    args = ["--reduce", "--device", "cpu", "--steps", "3", "--seq", "16", "--batch", "2",
            "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    launch.main(args)
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b" in out and "step     2 loss=" in out and "done in" in out
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000003"
    launch.main(args)
    assert "resumed from step 3" in capsys.readouterr().out
