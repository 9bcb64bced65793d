"""The port's gemma training paths against the JAX package's, from the same
weights and tokens: the loss and every gradient of ``forward`` + ``lm_loss``,
one ``make_train_step`` with 1 and 2 microbatches, and the launcher, for

* the reduced gemma2-27b (2 layers: layer 0 local with its window cut to 64,
  layer 1 global; attention softcap 50, final softcap 30, score scale
  144^-0.5; d_model 256, 4 heads / 2 KV heads of 64, vocab 512) at 2 x 128
  tokens, so that the window binds;
* the reduced gemma-7b at its published head size (d_model 256, 2 heads MHA
  of 256, 2 layers, vocab 512), 2 x 128 tokens.

Weights come from the port's ``init_params`` (seed 0) and go to JAX as
numpy arrays.  The JAX references are built once per model and jitted.

Tolerances, as tests/test_torch_train.py: fp32 loss 1e-5, every gradient
leaf elementwise within 1e-4 of the leaf's largest magnitude.  In bf16 the
two packages round activations at other places, so the loss is held within
3e-2 and each gradient leaf by the share of its elements within 3e-2 of the
leaf's largest magnitude (at least 0.99), the RMS of that relative error (at
most 3e-2 / 2) and a cap on it (0.5), as ``chip_smoke.py``'s train parity
phases hold the card against the CPU.  A step's updated parameters are
compared where the reference's gradient is clear of the gradients'
agreement, by the rule of tests/test_torch_train.py (which must leave at
least 0.4 of the elements compared, not 0.5: see the test).  On the CPU the flash
wrapper takes its plain version, which autograd differentiates; the
backward kernel's own window, softcap and head_dim 256 are held on the card
(``chip_smoke.py``)."""

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
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import leaves
from repro_torch.tree import unflatten

B, S = 2, 128
GRAD_TOL = 1e-4
SHARE_TOL = 3e-2
# each model's changes to its reduced config: gemma-7b keeps its published
# head size (and MHA)
CUTS = {"gemma2-27b": {}, "gemma-7b": dict(n_heads=2, n_kv_heads=2, head_dim=256)}


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs several files at once, each
    process would claim every core, and these sizes gain nothing from
    more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=list(CUTS))
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def setup(arch):
    """(port config, JAX config, weights as numpy, tokens)."""
    cfg = replace(reduce_for_smoke(get_arch(arch)), **CUTS[arch])
    jcfg = replace(jax_reduce(jax_get_arch(arch)), **CUTS[arch])
    arrays = convert.params_to_numpy(tm.init_params(cfg, seed=0, device="cpu"))
    tokens = JaxSyntheticLM(cfg.vocab, S, B, seed=3).batch(0)
    return cfg, jcfg, arrays, tokens


def params_in(arrays, dtype):
    """The weights as (JAX tree, port tree) in one type."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jax.tree.map(lambda a: jnp.asarray(a, jdt), arrays),
            convert.params_from_numpy(arrays, "cpu", dtype=dtype))


@pytest.fixture(scope="module")
def value_and_grads(setup):
    """{dtype: (JAX loss, JAX grads)} of forward + lm_loss, jitted, built
    once per model."""
    _, jcfg, arrays, tokens = setup
    tok = jnp.asarray(tokens)

    def loss(p):
        return jm.lm_loss(jm.forward(p, tok, jcfg, remat=False), tok)

    vg = jax.jit(jax.value_and_grad(loss))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        value, grads = vg(params_in(arrays, dtype)[0])
        out[dtype] = (float(value), jax_flat(grads))
    return out


def port_value_and_grad(cfg, params, tokens, remat=True):
    """(loss, {key: gradient}) of the port's forward + lm_loss."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    tok = torch.from_numpy(np.asarray(tokens)).long()
    loss = tm.lm_loss(tm.forward(unflatten(params, flat), tok, cfg, remat=remat), tok)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), dict(zip([k for k, _ in flatten_with_keys(params)], grads))


def test_the_cuts_keep_what_the_kernels_see(setup, arch):
    """gemma2: a local layer whose window binds in the batch, then a global
    one, both softcaps and the published score scale; gemma-7b: head_dim 256,
    MHA, no window and no softcap."""
    cfg = setup[0]
    if arch == "gemma2-27b":
        assert tm.local_flags(cfg) == (True, False)
        assert cfg.window == 64 < S
        assert (cfg.attn_softcap, cfg.final_softcap) == (50.0, 30.0)
        assert cfg.attn_scale == pytest.approx(144.0 ** -0.5)
    else:
        assert cfg.head_dim == 256 and cfg.n_heads == cfg.n_kv_heads == 2
        assert cfg.window is None and cfg.attn_softcap is None


def test_fp32_loss_and_grads_match_jax_value_and_grad(setup, value_and_grads):
    cfg, _, arrays, tokens = setup
    want_loss, want = value_and_grads[torch.float32]
    loss, grads = port_value_and_grad(cfg, params_in(arrays, torch.float32)[1], tokens)
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
    cfg, _, arrays, tokens = setup
    want_loss, want = value_and_grads[torch.bfloat16]
    loss, grads = port_value_and_grad(cfg, params_in(arrays, torch.bfloat16)[1], tokens)
    assert abs(float(loss) - want_loss) <= 3e-2
    for k, g in grads.items():
        assert g.dtype == torch.bfloat16, k
        held_by_share(f32(g), want[k], k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_every_leaf_gets_a_gradient(setup, dtype):
    cfg, _, arrays, tokens = setup
    _, grads = port_value_and_grad(cfg, params_in(arrays, dtype)[1], tokens)
    assert {k.split("/")[0] for k in grads} == {"embed", "ln_f", "lm_head", "layers"}
    for k, g in grads.items():
        assert bool((g != 0).any()), k


def test_remat_on_and_off_bit_identical(setup):
    cfg, _, arrays, tokens = setup
    params = params_in(arrays, torch.float32)[1]
    loss_a, ga = port_value_and_grad(cfg, params, tokens, remat=True)
    loss_b, gb = port_value_and_grad(cfg, params, tokens, remat=False)
    assert torch.equal(loss_a, loss_b)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(setup, value_and_grads, microbatches):
    """One ``make_train_step`` (fp32) against the reference's (jitted): loss,
    gradient norm and learning rate, and the updated parameters where the
    reference's full-batch gradient is clear of the gradients' agreement;
    everywhere else both moves are at most lr (1 + weight_decay |p|)."""
    cfg, jcfg, arrays, tokens = setup
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp, params = params_in(arrays, torch.float32)
    jstep = jax.jit(jt.make_train_step(jcfg, jt.AdamWConfig(**opt_kw), microbatches))
    js, jmet = jstep(jt.init_train_state(jp), jnp.asarray(tokens))
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
        n_clear, n_all = n_clear + clear.sum(), n_all + clear.size
        np.testing.assert_allclose(got[k][clear], want[k][clear], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        bound = opt_kw["lr"] * (1 + 0.1 * np.abs(p_before[k])) * (1 + 1e-5)
        for moved in (got[k] - p_before[k], want[k] - p_before[k]):
            assert (np.abs(moved) <= bound + 1e-7).all(), k
    # (tests/test_torch_train.py asks half; here the 512-word embedding's rows
    # that 256 tokens miss, and the final softcap's flattening of the head's
    # gradient, leave 0.47 (gemma2) of the elements clear)
    assert n_clear > 0.4 * n_all


def test_launcher_trains_gemma_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch gemma2-27b --reduce
    --device cpu`` (and gemma-7b): the reference's log lines, and the loss
    falls."""
    from repro_torch.launch import train as launch
    launch.main(["--arch", arch, "--reduce", "--device", "cpu", "--steps", "8", "--seq", "96",
                 "--batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "done in" in out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.5
