"""The port's hybrid family (zamba2-7b: groups of Mamba2 layers, each followed
by one weight-shared attention + MLP block, then a tail of Mamba2 layers)
against the JAX package's, on the CPU.

Three reduced configurations: ``reduce_for_smoke(zamba2-7b)`` (4 layers,
period 2, no tail), the same with 5 layers (a tail of 1, as the published
81 = 13 x 6 + 3) and the same with head_dim 112 (the published head size).
Weights come from the port's ``init_params`` (seed 0), cross to numpy and go
to JAX with the dtypes of the JAX package's own ``init_params`` tree, and
back into the port through ``repro_torch.convert``.

The JAX side runs op by op (``jax.disable_jit()``), as PyTorch runs, once
per configuration.  Tolerances (rtol = atol), the reference's: 3e-2 on bf16
logits and caches, 1e-4 (the SSD scan's) in fp32.

* fp32 (the same weights widened on both sides): the full forward's logits
  agree elementwise within 1e-4; this holds the algorithm.
* bf16 (the serving type): each block of the port agrees with its JAX twin
  to the last bf16 bit but for products summed in another order (a v
  projection flips a last bit now and then), and in these models such a
  flip grows through the layers: one value in 16,384 of the logits or of
  a later application's K lands 0.032-0.037 away where 3e-2 plus 3e-2 of a
  value near 0.05 allows 0.0315.  XLA's own fused evaluation of the same
  JAX functions is further from its op-by-op one (up to 0.083, 110 logits
  beyond 3e-2).  So bf16 logits and caches are held as ``chip_smoke.py``
  holds logits across devices: at least 99.9% within 3e-2 and an RMS error
  under 3e-2 / 2, here also none beyond 6e-2, and for logits the greedy
  token wherever the reference's top-2 margin is clear of the tolerance
  (ROADMAP Queue 3).

torch runs on one thread (see tests/test_torch_ssd_scan.py for why)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import layers as port_layers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as port_ssm

TOL = 3e-2
FP32_TOL = 1e-4
B, S, STEPS = 2, 16, 4
CONFIGS = {"no_tail": {}, "tail": dict(n_layers=5), "head_dim_112": dict(head_dim=112)}
FIELDS = ("k", "v", "conv_x", "conv_bc", "ssm")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def close_bf16(got, want, what=""):
    """Results of the bf16 model against the reference's (see the module's
    docstring)."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    share = float((err <= TOL + TOL * np.abs(want)).mean())
    assert share >= 0.999, f"{what}: only {share:.5f} within {TOL}"
    assert err.max() <= 2 * TOL, f"{what}: max abs err {err.max():.4f}"
    rms = float(np.sqrt(np.mean(err ** 2)))
    assert rms <= TOL / 2, f"{what}: RMS err {rms:.4f}"


def close_logits(got, want):
    close_bf16(got, want, "logits")
    got, want = f32(got), f32(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (TOL + TOL * np.abs(top2[..., 1]))
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def jax_cache_to_port(jcache):
    return convert.cache_from_numpy(pos=int(jcache.pos), device="cpu",
                                    **{k: f32(getattr(jcache, k)) for k in FIELDS})


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """Configs, weights on both sides, tokens, and JAX's results op by op:
    forward over S tokens, prefill of S tokens, STEPS decode steps from that
    prefill's cache (grown by STEPS rows), and an fp32 forward."""
    changes = CONFIGS[request.param]
    cfg = replace(reduce_for_smoke(get_arch("zamba2-7b")), **changes)
    jcfg = replace(jax_reduce(jax_get_arch("zamba2-7b")), **changes)
    arrays = convert.params_to_numpy(tm.init_params(cfg, seed=0, device="cpu"))
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    params = convert.params_from_numpy(arrays, "cpu")
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, size=(B, S + STEPS))
    ref = {}
    with jax.disable_jit():
        prompt = jnp.asarray(tokens[:, :S])
        ref["forward"] = jm.forward(jparams, prompt, jcfg, remat=False)
        ref["prefill"] = jm.prefill(jparams, prompt, jcfg)
        pad = [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]
        jcache = ref["prefill"][1]
        jcache = jcache._replace(k=jnp.pad(jcache.k, pad), v=jnp.pad(jcache.v, pad))
        ref["decode_from"] = jcache
        ref["decode"] = []
        for t in range(S, S + STEPS):
            logits, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                            jcache, jcfg)
            ref["decode"].append(logits)
        ref["decode_cache"] = jcache
        jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
        ref["forward_fp32"] = jm.forward(jp32, prompt, jcfg, remat=False)
    return dict(cfg=cfg, jcfg=jcfg, arrays=arrays, shapes=shapes, jparams=jparams,
                params=params, tokens=tokens, ref=ref)


# ---------------------------------------------------------------------------
# parameters, caches, convert
# ---------------------------------------------------------------------------
def test_init_params_tree_matches_jax(case):
    """Keys, shapes and dtypes of ``init_params`` are the reference's:
    ``mamba_groups`` stacked (n_groups, period, ...), ``mamba_tail`` only
    with a tail, the shared block without a layer axis."""
    cfg, shapes = case["cfg"], case["shapes"]
    own = tm.init_params(cfg, seed=0, device="cpu")
    jl, jdef = jax.tree.flatten(shapes)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    period = cfg.hybrid_period
    n_groups, tail = divmod(cfg.n_layers, period)
    assert own["mamba_groups"]["w_x"].shape[:2] == (n_groups, period)
    assert ("mamba_tail" in own) == bool(tail)
    if tail:
        assert own["mamba_tail"]["a_log"].shape[0] == tail
    assert own["shared_attn"]["wq"].shape == (cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert own["shared_mlp"]["w_gate"].shape == (cfg.d_model, cfg.d_ff)
    assert own["mamba_groups"]["a_log"].dtype == torch.float32


def test_convert_crosses_the_two_axis_leaves_one_to_one(case):
    """``mamba_groups``' (n_groups, period, ...) leaves and the squeezed
    shared block cross to JAX and back unchanged, in the reference's dtypes."""
    jparams, params = case["jparams"], case["params"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree.leaves(params)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_array_equal(f32(a), f32(b))
    again = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        assert torch.equal(a, b)


def test_init_cache_matches_jax(case):
    """K/V has one entry per application of the shared block (n_layers //
    period), conv history and fp32 state one per Mamba2 layer."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    cache = tm.init_cache(cfg, 3, 24, device="cpu")
    jcache = jm.init_cache(jcfg, 3, 24)
    assert cache.pos == 0
    assert cache.k.shape[0] == cfg.n_layers // cfg.hybrid_period
    assert cache.ssm.shape[0] == cfg.n_layers
    for k in FIELDS:
        t, j = getattr(cache, k), getattr(jcache, k)
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()


# ---------------------------------------------------------------------------
# the model: forward / prefill / decode
# ---------------------------------------------------------------------------
def test_forward_matches_jax(case):
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    got = tm.forward(params, torch.from_numpy(tokens[:, :S]), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.bfloat16
    close_logits(got, case["ref"]["forward"])


def test_forward_matches_jax_in_fp32(case):
    """The same weights widened to fp32 on both sides: free of bf16
    rounding, the logits agree elementwise within 1e-4.  (The reference's
    prefill keeps K/V in bf16 whatever the weights, so fp32 is held on the
    forward.)"""
    cfg, tokens = case["cfg"], case["tokens"]
    params = convert.params_from_numpy(case["arrays"], "cpu", dtype=torch.float32)
    got = tm.forward(params, torch.from_numpy(tokens[:, :S]), cfg)
    assert got.dtype == torch.float32
    close(got, case["ref"]["forward_fp32"], FP32_TOL)


def test_prefill_matches_jax(case):
    """Logits and every cache field: K/V of each application of the shared
    block, conv histories and fp32 state of each Mamba2 layer."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    jlogits, jcache = case["ref"]["prefill"]
    logits, cache = tm.prefill(params, torch.from_numpy(tokens[:, :S]), cfg,
                               pinned_rows=S)
    close_logits(logits, jlogits)
    for k in FIELDS:
        assert getattr(cache, k).shape == getattr(jcache, k).shape, k
        close_bf16(getattr(cache, k), getattr(jcache, k), k)
    assert cache.ssm.dtype == torch.float32 and cache.pos == int(jcache.pos) == S


def test_decode_steps_match_jax(case):
    """Four decode steps from the reference's prefilled cache, on each side:
    logits every step, then every cache field; the port writes into the
    cache it was given."""
    cfg, params, tokens, ref = case["cfg"], case["params"], case["tokens"], case["ref"]
    cache = jax_cache_to_port(ref["decode_from"])
    tensors = [getattr(cache, k) for k in FIELDS]
    for t, jlogits in zip(range(S, S + STEPS), ref["decode"]):
        logits, cache = tm.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                       cache, cfg)
        assert logits.shape == (B, 1, cfg.vocab)
        close_logits(logits, jlogits)
    assert all(getattr(cache, k) is t for k, t in zip(FIELDS, tensors))
    jcache = ref["decode_cache"]
    assert cache.pos == int(jcache.pos) == S + STEPS
    for k in FIELDS:
        close_bf16(getattr(cache, k), getattr(jcache, k), k)


def test_prefill_then_decode_matches_forward(case):
    """Prefill S tokens, decode STEPS more one by one: the logits follow the
    full forward's."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    tok = torch.from_numpy(tokens)
    full = tm.forward(params, tok, cfg)
    logits, cache = tm.prefill(params, tok[:, :S], cfg)
    close(logits, full[:, S - 1])
    pad = torch.zeros_like(cache.k[:, :, :STEPS])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    for t in range(S, S + STEPS):
        logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, cfg)
        close(logits[:, 0], full[:, t])
    assert cache.pos == S + STEPS


def test_decode_step_rows_leave_other_slots_untouched(case):
    """A step for slot 1 writes slot 1's K/V at the position **and** its
    conv history and state, as a step of the whole batch would; slot 0 keeps
    all of its cache."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    rng = np.random.default_rng(7)
    cache = tm.init_cache(cfg, B, 8, device="cpu")
    for k in FIELDS:
        t = getattr(cache, k)
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    before = [getattr(cache, k).clone() for k in FIELDS]
    tok = torch.from_numpy(tokens[:, :1])
    full = tm.Cache(*[t.clone() for t in before], pos=5)
    want, full = tm.decode_step(params, tok, full, cfg)
    got, new = tm.decode_step(params, tok, cache._replace(pos=5), cfg, rows=[1])
    assert new.pos == 6
    for k, old in zip(FIELDS, before):
        t, upd = getattr(cache, k), getattr(full, k)
        assert torch.equal(t[:, 0], old[:, 0]), k             # slot 0 untouched
        assert torch.equal(t[:, 1], upd[:, 1]), k             # slot 1 as a full step
        assert not torch.equal(t[:, 1], old[:, 1]), k
    assert torch.equal(cache.k[:, 1, :5], before[0][:, 1, :5])   # only row 5 written
    assert torch.equal(got[1], want[1])


def test_each_kernel_runs_where_the_reference_attends_and_scans(case, monkeypatch):
    """What the chip run counts, on the CPU: a prefill of S >= 2 tokens calls
    the SSD scan once per Mamba2 layer and flash attention once per
    application of the shared block; a decode step calls decode attention
    once per application and no SSD scan."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    calls = {"ssd_scan": 0, "flash_attention": 0, "decode_attention": 0}

    def counting(module, name):
        real = getattr(module, name)

        def spy(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, spy)

    counting(port_ssm, "ssd_scan")
    counting(port_layers, "flash_attention")
    counting(port_layers, "decode_attention")
    _, cache = tm.prefill(params, torch.from_numpy(tokens[:, :S]), cfg)
    apps = tmodel._n_attn_apps(cfg)
    assert apps == cfg.n_layers // cfg.hybrid_period
    assert calls == {"ssd_scan": cfg.n_layers, "flash_attention": apps,
                     "decode_attention": 0}
    pad = torch.zeros_like(cache.k[:, :, :1])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    tm.decode_step(params, torch.from_numpy(tokens[:, S:S + 1]), cache, cfg)
    assert calls == {"ssd_scan": cfg.n_layers, "flash_attention": apps,
                     "decode_attention": apps}
