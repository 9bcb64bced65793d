"""The port's gemma2 attention (a sliding window on local layers, logit
softcaps, a score scale that is not 1/sqrt(head_dim)) against the JAX
package's, on the CPU, and the repaired layer-at-a-time weight draw.

``reduce_for_smoke(gemma2-27b)`` has two layers, layer 0 local with a window
of 64 rows and layer 1 global, attention softcap 50, final softcap 30 and
scale 144^-0.5.  Prompts of 100 tokens and decode steps up to position 103
overrun the window, in prefill and at every decode step.  Weights are the
JAX package's ``init_params``, carried over by ``repro_torch.convert``.
Tolerances (rtol = atol): 2e-5 for fp32 attention and 2e-2 for bf16, the
reference's; logits 3e-2 in bf16 and 1e-4 in fp32.  The JAX side runs op by
op (``jax.disable_jit()``, see tests/test_torch_model.py), once per module.
The reference's prefill keeps K/V in bf16 whatever the weights' type
(ROADMAP Queue 3), so fp32 is held on ``forward`` against JAX and, for
prefill and decode, against the port's own fp32 ``forward``."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import layers as jl
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel

TOL = 3e-2
FP32_TOL = 1e-4
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, STEPS = 2, 100, 4
CFG = reduce_for_smoke(get_arch("gemma2-27b"))
JCFG = jax_reduce(jax_get_arch("gemma2-27b"))
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def model():
    """Weights on both sides, tokens, and JAX's results op by op: forward
    over S + STEPS tokens (bf16 and fp32), prefill of S tokens and STEPS
    decode steps from its cache (grown by STEPS rows)."""
    jparams = jm.init_params(JCFG, jax.random.key(0))
    arrays = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    tokens = np.random.default_rng(0).integers(2, CFG.vocab, size=(B, S + STEPS))
    ref = {}
    with jax.disable_jit():
        ref["forward"] = jm.forward(jparams, jnp.asarray(tokens), JCFG, remat=False)
        jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
        ref["forward_fp32"] = jm.forward(jp32, jnp.asarray(tokens), JCFG, remat=False)
        logits, jcache = jm.prefill(jparams, jnp.asarray(tokens[:, :S]), JCFG)
        ref["prefill"] = (logits, jcache)
        pad = [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]
        jcache = jcache._replace(k=jnp.pad(jcache.k, pad), v=jnp.pad(jcache.v, pad))
        ref["decode_from"] = jcache
        ref["decode"] = []
        for t in range(S, S + STEPS):
            logits, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                            jcache, JCFG)
            ref["decode"].append(logits)
        ref["decode_cache"] = jcache
    return dict(jparams=jparams, arrays=arrays, tokens=tokens, ref=ref,
                params=convert.params_from_numpy(arrays, "cpu"))


def test_published_config_and_local_layers():
    """gemma2-27b as the chip run serves it, and the reduced configuration
    the tests run: layer 0 local, layer 1 global, a window of 64."""
    cfg = get_arch("gemma2-27b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (46, 4608, 32, 16, 128, 36864, 256000)
    assert (cfg.window, cfg.local_global_period, cfg.attn_softcap, cfg.final_softcap,
            cfg.attn_scale, cfg.gemma_norm, cfg.act) == (4096, 2, 50.0, 30.0, 144.0 ** -0.5,
                                                         True, "gelu")
    flags = tm.local_flags(cfg)
    assert flags == tuple(bool(x) for x in jm.local_flags(jax_get_arch("gemma2-27b")))
    assert flags[:4] == (True, False, True, False) and sum(flags) == 23
    assert tm.local_flags(CFG) == (True, False) and CFG.window == JCFG.window == 64
    assert CFG.attn_scale != CFG.head_dim ** -0.5


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(model, mode, local, dtype):
    """Layer 0's attention weights on S = 100 rows of activations, or one
    token at position 103 against a cache of 104 rows: the window binds on
    the local layer in every mode, never on the global one."""
    lp = {k: v[0] for k, v in model["arrays"]["layers"]["attn"].items()}
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in lp.items()}
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in lp.items()}
    rng = np.random.default_rng(1)
    s = 1 if mode == "decode" else S
    x = rng.standard_normal((B, s, CFG.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    jkw, kw = dict(layer_is_local=jnp.asarray(local)), dict(layer_is_local=local)
    rows = S + STEPS
    kv = rng.standard_normal((2, B, rows, CFG.n_kv_heads, CFG.head_dim)).astype(np.float32)
    if mode == "prefill":
        zero = np.zeros((B, s, CFG.n_kv_heads, CFG.head_dim), np.float32)
        jkw.update(kv_cache=(jnp.asarray(zero, JDT[dtype]),) * 2,
                   cache_pos=jnp.zeros((), jnp.int32))
        kw.update(kv_cache=tuple(torch.zeros(zero.shape, dtype=TDT[dtype]) for _ in range(2)),
                  cache_pos=0, pinned_rows=64)
    elif mode == "decode":
        jkw.update(kv_cache=tuple(jnp.asarray(a, JDT[dtype]) for a in kv),
                   cache_pos=jnp.asarray(rows - 1, jnp.int32))
        kw.update(kv_cache=tuple(torch.from_numpy(a).to(TDT[dtype]).clone() for a in kv),
                  cache_pos=rows - 1)
    with jax.disable_jit():
        want, jcache = jl.attention_block(jp, jx, JCFG, **jkw)
    got, cache = tl.attention_block(tp, tx, CFG, **kw)
    tol = ATTN_TOL[dtype]
    close(got, want, tol)
    if mode != "no_cache":
        close(cache[0], jcache[0], tol)
        close(cache[1], jcache[1], tol)


def test_forward_matches_jax(model):
    got = tm.forward(model["params"], torch.from_numpy(model["tokens"]), CFG)
    assert got.shape == (B, S + STEPS, CFG.vocab) and got.dtype == torch.bfloat16
    close(got, model["ref"]["forward"], TOL)


def test_forward_matches_jax_in_fp32(model):
    params = convert.params_from_numpy(model["arrays"], "cpu", dtype=torch.float32)
    got = tm.forward(params, torch.from_numpy(model["tokens"]), CFG)
    assert got.dtype == torch.float32
    close(got, model["ref"]["forward_fp32"], FP32_TOL)
    # the window binds: without it the logits of the last positions move
    wide = tm.forward(params, torch.from_numpy(model["tokens"]), replace(CFG, window=None))
    assert np.abs(f32(wide) - f32(got))[:, 64:].max() > 0.1


def test_prefill_matches_jax(model):
    jlogits, jcache = model["ref"]["prefill"]
    logits, cache = tm.prefill(model["params"], torch.from_numpy(model["tokens"][:, :S]), CFG,
                               pinned_rows=64)
    close(logits, jlogits, TOL)
    close(cache.k, jcache.k, TOL)
    close(cache.v, jcache.v, TOL)
    assert cache.pos == int(jcache.pos) == S


def test_decode_steps_match_jax(model):
    """STEPS decode steps past the window from the reference's prefilled
    cache: logits at every step, then K/V; the cache is written in place."""
    ref, tokens = model["ref"], model["tokens"]
    jfrom = ref["decode_from"]
    cache = convert.cache_from_numpy(f32(jfrom.k), f32(jfrom.v), int(jfrom.pos), "cpu")
    k0 = cache.k
    for t, jlogits in zip(range(S, S + STEPS), ref["decode"]):
        logits, cache = tm.decode_step(model["params"], torch.from_numpy(tokens[:, t:t + 1]),
                                       cache, CFG)
        close(logits, jlogits, TOL)
    assert cache.k is k0 and cache.pos == int(ref["decode_cache"].pos) == S + STEPS
    close(cache.k, ref["decode_cache"].k, TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_follows_forward(model, dtype):
    """The port's own prefill then decode, one token at a time past the
    window, follows its full forward: the flash and decode paths agree on
    which rows a local layer's query sees (fp32 1e-4, bf16 3e-2)."""
    params = convert.params_from_numpy(model["arrays"], "cpu", dtype=TDT[dtype])
    tok = torch.from_numpy(model["tokens"])
    full = tm.forward(params, tok, CFG)
    logits, cache = tm.prefill(params, tok[:, :S], CFG)
    tol = FP32_TOL if dtype == "float32" else TOL
    close(logits, full[:, S - 1], tol)
    pad = torch.zeros_like(cache.k[:, :, :STEPS])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    for t in range(S, S + STEPS):
        logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, CFG)
        close(logits[:, 0], full[:, t], tol)


def test_kernels_get_the_window_on_local_layers_only(model, monkeypatch):
    """Every attention call takes the window on layer 0 and none on layer 1,
    the softcap and the config's scale on both, in prefill and at decode."""
    seen = []

    def spy(name):
        real = getattr(tl, name)

        def call(*args, **kw):
            seen.append((name, kw.get("window"), kw.get("softcap"), kw.get("scale")))
            return real(*args, **kw)
        monkeypatch.setattr(tl, name, call)

    spy("flash_attention")
    spy("decode_attention")
    tok = torch.from_numpy(model["tokens"])
    _, cache = tm.prefill(model["params"], tok[:, :S], CFG)
    pad = torch.zeros_like(cache.k[:, :, :1])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    tm.decode_step(model["params"], tok[:, S:S + 1], cache, CFG, rows=[1])
    assert seen == [(name, window, 50.0, 144.0 ** -0.5)
                    for name in ("flash_attention", "decode_attention")
                    for window in (64, None)]


# ---------------------------------------------------------------------------
# the weight draw, one layer at a time
# ---------------------------------------------------------------------------
ARCHS = ["llama3.2-3b", "gemma2-27b", "mamba2-2.7b", "zamba2-7b", "deepseek-moe-16b"]


@pytest.mark.parametrize("name", ARCHS)
def test_init_draws_stacked_leaves_a_layer_at_a_time(name, monkeypatch):
    """No fp32 draw of ``init_params`` holds more than one layer of a
    stacked leaf (gemma2-27b's ``w_down`` whole is 31.3 GB of fp32), and the
    tree keeps the reference's keys, shapes and types."""
    cfg = reduce_for_smoke(get_arch(name))
    draws = []
    real = tl.init_normal

    def spy(gen, shape, std, dtype):
        draws.append(tuple(shape))
        return real(gen, shape, std, dtype)

    monkeypatch.setattr(tl, "init_normal", spy)
    monkeypatch.setattr(tmodel, "init_normal", spy)
    own = tm.init_params(cfg, seed=0, device="cpu")
    jcfg = jax_reduce(jax_get_arch(name))
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
    jleaves, jdef = jax.tree.flatten(shapes)
    leaves, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, b in zip(jleaves, leaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    # the largest draw is embed's or lm_head's, which have no layer axis; a
    # stacked leaf drawn whole would be larger at these sizes
    assert max(int(np.prod(s)) for s in draws) == cfg.vocab * cfg.d_model
    # one wo draw a layer (a hybrid: one shared block)
    want = {"dense": cfg.n_layers, "moe": cfg.n_layers, "hybrid": 1, "ssm": 0}[cfg.family]
    assert draws.count((cfg.n_heads, cfg.head_dim, cfg.d_model)) == want


@pytest.mark.parametrize("name", ["gemma2-27b", "deepseek-moe-16b"])
def test_init_keeps_each_layers_distribution(name):
    """Each layer of each drawn leaf has mean 0 and the reference's std
    (d_in^-0.5, or (h e)^-0.5 for ``wo``) within sampling error, and the
    layers differ from one another."""
    cfg = replace(reduce_for_smoke(get_arch(name)), n_layers=4)
    params = tm.init_params(cfg, seed=3, device="cpu")
    d, f = cfg.d_model, cfg.d_ff
    attn = params["layers" if name == "gemma2-27b" else "moe_layers"]["attn"]
    want = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
            "wo": (cfg.n_heads * cfg.head_dim) ** -0.5}
    leaves = [(attn[k], s) for k, s in want.items()]
    if name == "gemma2-27b":
        mlp = params["layers"]["mlp"]
        leaves += [(mlp["w_gate"], d ** -0.5), (mlp["w_up"], d ** -0.5),
                   (mlp["w_down"], f ** -0.5)]
    else:
        moe = params["moe_layers"]["moe"]
        leaves += [(moe["w1"], d ** -0.5), (moe["w2"], cfg.moe.d_ff_expert ** -0.5),
                   (moe["w_gate"], d ** -0.5)]
    for leaf, std in leaves:
        assert leaf.shape[0] == cfg.n_layers - (name != "gemma2-27b")
        for layer in leaf.float():
            n = layer.numel()
            assert abs(float(layer.mean())) < 5 * std / n ** 0.5
            assert abs(float(layer.std()) / std - 1) < 5 * (2 * n) ** -0.5 + 4e-3
        assert not torch.equal(leaf[0], leaf[1])
