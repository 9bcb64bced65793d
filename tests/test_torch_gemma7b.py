"""The port's gemma-7b at its published head size, 256, against the JAX
package's, on the CPU.

``reduce_for_smoke(gemma-7b)`` sets head_dim to 64, where every attention
call fits the kernels the earlier slices had; here it is put back to 256 and
nothing else changes: two layers, d_model 256, four heads (MHA, as the 7b
model), so q is 4 x 256 = 1024 wide against a d_model of 256, GeGLU with the
tanh gelu, ``gemma_norm`` (1 + scale) and the sqrt(d_model) embedding scale.
Prompts of 80 tokens lie past the 58 rows the flash kernel's pin budget
holds whole at this head size, and 64 rows are pinned where bf16 allows it
(fp32 holds no 64-row tile at head_dim 256).  Weights are the JAX package's
``init_params``, carried over by ``repro_torch.convert``.  Tolerances (rtol =
atol): 2e-5 for fp32 attention and 2e-2 for bf16, the reference's; logits
3e-2 in bf16 and 1e-4 in fp32.  The JAX side runs op by op
(``jax.disable_jit()``, see tests/test_torch_model.py), once per module.
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
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as tl

TOL = 3e-2
FP32_TOL = 1e-4
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, STEPS = 2, 80, 4
PINNED = 64      # one KV tile: what the bf16 kernel holds at head_dim 256
CFG = replace(reduce_for_smoke(get_arch("gemma-7b")), head_dim=256)
JCFG = replace(jax_reduce(jax_get_arch("gemma-7b")), head_dim=256)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def pinned_for(dtype):
    return PINNED if dtype == "bfloat16" else 0


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


def test_published_config_and_the_reduced_width():
    """gemma-7b as the chip run serves it, and the configuration the tests
    run: the published head size on a reduced width, q wider than d_model."""
    cfg = get_arch("gemma-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab) == (28, 3072, 16, 16, 256, 24576, 256000)
    assert (cfg.act, cfg.gemma_norm, cfg.window, cfg.attn_softcap, cfg.attn_scale) == (
        "gelu", True, None, None, None)
    assert cfg.head_dim in flash_ops.HEAD_DIMS and cfg.head_dim in decode_ops.HEAD_DIMS
    assert CFG.head_dim == JCFG.head_dim == 256 and CFG.n_heads == CFG.n_kv_heads == 4
    assert CFG.n_heads * CFG.head_dim == 1024 != CFG.d_model
    assert replace(CFG, head_dim=64) == reduce_for_smoke(get_arch("gemma-7b"))


def test_convert_keeps_the_reference_tree(model):
    """The JAX tree at head_dim 256 crosses to the port leaf for leaf, and
    the port's own draw has the same keys, shapes and types."""
    params = model["params"]
    jleaves, jdef = jax.tree.flatten(model["jparams"])
    leaves, tdef = jax.tree.flatten(params)
    assert jdef == tdef
    for a, b in zip(jleaves, leaves):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    attn = params["layers"]["attn"]
    assert tuple(attn["wq"].shape) == (2, 256, 4, 256)
    assert tuple(attn["wo"].shape) == (2, 4, 256, 256)
    own = tm.init_params(CFG, seed=0, device="cpu")
    assert jax.tree.structure(own) == tdef
    for a, b in zip(leaves, jax.tree.leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(model, mode, dtype):
    """Layer 0's attention weights at head_dim 256 on S = 80 rows of
    activations, or one token at position 83 against a cache of 84 rows."""
    lp = {k: v[0] for k, v in model["arrays"]["layers"]["attn"].items()}
    jp = {k: jnp.asarray(v, JDT[dtype]) for k, v in lp.items()}
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in lp.items()}
    rng = np.random.default_rng(1)
    s = 1 if mode == "decode" else S
    x = rng.standard_normal((B, s, CFG.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    jkw, kw = {}, {}
    rows = S + STEPS
    kv = rng.standard_normal((2, B, rows, CFG.n_kv_heads, CFG.head_dim)).astype(np.float32)
    if mode == "prefill":
        zero = np.zeros((B, s, CFG.n_kv_heads, CFG.head_dim), np.float32)
        jkw.update(kv_cache=(jnp.asarray(zero, JDT[dtype]),) * 2,
                   cache_pos=jnp.zeros((), jnp.int32))
        kw.update(kv_cache=tuple(torch.zeros(zero.shape, dtype=TDT[dtype]) for _ in range(2)),
                  cache_pos=0, pinned_rows=pinned_for(dtype))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_mlp_block_matches_jax(model, dtype):
    """Layer 0's GeGLU block (tanh gelu, gemma_norm) op by op."""
    lp = {k: v[0] for k, v in model["arrays"]["layers"]["mlp"].items()}
    x = np.random.default_rng(2).standard_normal((B, 16, CFG.d_model)).astype(np.float32)
    with jax.disable_jit():
        want = jl.mlp_block({k: jnp.asarray(v, JDT[dtype]) for k, v in lp.items()},
                            jnp.asarray(x, JDT[dtype]), JCFG)
    got = tl.mlp_block({k: torch.from_numpy(v).to(TDT[dtype]) for k, v in lp.items()},
                       torch.from_numpy(x).to(TDT[dtype]), CFG)
    close(got, want, ATTN_TOL[dtype] if dtype == "float32" else TOL)


def test_forward_matches_jax(model):
    got = tm.forward(model["params"], torch.from_numpy(model["tokens"]), CFG)
    assert got.shape == (B, S + STEPS, CFG.vocab) and got.dtype == torch.bfloat16
    close(got, model["ref"]["forward"], TOL)


def test_forward_matches_jax_in_fp32(model):
    params = convert.params_from_numpy(model["arrays"], "cpu", dtype=torch.float32)
    got = tm.forward(params, torch.from_numpy(model["tokens"]), CFG)
    assert got.dtype == torch.float32
    close(got, model["ref"]["forward_fp32"], FP32_TOL)


def test_prefill_matches_jax(model):
    jlogits, jcache = model["ref"]["prefill"]
    logits, cache = tm.prefill(model["params"], torch.from_numpy(model["tokens"][:, :S]), CFG,
                               pinned_rows=PINNED)
    close(logits, jlogits, TOL)
    close(cache.k, jcache.k, TOL)
    close(cache.v, jcache.v, TOL)
    assert cache.k.shape[-1] == 256 and cache.pos == int(jcache.pos) == S


def test_decode_steps_match_jax(model):
    """STEPS decode steps from the reference's prefilled cache: logits at
    every step, then K/V; the cache is written in place."""
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
    """The port's own prefill (64 rows pinned in bf16, none in fp32) then
    decode, one token at a time, follows its full forward (fp32 1e-4, bf16
    3e-2): the flash and decode paths agree at head_dim 256."""
    params = convert.params_from_numpy(model["arrays"], "cpu", dtype=TDT[dtype])
    tok = torch.from_numpy(model["tokens"])
    full = tm.forward(params, tok, CFG)
    logits, cache = tm.prefill(params, tok[:, :S], CFG, pinned_rows=pinned_for(dtype))
    tol = FP32_TOL if dtype == "float32" else TOL
    close(logits, full[:, S - 1], tol)
    pad = torch.zeros_like(cache.k[:, :, :STEPS])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    for t in range(S, S + STEPS):
        logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, CFG)
        close(logits[:, 0], full[:, t], tol)


def test_kernels_get_head_dim_256(model, monkeypatch):
    """Every attention call hands the kernels q, k and v of head size 256
    and the scale 256^-0.5, with no window or softcap; a 64-row pin reaches
    the flash kernel, and the same pin in fp32 is refused as too large for
    the kernel's shared memory."""
    seen = []

    def spy(name):
        real = getattr(tl, name)

        def call(q, k, v, *args, **kw):
            seen.append((name, q.shape[-1], k.shape[-1], kw.get("scale"), kw.get("window"),
                         kw.get("softcap"), kw.get("pinned_rows")))
            return real(q, k, v, *args, **kw)
        monkeypatch.setattr(tl, name, call)

    spy("flash_attention")
    spy("decode_attention")
    tok = torch.from_numpy(model["tokens"])
    _, cache = tm.prefill(model["params"], tok[:, :S], CFG, pinned_rows=PINNED)
    pad = torch.zeros_like(cache.k[:, :, :1])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    tm.decode_step(model["params"], tok[:, S:S + 1], cache, CFG)
    assert seen == [("flash_attention", 256, 256, 1 / 16, None, None, PINNED)] * 2 + [
        ("decode_attention", 256, 256, 1 / 16, None, None, None)] * 2
    params = convert.params_from_numpy(model["arrays"], "cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        tm.prefill(params, tok[:, :S], CFG, pinned_rows=PINNED)
