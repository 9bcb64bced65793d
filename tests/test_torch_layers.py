"""The port's transformer building blocks against their JAX twins, on the
same numpy inputs.  Tolerances (rtol = atol): 2e-5 for fp32 functions, 2e-2
for bf16 ones (both sides round to bf16 at different places of a long
product), exact where nothing is accumulated."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import layers as jl
# the port
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import layers as tl

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CFG = reduce_for_smoke(get_arch("llama3.2-3b"))
JCFG = jax_reduce(jax_get_arch("llama3.2-3b"))


def both(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def attn_params(rng, cfg, dtype="bfloat16"):
    d, h, g, e = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"ln": ((d,), 1.0), "wq": ((d, h, e), d ** -0.5), "wk": ((d, g, e), d ** -0.5),
              "wv": ((d, g, e), d ** -0.5), "wo": ((h, e, d), (h * e) ** -0.5)}
    if cfg.qk_norm:
        shapes["q_norm"] = ((e,), 1.0)
        shapes["k_norm"] = ((e,), 1.0)
    jp, tp = {}, {}
    for key, (shape, s) in shapes.items():
        jp[key], tp[key] = both(rng, shape, dtype, s)
    return jp, tp


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(plus_one, dtype):
    rng = np.random.default_rng(0)
    jx, tx = both(rng, (2, 5, 256), dtype)
    jw, tw = both(rng, (256,), dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(f32(tl.rms_norm(tx, tw, plus_one=plus_one)),
                               f32(jl.rms_norm(jx, jw, plus_one=plus_one)),
                               rtol=tol, atol=tol)
    assert tl.rms_norm(tx, tw).dtype == tx.dtype


@pytest.mark.parametrize("sections", [None, (8, 12, 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(sections, dtype):
    rng = np.random.default_rng(1)
    jx, tx = both(rng, (2, 9, 4, 64), dtype)
    if sections is None:
        pos = rng.integers(0, 4000, size=(2, 9))
    else:
        pos = rng.integers(0, 4000, size=(3, 2, 9))
    tol = 1e-4 if dtype == "float32" else 2e-2   # fp32: cos/sin of angles up to 4e3
    got = tl.apply_rope(tx, torch.from_numpy(pos), 5e5, sections)
    want = jl.apply_rope(jx, jnp.asarray(pos), 5e5, sections)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(tl.rope_freqs(64, 5e5)), f32(jl.rope_freqs(64, 5e5)),
                               rtol=1e-6)


def test_apply_rope_mrope_text_only_fallback():
    rng = np.random.default_rng(2)
    jx, tx = both(rng, (1, 6, 2, 64), "float32")
    pos = np.arange(6)[None]
    np.testing.assert_allclose(
        f32(tl.apply_rope(tx, torch.from_numpy(pos), 1e4, (8, 12, 12))),
        f32(jl.apply_rope(jx, jnp.asarray(pos), 1e4, (8, 12, 12))), rtol=2e-5, atol=2e-5)


GQA_CASES = {
    "causal": dict(causal=True),
    "noncausal": dict(causal=False),
    "window": dict(causal=True, window=5),
    "softcap": dict(causal=True, softcap=50.0),
    "scale": dict(causal=True, scale=0.07),
}


@pytest.mark.parametrize("case", sorted(GQA_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_attention(case, dtype):
    rng = np.random.default_rng(3)
    jq, tq = both(rng, (2, 12, 4, 64), dtype)
    jk, tk = both(rng, (2, 12, 2, 64), dtype)
    jv, tv = both(rng, (2, 12, 2, 64), dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    kw = GQA_CASES[case]
    np.testing.assert_allclose(f32(tl.gqa_attention(tq, tk, tv, **kw)),
                               f32(jl.gqa_attention(jq, jk, jv, **kw)), rtol=tol, atol=tol)


def test_gqa_attention_explicit_positions():
    """Decode-shaped call: one query at position 6 against a cache of 10."""
    rng = np.random.default_rng(4)
    jq, tq = both(rng, (2, 1, 4, 64), "float32")
    jk, tk = both(rng, (2, 10, 2, 64), "float32")
    jv, tv = both(rng, (2, 10, 2, 64), "float32")
    qpos = np.full((2, 1), 6)
    kpos = np.broadcast_to(np.arange(10), (2, 10)).copy()
    got = tl.gqa_attention(tq, tk, tv, causal=True, window=4,
                           q_positions=torch.from_numpy(qpos),
                           kv_positions=torch.from_numpy(kpos))
    want = jl.gqa_attention(jq, jk, jv, causal=True, window=4,
                            q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos))
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_block(act):
    rng = np.random.default_rng(5)
    cfg, jcfg = replace(CFG, act=act), replace(JCFG, act=act)
    d, f = cfg.d_model, cfg.d_ff
    jp, tp = {}, {}
    for key, shape, s in (("ln", (d,), 1.0), ("w_gate", (d, f), d ** -0.5),
                          ("w_up", (d, f), d ** -0.5), ("w_down", (f, d), f ** -0.5)):
        jp[key], tp[key] = both(rng, shape, "bfloat16", s)
    jx, tx = both(rng, (2, 7, d), "bfloat16")
    np.testing.assert_allclose(f32(tl.mlp_block(tp, tx, cfg)), f32(jl.mlp_block(jp, jx, jcfg)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("scale", [0.3, 3.0, 30.0])
def test_gelu_matches_jax_bit_for_bit_in_bf16(scale):
    """zamba2-7b's shared MLP: the port's tanh gelu rounds each bf16 step
    where ``jax.nn.gelu(approximate=True)`` does, evaluated op by op (and
    jitted: XLA keeps the same roundings here), so the two agree exactly;
    ``F.gelu(approximate="tanh")`` rounds once and does not."""
    rng = np.random.default_rng(8)
    jx, tx = both(rng, (4096,), "bfloat16", scale)
    with jax.disable_jit():
        want = f32(jax.nn.gelu(jx, approximate=True))
    np.testing.assert_array_equal(f32(tl._gelu_tanh(tx)), want)
    np.testing.assert_array_equal(want, f32(jax.nn.gelu(jx, approximate=True)))
    fused = f32(torch.nn.functional.gelu(tx, approximate="tanh"))
    assert (fused != want).any()


def test_gelu_mlp_block_matches_jax_op_by_op_in_bf16():
    """The whole gated-gelu MLP block in bf16 against the JAX block run op
    by op: the activation is exact (above), so only the three products'
    summation order is left, which flips a last bit now and then."""
    rng = np.random.default_rng(9)
    cfg, jcfg = replace(CFG, act="gelu"), replace(JCFG, act="gelu")
    d, f = cfg.d_model, cfg.d_ff
    jp, tp = {}, {}
    for key, shape, s in (("ln", (d,), 1.0), ("w_gate", (d, f), d ** -0.5),
                          ("w_up", (d, f), d ** -0.5), ("w_down", (f, d), f ** -0.5)):
        jp[key], tp[key] = both(rng, shape, "bfloat16", s)
    jx, tx = both(rng, (2, 7, d), "bfloat16")
    with jax.disable_jit():
        want = f32(jl.mlp_block(jp, jx, jcfg))
    got = f32(tl.mlp_block(tp, tx, cfg))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("variant", ["llama", "qk_norm_gemma", "softcap_scale"])
def test_attention_block_no_cache_and_prefill(variant):
    """Modes 1 and 2: full sequence without a cache, and prefill into a
    cache; the cache the port filled in place equals the one JAX returns."""
    changes = {"llama": {}, "qk_norm_gemma": dict(qk_norm=True, gemma_norm=True),
               "softcap_scale": dict(attn_softcap=50.0, attn_scale=0.1)}[variant]
    cfg, jcfg = replace(CFG, **changes), replace(JCFG, **changes)
    rng = np.random.default_rng(6)
    jp, tp = attn_params(rng, cfg)
    jx, tx = both(rng, (2, 11, cfg.d_model), "bfloat16")
    want, _ = jl.attention_block(jp, jx, jcfg)
    got, none = tl.attention_block(tp, tx, cfg)
    assert none is None
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)

    shape = (2, 11, cfg.n_kv_heads, cfg.head_dim)
    jzero = jnp.zeros(shape, jnp.bfloat16)
    want, (jk, jv) = jl.attention_block(jp, jx, jcfg, kv_cache=(jzero, jzero),
                                        cache_pos=jnp.zeros((), jnp.int32))
    ck, cv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16)
    got, (nk, nv) = tl.attention_block(tp, tx, cfg, kv_cache=(ck, cv), cache_pos=0,
                                       pinned_rows=11)
    assert nk is ck and nv is cv                     # updated in place
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(ck), f32(jk), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(cv), f32(jv), rtol=2e-2, atol=2e-2)


def test_attention_block_prefill_into_longer_cache():
    """The reference may prefill into a cache longer than the prompt; the
    port attends over a strided slice of it and leaves the tail untouched."""
    rng = np.random.default_rng(7)
    jp, tp = attn_params(rng, CFG)
    jx, tx = both(rng, (1, 9, CFG.d_model), "bfloat16")
    shape = (1, 16, CFG.n_kv_heads, CFG.head_dim)
    jzero = jnp.zeros(shape, jnp.bfloat16)
    want, (jk, _) = jl.attention_block(jp, jx, JCFG, kv_cache=(jzero, jzero),
                                       cache_pos=jnp.zeros((), jnp.int32))
    ck, cv = torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16)
    got, _ = tl.attention_block(tp, tx, CFG, kv_cache=(ck, cv), cache_pos=0)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(ck), f32(jk), rtol=2e-2, atol=2e-2)
    assert not ck[:, 9:].any()


def test_attention_block_decode():
    """Mode 3: one token against a cache; then the same with ``cache_rows``:
    only the chosen rows write their K/V and attend."""
    rng = np.random.default_rng(8)
    jp, tp = attn_params(rng, CFG)
    shape = (3, 16, CFG.n_kv_heads, CFG.head_dim)
    jk0, tk0 = both(rng, shape, "bfloat16")
    jv0, tv0 = both(rng, shape, "bfloat16")
    jx, tx = both(rng, (3, 1, CFG.d_model), "bfloat16")
    pos = 7
    want, (jk, jv) = jl.attention_block(jp, jx, JCFG, kv_cache=(jk0, jv0),
                                        cache_pos=jnp.asarray(pos, jnp.int32))
    ck, cv = tk0.clone(), tv0.clone()
    got, _ = tl.attention_block(tp, tx, CFG, kv_cache=(ck, cv), cache_pos=pos)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(ck), f32(jk), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(cv), f32(jv), rtol=2e-2, atol=2e-2)

    ck, cv = tk0.clone(), tv0.clone()
    rows = torch.tensor([0, 2])
    lens = torch.tensor([pos + 1, 0, pos + 1], dtype=torch.int32)
    got, _ = tl.attention_block(tp, tx, CFG, kv_cache=(ck, cv), cache_pos=pos,
                                cache_rows=rows, cache_len=lens)
    np.testing.assert_allclose(f32(got[rows]), f32(want)[[0, 2]], rtol=2e-2, atol=2e-2)
    assert torch.equal(ck[1], tk0[1]) and torch.equal(cv[1], tv0[1])
    np.testing.assert_allclose(f32(ck[rows]), f32(jk)[[0, 2]], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ["positions", "chunked_prefill"])
def test_attention_block_raises_outside_the_kernels(case):
    """What the two kernels do not compute raises; nothing routes to the
    plain oracle: chunked prefill (``NotImplementedError``) and M-RoPE's
    3-plane positions, which the reference cannot run either
    (``ValueError``); (B, S) positions are computed
    (tests/test_torch_positions.py)."""
    rng = np.random.default_rng(9)
    cfg = CFG
    s = 4
    cache = (torch.zeros(1, 8, CFG.n_kv_heads, CFG.head_dim, dtype=torch.bfloat16),) * 2
    if case == "positions":
        kw, error = dict(positions=torch.zeros(3, 1, 4, dtype=torch.long)), ValueError
    else:
        kw, error = dict(kv_cache=cache, cache_pos=2), NotImplementedError
    _, tp = attn_params(rng, cfg)
    _, tx = both(rng, (1, s, cfg.d_model), "bfloat16")
    with pytest.raises(error):
        tl.attention_block(tp, tx, cfg, **kw)


def test_global_layer_of_a_windowed_config_runs():
    cfg = replace(CFG, window=4, local_global_period=2)
    jcfg = replace(JCFG, window=4, local_global_period=2)
    rng = np.random.default_rng(10)
    jp, tp = attn_params(rng, cfg)
    jx, tx = both(rng, (1, 6, cfg.d_model), "bfloat16")
    want, _ = jl.attention_block(jp, jx, jcfg, layer_is_local=jnp.asarray(False))
    got, _ = tl.attention_block(tp, tx, cfg, layer_is_local=False)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)


LOCAL_CASES = {
    "window_no_cache": dict(window=4),
    "window_prefill": dict(window=4),
    "window_decode": dict(window=4),
    "softcap_decode": dict(attn_softcap=5.0),
    "window_softcap_decode": dict(window=4, attn_softcap=5.0),
}


@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_attention_block_local_layer_and_decode_softcap_match_jax(case):
    """gemma2's attention in the kernels' place: a local layer's window (4
    rows, binding: 11 tokens, or a decode at position 11) and the logit
    softcap at decode (5.0, which bends the scores of these inputs), against
    the JAX block; the window must change the output."""
    changes = dict(LOCAL_CASES[case], local_global_period=2, attn_scale=0.2)
    cfg, jcfg = replace(CFG, **changes), replace(JCFG, **changes)
    rng = np.random.default_rng(11)
    jp, tp = attn_params(rng, cfg)
    s = 1 if case.endswith("decode") else 11
    jx, tx = both(rng, (3, s, cfg.d_model), "bfloat16", 3.0)
    shape = (3, 16, cfg.n_kv_heads, cfg.head_dim)
    jk0, tk0 = both(rng, shape, "bfloat16", 3.0)
    jv0, tv0 = both(rng, shape, "bfloat16")
    jkw, kw = dict(layer_is_local=jnp.asarray(True)), dict(layer_is_local=True)
    if case.endswith("prefill"):
        jkw.update(kv_cache=(jk0[:, :s] * 0, jv0[:, :s] * 0),
                   cache_pos=jnp.zeros((), jnp.int32))
        kw.update(kv_cache=(tk0[:, :s] * 0, tv0[:, :s] * 0), cache_pos=0, pinned_rows=s)
    elif case.endswith("decode"):
        jkw.update(kv_cache=(jk0, jv0), cache_pos=jnp.asarray(11, jnp.int32))
        kw.update(kv_cache=(tk0.clone(), tv0.clone()), cache_pos=11)
    want, _ = jl.attention_block(jp, jx, jcfg, **jkw)
    got, _ = tl.attention_block(tp, tx, cfg, **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-2, atol=2e-2)
    if "window" in case:
        kw["layer_is_local"] = False
        if "kv_cache" in kw:
            kw["kv_cache"] = tuple(c.clone() for c in kw["kv_cache"])
        wide, _ = tl.attention_block(tp, tx, cfg, **kw)
        assert np.abs(f32(wide) - f32(got)).max() > 0.1
