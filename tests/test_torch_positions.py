"""Explicit (B, S) positions in the port against the JAX package, on the CPU.

The JAX package's ``forward`` and ``prefill`` take ``positions`` (B, S) and
mask by them in ``gqa_attention``: ``forward`` puts queries and keys at the
same table; ``prefill`` attends its cache (``attention_block`` at
``cache_pos`` 0), the queries at the table against the keys at their row
index, so a query whose position lies past a row sees it, and one with no
visible key (a negative position) gets the mean of all value rows (every
score -1e30).  The port computes both in the flash kernel's position variant
(``csrc/flash_attention_pos.cu``; on the CPU its plain version).

Four patterns of positions on 2 x 12 tokens: a row shifted by 5; packed
sequences whose positions restart, beside a permutation; positions past S
(three times the row index); a row starting at -4 (in ``prefill``: four
rows that see no key).  Six families: llama3.2-3b, qwen2-vl-7b (M-RoPE, its
text-only (B, S) positions), gemma2-27b (window cut to 4 so that it binds,
both softcaps), deepseek-moe-16b, zamba2-7b (the shared attention block)
and mamba2-2.7b, which ignores positions, as the reference's SSM branch
does.

Tolerances, those of the other model files: fp32 logits elementwise within
1e-5 of their scale; bf16 logits and caches by the share rule of
``tests/test_torch_hybrid.py`` (at least 99.9% within 3e-2, none beyond 6e-2,
RMS under 1.5e-2) and the greedy token where the reference's top-2 margin is
clear.  The reference's prefill keeps K/V in bf16 whatever the weights, so an
fp32 prefill is held at the layer (``attention_block`` with fp32 caches, at
2e-5, the attention kernels' fp32 tolerance).  Weights come from the port's
``init_params`` (seed 0); the JAX side runs op by op, once per module.

Also: the attention core (``flash_attention`` and ``attention_bwd_ref``
with tables) against the reference's ``gqa_attention`` and its ``jax.vjp``;
the kernel's tile walks (``kv_tiles``, ``bwd_q_tiles``, ``bwd_kv_tiles``)
emulated on the CPU against the plain mask; ``jax.grad`` of ``forward`` with
positions against the port's autograd in fp32; 3-plane positions refused
with ``ValueError`` by both packages."""

from dataclasses import replace
import math
from pathlib import Path

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
from repro_torch.core.orchestrator import FLASH_TILE_ROWS
from repro_torch.kernels import attention_bwd_ref
from repro_torch.kernels import attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as tl
from repro_torch.tree import flatten_with_keys

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
TOL = 3e-2
FP32_TOL = 1e-5          # of the logits' scale
ATTN_TOL = 2e-5          # fp32 attention, rtol = atol
GRAD_TOL = 1e-4          # fp32 gradients, rtol = atol (tests/test_torch_train.py)
B, S = 2, 12
ARCHS = ("llama3.2-3b", "qwen2-vl-7b", "gemma2-27b", "deepseek-moe-16b", "zamba2-7b",
         "mamba2-2.7b")
ATTENDING = ARCHS[:-1]
GEMMA2_WINDOW = 4


def patterns():
    """{name: (B, S) int32 positions}."""
    rng = np.random.default_rng(1)
    row = np.arange(S)
    return {
        "shifted": np.stack([row + 5, row]),
        "packed": np.stack([np.concatenate([row[:5], row[:7]]), rng.permutation(S)]),
        "past_s": np.stack([3 * row, 3 * row + 1]),
        "negative": np.stack([row - 4, row]),
    }


PATTERNS = {k: v.astype(np.int32) for k, v in patterns().items()}


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


def held(got, want, what, tol=FP32_TOL):
    """|got - want| <= tol * max |want|, elementwise."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} beyond {tol} x {scale:.3e}"


def close_bf16(got, want, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    share = float((err <= TOL + TOL * np.abs(want)).mean())
    assert share >= 0.999, f"{what}: only {share:.5f} within {TOL}"
    assert err.max() <= 2 * TOL, f"{what}: max abs err {err.max():.4f}"
    rms = float(np.sqrt(np.mean(err ** 2)))
    assert rms <= TOL / 2, f"{what}: RMS err {rms:.4f}"


def close_logits(got, want, what="logits"):
    close_bf16(got, want, what)
    got, want = f32(got), f32(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (TOL + TOL * np.abs(top2[..., 1]))
    assert (got.argmax(-1) == want.argmax(-1))[clear].all(), f"{what}: greedy tokens"


def configs(arch):
    changes = dict(window=GEMMA2_WINDOW) if arch == "gemma2-27b" else {}
    return (replace(jax_reduce(jax_get_arch(arch)), **changes),
            replace(reduce_for_smoke(get_arch(arch)), **changes))


@pytest.fixture(scope="module")
def models():
    """Each architecture's configs, weights on both sides (bf16 and fp32),
    tokens, and the JAX package's results op by op for every pattern:
    forward and prefill in bf16, forward in fp32."""
    out = {}
    tokens = np.random.default_rng(0).integers(2, 256, size=(B, S))
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        arrays = convert.params_to_numpy(tm.init_params(cfg, seed=0, device="cpu"))
        shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
        jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
        jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
        ref = {}
        with jax.disable_jit():
            for name, pos in PATTERNS.items():
                jpos, jtok = jnp.asarray(pos), jnp.asarray(tokens)
                ref[name] = dict(
                    forward=jm.forward(jparams, jtok, jcfg, positions=jpos, remat=False),
                    prefill=jm.prefill(jparams, jtok, jcfg, positions=jpos),
                    forward_fp32=jm.forward(jp32, jtok, jcfg, positions=jpos, remat=False))
        out[arch] = dict(cfg=cfg, jcfg=jcfg, arrays=arrays, jparams=jparams,
                         params=convert.params_from_numpy(arrays, "cpu"),
                         params32=convert.params_from_numpy(arrays, "cpu",
                                                            dtype=torch.float32),
                         ref=ref)
    return dict(archs=out, tokens=tokens)


def port_call(models, arch, entry, name, fp32=False):
    m = models["archs"][arch]
    params = m["params32"] if fp32 else m["params"]
    pos = torch.from_numpy(PATTERNS[name])
    tokens = torch.from_numpy(models["tokens"])
    with torch.no_grad():
        if entry == "forward":
            return tm.forward(params, tokens, m["cfg"], positions=pos)
        return tm.prefill(params, tokens, m["cfg"], positions=pos)


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_positions_matches_jax_in_fp32(models, arch, name):
    got = port_call(models, arch, "forward", name, fp32=True)
    assert got.dtype == torch.float32 and got.shape == (B, S, models["archs"][arch]["cfg"].vocab)
    held(got, models["archs"][arch]["ref"][name]["forward_fp32"], f"{arch} {name}")


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_positions_matches_jax_in_bf16(models, arch, name):
    got = port_call(models, arch, "forward", name)
    close_logits(got, models["archs"][arch]["ref"][name]["forward"], f"{arch} {name}")


@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_positions_matches_jax(models, arch, name):
    """Last-token logits and every cache field, bf16 by share; the cache's
    K/V of a later layer carry the uniform rows of a negative position."""
    logits, cache = port_call(models, arch, "prefill", name)
    jlogits, jcache = models["archs"][arch]["ref"][name]["prefill"]
    close_logits(logits, jlogits, f"{arch} {name} prefill logits")
    assert cache.pos == int(jcache.pos) == S
    for f in ("k", "v", "conv_x", "conv_bc", "ssm"):
        mine, want = getattr(cache, f), getattr(jcache, f)
        assert (mine is None) == (want is None), f
        if mine is not None:
            close_bf16(mine, want, f"{arch} {name} cache {f}")


@pytest.mark.parametrize("arch", ATTENDING)
def test_positions_change_what_the_attention_families_compute(models, arch):
    """Not vacuous: shifted positions move the prefill's logits beyond the
    tolerance, on both sides (the reference's own change)."""
    m = models["archs"][arch]
    tokens = torch.from_numpy(models["tokens"])
    with torch.no_grad():
        plain, _ = tm.prefill(m["params"], tokens, m["cfg"])
    moved, _ = port_call(models, arch, "prefill", "shifted")
    want = f32(m["ref"]["shifted"]["prefill"][0])
    assert np.abs(f32(moved) - f32(plain)).max() > 4 * TOL
    assert np.abs(want - f32(plain)).max() > 4 * TOL


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_the_ssm_family_ignores_positions(models, entry):
    m = models["archs"]["mamba2-2.7b"]
    tokens = torch.from_numpy(models["tokens"])
    with torch.no_grad():
        fn = tm.forward if entry == "forward" else tm.prefill
        plain = fn(m["params"], tokens, m["cfg"])
        moved = fn(m["params"], tokens, m["cfg"], positions=torch.from_numpy(PATTERNS["past_s"]))
        three = fn(m["params"], tokens, m["cfg"], positions=torch.zeros((3, B, S), dtype=torch.long))
    if entry == "prefill":
        plain, moved, three = plain[0], moved[0], three[0]
    assert torch.equal(plain, moved) and torch.equal(plain, three)


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_three_plane_positions_raise_value_error_in_both_packages(models, entry):
    """qwen2-vl-7b's M-RoPE planes, (3, B, S): the reference's ``forward``
    and ``prefill`` raise ``ValueError`` (its attention takes them as (B, S)
    query positions), and so does the port, before any layer runs."""
    m = models["archs"]["qwen2-vl-7b"]
    pos = np.broadcast_to(np.arange(S), (3, B, S)).astype(np.int32)
    with pytest.raises(ValueError), jax.disable_jit():
        getattr(jm, entry)(m["jparams"], jnp.asarray(models["tokens"]), m["jcfg"],
                           positions=jnp.asarray(pos))
    with pytest.raises(ValueError, match="3-plane") as err:
        getattr(tm, entry)(m["params"], torch.from_numpy(models["tokens"]), m["cfg"],
                           positions=torch.from_numpy(pos))
    assert str(err.value) == tl.THREE_PLANES_REFUSED


@pytest.mark.parametrize("entry", ["forward", "prefill"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-7b"])
def test_three_plane_positions_raise_value_error_in_every_attending_family(models, arch,
                                                                          entry):
    m = models["archs"][arch]
    with pytest.raises(ValueError, match="3-plane"):
        getattr(tm, entry)(m["params"], torch.from_numpy(models["tokens"]), m["cfg"],
                           positions=torch.zeros((3, B, S), dtype=torch.long))


def test_positions_of_another_shape_raise(models):
    m = models["archs"]["llama3.2-3b"]
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        tm.forward(m["params"], torch.from_numpy(models["tokens"]), m["cfg"],
                   positions=torch.zeros((B, S + 1), dtype=torch.long))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b"])
def test_grad_of_forward_with_positions_matches_jax_grad_in_fp32(models, arch):
    """The training loss (``lm_loss`` of ``forward``) with shifted positions
    and its gradient with respect to every parameter: ``jax.value_and_grad``
    of the reference's against the port's autograd (through the plain
    attention, as a CPU tensor computes it), fp32, loss within 1e-5 and the
    gradients within rtol = atol = 1e-4, as tests/test_torch_train.py holds
    them."""
    m = models["archs"][arch]
    pos, tokens = PATTERNS["shifted"], models["tokens"]
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), m["jparams"])

    def jloss(p):
        out = jm.forward(p, jnp.asarray(tokens), m["jcfg"], positions=jnp.asarray(pos),
                         remat=False)
        return jm.lm_loss(out, jnp.asarray(tokens))

    with jax.disable_jit():
        want_loss, want = jax.value_and_grad(jloss)(jp32)
    keys = [k for k, _ in flatten_with_keys(m["params32"])]
    flat = [p.detach().clone().requires_grad_() for p in jax.tree.leaves(m["params32"])]
    params = jax.tree.unflatten(jax.tree.structure(m["params32"]), flat)
    tok = torch.from_numpy(tokens)
    loss = tm.lm_loss(tm.forward(params, tok, m["cfg"], positions=torch.from_numpy(pos)), tok)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(want_loss)
    grads = torch.autograd.grad(loss, flat)
    for k, g, gw in zip(keys, grads, jax.tree.leaves(want)):
        np.testing.assert_allclose(f32(g), f32(gw), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# the attention block in its prefill-cache mode, fp32
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra_rows", [0, 8])
@pytest.mark.parametrize("name", sorted(PATTERNS))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-27b", "qwen2-vl-7b"])
def test_attention_block_prefill_mode_matches_jax_in_fp32(models, arch, name, extra_rows):
    """``attention_block`` writing fp32 caches at ``cache_pos`` 0 with
    positions (the reference's prefill branch, its caches fp32 here), into
    a cache of S rows (``prefill``'s) or more, which the reference attends
    whole: output and caches within 2e-5; a negative position's row is the
    mean of every value row."""
    m = models["archs"][arch]
    cfg, jcfg = m["cfg"], m["jcfg"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p = {k: f32(v[0]) for k, v in m["params32"]["layers"]["attn"].items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    shape = (B, S + extra_rows, cfg.n_kv_heads, cfg.head_dim)
    pos = PATTERNS[name]
    with jax.disable_jit():
        want, (wk, wv) = jl.attention_block(
            jp, jnp.asarray(x), jcfg, layer_is_local=jnp.asarray(True), positions=jnp.asarray(pos),
            kv_cache=(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)),
            cache_pos=jnp.zeros((), jnp.int32))
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    got, _ = tl.attention_block({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), cfg, layer_is_local=True,
                                positions=torch.from_numpy(pos), kv_cache=(ck, cv), cache_pos=0)
    for what, a, r in (("out", got, want), ("k", ck, wk), ("v", cv, wv)):
        np.testing.assert_allclose(f32(a), f32(r), rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the attention core with position tables
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # (Sq, Sk, H, G, D, window, softcap, keys): keys at the queries' positions
    # (forward's mode), "shuffled" or "same" (shifted, packed), or at their
    # row "index" (prefill's mode)
    (40, 40, 4, 2, 64, None, None, "shuffled"),
    (40, 40, 4, 2, 112, 5, None, "shuffled"),
    (70, 70, 4, 1, 128, None, 50.0, "shuffled"),
    (33, 33, 2, 2, 256, 7, 30.0, "shuffled"),
    (150, 150, 4, 2, 64, None, None, "same"),
    (150, 150, 4, 1, 128, 20, 50.0, "same"),
    (40, 40, 4, 2, 64, None, None, "index"),
    (40, 72, 4, 2, 128, 9, 50.0, "index"),
    (70, 70, 8, 2, 112, None, None, "index"),
]


def attn_inputs(sq, sk, h, g, d, keys="shuffled", seed=0):
    """q, k, v, the query positions and the keys' (the same array but for
    ``index``, where they are None: keys at their row index).  ``same``: a
    row shifted by 3, and packed sequences restarting every 50 rows;
    ``shuffled``: random positions, some negative and some repeated, and a
    permutation; ``index``: random query positions, some negative, some
    past Sk (rows that see no key or every key), and a row shifted by 3."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((B, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((B, sk, g, d)).astype(np.float32)
    if keys == "same":
        qp = np.stack([np.arange(sq) + 3, np.arange(sq) % 50]).astype(np.int32)
        return q, k, v, qp, qp
    if keys == "shuffled":
        qp = np.stack([rng.integers(-6, sk + 8, sq), rng.permutation(sq)]).astype(np.int32)
        return q, k, v, qp, qp
    qp = np.stack([rng.integers(-6, sk + 8, sq), np.arange(sq) + 3]).astype(np.int32)
    return q, k, v, qp, None


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_with_tables_matches_jax_gqa_attention(case):
    """Keys at the queries' positions (shifted, packed, shuffled) or at their
    row index against random query positions (rows that see no key or every
    key), fp32, 2e-5."""
    sq, sk, h, g, d, window, softcap, keys = case
    q, k, v, qp, kp = attn_inputs(sq, sk, h, g, d, keys)
    kw = dict(window=window, softcap=softcap)
    want = jl.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            q_positions=jnp.asarray(qp),
                            kv_positions=None if kp is None else jnp.asarray(kp), **kw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          positions=torch.from_numpy(qp), keys_at_rows=kp is None, **kw)
    np.testing.assert_allclose(f32(got), f32(want), rtol=ATTN_TOL, atol=ATTN_TOL)


def test_a_row_that_sees_no_key_is_the_mean_of_every_value_row():
    q, k, v, _, _ = attn_inputs(8, 8, 2, 1, 64, "index")
    qp = torch.tensor([[-1] * 8, list(range(8))], dtype=torch.int32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          positions=qp, keys_at_rows=True)
    mean = torch.from_numpy(v[0]).mean(0)                        # (G, D)
    for h in range(2):
        np.testing.assert_allclose(f32(out[0, :, h]), f32(mean.expand(8, -1)), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", [c for c in ATTN_CASES if c[-1] != "index"], ids=str)
def test_bwd_ref_with_a_table_matches_jax_vjp(case):
    """``attention_bwd_ref`` with one table for queries and keys (forward's)
    against ``jax.vjp`` of the reference's ``gqa_attention`` at those
    positions: dq, dk, dv in fp32 within 1e-4."""
    s, _, h, g, d, window, softcap, keys = case
    q, k, v, _, kp = attn_inputs(s, s, h, g, d, keys, seed=1)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    kw = dict(window=window, softcap=softcap)

    def fn(a, b_, c):
        return jl.gqa_attention(a, b_, c, causal=True, q_positions=jnp.asarray(kp),
                                kv_positions=jnp.asarray(kp), **kw)

    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.from_numpy(kp)
    o, lse = attention_ref(tq, tk, tv, return_lse=True, q_positions=pos, kv_positions=pos, **kw)
    got = flash_ops.flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do),
                                        positions=pos, **kw)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(f32(a), f32(r), rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
    same = attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do), q_positions=pos,
                             kv_positions=pos, **kw)
    for a, r in zip(got, same):
        assert torch.equal(a, r)


def emulate_walk(q, k, v, qp, keys_at_rows, window, softcap, rows=FLASH_TILE_ROWS):
    """The forward kernel's position variant, emulated: each Q tile of
    ``rows`` rows attends only the KV tiles ``kv_tiles`` walks, a hidden
    score -1e30, columns of no walked tile not counted at all."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    out = torch.zeros_like(q)
    for bi in range(b):
        for q_lo in range(0, sq, rows):
            nq = min(rows, sq - q_lo)
            tiles = flash_ops.kv_tiles(q_lo, nq, sk, window=window, positions=qp[bi],
                                       keys_at_rows=keys_at_rows)
            cols = torch.cat([torch.arange(t * FLASH_TILE_ROWS,
                                           min(sk, (t + 1) * FLASH_TILE_ROWS))
                              for t in tiles])
            kpos = (torch.arange(sk) if keys_at_rows else qp[bi])[cols].long()
            qpos = qp[bi, q_lo:q_lo + nq].long()
            seen = kpos[None, :] <= qpos[:, None]
            if window:
                seen &= kpos[None, :] > qpos[:, None] - window
            qs = q[bi, q_lo:q_lo + nq].reshape(nq, g, h // g, d)
            s = torch.einsum("sgqd,tgd->gqst", qs, k[bi, cols]) / math.sqrt(d)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            p = torch.softmax(s.masked_fill(~seen, -1e30), dim=-1)
            o = torch.einsum("gqst,tgd->sgqd", p, v[bi, cols])
            out[bi, q_lo:q_lo + nq] = o.reshape(nq, h, d)
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_the_kernels_tile_walk_with_tables_computes_the_plain_result(case):
    """Walking only ``kv_tiles``' tiles for each Q tile (prefill mode: from
    the window's first tile under the tile's smallest position to its
    largest + 1, or every tile where a row sees no key; forward mode: every
    tile not proved hidden) gives what the plain version gives, in fp32
    within 2e-5, at the bf16 kernel's 16-row tiles and the fp32 kernel's
    64."""
    sq, sk, h, g, d, window, softcap, keys = case
    q, k, v, qp, kp = attn_inputs(sq, sk, h, g, d, keys)
    q, k, v, qp = (torch.from_numpy(a) for a in (q, k, v, qp))
    by_index = kp is None
    want = attention_ref(q, k, v, window=window, softcap=softcap, q_positions=qp,
                         kv_positions=None if by_index else qp)
    for rows in (16, FLASH_TILE_ROWS):
        got = emulate_walk(q, k, v, qp, by_index, window, softcap, rows)
        np.testing.assert_allclose(f32(got), f32(want), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("window", [None, 3, 64, 100])
def test_kv_tiles_with_a_table_hold_every_visible_key(window):
    """Prefill mode: every key some row of a Q tile sees lies in a walked
    tile, the walk starts no later than the tile under the window of the
    smallest position, and a tile holding a row that sees nothing walks all
    of them; positions equal to the rows' own walk as the causal index
    walk."""
    rng = np.random.default_rng(7)
    sk = 300
    n = -(-sk // FLASH_TILE_ROWS)
    for trial in range(40):
        qp = rng.integers(-3 if trial % 4 == 0 else 0, sk + 40, 64)
        for nq in (16, 32, 64):
            walked = set(flash_ops.kv_tiles(0, nq, sk, window=window, positions=qp,
                                            keys_at_rows=True))
            pos = qp[:nq]
            cols = np.arange(sk)
            seen = (cols[None] <= pos[:, None]) & (
                (cols[None] > pos[:, None] - window) if window else True)
            need = {c // FLASH_TILE_ROWS for c in np.nonzero(seen.any(0))[0]}
            assert need <= walked
            blind = (~seen.any(1)).any()
            assert (walked == set(range(n))) if blind else max(walked) < n
    for q_lo in range(0, sk, 64):
        assert list(flash_ops.kv_tiles(q_lo, min(64, sk - q_lo), sk, window=window,
                                       positions=np.arange(sk), keys_at_rows=True)) == \
            list(flash_ops.kv_tiles(q_lo, min(64, sk - q_lo), sk, window=window))


@pytest.mark.parametrize("window", [None, 1, 63, 100])
def test_one_table_walks_skip_only_tiles_no_row_sees(window):
    """One table for queries and keys (forward's mode, and the backward's):
    the forward's KV tiles and the backward's Q and KV tiles hold every tile
    with a pair some row of the other tile sees, for packed, shifted and
    shuffled positions; for contiguous positions (the rows' own, or shifted)
    exactly those, which are the causal and window walks of the index."""
    rng = np.random.default_rng(8)
    s = 300
    contiguous = [np.arange(s), np.arange(s) + 7]
    tables = contiguous + [np.arange(s) % 70, rng.permutation(s),
                           np.concatenate([np.arange(100) + 40, np.arange(200)])]
    for i, pos in enumerate(tables):
        exact = i < len(contiguous)
        for tile in (64, 32, 16):
            n = -(-s // tile)
            seen = (pos[None, :] <= pos[:, None]) & (
                (pos[None, :] > pos[:, None] - window) if window else True)
            pairs = {(int(r) // tile, int(c) // tile) for r, c in zip(*np.nonzero(seen))}
            for t in range(n):
                walks = [(flash_ops.bwd_q_tiles(t, s, window=window, tile=tile, positions=pos),
                          sorted(qt for qt, kt in pairs if kt == t)),
                         (flash_ops.bwd_kv_tiles(t, window=window, tile=tile, positions=pos),
                          sorted(kt for qt, kt in pairs if qt == t))]
                if tile == FLASH_TILE_ROWS:
                    walks.append((flash_ops.kv_tiles(t * tile, tile, s, window=window,
                                                     positions=pos),
                                  walks[1][1]))
                for walked, need in walks:
                    assert walked == need if exact else set(need) <= set(walked)
    for t in range(-(-s // 64)):     # rows at their index: the index walk itself
        assert flash_ops.bwd_kv_tiles(t, window=window, positions=np.arange(s)) == \
            list(flash_ops.bwd_kv_tiles(t, window=window))
        assert flash_ops.bwd_q_tiles(t, s, window=window, positions=np.arange(s)) == \
            list(flash_ops.bwd_q_tiles(t, s, window=window))


def test_the_sources_walk_as_the_wrappers_mirror():
    text = (CSRC / "flash_attention.cu").read_text()
    assert "t_lo = window > 0 ? max(0, lo - window + 1) / BK : 0;" in text
    assert "kv_end = min(Sk, hi + 1);" in text
    assert "if (lo < 0 || (window > 0 && hi - window + 1 >= Sk)) return;" in text
    assert text.count("pos_walk(qpb, kpb, q_lo,") == 2            # fp32 and bf16 loops
    pos_tu = (CSRC / "flash_attention_pos.cu").read_text()
    assert "#define DCO_FLASH_POS" in pos_tu and '#include "flash_attention.cu"' in pos_tu
    assert "if (pos_tile_hidden(kpb, k_lo, Sk, q_mn, q_mx, window)) continue;" in text
    assert ("while (t < w.n_kv && pos_tile_hidden(kpb, t * BK, Sk, w.q_mn, w.q_mx, window)) ++t;"
            in text)
    # forward mode: the keys' positions are the queries' table; prefill mode: none
    assert text.count("const int* kpb = POS && !keys_at_rows ? qpb : nullptr;") == 2
    assert "if (kp == nullptr) return false;" in text
    assert "return k_mn > q_mx || (window > 0 && k_mx <= q_mn - window);" in (
        CSRC / "positions.cuh").read_text()
    bwd = (CSRC / "flash_attention_bwd.cu").read_text()
    assert bwd.count("const bool by_pos = EXT && POS_TABLE;") == 4   # four bodies
    bwd_tu = (CSRC / "flash_attention_bwd_pos.cu").read_text()
    assert "#define DCO_FLASH_POS" in bwd_tu and '#include "flash_attention_bwd.cu"' in bwd_tu
    # the fp32 bodies and the bf16 dK/dV walk test a 64-row Q tile against
    # their KV rows; the bf16 dQ walk tests each KV tile against its Q tile's
    assert bwd.count("pair_hidden<") == 3
    assert "if (!dco_positions::tiles_hidden(q_mn, q_mx, k_mn, k_mx, window)) break;" in bwd


# ---------------------------------------------------------------------------
# what the wrappers take
# ---------------------------------------------------------------------------
def test_tables_are_checked_on_every_device():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 8, 1, 64)
    ok = torch.arange(8, dtype=torch.int32)[None]
    assert flash_attention(q, k, k, positions=ok).shape == q.shape
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, k, k, positions=ok.long())
    with pytest.raises(ValueError, match=r"\(B, Sq\)"):
        flash_attention(q, k, k, positions=ok[:, :7])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, k, k, positions=torch.zeros(1, 16, dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="keys_at_rows needs positions"):
        flash_attention(q, k, k, keys_at_rows=True)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, k, causal=False, positions=ok)
    long_k = torch.zeros(1, 20, 1, 64)
    # keys at the queries' positions: Sq == Sk; at their row index: Sq may differ
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, long_k, long_k, positions=ok)
    assert flash_attention(q, long_k, long_k, positions=ok,
                           keys_at_rows=True).shape == q.shape


def test_the_backward_refuses_keys_at_their_row_index():
    flash_ops.check_backward(64, True, None, None)
    flash_ops.check_backward(64, True, None, None, keys_at_rows=False)
    with pytest.raises(NotImplementedError, match="row index"):
        flash_ops.check_backward(64, True, None, None, keys_at_rows=True)
