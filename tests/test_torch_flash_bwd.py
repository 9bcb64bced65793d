"""The gradient of attention in the port against the JAX package's.

``attention_bwd_ref`` (the FlashAttention-2 backward written out, the oracle
of the backward kernel) is held against torch autograd of ``attention_ref``
and against ``jax.vjp`` of the reference's ``gqa_attention``, which is what
the JAX package differentiates in training, also with gemma2's sliding
window and softcap and at gemma-7b's head_dim 256; the forward's per-row
log-sum-exp against the log-sum-exp of the reference's masked scores.  The
backward kernel's tile walk under a window (``bwd_q_tiles``,
``bwd_kv_tiles``, the CPU mirrors of csrc/flash_attention_bwd.cu's) against
the mask.

Tolerances are relative to each gradient's largest magnitude: fp32 2e-5
(the flash forward's, two fp32 evaluations in another order), bf16 2e-2
(outputs rounded to bf16 on both sides, 2^-8 each, at other places).  The
kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers take their plain versions because the tensors lie on the CPU."""

import ctypes
import importlib.util
import math
from pathlib import Path
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import gqa_attention
# the port
from repro_torch.kernels import attention_bwd_ref
from repro_torch.kernels import attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels import flash_attention_bwd
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import _mask

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
D = 64
# (B, S, H, G)
SHAPES = [(1, 17, 4, 4), (2, 17, 4, 2), (1, 100, 4, 1), (2, 100, 8, 2), (1, 100, 4, 4)]


GEMMA2_SCALE = 144.0 ** -0.5
# (B, S, H, G, D, options) of the window, softcap and head_dim 256 cases:
# windows 1 (the diagonal), 17 and 64 at lengths 100 and 130, softcaps 30
# and 50 and one that bends the scores (chip_smoke.CAP_BENDS), gemma2's score
# scale, D 64, 128 and 256
EXT_CASES = [(1, 100, 4, 2, 64, dict(window=1)),
             (2, 130, 4, 4, 64, dict(window=17, softcap=30.0)),
             (1, 130, 4, 2, 128, dict(window=64, softcap=50.0, scale=GEMMA2_SCALE)),
             (2, 100, 4, 2, 128, dict(softcap=50.0, scale=GEMMA2_SCALE)),
             (1, 130, 4, 2, 128, dict(window=17, softcap=2.0, scale=GEMMA2_SCALE)),
             (1, 100, 4, 1, 128, dict(window=17, scale=GEMMA2_SCALE)),
             (1, 130, 2, 2, 256, {}),
             (1, 100, 2, 1, 256, dict(window=64, softcap=30.0)),
             (2, 130, 2, 2, 256, dict(window=1, softcap=50.0))]


def ext_id(case):
    b, s, h, g, d, kw = case
    return f"B{b}S{s}H{h}G{g}D{d}" + "".join(f"-{k}{v:g}" for k, v in kw.items())


def inputs(b, s, h, g, dtype, seed=0, d=D):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, g, d), (b, s, g, d), (b, s, h, d))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def held(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} beyond {tol} x {scale:.3g}"


def f32(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def dtype(request):
    return request.param


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}S{}H{}G{}".format(*s))
def test_bwd_ref_matches_autograd_of_forward_ref(shape, dtype):
    _, (q, k, v, do) = inputs(*shape, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = attention_ref(q, k, v, return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        held(f32(a), f32(b), TOL[dtype], f"d{name} {shape} {dtype}")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}S{}H{}G{}".format(*s))
def test_bwd_ref_matches_jax_vjp_of_reference_attention(shape, dtype):
    arrs, (q, k, v, do) = inputs(*shape, dtype, seed=1)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: gqa_attention(a, b, c, causal=True), jq, jk, jv)
    want = vjp(jdo)
    o, lse = attention_ref(q, k, v, return_lse=True)
    got = attention_bwd_ref(q, k, v, o, lse, do)
    for name, a, b in zip("qkv", got, want):
        held(f32(a), np.asarray(b.astype(jnp.float32)), TOL[dtype],
             f"d{name} vs jax.vjp {shape} {dtype}")


@pytest.mark.parametrize("shape", [(1, 100, 4, 4), (2, 70, 4, 2)],
                         ids=lambda s: "B{}S{}H{}G{}".format(*s))
def test_bwd_ref_matches_jax_vjp_at_head_dim_112(shape, dtype):
    """zamba2-7b's head size (MHA in the model; GQA group 2 too): the plain
    backward does not depend on D, and agrees with the reference's VJP at
    112 as at 64."""
    arrs, (q, k, v, do) = inputs(*shape, dtype, seed=6, d=112)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: gqa_attention(a, b, c, causal=True), jq, jk, jv)
    want = vjp(jdo)
    o, lse = attention_ref(q, k, v, return_lse=True)
    got = attention_bwd_ref(q, k, v, o, lse, do)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == b.shape
        held(f32(a), np.asarray(b.astype(jnp.float32)), TOL[dtype],
             f"d{name} vs jax.vjp at D 112 {shape} {dtype}")


@pytest.mark.parametrize("case", EXT_CASES, ids=ext_id)
def test_bwd_ref_with_window_softcap_and_head_dim_256_matches_autograd(case, dtype):
    """The oracle with gemma2's window and softcap and at head_dim 256
    against torch autograd of ``attention_ref`` with the same options."""
    b, s, h, g, d, kw = case
    _, (q, k, v, do) = inputs(b, s, h, g, dtype, seed=7, d=d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(),
                            do, **kw)
    for name, a, r in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == r.shape
        held(f32(a), f32(r), TOL[dtype], f"d{name} {ext_id(case)} {dtype}")


@pytest.mark.parametrize("case", EXT_CASES, ids=ext_id)
def test_bwd_ref_with_window_softcap_and_head_dim_256_matches_jax_vjp(case, dtype):
    """The same against ``jax.vjp`` of the reference's ``gqa_attention``
    with the window, softcap and scale: what the JAX package differentiates
    when it trains gemma."""
    b, s, h, g, d, kw = case
    arrs, (q, k, v, do) = inputs(b, s, h, g, dtype, seed=8, d=d)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(JDT[dtype]) for a in arrs)
    _, vjp = jax.vjp(lambda a, bb, c: gqa_attention(a, bb, c, causal=True, **kw), jq, jk, jv)
    want = vjp(jdo)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    got = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for name, a, r in zip("qkv", got, want):
        held(f32(a), np.asarray(r.astype(jnp.float32)), TOL[dtype],
             f"d{name} vs jax.vjp {ext_id(case)} {dtype}")


@pytest.mark.parametrize("s,window,tile", [(100, 1, 64), (130, 17, 64), (1000, 64, 64),
                                           (1000, 100, 64), (1024, 63, 64), (512, 4096, 64),
                                           (5120, 4096, 64), (300, 63, 32), (130, None, 64)])
def test_bwd_tile_walks_are_the_tiles_the_mask_needs(s, window, tile):
    """The Q tiles a KV tile's dK/dV block walks, and the KV tiles a Q
    tile's dQ block walks, are exactly the tile pairs in which the causal
    mask and the window leave some (row, column) pair visible: none is
    skipped that is needed, none walked that is not."""
    n = -(-s // tile)
    mask = torch.zeros(n * tile, n * tile, dtype=torch.bool)
    mask[:s, :s] = _mask(s, s, True, window, "cpu")
    needed = mask.reshape(n, tile, n, tile).any(dim=3).any(dim=1)      # (Q tile, KV tile)
    for t in range(n):
        assert list(flash_ops.bwd_q_tiles(t, s, window=window, tile=tile)) == \
            needed[:, t].nonzero().flatten().tolist()
        assert list(flash_ops.bwd_kv_tiles(t, window=window, tile=tile)) == \
            needed[t].nonzero().flatten().tolist()


def test_bwd_tile_rows():
    """64-row tiles, but 32 in fp32 at head_dim 256 (four staged 64-row
    fp32 tiles of 257 words pass a block's 227 KB)."""
    for d in flash_ops.BWD_HEAD_DIMS:
        assert flash_ops.bwd_tile_rows(d, 2) == 64
        assert flash_ops.bwd_tile_rows(d, 4) == (32 if d == 256 else 64)
    assert 4 * 64 * 257 * 4 > flash_ops.H100_SMEM_PER_BLOCK >= 4 * 32 * 257 * 4 + 2 * 32 * 33 * 4


@pytest.mark.parametrize("shape", SHAPES[:3], ids=lambda s: "B{}S{}H{}G{}".format(*s))
def test_lse_matches_reference_scores(shape):
    arrs, (q, k, v, _) = inputs(*shape, torch.float32, seed=2)
    b, s, h, g = shape
    jq, jk = jnp.asarray(arrs[0]), jnp.asarray(arrs[1])
    scores = jnp.einsum("bsgqd,btgd->bgqst", jq.reshape(b, s, g, h // g, D), jk) / math.sqrt(D)
    mask = jnp.tril(jnp.ones((s, s), bool))
    want = jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1).reshape(b, h, s)
    out, lse = attention_ref(q, k, v, return_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, flash_attention(q, k, v))


def test_cpu_flash_under_grad_is_differentiated_by_autograd():
    """On the CPU, ``flash_attention`` under grad is the plain version, which
    autograd differentiates; its gradient is ``attention_bwd_ref``'s, and no
    kernel is launched or built."""
    reset_launch_counts()
    _, (q, k, v, do) = inputs(2, 33, 8, 2, torch.float32, seed=3)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = flash_attention(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    _, lse = attention_ref(q.detach(), k.detach(), v.detach(), return_lse=True)
    want = flash_attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(), lse, do)
    for name, a, b in zip("qkv", got, want):
        held(f32(a), f32(b), TOL[torch.float32], f"d{name}")
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("kw,error,why", [
    (dict(causal=False), NotImplementedError, "non-causal"),
    (dict(d=96), ValueError, "head_dim"), (dict(window=0), ValueError, "window"),
    (dict(softcap=0.0), ValueError, "softcap")])
def test_backward_refuses_what_the_kernel_does_not_compute(kw, error, why):
    """Non-causal attention has no backward kernel; a head size outside the
    kernel's, an empty window or a softcap of 0 are refused as the forward
    refuses them."""
    args = dict(d=128, causal=True, window=None, softcap=None)
    args.update(kw)
    with pytest.raises(error, match=why):
        flash_ops.check_backward(args["d"], args["causal"], args["window"], args["softcap"])


@pytest.mark.parametrize("kw", [
    dict(d=64), dict(d=112), dict(d=128), dict(d=256), dict(window=64),
    dict(softcap=50.0), dict(d=112, window=64), dict(window=4096, softcap=50.0),
    dict(d=256, window=1, softcap=30.0)], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_backward_takes_every_training_shape(kw):
    """Causal attention at every head size of the forward, with or without
    gemma2's window and softcap: gemma2-27b's and gemma-7b's training among
    them."""
    args = dict(d=128, window=None, softcap=None)
    args.update(kw)
    flash_ops.check_backward(args["d"], True, args["window"], args["softcap"])


def test_needs_grad_follows_autograd():
    a = torch.zeros(2)
    b = torch.zeros(2, requires_grad=True)
    assert not flash_ops.needs_grad(a, None)
    assert flash_ops.needs_grad(a, b)
    with torch.no_grad():
        assert not flash_ops.needs_grad(b)


def test_bwd_wrapper_argtypes_match_the_c_interface():
    source = (CSRC / "flash_attention_bwd.cu").read_text()
    params = [" ".join(p.split()) for p in re.search(
        r'extern "C" int dco_flash_attention_bwd\(([^)]*)\)', source).group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
             else ctypes.c_int for p in params]
    assert kinds == flash_ops.BWD_ARGTYPES
    fwd = (CSRC / "flash_attention.cu").read_text()
    assert "float* lse" in re.search(r'extern "C" int dco_flash_attention\(([^)]*)\)',
                                     fwd).group(1)


def test_bwd_wrapper_checks_shapes():
    _, (q, k, v, do) = inputs(1, 17, 4, 2, torch.float32)
    o, lse = attention_ref(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :5], do)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, do[:, :5])


def bwd_float64(q, k, v, o, lse, do):
    """``attention_bwd_ref``'s formulas in float64 (causal), its outputs
    rounded to the inputs' type: a backward right up to that rounding."""
    b, s, h, d = q.shape
    g = k.shape[2]
    qg, dog, og = (t.double().reshape(b, s, g, h // g, d) for t in (q, do, o))
    kf, vf = k.double(), v.double()
    scale = 1.0 / math.sqrt(d)
    delta = (dog * og).sum(-1)
    p = torch.exp(torch.einsum("bsgqd,btgd->bgqst", qg, kf) * scale
                  - lse.double().reshape(b, g, h // g, s, 1))
    p = p.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), 0.0)
    dv = torch.einsum("bgqst,bsgqd->btgd", p, dog)
    dp = torch.einsum("bsgqd,btgd->bgqst", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bgqst,btgd->bsgqd", ds, kf) * scale
    dk = torch.einsum("bgqst,bsgqd->btgd", ds, qg) * scale
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, whose gradient rule the card's check uses."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(1, 200, 8, 2), (2, 130, 6, 2), (1, 100, 4, 1)],
                         ids=lambda s: "B{}S{}H{}G{}".format(*s))
def test_card_gradient_rule_holds_a_right_backward_and_rejects_planted_faults(
        smoke, shape, dtype):
    """The rule ``chip_smoke.py`` holds the backward kernel to (elementwise,
    tolerance of the dtype on each row's and 64-row tile's scale) passes a backward
    right up to its rounding (float64, then the dtype) against the plain
    version, and fails the faults it plants: the last KV tile of dK and dV
    left at zero, one query head of every group missing from the tile
    before it."""
    _, (q, k, v, do) = inputs(*shape, dtype, seed=4)
    o, lse = attention_ref(q, k, v, return_lse=True)
    got = bwd_float64(q, k, v, o, lse, do)
    want = attention_bwd_ref(q, k, v, o, lse, do)
    for name, a, r in zip("qkv", got, want):
        ok, ratio, _, _ = smoke.grad_err(a, r, TOL[dtype])
        assert ok, f"d{name} {shape} {dtype}: worst ratio {ratio:.3g}"
    assert min(smoke.check_faults_rejected(q, k, v, o, lse, do, got, want, TOL[dtype],
                                           f"{shape} {dtype}").values()) > 1.0


@pytest.mark.parametrize("case", [(1, 200, 8, 4, 128, dict(window=1, scale=GEMMA2_SCALE)),
                                  (1, 200, 8, 4, 128, dict(window=100, softcap=50.0,
                                                           scale=GEMMA2_SCALE)),
                                  (2, 130, 4, 4, 128, dict(softcap=30.0)),
                                  (1, 200, 8, 4, 128, dict(window=64, softcap=2.0)),
                                  (1, 150, 4, 2, 256, dict(window=63, softcap=50.0)),
                                  (1, 150, 4, 4, 256, {})], ids=ext_id)
def test_card_gradient_rule_with_a_window_a_softcap_and_head_dim_256(smoke, case, dtype):
    """The card's rule with gemma's options: a backward right up to its
    rounding (the oracle in float64, then the dtype) passes, with dQ and dK
    under a window of 1, which vanish, held on ``vanishing_floor``; and the
    faults planted for a window (one more key a row; the last Q tile of a
    KV tile's walk skipped), a softcap (its derivative left out of dS) and
    head_dim 256 (half of dK's columns at zero) fail, in every gradient each
    touches, with the old ones (the softcap's in bf16 only where the cap
    bends the scores, ``chip_smoke.CAP_BENDS``)."""
    b, s, h, g, d, kw = case
    _, (q, k, v, do) = inputs(b, s, h, g, dtype, seed=9, d=d)
    o, lse = attention_ref(q, k, v, return_lse=True, **kw)
    got = [t.to(dtype) for t in attention_bwd_ref(
        *(t.double() for t in (q, k, v, o, lse, do)), **kw)]
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    floor = smoke.vanishing_floor(want, kw)
    assert set(floor) == ({"dq", "dk"} if kw.get("window") == 1 else set())
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        ok, ratio, _, _ = smoke.grad_err(a, r, TOL[dtype], floor.get(name, 0.0))
        assert ok, f"{name} {ext_id(case)} {dtype}: worst ratio {ratio:.3g}"
    least = smoke.check_faults_rejected(q, k, v, o, lse, do, got, want, TOL[dtype],
                                        f"{ext_id(case)} {dtype}", kw)
    vanish = kw.get("window") == 1   # dQ and dK: only the widened window touches them
    expect = {"tail", "head"}
    bends = dtype == torch.float32 or kw.get("softcap", 99.0) <= smoke.CAP_BENDS
    expect |= {"uncapped"} if kw.get("softcap") and bends and not vanish else set()
    expect |= {"window_off_by_one", "last_q_tile"} if kw.get("window") else set()
    expect |= {"dk_half"} if d == 256 and not vanish else set()
    assert set(least) == expect and min(least.values()) > 1.0


def test_card_gradient_scale_is_the_larger_rms_of_row_and_tile(smoke):
    ref = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 150, 3, 8))
                           .astype(np.float32))
    ref[:, 3] *= 10.0     # rows above their tile's RMS
    ref[:, 70] *= 0.0     # a zero row, held at its tile's
    scale = smoke.grad_scale(ref)
    assert scale.shape == (2, 150, 3, 1)
    row = ref.square().mean(-1).sqrt()                                   # (B, S, H)
    for lo, hi in ((0, 64), (64, 128), (128, 150)):
        tile = ref[:, lo:hi].square().mean(dim=(1, 3)).sqrt()[:, None]   # (B, 1, H)
        torch.testing.assert_close(scale[:, lo:hi, :, 0], torch.maximum(row[:, lo:hi], tile))
