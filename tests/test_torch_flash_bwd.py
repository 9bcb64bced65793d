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


# ---------------------------------------------------------------------------
# Mirrors of the bf16 backward's schedule (csrc/flash_attention_bwd.cu: the
# dK/dV and dQ kernels on TMA and wgmma), held to what the kernels must
# compute: the launch order, each block's walk, each consumer's rows and
# tiles, the masks, and the shared-memory layout.

BT = 64   # rows of the bf16 kernels' Q and KV tiles


def _bwd_source_constants():
    """The backward's constants, with those of hopper.cuh it includes."""
    text = (CSRC / "flash_attention_bwd.cu").read_text() + (CSRC / "hopper.cuh").read_text()
    return {name: int(val) for name, val in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _bwd_layout(d):
    """The bf16 kernels' shapes at head_dim ``d``: dK/dV consumers sharing a
    KV tile (each its share of the output columns), the KV tiles of a dK/dV
    block, the consumers of a dQ block and the slots of both rings
    (``ring_stages``)."""
    c = _bwd_source_constants()
    wide = d > c["WIDE_DIM"]
    split = 2 if wide else 1
    return dict(split=split, kv_tiles=c["CONSUMERS"] // split, consumers=c["CONSUMERS"],
                dq_consumers=1 if wide else c["CONSUMERS"], stages=2 if wide else c["STAGES"])


def _q_tile_end(k_lo, n, window):
    """``q_tile_end`` at 64-row tiles: past the last Q tile the window of the
    KV tile's last row reaches."""
    return min(n, (k_lo + BT - 1 + window - 1) // BT + 1) if window else n


def _kv_tile_begin(q_lo, window):
    return max(0, q_lo - window + 1) // BT if window else 0


def _hidden_tiles(pos, lo_a, n_a, lo_b, n_b, window):
    """``tiles_hidden`` of the keys at rows [lo_b, +n_b) from the queries at
    [lo_a, +n_a), both cut at the row's length."""
    return flash_ops.tiles_hidden([int(p) for p in pos[lo_a:lo_a + n_a]],
                                  [int(p) for p in pos[lo_b:lo_b + n_b]], window)


def _dkdv_blocks(b, s, g, group, d, window=None, positions=None):
    """The dK/dV kernel's blocks in launch order (block x: KV block x // (B G),
    batch x // G % B, KV head x % G), each with its consumers: (x, batch, KV
    head, [(KV tile, first output column, output columns, [(head in the
    group, Q tile) computed], items taken unread)]).  A block's walk is, for
    each head of the group, the Q tiles from its first KV tile's own to the
    last its last live KV tile's window reaches (with ``positions``: every
    Q tile not hidden from the block's KV rows); a consumer computes those
    from its own KV tile's to the last its window reaches (with positions:
    all), none where its tile lies past S."""
    lay = _bwd_layout(d)
    n = -(-s // BT)
    kvt = lay["kv_tiles"]
    out = []
    for x in range(-(-n // kvt) * b * g):
        kb, bg = divmod(x, b * g)
        bi, gi = divmod(bg, g)
        kt0 = kb * kvt
        live = min(kvt, n - kt0)
        pos = None if positions is None else positions[bi]
        if pos is not None:   # the Q tiles not hidden from the block's KV rows
            walk = flash_ops.bwd_q_tiles(kt0, s, window=window, positions=pos, block=kvt)
        else:
            walk = list(range(kt0, _q_tile_end((kt0 + live - 1) * BT, n, window)))
        cons = []
        for c in range(lay["consumers"]):
            kt = kt0 + c // lay["split"]
            cols = d // lay["split"]
            if kt >= n:
                mine = []
            elif pos is not None:
                mine = walk
            else:
                mine = [qt for qt in walk if kt <= qt < _q_tile_end(kt * BT, n, window)]
            items = [(hh, qt) for hh in range(group) for qt in mine]
            cons.append((kt, c % lay["split"] * cols, cols, items,
                         group * len(walk) - len(items)))
        out.append((x, bi, gi, cons))
    return out


def _dq_rows(group, d):
    """A dQ consumer's 64 packed rows: (query row within its tile, head in
    the group), None for the 64 % group rows no head fills."""
    rows_s = 64 // group
    return [(r // group, r % group) if r < rows_s * group else None for r in range(64)]


def _dq_blocks(b, s, g, group, d, window=None, positions=None):
    """The dQ kernel's blocks in launch order (block x: Q tile n - 1 - x //
    (B G), batch x // G % B, KV head x % G; a Q tile is the consumers' 64 //
    group query rows each), each with its consumers: (x, batch, KV head,
    [(first query row, [KV tiles computed])]).  The walk: the KV tiles from
    the first the window of the tile's first row reaches to the diagonal
    (with ``positions``: every one not hidden from the tile's rows); a
    consumer computes those from the first its first row's window reaches to
    the one holding its last row (with positions: all)."""
    lay = _bwd_layout(d)
    rows_s = 64 // group
    bq = lay["dq_consumers"] * rows_s
    n_q = -(-s // bq)
    n = -(-s // BT)
    out = []
    for x in range(n_q * b * g):
        p, bg = divmod(x, b * g)
        bi, gi = divmod(bg, g)
        q_lo = (n_q - 1 - p) * bq
        pos = None if positions is None else positions[bi]
        if pos is not None:
            walk = [t for t in range(n) if not _hidden_tiles(
                pos, q_lo, min(bq, s - q_lo), t * BT, BT, window)]
        else:
            walk = list(range(_kv_tile_begin(q_lo, window), -(-min(s, q_lo + bq) // BT)))
        cons = []
        for c in range(lay["dq_consumers"]):
            s0 = q_lo + c * rows_s
            s1 = min(s, s0 + rows_s) - 1
            if pos is not None:
                mine = walk if s1 >= s0 else []
            else:
                lo = max(walk[0] if walk else 0, _kv_tile_begin(s0, window))
                mine = [t for t in walk if s1 >= s0 and lo <= t <= s1 // BT]
            cons.append((s0, mine))
        out.append((x, bi, gi, cons))
    return out


def _emulate_bwd(q, k, v, o, lse, do, *, window=None, softcap=None, positions=None):
    """(dq, dk, dv) as the bf16 kernels' schedule computes them (in fp32 on
    the CPU): each dK/dV consumer's products over the items it computes, each
    dQ consumer's over its packed rows and KV tiles, every pair masked as
    the kernels mask it; every output row written by exactly one consumer."""
    b, s, h, d = q.shape
    g = k.shape[2]
    group = h // g
    scale = d ** -0.5
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    delta = (do * o).sum(-1).permute(0, 2, 1)                      # (B, H, S)
    rows = torch.arange(s)

    def seen(bi, qr, kr):
        """(len(qr), len(kr)) bool: query rows qr see key rows kr."""
        if positions is None:
            pq, pk = qr[:, None], kr[None, :]
        else:
            pq, pk = positions[bi][qr][:, None], positions[bi][kr][None, :]
        vis = pk <= pq
        return vis & (pk > pq - window) if window else vis

    def grads(bi, hd, gi, qr, kr):
        """P and dS of query rows qr of head hd against key rows kr."""
        sc = q[bi, qr, hd] @ k[bi, kr, gi].T * scale
        dcap = torch.ones_like(sc)
        if softcap:
            t = torch.tanh(sc / softcap)
            sc, dcap = t * softcap, 1 - t * t
        vis = seen(bi, qr, kr)
        p = torch.where(vis, torch.exp(sc - lse[bi, hd, qr][:, None]), torch.zeros(()))
        dp = do[bi, qr, hd] @ v[bi, kr, gi].T
        return p, p * (dp - delta[bi, hd, qr][:, None]) * dcap

    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    written = torch.zeros(b, s, g, d, dtype=torch.int64)
    for _, bi, gi, cons in _dkdv_blocks(b, s, g, group, d, window, positions):
        for kt, c0, cols, items, _ in cons:
            kr = rows[kt * BT:(kt + 1) * BT]
            if not len(kr):
                continue
            for hh, qt in items:
                qr = rows[qt * BT:(qt + 1) * BT]
                p, ds = grads(bi, gi * group + hh, gi, qr, kr)
                dv[bi, kr, gi, c0:c0 + cols] += p.T @ do[bi, qr, gi * group + hh, c0:c0 + cols]
                dk[bi, kr, gi, c0:c0 + cols] += ds.T @ q[bi, qr, gi * group + hh, c0:c0 + cols]
            written[bi, kr, gi, c0:c0 + cols] += 1
    dq_written = torch.zeros(b, s, h, dtype=torch.int64)
    for _, bi, gi, cons in _dq_blocks(b, s, g, group, d, window, positions):
        for s0, tiles in cons:
            for r in _dq_rows(group, d):
                if r is None or s0 + r[0] >= s:
                    continue
                qr, hd = rows[s0 + r[0]:s0 + r[0] + 1], gi * group + r[1]
                for t in tiles:
                    kr = rows[t * BT:(t + 1) * BT]
                    dq[bi, qr, hd] += grads(bi, hd, gi, qr, kr)[1] @ k[bi, kr, gi]
                dq_written[bi, qr, hd] += 1
    assert bool((written == 1).all()) and bool((dq_written == 1).all())
    return dq * scale, dk * scale, dv


BWD_MIRROR_CASES = [(1, 200, 4, 4, 64, {}, None), (2, 130, 6, 2, 128, {}, None),
                    (1, 300, 3, 1, 112, {}, None), (1, 150, 7, 1, 128, {}, None),
                    (1, 200, 8, 1, 64, dict(window=37), None),
                    (1, 300, 4, 2, 128, dict(window=64, softcap=2.0), None),
                    (2, 140, 4, 2, 256, {}, None), (1, 200, 2, 2, 256, dict(window=63), None),
                    (2, 200, 4, 4, 64, {}, "shifted"), (2, 200, 6, 2, 128, dict(window=50), "packed"),
                    (2, 130, 4, 2, 256, {}, "packed")]


def _tables(pattern, b, s):
    """chip_smoke.position_tables' patterns on the CPU: even rows shifted by 5
    (``shifted``) or three packed sequences (``packed``), odd rows at their
    index or a permutation."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(b):
        r = np.arange(s)
        if pattern == "shifted" or i % 2:
            out.append(r + 5 if pattern == "shifted" and i % 2 == 0 else
                       r if pattern == "shifted" else rng.permutation(s))
        else:
            cut = [s // 3, s // 3, s - 2 * (s // 3)]
            out.append(np.concatenate([np.arange(n) for n in cut]))
    return torch.tensor(np.stack(out), dtype=torch.int32)


@pytest.mark.parametrize("case", BWD_MIRROR_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}H{c[2]}G{c[3]}D{c[4]}"
                         + "".join(f"-{k}{v:g}" for k, v in c[5].items()) + f"-{c[6]}")
def test_bf16_schedule_computes_the_gradient(case):
    """The bf16 kernels' schedule, walked as the mirrors say (launch order,
    block walks, consumers' tiles and packed rows, masks), computes the
    gradient of the plain version: every pair each gradient needs is
    computed once, at GQA groups 1 to 8, head_dim 64, 112, 128 and 256
    (whose dK/dV consumers split the columns), with a window, a softcap and
    both tables of the training forward."""
    b, s, h, g, d, kw, pattern = case
    _, (q, k, v, do) = inputs(b, s, h, g, torch.float32, seed=12, d=d)
    pos = _tables(pattern, b, s) if pattern else None
    o, lse = attention_ref(q, k, v, return_lse=True, q_positions=pos, kv_positions=pos, **kw)
    got = _emulate_bwd(q, k, v, o, lse, do, positions=pos, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, q_positions=pos, kv_positions=pos, **kw)
    for name, a, r in zip("qkv", got, want):
        held(f32(a), f32(r), TOL[torch.float32], f"d{name} {case}")


@pytest.mark.parametrize("d", [64, 112, 128, 256])
@pytest.mark.parametrize("s,window", [(17, None), (512, None), (1000, None), (1000, 100),
                                      (5120, 4096)])
def test_dkdv_blocks_launch_every_kv_tile_once_heaviest_first(d, s, window):
    """The dK/dV kernel's launch order takes every (batch, KV head, KV tile)
    once, one consumer a tile (two at head_dim 256, each half of the
    columns), and launches the blocks heaviest first: the items a block
    computes never grow along the order.  The dQ kernel's likewise: every
    (batch, KV head, Q tile) once, its KV tiles never growing.  The source
    decodes the block index so."""
    b, g, group = 2, 3, 2
    n = -(-s // BT)
    blocks = _dkdv_blocks(b, s, g, group, d, window)
    seen = [(bi, gi, kt, c0) for _, bi, gi, cons in blocks for kt, c0, _, _, _ in cons
            if kt < n]
    split = _bwd_layout(d)["split"]
    assert sorted(seen) == sorted({(bi, gi, kt, c * d // split) for bi in range(b)
                                   for gi in range(g) for kt in range(n)
                                   for c in range(split)})
    work = [sum(len(items) for _, _, _, items, _ in cons) for _, _, _, cons in blocks]
    assert all(a >= c for a, c in zip(work, work[1:]))
    dq = _dq_blocks(b, s, g, group, d, window)
    rows = [(bi, gi, s0 + r[0], r[1]) for _, bi, gi, cons in dq for s0, _ in cons
            for r in _dq_rows(group, d) if r is not None and s0 + r[0] < s]
    assert sorted(rows) == sorted({(bi, gi, r, hh) for bi in range(b) for gi in range(g)
                                   for r in range(s) for hh in range(group)})
    work = [sum(len(tiles) for _, tiles in cons) for _, _, _, cons in dq]
    assert all(a >= c for a, c in zip(work, work[1:]))
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for line in ("const int kb = blockIdx.x / (B * G);", "const int bg = blockIdx.x % (B * G);",
                 "const int qt = n_q - 1 - (int)(blockIdx.x / (B * G));",
                 "const int b = bg / G;", "const int g = bg % G;"):
        assert line in text, line


@pytest.mark.parametrize("s,window,group", [(100, 1, 1), (130, 17, 3), (1000, 64, 4),
                                            (1000, 100, 7), (1024, 63, 8), (512, 4096, 3),
                                            (5120, 4096, 2), (300, None, 8)])
def test_bf16_bwd_walks_are_the_tiles_the_mask_needs(s, window, group):
    """At the bf16 kernels' tiles: the Q tiles each dK/dV consumer computes
    are exactly those its 64 KV rows need (``bwd_q_tiles``), its block's walk
    their union; the KV tiles each dQ block walks are exactly those its
    packed Q tile's query rows need (``bwd_kv_tiles`` at the tile's rows),
    and each consumer's those of its own rows."""
    n = -(-s // BT)
    mask = torch.zeros(n * BT, n * BT, dtype=torch.bool)
    mask[:s, :s] = _mask(s, s, True, window, "cpu")
    for d in (128, 256):
        for _, _, _, cons in _dkdv_blocks(1, s, 1, 1, d, window):
            union = set()
            for kt, _, _, items, _ in cons:
                need = mask[:, kt * BT:(kt + 1) * BT].any(1).reshape(n, BT).any(1)
                mine = [qt for _, qt in items]
                assert mine == need.nonzero().flatten().tolist()
                if kt < n:
                    assert mine == list(flash_ops.bwd_q_tiles(kt, s, window=window))
                union |= set(mine)
        rows_s = 64 // group
        bq = _bwd_layout(d)["dq_consumers"] * rows_s
        n_q = -(-s // bq)
        for x, _, _, cons in _dq_blocks(1, s, 1, group, d, window):
            qt = n_q - 1 - x
            walk = list(flash_ops.bwd_kv_tiles(qt, window=window, q_rows=bq, s=s))
            need = mask[qt * bq:min(s, (qt + 1) * bq)].any(0).reshape(n, BT).any(1)
            assert walk == need.nonzero().flatten().tolist()
            for s0, tiles in cons:
                need = mask[s0:min(s, s0 + rows_s)].any(0).reshape(n, BT).any(1)
                assert tiles == need.nonzero().flatten().tolist()


@pytest.mark.parametrize("group", [1, 3, 4, 7, 8])
def test_dq_packed_rows_hold_whole_query_rows(group):
    """A dQ consumer's 64 packed rows: row r is query row r // group of head
    r % group of the group, the 64 % group left over never loaded or
    written; its Q and dO boxes are 64 // group rows of the group's heads,
    and the block's Q tile is its consumers' rows (one consumer above
    head_dim 128)."""
    rows = _dq_rows(group, 128)
    rows_s = 64 // group
    assert [r for r in rows if r is not None] == [(i, hh) for i in range(rows_s)
                                                  for hh in range(group)]
    assert rows.count(None) == 64 % group
    for d in (64, 112, 128, 256):
        assert _bwd_layout(d)["dq_consumers"] == (1 if d > 128 else 2)
    text = " ".join((CSRC / "flash_attention_bwd.cu").read_text().split())
    assert "const int rows_s = MMA_ROWS / group;" in text
    assert "sr[i] = s0 + r / group;" in text and "hd[i] = g * group + r % group;" in text
    assert "live[i] = r < rows_s * group && sr[i] < S;" in text
    assert "!tensor_map(&tm_qp, q, D, H, S, B, D, qrow, qbatch, group, rows_s)" in text


@pytest.mark.parametrize("ext", [False, True], ids=["plain", "ext"])
@pytest.mark.parametrize("d", [64, 112, 128, 256])
def test_bwd_kernels_shared_memory_fits_a_block(d, ext):
    """Each bf16 backward kernel's shared memory fits the 232,448 bytes a
    block may take: dK/dV its KV tiles, the ring of Q and dO tiles with their
    lse and delta values, the barriers and the alignment slack; dQ its
    consumers' Q and dO, the ring of K and V tiles, the barriers and the
    slack; the same layout with and without the window and softcap (the
    ``_ext_`` kernels share the bodies), and the registers of a producer and
    two consumers fit an SM's 65,536."""
    c = _bwd_source_constants()
    lay = _bwd_layout(d)
    tile = -(-d // c["BOX_COLS"]) * c["BOX_BYTES"]
    ns = lay["stages"]
    dkdv = ((2 * lay["kv_tiles"] + 2 * ns) * tile + 2 * ns * c["STATS_BYTES"]
            + c["BAR_BYTES"] + c["SMEM_ALIGN"])
    dq = (2 * lay["dq_consumers"] + 2 * ns) * tile + c["BAR_BYTES"] + c["SMEM_ALIGN"]
    assert max(dkdv, dq) <= c["SMEM_LIMIT"] == 232448
    # a third slot would pass the block's shared memory at head_dim 256
    assert d <= 128 or (2 * lay["kv_tiles"] + 2 * (ns + 1)) * tile > c["SMEM_LIMIT"]
    assert 8 * (1 + 2 * c["STAGES"]) <= c["BAR_BYTES"]
    # a Q tile's 64 lse (or delta) values from the 16-byte boundary below them
    assert c["STATS_BOX"] >= BT + 3 and 4 * c["STATS_BOX"] % 16 == 0
    assert 4 * c["STATS_BOX"] <= c["STATS_BYTES"]
    assert 128 * (c["PRODUCER_REGS"] + c["CONSUMERS"] * c["CONSUMER_REGS"]) <= 65536
    text = " ".join((CSRC / "flash_attention_bwd.cu").read_text().split())
    assert ("return (long long)(2 * dkdv_kv_tiles<D>() + 2 * ring_stages<D>()) * tile_bytes<D>() + "
            "2 * ring_stages<D>() * STATS_BYTES + BAR_BYTES + SMEM_ALIGN;") in text
    assert ("return (long long)(2 * dq_consumers<D>() + 2 * ring_stages<D>()) * tile_bytes<D>() + "
            "BAR_BYTES + SMEM_ALIGN;") in text
    assert "return D > WIDE_DIM ? 2 : STAGES;" in text
    body = "dkdv_wgmma_body<D, true>" if ext else "dkdv_wgmma_body<D, false>"
    assert body in text and ("dq_wgmma_body<D, true>" if ext else "dq_wgmma_body<D, false>") in text
    assert text.count("const int smem_kv = (int)dkdv_smem_bytes<D>(), "
                      "smem_q = (int)dq_smem_bytes<D>();") == 1


def test_the_chip_check_names_every_bf16_backward_kernel(smoke):
    """``chip_smoke.py``'s SASS check covers the bf16 backward kernels: the
    dK/dV and dQ kernels without and with a window or softcap and the
    position variant's, at each head size, each a kernel of the sources."""
    names = smoke.FLASH_BWD_WGMMA_KERNELS
    assert len(names) == 24 and len(set(names)) == 24
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for name in {n.split("<")[0] for n in names}:
        assert f"\n{name}(const __grid_constant__ CUtensorMap tm_q," in text, name


def test_bf16_bwd_consumers_wait_for_every_load_they_read():
    """Each bf16 backward body's consumers wait on every barrier its
    producer arms before reading what it guards: the block's resident tiles
    (K and V in dK/dV, Q and dO in dQ) once, each ring slot's tile before
    its products, the slot freed after them; a consumer that read a tile
    before its copy landed would compute on the previous block's data."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    for body, resident in (("dkdv_wgmma_body", "kv_full"), ("dq_wgmma_body", "q_full")):
        start = text.index(f"__device__ __forceinline__ void {body}(")
        code = text[start:text.index("\n}\n", start)]
        consumer = code[code.index("// a consumer warpgroup"):]
        producer = code[code.index("// the producer"):code.index("// a consumer warpgroup")]
        assert f"mbar_expect_tx({resident}," in producer
        assert consumer.count(f"mbar_wait({resident}, 0);") == 1
        first_product = consumer.index("wgmma_fence();")
        assert consumer.index(f"mbar_wait({resident}, 0);") < first_product
        assert "mbar_expect_tx(full(st)," in producer and "mbar_wait(empty(st)," in producer
        assert consumer.count("mbar_wait(full(st") >= 2          # computed and passed items
        assert "mbar_arrive(empty(st), lane == 0);" in consumer
