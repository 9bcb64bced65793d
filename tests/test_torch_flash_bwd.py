"""The gradient of attention in the port against the JAX package's.

``attention_bwd_ref`` (the FlashAttention-2 backward written out, the oracle
of the backward kernel) is held against torch autograd of ``attention_ref``
and against ``jax.vjp`` of the reference's ``gqa_attention``, which is what
the JAX package differentiates in training; the forward's per-row
log-sum-exp against the log-sum-exp of the reference's masked scores.

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

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
D = 64
# (B, S, H, G)
SHAPES = [(1, 17, 4, 4), (2, 17, 4, 2), (1, 100, 4, 1), (2, 100, 8, 2), (1, 100, 4, 4)]


def inputs(b, s, h, g, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, D), (b, s, g, D), (b, s, g, D), (b, s, h, D))]
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


@pytest.mark.parametrize("kw,why", [
    (dict(window=64), "window"), (dict(softcap=50.0), "softcap"),
    (dict(d=112), "head_dim 112"), (dict(d=256), "head_dim 256"),
    (dict(causal=False), "non-causal")])
def test_backward_refuses_what_the_kernel_does_not_compute(kw, why):
    args = dict(d=128, causal=True, window=None, softcap=None)
    args.update(kw)
    with pytest.raises(NotImplementedError, match=why):
        flash_ops.check_backward(args["d"], args["causal"], args["window"], args["softcap"])


@pytest.mark.parametrize("d", [64, 128])
def test_backward_takes_the_dense_training_shapes(d):
    flash_ops.check_backward(d, True, None, None)


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
    assert smoke.check_faults_rejected(q, k, v, o, lse, do, got, want, TOL[dtype],
                                       f"{shape} {dtype}") > 1.0


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
