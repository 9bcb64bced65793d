"""The gradient of the SSD scan in the port against the JAX package's.

``ssd_bwd_ref`` (the closed forms of the scan's backward walked one row at a
time, the oracle of the backward kernel) is held against torch autograd of
``ssd_ref`` and against ``jax.vjp`` of the reference's ``ssd_chunked``, which
is what the JAX package differentiates in training; every gradient (x, dt,
A, B, C and the initial state), with and without an initial state and a
final-state gradient.  The kernel's own arithmetic, the sub-chunk products of
csrc/ssd_scan_bwd.cu, is mirrored in torch and held against the oracle too.

Tolerance: 1e-4 of each gradient's largest magnitude (fp32, the reference's
SSD tolerance; two fp32 evaluations summing in other orders).  The kernel
itself runs only on the card (``chip_smoke.py``); here the wrappers take
their plain versions because the tensors lie on the CPU.  torch runs on one
thread (see tests/test_torch_ssd_scan.py for why)."""

import ctypes
import importlib.util
from pathlib import Path
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
# the port
from repro_torch.kernels import kernels_built
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.kernels import ssd_bwd_ref
from repro_torch.kernels import ssd_ref
from repro_torch.kernels import ssd_scan
from repro_torch.kernels import ssd_scan_bwd
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src" / "repro_torch" / "csrc"
TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")
# (B, S, H, G, P, N, chunk, initial state, final-state gradient)
CASES = [
    (2, 64, 4, 2, 16, 8, 16, True, True),     # S a multiple of the chunk, G 2
    (1, 40, 2, 1, 32, 16, 40, False, False),  # S <= chunk, one chunk
    (2, 96, 6, 3, 8, 4, 32, True, False),
    (1, 130, 4, 1, 32, 16, 130, False, True),  # past two 64-row sub-chunks
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def case_id(c):
    return "B{}S{}H{}G{}P{}N{}c{}".format(*c[:7]) + ("-init" if c[7] else "") + \
        ("-dfinal" if c[8] else "")


def arrays(case, seed=0):
    """numpy inputs (the reference's recipe: dt = softplus(N(0,1)) * 0.1, A =
    -exp(U(-1,1))), dy, and the initial state and dfinal (None where the case
    has none)."""
    b, s, h, g, p, n, _, with_init, with_final = case
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((b, s, h, p)),
           np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1,
           -np.exp(rng.uniform(-1.0, 1.0, h)),
           rng.standard_normal((b, s, g, n)), rng.standard_normal((b, s, g, n)),
           rng.standard_normal((b, s, h, p)),
           rng.standard_normal((b, h, p, n)) if with_init else None,
           rng.standard_normal((b, h, p, n)) if with_final else None]
    return [None if a is None else a.astype(np.float32) for a in out]


def tensors(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def held(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} beyond {tol} x {scale:.3g}"


def autograd_grads(x, dt, A, B, C, dy, init, dfinal, chunk, dtype=torch.float32):
    """The six gradients by autograd of the chunked scan in ``dtype`` (an
    initial state of zeros where none is given, whose gradient is dinit)."""
    b, _, h, p = x.shape
    n = B.shape[3]
    if init is None:
        init = torch.zeros((b, h, p, n))
    leaves = [t.to(dtype).requires_grad_() for t in (x, dt, A, B, C, init)]
    y, final = ssd_chunked(*leaves[:5], chunk, initial_state=leaves[5])
    loss = (y * dy.to(dtype)).sum()
    if dfinal is not None:
        loss = loss + (final * dfinal.to(dtype)).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_ref_matches_autograd_of_ssd_ref(case):
    x, dt, A, B, C, dy, init, dfinal = tensors(arrays(case))
    chunk = case[6]
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    if init is not None:
        leaves.append(init.clone().requires_grad_())
    y, final = ssd_ref(*leaves[:5], chunk, initial_state=leaves[5] if init is not None else None)
    loss = (y * dy).sum() + ((final * dfinal).sum() if dfinal is not None else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32
        held(a.numpy(), w.numpy(), f"{name} {case_id(case)}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_ref_matches_jax_vjp_of_ssd_chunked(case):
    arrs = arrays(case, seed=1)
    b, _, h, _, p, n, chunk = case[:7]
    x, dt, A, B, C, dy, init, dfinal = arrs
    jinit = init if init is not None else np.zeros((b, h, p, n), np.float32)
    jfinal = dfinal if dfinal is not None else np.zeros((b, h, p, n), np.float32)

    @jax.jit
    def vjp(*args):
        _, pull = jax.vjp(lambda *a: jax_ssd_chunked(*a[:5], chunk, initial_state=a[5]),
                          *args)
        return pull((jnp.asarray(dy), jnp.asarray(jfinal)))

    want = vjp(*(jnp.asarray(a) for a in (x, dt, A, B, C, jinit)))
    tx, tdt, tA, tB, tC, tdy, tinit, tfinal = tensors(arrs)
    got = ssd_bwd_ref(tx, tdt, tA, tB, tC, tdy, tfinal, tinit)
    for name, a, w in zip(NAMES, got, want):
        held(a.numpy(), np.asarray(w), f"{name} vs jax.vjp {case_id(case)}")


def kernel_walk(x, dt, A, B, C, dy, dfinal, init, q=64):
    """The sub-chunk products of csrc/ssd_scan_bwd.cu in torch, one (batch,
    head) at a time: the forward walk (dC^h and the running state), the
    reverse walk (dXD, dB^h, the reverse state R, the reverse running sum of
    dcum from a carry), then the sums over a group's heads."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    dch, dbh = torch.zeros(b, s, h, n), torch.zeros(b, s, h, n)
    dx, ddt = torch.zeros_like(x), torch.zeros(b, s, h)
    dinit, dA = torch.zeros(b, h, p, n), torch.zeros(h)

    def tile(t, rows, c0):
        out = torch.zeros((q,) + tuple(t.shape[1:]))
        out[:rows] = t[c0:c0 + rows]
        return out

    for bi in range(b):
        for hi in range(h):
            gi, a = hi // rep, A[hi]

            def chunk(c0):
                rows = min(q, s - c0)
                X, DY = tile(x[bi, :, hi], rows, c0), tile(dy[bi, :, hi], rows, c0)
                Bs, Cs = tile(B[bi, :, gi], rows, c0), tile(C[bi, :, gi], rows, c0)
                d = tile(dt[bi, :, hi], rows, c0)
                cum = torch.cumsum(d * a, 0)
                L = torch.exp((cum[:, None] - cum[None, :]).tril()).tril()
                return rows, X, DY, Bs, Cs, d, cum, cum[-1], L

            st = init[bi, hi].clone() if init is not None else torch.zeros(p, n)
            for c0 in range(0, s, q):
                rows, X, DY, Bs, _, d, cum, tot, L = chunk(c0)
                ML = (DY @ X.T) * d[None, :] * L
                dch[bi, c0:c0 + rows, hi] = (torch.exp(cum)[:, None] * (DY @ st) + ML @ Bs)[:rows]
                st = torch.exp(tot) * st + X.T @ ((d * torch.exp(tot - cum))[:, None] * Bs)
            carry = (dfinal[bi, hi] * st).sum() if dfinal is not None else torch.zeros(())
            R = dfinal[bi, hi].clone() if dfinal is not None else torch.zeros(p, n)
            for c0 in reversed(range(0, s, q)):
                rows, X, DY, Bs, Cs, d, cum, tot, L = chunk(c0)
                w = torch.exp(tot - cum)
                dxd = w[:, None] * (Bs @ R.T) + ((Cs @ Bs.T) * L).T @ DY
                dbh_c = (w * d)[:, None] * (X @ R) + ((DY @ X.T) * d[None, :] * L).T @ Cs
                dcum = (Cs * tile(dch[bi, :, hi], rows, c0)).sum(1) - (Bs * dbh_c).sum(1)
                R = torch.exp(tot) * R + DY.T @ (torch.exp(cum)[:, None] * Cs)
                da = dcum.flip(0).cumsum(0).flip(0) + carry
                carry = da[0]
                dx[bi, c0:c0 + rows, hi] = (dxd * d[:, None])[:rows]
                ddt[bi, c0:c0 + rows, hi] = ((dxd * X).sum(1) + da * a)[:rows]
                dbh[bi, c0:c0 + rows, hi] = dbh_c[:rows]
                dA[hi] += (da * d).sum()
            dinit[bi, hi] = R
    return (dx, ddt, dA, dbh.reshape(b, s, g, rep, n).sum(3),
            dch.reshape(b, s, g, rep, n).sum(3), dinit)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=case_id)
def test_kernel_sub_chunk_walk_matches_bwd_ref(case):
    """The kernel's algorithm (64-row sub-chunks, decays within one
    sub-chunk only, the carried reverse state and dcum sum) gives the
    oracle's gradients."""
    x, dt, A, B, C, dy, init, dfinal = tensors(arrays(case, seed=2))
    got = kernel_walk(x, dt, A, B, C, dy, dfinal, init)
    want = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init)
    for name, a, w in zip(NAMES, got, want):
        held(a.numpy(), w.numpy(), f"{name} {case_id(case)}")


def test_cpu_scan_under_grad_is_differentiated_by_autograd():
    """On the CPU, ``ssd_scan`` under grad is the plain version, which
    autograd differentiates; its gradient is ``ssd_scan_bwd``'s (the plain
    ``ssd_bwd_ref`` here), on strided views as the model hands them over;
    nothing is launched or built."""
    reset_launch_counts()
    b, s, h, g, p, n = 2, 64, 4, 2, 32, 16
    x, dt, A, _, _, dy, init, dfinal = tensors(arrays((b, s, h, g, p, n, 32, True, True), 3))
    bc = torch.from_numpy(np.random.default_rng(3).standard_normal((b, s, 2 * g * n))
                          .astype(np.float32)).requires_grad_()
    x, dt, A, init = (t.clone().requires_grad_() for t in (x, dt, A, init))
    B, C = bc[..., :g * n].view(b, s, g, n), bc[..., g * n:].view(b, s, g, n)
    y, final = ssd_scan(x, dt, A, B, C, chunk=32, initial_state=init)
    got = torch.autograd.grad((y, final), (x, dt, A, bc, init), (dy, dfinal))
    want = ssd_scan_bwd(x.detach(), dt.detach(), A.detach(), B.detach(), C.detach(), dy,
                        dfinal, initial_state=init.detach())
    got_b, got_c = got[3][..., :g * n].reshape(b, s, g, n), got[3][..., g * n:].reshape(b, s, g, n)
    for name, a, w in zip(NAMES, (got[0], got[1], got[2], got_b, got_c, got[4]), want):
        held(a.numpy(), w.numpy(), name)
    assert launch_counts()["ssd_scan"] == 0 and launch_counts()["ssd_scan_bwd"] == 0
    assert not kernels_built()


@pytest.mark.parametrize("kw,why", [
    (dict(dtype=torch.bfloat16), "bfloat16"), (dict(n=8), "d_state 8"),
    (dict(n=256), "d_state 256"), (dict(p=96), "head_dim 96"), (dict(p=128), "head_dim 128")])
def test_backward_refuses_what_the_kernel_does_not_compute(kw, why):
    args = dict(dtype=torch.float32, p=64, n=128)
    args.update(kw)
    with pytest.raises(NotImplementedError, match=why):
        ssd_ops.check_backward(args["dtype"], args["p"], args["n"])


@pytest.mark.parametrize("p", ssd_ops.BWD_HEAD_DIMS)
@pytest.mark.parametrize("n", ssd_ops.D_STATES)
def test_backward_takes_the_model_shapes(p, n):
    ssd_ops.check_backward(torch.float32, p, n)


def test_bwd_wrapper_argtypes_match_the_c_interface():
    source = (CSRC / "ssd_scan_bwd.cu").read_text()
    params = [" ".join(p.split()) for p in re.search(
        r'extern "C" int dco_ssd_scan_bwd\(([^)]*)\)', source).group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == ssd_ops.BWD_ARGTYPES
    fwd = (CSRC / "ssd_scan.cu").read_text()
    params = re.search(r'extern "C" int dco_ssd_scan\(([^)]*)\)', fwd).group(1).split(",")
    assert [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params] == ssd_ops.ARGTYPES


def test_bwd_wrapper_limits_match_the_kernel_source():
    """The wrapper's view of the backward kernel matches its source: the
    head sizes and state sizes it is compiled for, the sub-chunk, and one
    count a launch."""
    source = (CSRC / "ssd_scan_bwd.cu").read_text()
    for p in ssd_ops.BWD_HEAD_DIMS:
        assert f"if (P == {p}) return launch_n<{p}>" in source
    for n in ssd_ops.D_STATES:
        assert f"case {n}:" in source
    assert f"constexpr int Q = {ssd_ops.SUB_CHUNK};" in source
    launch = source[source.index("int launch(const Args& r"):]
    assert launch[:launch.index("\n}\n")].count("<<<") == ssd_ops.BWD_KERNELS


def test_bwd_wrapper_checks_shapes():
    x, dt, A, B, C, dy, _, _ = tensors(arrays(CASES[1]))
    with pytest.raises(ValueError, match="dy"):
        ssd_scan_bwd(x, dt, A, B, C, dy[:, :5])
    with pytest.raises(ValueError, match="dfinal"):
        ssd_scan_bwd(x, dt, A, B, C, dy, torch.zeros(1, 2, 32, 8))
    with pytest.raises(ValueError, match="disagree"):
        ssd_scan_bwd(x, dt[:, :20], A, B, C, dy)


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, whose SSD gradient rule the card's check uses."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", [(2, 200, 4, 2, 32, 16, 200, True, True),
                                  (1, 256, 3, 1, 32, 32, 64, False, False)], ids=case_id)
def test_card_gradient_rule_holds_the_oracle_and_rejects_planted_faults(smoke, case):
    """The rule ``chip_smoke.py`` holds the SSD backward kernel to
    (elementwise, 1e-4 on each row's and 64-row tile's scale; dA on its RMS)
    passes ``ssd_bwd_ref`` against autograd of the chunked scan in float64,
    and fails each fault it plants: the last sub-chunk's dB left at zero, one
    head of every group missing from dB and from dC in the sub-chunk before,
    and the reverse running sum of dcum cut at the last sub-chunk boundary."""
    x, dt, A, B, C, dy, init, dfinal = tensors(arrays(case, seed=4))
    got = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init)
    want = tuple(t.float() for t in autograd_grads(x, dt, A, B, C, dy, init, dfinal, case[6],
                                                   torch.float64))
    for name, a, w in zip(NAMES, got, want):
        ok, ratio, _, _ = smoke.ssd_grad_err(name, a, w, TOL)
        assert ok, f"{name} {case_id(case)}: worst ratio {ratio:.3g}"
    assert smoke.ssd_faults_rejected(x, dt, A, B, C, dy, dfinal, init, got, want, TOL,
                                     case_id(case)) > 1.0
