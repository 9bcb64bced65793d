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


def tf32(t):
    """fp32 rounded to TF32 as ``tf32_rna`` (csrc/tf32.cuh) does it: to
    nearest, ties away from zero, as integer operations on the bits."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b as the kernel's wgmma products form it: each operand split into
    hi = tf32(a) and lo = tf32(a - hi), lo hi' + hi lo' + hi hi' with fp32
    sums (lo lo' dropped)."""
    a_hi, b_hi = tf32(a), tf32(b)
    return tf32(a - a_hi) @ b_hi + a_hi @ tf32(b - b_hi) + a_hi @ b_hi


def kernel_walk(x, dt, A, B, C, dy, dfinal, init, q=64, mm=torch.matmul, seed=None):
    """csrc/ssd_scan_bwd.cu's schedule in torch.  Three walks a (batch, head),
    each carrying its own state from sub-chunk to sub-chunk: the dC^h walk
    (first to last, the running state ST), the dB^h walk and the dx walk
    (last to first, R and R^T); each writes its rows and, per consumer half
    of its columns (N for the first two, P for the third), the fp64
    partials of C . dC^h, B . dB^h and dXD . x.  Then the fp64 scan of dcum
    from the partials and <dFinal, final state>, and the sums over a group's
    heads.  Every product goes through ``mm``.  With ``seed`` the (walk,
    batch, head) blocks run in a shuffled order: none reads what another
    writes, as on the card."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    f64 = torch.float64
    dch, dbh = torch.zeros(b, s, h, n), torch.zeros(b, s, h, n)
    dx = torch.zeros_like(x)
    parts = torch.zeros(6, b, h, s, dtype=f64)
    fdot = torch.zeros(b, h, dtype=f64)
    dinit = torch.zeros(b, h, p, n)

    def tile(t, rows, c0):
        out = torch.zeros((q,) + tuple(t.shape[1:]))
        out[:rows] = t[c0:c0 + rows]
        return out

    def sub(bi, hi, c0):
        rows = min(q, s - c0)
        X, DY = tile(x[bi, :, hi], rows, c0), tile(dy[bi, :, hi], rows, c0)
        Bs, Cs = tile(B[bi, :, hi // rep], rows, c0), tile(C[bi, :, hi // rep], rows, c0)
        d = tile(dt[bi, :, hi], rows, c0)
        cum = torch.cumsum(d * A[hi], 0)
        L = torch.exp((cum[:, None] - cum[None, :]).tril()).tril()
        w = torch.exp(cum[-1] - cum)
        return rows, X, DY, Bs, Cs, d, torch.exp(cum), torch.exp(cum[-1]), w, L

    def halves(prod, slot, bi, hi, c0, rows):
        """The two consumers' fp64 row sums of ``prod`` (rows x columns)."""
        cols = prod.shape[1] // 2
        for k in range(2):
            part = prod[:rows, k * cols:(k + 1) * cols].double().sum(1)
            parts[slot + k, bi, hi, c0:c0 + rows] = part

    def c_walk(bi, hi):
        st = init[bi, hi].clone() if init is not None else torch.zeros(p, n)
        for c0 in range(0, s, q):
            rows, X, DY, Bs, Cs, d, ecum, e, w, L = sub(bi, hi, c0)
            ML = mm(DY, X.T) * d[None, :] * L
            dc = ecum[:, None] * mm(DY, st) + mm(ML, Bs)
            dch[bi, c0:c0 + rows, hi] = dc[:rows]
            halves(Cs.double() * dc.double(), 0, bi, hi, c0, rows)
            st = e * st + mm((X * (d * w)[:, None]).T, Bs)
        if dfinal is not None:
            fdot[bi, hi] = (dfinal[bi, hi].double() * st.double()).sum()

    def b_walk(bi, hi):
        R = dfinal[bi, hi].clone() if dfinal is not None else torch.zeros(p, n)
        for c0 in reversed(range(0, s, q)):
            rows, X, DY, Bs, Cs, d, ecum, e, w, L = sub(bi, hi, c0)
            MLT = mm(X, DY.T) * d[:, None] * L.T
            db = (w * d)[:, None] * mm(X, R) + mm(MLT, Cs)
            dbh[bi, c0:c0 + rows, hi] = db[:rows]
            halves(Bs.double() * db.double(), 2, bi, hi, c0, rows)
            R = e * R + mm((DY * ecum[:, None]).T, Cs)
        dinit[bi, hi] = R

    def x_walk(bi, hi):
        RT = dfinal[bi, hi].T.clone() if dfinal is not None else torch.zeros(n, p)
        for c0 in reversed(range(0, s, q)):
            rows, X, DY, Bs, Cs, d, ecum, e, w, L = sub(bi, hi, c0)
            SLT = mm(Bs, Cs.T) * L.T
            dxd = w[:, None] * mm(Bs, RT) + mm(SLT, DY)
            dx[bi, c0:c0 + rows, hi] = (dxd * d[:, None])[:rows]
            halves(dxd.double() * X.double(), 4, bi, hi, c0, rows)
            RT = e * RT + mm((Cs * ecum[:, None]).T, DY)

    blocks = [(walk, bi, hi) for walk in (c_walk, b_walk, x_walk)
              for bi in range(b) for hi in range(h)]
    if seed is not None:
        blocks = [blocks[i] for i in np.random.default_rng(seed).permutation(len(blocks))]
    for walk, bi, hi in blocks:
        walk(bi, hi)
    # the scan: da_t = <dFinal, final state> + the sum of dcum over t' >= t
    dcum = (parts[0] + parts[1]) - (parts[2] + parts[3])                  # (b, h, s)
    da = dcum.flip(-1).cumsum(-1).flip(-1) + fdot[..., None]
    dt64 = dt.double().permute(0, 2, 1)
    ddt = (da * A.double()[None, :, None] + parts[4] + parts[5]).float().permute(0, 2, 1)
    dA = (da * dt64).sum((0, 2)).float()
    return (dx, ddt, dA, dbh.reshape(b, s, g, rep, n).sum(3),
            dch.reshape(b, s, g, rep, n).sum(3), dinit)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]], ids=case_id)
def test_kernel_sub_chunk_walk_matches_bwd_ref(case):
    """The kernel's algorithm (64-row sub-chunks, decays within one
    sub-chunk only, three walks with their own carried states, the fp64
    partials and scan of dcum), its blocks in a shuffled order, gives the
    oracle's gradients and the JAX package's."""
    x, dt, A, B, C, dy, init, dfinal = tensors(arrays(case, seed=2))
    got = kernel_walk(x, dt, A, B, C, dy, dfinal, init, seed=5)
    want = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init)
    for name, a, w in zip(NAMES, got, want):
        held(a.numpy(), w.numpy(), f"{name} {case_id(case)}")
    b, _, h, _, p, n, chunk = case[:7]
    xa, dta, Aa, Ba, Ca, dya, inita, dfa = arrays(case, seed=2)
    jinit = inita if inita is not None else np.zeros((b, h, p, n), np.float32)
    jfinal = dfa if dfa is not None else np.zeros((b, h, p, n), np.float32)

    @jax.jit
    def vjp(*args):
        _, pull = jax.vjp(lambda *a: jax_ssd_chunked(*a[:5], chunk, initial_state=a[5]),
                          *args)
        return pull((jnp.asarray(dya), jnp.asarray(jfinal)))

    want_jax = vjp(*(jnp.asarray(t) for t in (xa, dta, Aa, Ba, Ca, jinit)))
    for name, a, w in zip(NAMES, got, want_jax):
        held(a.numpy(), np.asarray(w), f"{name} vs jax.vjp {case_id(case)}")


@pytest.mark.parametrize("case", [(2, 200, 4, 2, 32, 16, 200, True, True),
                                  (1, 130, 2, 1, 32, 16, 130, False, True),
                                  (1, 192, 3, 1, 16, 32, 64, True, False),
                                  (2, 150, 2, 2, 32, 8, 150, False, False)], ids=case_id)
def test_kernel_walk_in_3xtf32_holds_the_card_rule(smoke, case):
    """The kernel's schedule with every product formed as its wgmma forms
    it, 3xTF32 (``mm_3xtf32``), stays within ``chip_smoke.ssd_grad_err``'s
    rule at 1e-4 against autograd of the chunked scan in float64; S past two
    sub-chunks, with and without dinit and dFinal."""
    x, dt, A, B, C, dy, init, dfinal = tensors(arrays(case, seed=6))
    got = kernel_walk(x, dt, A, B, C, dy, dfinal, init, mm=mm_3xtf32)
    want = tuple(t.float() for t in autograd_grads(x, dt, A, B, C, dy, init, dfinal, case[6],
                                                   torch.float64))
    for name, a, w in zip(NAMES, got, want):
        if init is None and name == "dinit":
            continue
        ok, ratio, _, _ = smoke.ssd_grad_err(name, a, w, TOL)
        assert ok, f"{name} {case_id(case)}: worst ratio {ratio:.3g}"


def test_tf32_split_matches_the_kernel_header():
    """``tf32`` rounds as csrc/tf32.cuh's ``tf32_rna`` (ties away from zero,
    13 low bits cleared), and hi + lo of ``mm_3xtf32``'s split keeps 21 bits."""
    text = " ".join((CSRC / "tf32.cuh").read_text().split())
    assert "return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;" in text
    assert "lo = tf32_rna(a - __uint_as_float(hi));" in text
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 3 * 2 ** -11])
    assert torch.equal(tf32(x), torch.tensor([1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                                              1.0 + 2 ** -9]))
    r = torch.from_numpy(np.random.default_rng(13).standard_normal(4096).astype(np.float32))
    hi = tf32(r)
    assert float(((r - hi - tf32(r - hi)) / r).abs().max()) <= 2 ** -21


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


def _source_ints(text):
    """{NAME: value} of the ``constexpr int NAME = <int or a * b>;`` lines."""
    out = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([0-9 *]+);", text):
        value = 1
        for factor in expr.split("*"):
            value *= int(factor)
        out[name] = value
    return out


def op_tile_bytes(rows, k):
    """``OpTile<ROWS, K>::BYTES``: the hi and lo parts, boxes of 32 values of
    4 bytes, ROWS rows a box."""
    return 2 * (-(-k // 32)) * rows * 128


@pytest.mark.parametrize("p", ssd_ops.BWD_HEAD_DIMS)
@pytest.mark.parametrize("n", ssd_ops.D_STATES)
def test_bwd_walk_shared_memory_fits_a_block(p, n):
    """Each walk kernel's shared memory (``Smem<W, P, N>`` of
    csrc/ssd_scan_bwd.cu, its lines checked here and summed as the source
    sums them) fits the 232,448 bytes a block may take, at every (P, N) the
    wrapper passes; the prepared tiles' size is the wrapper's
    ``bwd_prep_bytes``."""
    text = (CSRC / "ssd_scan_bwd.cu").read_text()
    flat = " ".join(text.split())
    c = _source_ints(text)
    c.update(_source_ints((CSRC / "hopper.cuh").read_text()))
    q = ssd_ops.SUB_CHUNK
    assert c["Q"] == q and c["RAW_BOX"] == 64 * 128 and c["SMEM_LIMIT"] == 232448
    for line in (
            "static constexpr int BOX = ROWS * 128;",
            "static constexpr int HALF = (K + 31) / 32 * BOX;",
            "static constexpr int BYTES = 2 * HALF;",
            "static constexpr int RAW = P / 32 * RAW_BOX;",
            "static constexpr int DY_AT = W == X_WALK ? 0 : RAW;",
            "static constexpr int STAGE = DY_AT + RAW;",
            "static constexpr int BR_OFF = T2_OFF + T2::BYTES;",
            "static constexpr int V_OFF = BR_OFF + (W == X_WALK ? (N + 31) / 32 * RAW_BOX : 0);",
            "using T0 = typename std::conditional<W == X_WALK, OpTile<Q, N>, OpTile<Q, P>>::type;",
            "using T1 = typename std::conditional<W == X_WALK, OpTile<P, Q>, OpTile<N, Q>>::type;",
            "using T2 = typename std::conditional<W == X_WALK, OpTile<P, N>, OpTile<N, P>>::type;",
            "static constexpr int T0_OFF = STAGES * STAGE;",
            "static constexpr int RED_OFF = V_OFF + 4 * Q * 4 + 16;",
            "static constexpr int BAR_OFF = RED_OFF + 8 * 8;",
            "static constexpr int BYTES = BAR_OFF + 8 * (STAGES + 1) + SMEM_ALIGN;",
            "return 2LL * OpTile<N, Q>::BYTES + OpTile<Q, N>::BYTES + (N + 31) / 32 * RAW_BOX;"):
        assert line in flat, line
    raw = (p // 32) * c["RAW_BOX"]            # a staged 64 x P tile
    b_rows = -(-n // 32) * c["RAW_BOX"]       # the x walk's staged B rows
    for stage, tiles, extra in (
            (2 * raw, [(q, p), (n, q), (n, p)], 0),        # the c walk (x, dy staged)
            (2 * raw, [(q, p), (n, q), (n, p)], 0),        # the b walk
            (raw, [(q, n), (p, q), (p, n)], b_rows)):      # the x walk (dy staged)
        total = (c["STAGES"] * stage + sum(op_tile_bytes(*t) for t in tiles) + extra
                 + 4 * q * 4 + 16 + 8 * 8 + 8 * (c["STAGES"] + 1) + c["SMEM_ALIGN"])
        assert total <= c["SMEM_LIMIT"], (p, n, tiles, total)
    assert ssd_ops.bwd_prep_bytes(n) == (2 * op_tile_bytes(n, q) + op_tile_bytes(q, n)
                                         + b_rows)
    assert ssd_ops.bwd_prep_bytes(n) % 1024 == 0   # each tile's copy starts on 1,024 bytes


def test_every_tma_box_is_a_multiple_of_16_bytes():
    """TMA moves boxes whose innermost extent is a multiple of 16 bytes: the
    tensor maps of csrc/hopper.cuh (bf16 boxes of BOX_COLS columns, 4-d and,
    for decode's q, 3-d; fp32 boxes of 32), the 1-d boxes the flash backward
    asks for (STATS_BOX fp32 values) and the SSD backward's bulk copies of
    its prepared tiles."""
    hop = (CSRC / "hopper.cuh").read_text()
    consts = _source_ints(hop)
    consts.update(_source_ints((CSRC / "flash_attention_bwd.cu").read_text()))
    boxes = re.findall(r"const cuuint32_t box(?:es)?\[\d\] = \{(\w+|\(cuuint32_t\)box)", hop)
    kinds = re.findall(r"CU_TENSOR_MAP_DATA_TYPE_(\w+), \d", hop)
    assert len(boxes) == len(kinds) == 4
    size = {"BFLOAT16": 2, "FLOAT32": 4}
    for box, kind in zip(boxes, kinds):
        inner = consts["STATS_BOX"] if box == "(cuuint32_t)box" else int(consts.get(box, box))
        assert inner * size[kind] % 16 == 0, (box, kind)
    bwd = " ".join((CSRC / "ssd_scan_bwd.cu").read_text().split())
    assert "bulk_load(base + L::T0_OFF, src + 2 * OpTile<N, Q>::BYTES, T0::BYTES, tbar);" in bwd
    assert "bulk_load(base + L::BR_OFF, src + 2 * OpTile<N, Q>::BYTES + T0::BYTES, RB, tbar);" \
        in bwd
    assert "constexpr int RB = (N + 31) / 32 * RAW_BOX;" in bwd
    assert "bulk_load(base + L::T1_OFF, src + (W == B_WALK ? T1::BYTES : 0), T1::BYTES, tbar);" \
        in bwd
    for n in ssd_ops.D_STATES:
        for rows, k in ((n, ssd_ops.SUB_CHUNK), (ssd_ops.SUB_CHUNK, n)):
            assert op_tile_bytes(rows, k) % 16 == 0


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
