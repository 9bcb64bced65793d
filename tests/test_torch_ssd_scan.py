"""The port's SSD scan (wrapper on CPU tensors = its plain version) against
the JAX package's: the Pallas kernel in interpret mode, the chunked oracle
and the sequential recurrence, on the same numpy inputs.

Tolerances (rtol = atol) are the reference's own: 1e-4 for fp32, 3e-2 for
bf16 inputs.  The CUDA kernel itself is held to the plain version on the
card by ``chip_smoke.py``.

torch runs on one thread here: on the CPUs these tests were written on, the
first multithreaded float32 ``exp`` of a process now and then came out up
to 1e-4 off (a second identical call was exact), which is the size of the
fp32 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_ref as jax_ssd_ref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels import ssd_sequential_ref as jax_ssd_sequential_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
# the port
from repro_torch.kernels import kernels_built
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.kernels import ssd_ref
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan import ops as ssd_ops

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's SSD_CASES (tests/test_kernels.py)
SSD_CASES = [
    # (B, S, H, G, P, N, chunk, dtype)
    (1, 128, 2, 1, 64, 32, 32, "float32"),
    (2, 256, 4, 1, 32, 64, 64, "float32"),
    (1, 256, 4, 2, 64, 32, 64, "bfloat16"),
    (1, 512, 2, 1, 64, 128, 128, "float32"),
]


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


def inputs(seed, b, s, h, g, p, n, dtype="float32", init=False):
    """The reference's input recipe (dt = softplus(N(0,1)) * 0.1, A =
    -exp(U(-1,1))) drawn with numpy, as JAX arrays and as torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, p)),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.1,
            -np.exp(rng.uniform(-1.0, 1.0, h)),
            rng.standard_normal((b, s, g, n)),
            rng.standard_normal((b, s, g, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    types = [dtype, "float32", "float32", dtype, dtype]
    jax_in = [jnp.asarray(a, JDT[t]) for a, t in zip(arrs, types)]
    torch_in = [torch.from_numpy(a).to(TDT[t]) for a, t in zip(arrs, types)]
    state = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    return jax_in, torch_in, state


def ssd_sequential_ref(x, dt, A, B, C, initial_state=None):
    """O(S) sequential recurrence in fp32: ground truth for the chunked
    algorithm and the wrapper."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    Bh = B.float().repeat_interleave(h // g, dim=2)
    Ch = C.float().repeat_interleave(h // g, dim=2)
    x, dt, A = x.float(), dt.float(), A.float()
    state = (initial_state.float().clone() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32))
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A)                                   # (b,h)
        upd = torch.einsum("bhp,bhn->bhpn", x[:, t] * dt[:, t, :, None], Bh[:, t])
        state = state * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("b,s,h,g,p,n,chunk,dtype", SSD_CASES)
def test_ssd_scan_matches_jax_pallas(b, s, h, g, p, n, chunk, dtype):
    jin, tin, _ = inputs(5, b, s, h, g, p, n, dtype)
    y, state = ssd_scan(*tin, chunk=chunk)
    assert y.dtype == TDT[dtype] and state.dtype == torch.float32
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    tol = TOL[dtype]
    jy, jstate = jax_ssd_scan(*jin, chunk=chunk, interpret=True)
    np.testing.assert_allclose(f32(y), f32(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(state), f32(jstate), rtol=tol, atol=tol)
    ry, rstate = jax_ssd_ref(*jin, chunk)
    np.testing.assert_allclose(f32(y), f32(ry), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(state), f32(rstate), rtol=tol, atol=tol)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_initial_state_matches_jax_chunked(g):
    jin, tin, init = inputs(6, 2, 96, 4, g, 32, 16, init=True)
    y, state = ssd_scan(*tin, chunk=32, initial_state=torch.from_numpy(init))
    jy, jstate = jax_ssd_chunked(*jin, 32, initial_state=jnp.asarray(init))
    np.testing.assert_allclose(f32(y), f32(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(state), f32(jstate), rtol=1e-4, atol=1e-4)
    # and against the recurrence started from the same state
    sy, sstate = ssd_sequential_ref(*tin, initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(f32(y), f32(sy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(state), f32(sstate), rtol=1e-4, atol=1e-4)


def test_ssd_chunked_matches_sequential():
    """The port of the reference's test of the same name: chunked SSD (the
    model path's oracle) against the O(S) recurrence, and both against
    their JAX twins."""
    jin, tin, _ = inputs(7, 2, 128, 2, 1, 32, 16)
    y_c, st_c = ssd_ref(*tin, chunk=32)
    y_s, st_s = ssd_sequential_ref(*tin)
    np.testing.assert_allclose(f32(y_c), f32(y_s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(st_c), f32(st_s), rtol=1e-4, atol=1e-4)
    jy_s, jst_s = jax_ssd_sequential_ref(*jin)
    np.testing.assert_allclose(f32(y_s), f32(jy_s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f32(st_s), f32(jst_s), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [16, 32, 96])
def test_result_does_not_depend_on_the_chunk(chunk):
    """In exact arithmetic the chunk is a schedule parameter (which is why the
    kernel may walk its own sub-chunks); in fp32 the results agree to 1e-4."""
    _, tin, init = inputs(8, 1, 96, 4, 2, 32, 16, init=True)
    base = ssd_ref(*tin, chunk=96, initial_state=torch.from_numpy(init))
    other = ssd_ref(*tin, chunk=chunk, initial_state=torch.from_numpy(init))
    for a, b in zip(base, other):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-4, atol=1e-4)


def test_ssd_scan_reads_strided_views():
    """B and C as column ranges of one (B, S, 2GN) tensor and x as a slice of
    a wider one, as mamba2_block hands them over."""
    rng = np.random.default_rng(9)
    b, s, h, g, p, n = 2, 64, 4, 2, 32, 16
    wide = torch.from_numpy(rng.standard_normal((b, s, h, 2 * p)).astype(np.float32))
    bc = torch.from_numpy(rng.standard_normal((b, s, 2 * g * n)).astype(np.float32))
    _, (_, dt, A, _, _), _ = inputs(9, b, s, h, g, p, n)
    x, B, C = wide[..., p:], bc[..., :g * n].view(b, s, g, n), bc[..., g * n:].view(b, s, g, n)
    assert not x.is_contiguous() and not B.is_contiguous()
    got = ssd_scan(x, dt, A, B, C, chunk=32)
    want = ssd_ref(x.contiguous(), dt, A, B.contiguous(), C.contiguous(), 32)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_ssd_scan_rejects_what_the_reference_rejects():
    _, (x, dt, A, B, C), _ = inputs(10, 1, 40, 4, 1, 32, 16)
    with pytest.raises(ValueError, match="chunk-aligned.*40.*chunk 32"):
        ssd_scan(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="n_groups"):
        ssd_scan(x, dt, A, B[:, :, [0, 0, 0]], C[:, :, [0, 0, 0]], chunk=40)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, A, B, C, chunk=40, initial_state=torch.zeros(1, 4, 32, 8))
    with pytest.raises(ValueError, match="disagree"):
        ssd_scan(x, dt[:, :20], A, B, C, chunk=20)


def test_cpu_calls_launch_nothing():
    reset_launch_counts()
    _, tin, _ = inputs(11, 1, 32, 2, 1, 32, 16)
    ssd_scan(*tin, chunk=32)
    assert launch_counts()["ssd_scan"] == 0
    assert ssd_ops.LAUNCHES == [0]
    assert not kernels_built()


def test_wrapper_limits_match_the_kernel_source():
    """The wrapper's view of what the kernel takes matches csrc/ssd_scan.cu."""
    from repro_torch.kernels import build
    src = next(p for p in build.sources() if p.name == "ssd_scan.cu").read_text()
    assert f"constexpr int PS = {ssd_ops.P_SLICE};" in src
    assert f"constexpr int Q = {ssd_ops.SUB_CHUNK};" in src
    for n in ssd_ops.D_STATES:
        assert f"case {n}:" in src


# --- the kernel's arithmetic: 3xTF32 tensor-core products (csrc/ssd_scan.cu) ---

def tf32(x):
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, on the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    """a @ b from TF32 parts, a = hi + lo with hi = tf32(a), lo = tf32(a - hi):
    lo hi' + hi lo' + hi hi', fp32 sums (the lo lo' term is dropped)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_1xtf32(a, b):
    return tf32(a) @ tf32(b)


def ssd_as_the_kernel(x, dt, A, B, C, mm, q=64):
    """The kernel's schedule in torch: 64-row sub-chunks, the running state
    carried from one to the next, the four products through ``mm``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xs = x.float().permute(0, 2, 1, 3)                                 # (b,h,s,p)
    dts = dt.float().permute(0, 2, 1)                                  # (b,h,s)
    Bs = B.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)   # (b,h,s,n)
    Cs = C.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    state = torch.zeros((b, h, p, n))
    ys = []
    for c0 in range(0, s, q):
        xc, dc = xs[:, :, c0:c0 + q], dts[:, :, c0:c0 + q]
        Bc, Cc = Bs[:, :, c0:c0 + q], Cs[:, :, c0:c0 + q]
        cum = torch.cumsum(dc * A.float()[None, :, None], dim=-1)     # (b,h,q)
        total = cum[..., -1:]
        rows = cum.shape[-1]
        mask = torch.ones((rows, rows), dtype=torch.bool).tril()
        L = torch.where(mask, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        torch.tensor(0.0))
        scores = mm(Cc, Bc.transpose(-1, -2)) * L
        xdt = xc * dc[..., None]
        y = mm(scores, xdt) + torch.exp(cum)[..., None] * mm(Cc, state.transpose(-1, -2))
        xw = xdt * torch.exp(total - cum)[..., None]
        state = state * torch.exp(total)[..., None] + mm(xw.transpose(-1, -2), Bc)
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), state


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 3.0e-3, -7.25], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10)], dtype=torch.float32)
    assert torch.equal(tf32(x)[:5], want)          # ties away from zero
    for v in tf32(x):
        assert int(v.view(torch.int32)) & 0x1FFF == 0
    r = torch.from_numpy(np.random.default_rng(13).standard_normal(4096).astype(np.float32))
    assert float(((r - tf32(r)) / r).abs().max()) <= 2 ** -11
    hi = tf32(r)
    assert float(((r - hi - tf32(r - hi)) / r).abs().max()) <= 2 ** -21


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_3xtf32_products_meet_the_reference_tolerance(dtype):
    """The kernel's arithmetic (3xTF32 products at its 64-row sub-chunks) at
    a reduced serving shape, against the JAX package's chunked oracle at the
    reference's unchanged tolerance; plain TF32 does not meet it in fp32."""
    b, s, h, g, p, n = 1, 256, 4, 1, 64, 128
    jin, tin, _ = inputs(14, b, s, h, g, p, n, dtype)
    ry, rstate = jax_ssd_ref(*jin, 256)
    y, state = ssd_as_the_kernel(*tin, mm_3xtf32)
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(y), f32(ry), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(state), f32(rstate), rtol=TOL["float32"],
                               atol=TOL["float32"])
    if dtype == "float32":
        y1, state1 = ssd_as_the_kernel(*tin, mm_1xtf32)
        err = max(float(np.abs(f32(y1) - f32(ry)).max()),
                  float(np.abs(f32(state1) - f32(rstate)).max()))
        assert err > TOL["float32"]


def test_3xtf32_products_at_zamba2s_state_size():
    """zamba2-7b's SSD shape (P 64, N 64, one group; heads reduced from 112)
    through the kernel's 3xTF32 arithmetic, against the JAX package's
    chunked oracle at the reference's fp32 tolerance."""
    b, s, h, g, p, n = 1, 256, 4, 1, 64, 64
    jin, tin, _ = inputs(15, b, s, h, g, p, n, "float32")
    ry, rstate = jax_ssd_ref(*jin, 256)
    y, state = ssd_as_the_kernel(*tin, mm_3xtf32)
    np.testing.assert_allclose(f32(y), f32(ry), rtol=TOL["float32"], atol=TOL["float32"])
    np.testing.assert_allclose(f32(state), f32(rstate), rtol=TOL["float32"],
                               atol=TOL["float32"])
    assert n in ssd_ops.D_STATES and p % ssd_ops.P_SLICE == 0
