"""Wrappers of the SSD chunked-scan CUDA kernels: the forward
(csrc/ssd_scan.cu) and, for training, its backward (csrc/ssd_scan_bwd.cu),
tied together by ``SSDScanFn``."""

from __future__ import annotations

import ctypes
from typing import Optional
from typing import Tuple

import torch

from ..build import load
from ..flash_attention.ops import needs_grad
from .ref import ssd_bwd_ref
from .ref import ssd_ref

LAUNCHES = [0]                 # forward kernel launches made by this module
BWD_LAUNCHES = [0]             # backward kernel launches made by this module
BWD_KERNELS = 6                # kernels a dco_ssd_scan_bwd call launches: the B and C
                               # tiles, the dC^h, dB^h and dx walks, the dcum scan, the
                               # head sums
P_SLICE = 32                   # columns of P one block owns (csrc/ssd_scan.cu: PS)
SUB_CHUNK = 64                 # rows of the kernel's sub-chunk (csrc/ssd_scan.cu: Q)
D_STATES = (16, 32, 64, 128)   # state sizes N the kernels are compiled for
BWD_HEAD_DIMS = (32, 64)       # head sizes P the backward kernel is compiled for
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# dco_ssd_scan: x, dt, A, B, C, init, y, final_state; dtype, B, S, H, G, P, N;
# strides, stream
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
# dco_ssd_scan_bwd: x, dt, A, B, C, init, dy, dfinal, dx, ddt, dA, dB, dC, dinit,
# dch, dbh, fdot, da_part, parts, prep; B, S, H, G, P, N; strides, stream
BWD_ARGTYPES = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
_fns = {}


def bwd_prep_bytes(n: int) -> int:
    """Bytes of the backward's prepared B and C tiles of one (batch, group,
    sub-chunk) (csrc/ssd_scan_bwd.cu: ``prep_bytes<N>()``): B^T and C^T,
    N rows of SUB_CHUNK values, and C, SUB_CHUNK rows of N values in boxes
    of 32, each as its TF32 hi and lo parts in 4-byte words; then B's rows,
    fp32 in the same boxes."""
    rows_by_k = n * 128 * (SUB_CHUNK // 32)
    boxes = SUB_CHUNK * 128 * -(-n // 32)
    return 2 * (2 * rows_by_k) + 2 * boxes + boxes


def _kernel(name: str = "dco_ssd_scan"):
    if name not in _fns:
        fn = getattr(load(), name)
        fn.argtypes = ARGTYPES if name == "dco_ssd_scan" else BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _strides(x, dt, B, C):
    """The C interface's 12 strides: batch, row and head of x and of dt,
    batch, row and group of B and of C."""
    return (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1), C.stride(2))


def _check(x, dt, A, B, C, chunk, initial_state) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError("expected x (B,S,H,P), dt (B,S,H), A (H,) and B/C (B,S,G,N)")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape[:2] != (b, s):
        raise ValueError("x, dt, A and B/C disagree on batch, length or heads")
    if h % g:
        raise ValueError("n_heads must be divisible by n_groups")
    if chunk <= 0 or s % chunk:
        raise ValueError(f"sequence must be chunk-aligned: length {s} is no multiple "
                         f"of chunk {chunk} (the reference's rule; the model takes "
                         "chunk = min(spec.chunk, S))")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"initial_state must be (B,H,P,N) = {(b, h, p, n)}")


def check_backward(dtype: torch.dtype, p: int, n: int) -> None:
    """Raise ``NotImplementedError`` for a scan whose gradient the backward
    kernel does not compute: it takes fp32 inputs (as ``mamba2_block``
    passes them), head_dim P in ``BWD_HEAD_DIMS`` and d_state N in
    ``D_STATES``."""
    why = []
    if dtype != torch.float32:
        why.append(f"{dtype} inputs (the kernel takes fp32, as mamba2_block passes them)")
    if p not in BWD_HEAD_DIMS:
        why.append(f"head_dim {p} (the kernel takes {BWD_HEAD_DIMS})")
    if n not in D_STATES:
        why.append(f"d_state {n} (the kernel takes {D_STATES})")
    if why:
        raise NotImplementedError("the SSD backward kernel does not compute the gradient "
                                  "of a scan with " + ", ".join(why))


def _check_kernel_inputs(x, dt, A, B, C, initial_state) -> None:
    """Raise for CUDA inputs the kernels do not take (beyond ``_check``)."""
    p, n = x.shape[3], B.shape[3]
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError("ssd_scan kernel takes bf16 or fp32, one type for x, B and C; "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if p % P_SLICE:
        raise ValueError(f"ssd_scan kernel takes head_dim a multiple of {P_SLICE}, got {p}")
    if n not in D_STATES:
        raise ValueError(f"ssd_scan kernel takes d_state in {D_STATES}, got {n}")
    tensors = (dt, A, B, C) + ((initial_state,) if initial_state is not None else ())
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B, C and initial_state must lie on one device")
    vec = 16 // x.element_size()
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel copies 16 bytes at a time; it needs "
                             "stride 1 along the last dimension and rows that start "
                             "on 16 bytes")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan.  x (B,S,H,P); dt (B,S,H); A (H,); B/C
    (B,S,G,N); ``initial_state`` (B,H,P,N) or zeros.  Returns (y (B,S,H,P)
    in x's type, final_state (B,H,P,N) fp32).

    ``chunk`` is the reference's contract (S must be a multiple of it); the
    kernel walks its own ``SUB_CHUNK``-row sub-chunks, which in exact arithmetic gives
    the same result.  x and B/C are read through their strides (head h reads
    group ``h // (H/G)``): no transposed or repeated copy is made; their rows
    must start on 16 bytes (the kernel stages them with 16-byte copies).

    On a CPU tensor this computes the plain version, which autograd
    differentiates.  On a CUDA tensor it launches the kernel or raises; when
    autograd records the call (grad enabled and an input requiring grad) it
    goes through ``SSDScanFn``, whose backward is the backward kernel, and
    raises ``NotImplementedError`` before any launch for what that kernel
    does not compute (``check_backward``)."""
    _check(x, dt, A, B, C, chunk, initial_state)
    if not x.is_cuda:
        y, state = ssd_ref(x, dt, A, B, C, chunk, initial_state=initial_state)
        return y.to(x.dtype), state
    _check_kernel_inputs(x, dt, A, B, C, initial_state)
    dt, A = dt.float(), A.float()
    init = initial_state.float() if initial_state is not None else None
    if needs_grad(x, dt, A, B, C, init):
        check_backward(x.dtype, x.shape[3], B.shape[3])
        return SSDScanFn.apply(x, dt, A, B, C, init)
    return _forward(x, dt, A, B, C, init)


def _forward(x, dt, A, B, C, init: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on checked inputs (dt, A and init
    fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    A = A.contiguous()
    init = init.contiguous() if init is not None else None
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                       C.data_ptr(), init.data_ptr() if init is not None else None,
                       y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], b, s, h, g, p,
                       n, _strides(x, dt, B, C), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return y, state


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with its gradient on the card: the forward kernel, then
    the backward kernel from the saved inputs (it recomputes the running
    state itself; the forward keeps none).  Built by ``ssd_scan`` on checked
    fp32 inputs only.  A gradient autograd hands over as None (y or the
    final state unused) counts as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        return _forward(x, dt, A, B, C, initial_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(x, dt, A, B, C, dy, dfinal,
                                                 initial_state=init)
        return dx, ddt, dA, dB, dC, dinit if init is not None else None


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None,
                 *, initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC, dinit) of the scan from the gradient ``dy``
    (B,S,H,P) of y and ``dfinal`` (B,H,P,N, or None for zero) of the final
    state, all fp32; dB and dC come out contiguous (B,S,G,N) whatever the
    strides of B and C.

    On a CUDA tensor this calls the backward kernel (``BWD_KERNELS``
    launches, each counted in ``BWD_LAUNCHES``) or raises; on a CPU tensor
    it computes the plain version ``ssd_bwd_ref``.  x, dt, B and C are read
    through their strides; dy, dfinal and the initial state are made
    contiguous (a no-op for those that are)."""
    b, s, h, p = x.shape
    n = B.shape[3]
    _check(x, dt, A, B, C, s, initial_state)
    if dy.shape != x.shape:
        raise ValueError(f"dy must be (B,S,H,P) = {tuple(x.shape)}")
    if dfinal is not None and dfinal.shape != (b, h, p, n):
        raise ValueError(f"dfinal must be (B,H,P,N) = {(b, h, p, n)}")
    if not x.is_cuda:
        return ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, initial_state)
    check_backward(x.dtype, p, n)
    opt = tuple(t for t in (dfinal, initial_state) if t is not None)
    if any(t.dtype != torch.float32 for t in (dt, A, B, C, dy) + opt):
        raise NotImplementedError("the SSD backward kernel takes fp32 throughout")
    _check_kernel_inputs(x, dt, A, B, C, initial_state)
    if any(t.device != x.device for t in (dy,) + opt):
        raise ValueError("the backward kernel's inputs must lie on one device")
    g = B.shape[2]
    dev = x.device
    A, dy = A.contiguous(), dy.contiguous()
    dfinal = dfinal.contiguous() if dfinal is not None else None
    init = initial_state.contiguous() if initial_state is not None else None
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, h, p), **f32)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, g, n), **f32)
    dC = torch.empty((b, s, g, n), **f32)
    dinit = torch.empty((b, h, p, n), **f32)
    dch = torch.empty((b, s, h, n), **f32)
    dbh = torch.empty((b, s, h, n), **f32)
    fdot = torch.empty((b, h), dtype=torch.float64, device=dev)
    da_part = torch.empty((b, h), dtype=torch.float64, device=dev)
    parts = torch.empty((6, b, h, s), dtype=torch.float64, device=dev)
    prep = torch.empty((b * g * -(-s // SUB_CHUNK) * bwd_prep_bytes(n),), dtype=torch.uint8,
                       device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("dco_ssd_scan_bwd")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            ptr(init), dy.data_ptr(), ptr(dfinal), dx.data_ptr(), ddt.data_ptr(),
            dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dinit.data_ptr(), dch.data_ptr(),
            dbh.data_ptr(), fdot.data_ptr(), da_part.data_ptr(), parts.data_ptr(),
            prep.data_ptr(), b, s, h, g, p, n,
            _strides(x, dt, B, C), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed (code {rc})")
    BWD_LAUNCHES[0] += BWD_KERNELS
    return dx, ddt, dA, dB, dC, dinit
