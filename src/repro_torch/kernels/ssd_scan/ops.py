"""Wrapper of the SSD chunked-scan CUDA kernel (csrc/ssd_scan.cu)."""

from __future__ import annotations

import ctypes
from typing import Optional
from typing import Tuple

import torch

from ..build import load
from .ref import ssd_ref

LAUNCHES = [0]                 # kernel launches made by this wrapper
P_SLICE = 32                   # columns of P one block owns (csrc/ssd_scan.cu: PS)
SUB_CHUNK = 64                 # rows of the kernel's sub-chunk (csrc/ssd_scan.cu: Q)
D_STATES = (16, 32, 64, 128)   # state sizes N the kernel is compiled for
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load().dco_ssd_scan
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    computes the plain version."""
    _check(x, dt, A, B, C, chunk, initial_state)
    if not x.is_cuda:
        y, state = ssd_ref(x, dt, A, B, C, chunk, initial_state=initial_state)
        return y.to(x.dtype), state
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
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
    dt32 = dt.float()
    a32 = A.float().contiguous()
    init = initial_state.float().contiguous() if initial_state is not None else None
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2), dt32.stride(0), dt32.stride(1),
        dt32.stride(2), B.stride(0), B.stride(1), B.stride(2), C.stride(0), C.stride(1),
        C.stride(2))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(x.data_ptr(), dt32.data_ptr(), a32.data_ptr(), B.data_ptr(),
                       C.data_ptr(), init.data_ptr() if init is not None else None,
                       y.data_ptr(), state.data_ptr(), _DTYPES[x.dtype], b, s, h, g, p,
                       n, strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return y, state
