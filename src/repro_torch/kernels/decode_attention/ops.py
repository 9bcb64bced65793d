"""Wrapper of the decode-attention CUDA kernel (csrc/decode_attention.cu)."""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..build import load
from .ref import decode_attention_ref

LAUNCHES = [0]                 # kernel launches made by this wrapper
TARGET_BLOCKS_PER_SM = 2       # the KV range is split until the card is this full
MIN_ROWS_PER_SPLIT = 64
MAX_SPLITS = 32
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load().dco_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def n_splits_for(b: int, g: int, s: int, sm_count: int) -> int:
    """Pieces the KV range is cut into so that ``b * g * n_splits`` blocks
    fill the card, each piece at least ``MIN_ROWS_PER_SPLIT`` rows of the
    cache's capacity ``s``."""
    want = -(-TARGET_BLOCKS_PER_SM * sm_count // (b * g))
    return max(1, min(want, s // MIN_ROWS_PER_SPLIT, MAX_SPLITS))


def _check(q, k, v, cache_len):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, H, D) and k/v (B, S, G, D)")
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or cache_len.shape != (b,):
        raise ValueError("q, k/v and cache_len disagree on batch or head_dim")
    if h % k.shape[2]:
        raise ValueError("n_heads must be divisible by n_kv_heads")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor, *,
                     scale: Optional[float] = None,
                     n_splits: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D) single new token; k/v (B, S, G, D) KV cache, read in place
    through its strides (any S >= 1, no transposed copy); cache_len (B,)
    valid lengths, read on the device.  Returns (B, H, D).

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    computes the plain version."""
    _check(q, k, v, cache_len)
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, cache_len, scale=scale)
    b, h, d = q.shape
    _, s, g, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention kernel takes bf16 or fp32, one type "
                        f"for q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (64, 128):
        raise ValueError(f"decode_attention kernel takes head_dim 64 or 128, got {d}")
    if k.device != q.device or v.device != q.device or cache_len.device != q.device:
        raise ValueError("q, k, v and cache_len must lie on one device")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte vectors along "
                             "head_dim; it needs stride 1 there and 16-byte "
                             "aligned rows")
    lens = cache_len if cache_len.dtype == torch.int32 else cache_len.to(torch.int32)
    lens = lens.contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if n_splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_splits = n_splits_for(b, g, s, sms)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    scratch = torch.empty((b * h * n_splits * (d + 2),), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                       out.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype],
                       b, s, h, g, d, n_splits, float(scale), strides, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return out
