"""Wrapper of the flash-attention CUDA kernel (csrc/flash_attention.cu)."""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...core.orchestrator import FLASH_TILE_ROWS
from ...core.orchestrator import H100_SMEM_PER_BLOCK
from ...core.orchestrator import flash_smem_bytes
from ..build import load
from .ref import attention_ref

LAUNCHES = [0]                 # kernel launches made by this wrapper
MAX_WARPS = 8                  # warps of a bf16 block (csrc/flash_attention.cu)
HEAD_DIMS = (64, 112, 128)     # head sizes the kernel is compiled for
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the C interface dco_flash_attention: q, k, v, out; dtype, B, Sq, Sk, H, G, D,
# tiles_per_chunk, pinned_rows, causal, window; scale, softcap; strides, stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load().dco_flash_attention
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def q_tile_rows(group: int, itemsize: int) -> int:
    """Query rows of the kernel's Q tile.  fp32: 64.  bf16: 16 a warp for
    each of the warps a head gets (4, 2 or 1) when every head of a pass
    (``group`` heads, in passes of at most ``MAX_WARPS``) has a warp of its
    own, as ``launch_mma`` in csrc/flash_attention.cu chooses them."""
    if itemsize != 2:
        return FLASH_TILE_ROWS
    passes = -(-group // MAX_WARPS)
    heads = -(-group // passes)
    warps = 4
    while warps > 1 and heads * warps > MAX_WARPS:
        warps //= 2
    return 16 * warps


def tiles_per_chunk_for(b: int, g: int, sq: int, sm_count: int,
                        tile_rows: int = FLASH_TILE_ROWS) -> int:
    """Q tiles of ``tile_rows`` rows one block walks.  More tiles a block
    reuse the pinned prefix more often; fewer give more blocks.  Chosen so
    that about one block per SM exists when the shape allows it; the bf16
    kernel pairs each chunk's heavy causal tiles with light ones."""
    n_q_tiles = -(-sq // tile_rows)
    chunks = max(1, min(n_q_tiles, sm_count // (b * g)))
    return -(-n_q_tiles // chunks)


def kv_tiles(q_lo: int, q_rows: int, sk: int, *, causal: bool = True,
             window: Optional[int] = None) -> range:
    """The KV tiles (of ``FLASH_TILE_ROWS`` rows) that the kernel walks for
    the Q tile of rows ``[q_lo, q_lo + q_rows)``, in its order: up to the
    causal end, and from the first tile the tile's first row can see under a
    ``window`` (row r sees columns (r - window, r]), as ``first_kv_tile`` in
    csrc/flash_attention.cu."""
    end = min(sk, q_lo + q_rows) if causal else sk
    lo = max(0, q_lo - window + 1) // FLASH_TILE_ROWS if window else 0
    return range(lo, -(-end // FLASH_TILE_ROWS))


def check_window(window: Optional[int], causal: bool) -> None:
    """Raise unless ``window`` is None or a positive int, given with causal
    masking (a window counts back from each query's own position)."""
    if window is None:
        return
    if isinstance(window, bool) or not isinstance(window, int) or window <= 0:
        raise ValueError(f"window must be a positive int or None, got {window!r}")
    if not causal:
        raise ValueError("a sliding window needs causal masking")


def check_pinned_rows(pinned_rows: int, sk: int, head_dim: int, itemsize: int) -> None:
    """Raise unless ``pinned_rows`` is a prefix the kernel can keep resident."""
    if not 0 <= pinned_rows <= sk:
        raise ValueError(f"pinned_rows {pinned_rows} is not a prefix of {sk} KV rows")
    if pinned_rows != sk and pinned_rows % FLASH_TILE_ROWS:
        raise ValueError(f"pinned_rows must be the whole KV length or a multiple "
                         f"of the KV tile ({FLASH_TILE_ROWS} rows), got {pinned_rows}")
    need = flash_smem_bytes(pinned_rows, head_dim, itemsize)
    if need > H100_SMEM_PER_BLOCK:
        raise ValueError(f"pinned_rows {pinned_rows} needs {need} bytes of shared "
                         f"memory; a block may take {H100_SMEM_PER_BLOCK}")


def check_rows_aligned(name: str, t: torch.Tensor) -> None:
    """Raise unless the kernel can read ``t``'s rows along head_dim: stride
    1 there, and each row aligned to the kernel's copies.  bf16 is copied 16
    bytes a lane, so its data pointer must sit on 16 bytes and its other
    strides be multiples of 8 elements; fp32 is read in 4-byte words."""
    align = 16 if t.dtype == torch.bfloat16 else 4
    elems = align // t.element_size()
    if t.stride(-1) != 1 or any(st % elems for st in t.stride()[:-1]) \
            or t.data_ptr() % align:
        raise ValueError(f"{name}: the kernel reads {align}-byte pieces along "
                         f"head_dim; it needs stride 1 there and {align}-byte "
                         f"aligned rows (other strides multiples of {elems})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    pinned_rows: int = 0,
                    tiles_per_chunk: Optional[int] = None) -> torch.Tensor:
    """FlashAttention-2 forward with the DCO KV split.

    q (B, Sq, H, D); k/v (B, Sk, G, D), any lengths, read through their
    strides.  ``window`` (causal only) lets query row r see key rows
    (r - window, r]; tiles wholly older than a Q tile's window are not walked.  ``pinned_rows`` KV rows (the whole of Sk, or a multiple of the
    KV tile, from ``CacheOrchestrator.plan_kv_split``) stay in shared memory
    across a block's Q tiles and query heads; the rest stream per Q tile.
    It changes the schedule, not the result.

    On a CUDA tensor this launches the kernel or raises; on a CPU tensor it
    computes the plain version."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, Sq, H, D) and k/v (B, Sk, G, D)")
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if h % g:
        raise ValueError("n_heads must be divisible by n_kv_heads")
    if causal and sq != sk:
        raise ValueError("causal masking assumes aligned q/k sequences; "
                         "use decode_attention for cached decoding")
    check_window(window, causal)
    check_pinned_rows(pinned_rows, sk, d, q.element_size())
    if not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, scale=scale, softcap=softcap,
                             window=window)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes bf16 or fp32, one type for "
                        f"q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows_aligned(name, t)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if tiles_per_chunk is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        tiles_per_chunk = tiles_per_chunk_for(
            b, g, sq, sms, q_tile_rows(h // g, q.element_size()))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
        out.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       _DTYPES[q.dtype], b, sq, sk, h, g, d, tiles_per_chunk,
                       pinned_rows, int(causal), int(window or 0), float(scale),
                       float(softcap or 0.0), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return out
