"""Wrappers of the flash-attention CUDA kernels: the forward
(csrc/flash_attention.cu) and, for training, its backward
(csrc/flash_attention_bwd.cu), tied together by ``FlashAttentionFn``.  Both
take causal attention at head_dim 64, 112, 128 and 256 with a sliding
window and a softcap; the forward also takes non-causal attention, which has
no backward kernel."""

from __future__ import annotations

import ctypes
import math
from typing import Optional
from typing import Tuple

import torch

from ...core.orchestrator import FLASH_Q_REG_DIM
from ...core.orchestrator import FLASH_TILE_ROWS
from ...core.orchestrator import H100_SMEM_PER_BLOCK
from ...core.orchestrator import flash_smem_bytes
from ..build import load
from .ref import attention_bwd_ref
from .ref import attention_ref

LAUNCHES = [0]                 # forward kernel launches made by this module
BWD_LAUNCHES = [0]             # backward kernel launches made by this module
BWD_KERNELS = 3                # kernels a dco_flash_attention_bwd call launches: delta, dK/dV, dQ
MAX_WARPS = 8                  # warps of a bf16 block (csrc/flash_attention.cu)
MAX_WARPS_Q_SMEM = 4           # warps of a bf16 block above FLASH_Q_REG_DIM (csrc)
HEAD_DIMS = (64, 112, 128, 256)   # head sizes the kernel is compiled for
BWD_HEAD_DIMS = (64, 112, 128, 256)   # head sizes the backward kernel is compiled for
BWD_FP32_TILE_256 = 32         # rows of the fp32 backward's tiles at head_dim 256 (fp32_tile in csrc)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the C interface dco_flash_attention: q, k, v, out, lse; dtype, B, Sq, Sk, H, G,
# D, tiles_per_chunk, pinned_rows, causal, window; scale, softcap; strides, stream
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
# dco_flash_attention_bwd: q, k, v, o, dout, lse, delta, dq, dk, dv; dtype, B, S,
# H, G, D, window; scale, softcap; stream
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                + [ctypes.c_void_p])
_fns = {}


def _kernel(name: str = "dco_flash_attention"):
    if name not in _fns:
        fn = getattr(load(), name)
        fn.argtypes = ARGTYPES if name == "dco_flash_attention" else BWD_ARGTYPES
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def max_warps(head_dim: int) -> int:
    """Warps of a bf16 block at most: ``MAX_WARPS``, or ``MAX_WARPS_Q_SMEM``
    above ``FLASH_Q_REG_DIM``, where Q's fragments are read from a buffer of
    that many warps' rows instead of held in registers."""
    return MAX_WARPS_Q_SMEM if head_dim > FLASH_Q_REG_DIM else MAX_WARPS


def q_tile_rows(group: int, itemsize: int, head_dim: int) -> int:
    """Query rows of the kernel's Q tile.  fp32: 64.  bf16: 16 a warp for
    each of the warps a head gets (4, 2 or 1) when every head of a pass
    (``group`` heads, in passes of at most ``max_warps(head_dim)``) has a
    warp of its own, as ``launch_mma`` in csrc/flash_attention.cu chooses
    them."""
    if itemsize != 2:
        return FLASH_TILE_ROWS
    most = max_warps(head_dim)
    passes = -(-group // most)
    heads = -(-group // passes)
    warps = 4
    while warps > 1 and heads * warps > most:
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


def bwd_tile_rows(head_dim: int, itemsize: int) -> int:
    """Rows of the backward kernel's Q and KV tiles: ``FLASH_TILE_ROWS``, or
    ``BWD_FP32_TILE_256`` in fp32 at head_dim 256, where four staged 64-row
    fp32 tiles pass a block's shared memory."""
    return BWD_FP32_TILE_256 if itemsize == 4 and head_dim > 128 else FLASH_TILE_ROWS


def bwd_q_tiles(kt: int, s: int, *, window: Optional[int] = None,
                tile: int = FLASH_TILE_ROWS) -> range:
    """The Q tiles that the backward's dK/dV block of KV tile ``kt`` walks
    (tiles of ``tile`` rows, length ``s``): from its own, the first at or
    below the causal diagonal, to the last that the ``window`` of the tile's
    last row reaches, as ``q_tile_end`` in csrc/flash_attention_bwd.cu."""
    n = -(-s // tile)
    end = min(n, (kt * tile + tile - 1 + window - 1) // tile + 1) if window else n
    return range(kt, end)


def bwd_kv_tiles(qt: int, *, window: Optional[int] = None,
                 tile: int = FLASH_TILE_ROWS) -> range:
    """The KV tiles that the backward's dQ block of Q tile ``qt`` walks: up
    to the diagonal, from the first that the tile's first row can see under
    a ``window``, as ``kv_tile_begin`` in csrc/flash_attention_bwd.cu."""
    lo = max(0, qt * tile - window + 1) // tile if window else 0
    return range(lo, qt + 1)


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


def check_backward(d: int, causal: bool, window: Optional[int],
                   softcap: Optional[float]) -> None:
    """Raise for attention whose gradient the backward kernel does not
    compute: ``NotImplementedError`` for non-causal attention (no training
    path runs it); ``ValueError`` for a head size outside ``BWD_HEAD_DIMS``,
    a window that is not a positive int or a softcap that is not positive.
    Causal attention with or without gemma2's window and softcap, at every
    head size of the forward, gemma-7b's 256 among them, goes through."""
    if not causal:
        raise NotImplementedError(
            "the flash-attention backward kernel does not compute the gradient of "
            "non-causal attention")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the backward kernel takes head_dim in {BWD_HEAD_DIMS}, got {d}")
    check_window(window, causal)
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")


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

    On a CPU tensor this computes the plain version, which autograd
    differentiates.  On a CUDA tensor it launches the kernel or raises; when
    autograd records the call (grad enabled and q, k or v requiring grad) it
    goes through ``FlashAttentionFn``, whose backward is the backward kernel
    with the same scale, window and softcap, and raises
    ``NotImplementedError`` before any launch for non-causal attention, which
    that kernel does not compute (``check_backward``)."""
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
    if needs_grad(q, k, v):
        check_backward(d, causal, window, softcap)
        return FlashAttentionFn.apply(q, k, v, scale, softcap, window, pinned_rows,
                                      tiles_per_chunk)
    return _forward(q, k, v, None, causal=causal, scale=scale, softcap=softcap,
                    window=window, pinned_rows=pinned_rows, tiles_per_chunk=tiles_per_chunk)


def _forward(q, k, v, lse: Optional[torch.Tensor], *, causal: bool, scale: float,
             softcap: Optional[float], window: Optional[int], pinned_rows: int,
             tiles_per_chunk: Optional[int]) -> torch.Tensor:
    """One launch of the forward kernel on checked inputs; it also writes
    ``lse`` (B, H, Sq) fp32 where one is given."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    if tiles_per_chunk is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        tiles_per_chunk = tiles_per_chunk_for(
            b, g, sq, sms, q_tile_rows(h // g, q.element_size(), d))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
        out.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       None if lse is None else lse.data_ptr(),
                       _DTYPES[q.dtype], b, sq, sk, h, g, d, tiles_per_chunk,
                       pinned_rows, int(causal), int(window or 0), float(scale),
                       float(softcap or 0.0), strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Causal flash attention with its gradient on the card: the forward
    kernel, also writing the per-row log-sum-exp of the scaled, capped and
    windowed scores, and the backward kernel from it with the same scale,
    softcap and window.  Built by ``flash_attention`` on checked inputs
    only."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, softcap: Optional[float],
                window: Optional[int], pinned_rows: int, tiles_per_chunk: Optional[int]):
        b, sq, h, _ = q.shape
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        out = _forward(q, k, v, lse, causal=True, scale=scale, softcap=softcap, window=window,
                       pinned_rows=pinned_rows, tiles_per_chunk=tiles_per_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.softcap, ctx.window = scale, softcap, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd hands dO over with any strides; the kernel reads it contiguous
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), scale=ctx.scale,
                                         softcap=ctx.softcap, window=ctx.window)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                        scale: Optional[float] = None,
                        softcap: Optional[float] = None,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal attention, with the ``softcap`` and sliding
    ``window`` of its forward, from the forward's output ``o`` and
    log-sum-exp ``lse`` (B, H, S) and the output's gradient ``do``.

    On a CUDA tensor this calls the backward kernel (``BWD_KERNELS``
    launches, each counted in ``BWD_LAUNCHES``) or raises; on a CPU tensor
    it computes the plain version ``attention_bwd_ref``.  Inputs are made
    contiguous (a no-op for those that are)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("expected q, o, do (B, S, H, D) and k/v (B, S, G, D)")
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % g or sq != sk:
        raise ValueError("q and k/v disagree on batch, length or head_dim, or "
                         "n_heads is no multiple of n_kv_heads")
    if lse.shape != (b, h, sq):
        raise ValueError(f"lse must be (B, H, S) = {(b, h, sq)}")
    check_window(window, True)
    if not q.is_cuda:
        return attention_bwd_ref(q, k, v, o, lse, do, scale=scale, softcap=softcap,
                                 window=window)
    check_backward(d, True, window, softcap)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError("the backward kernel takes bf16 or fp32, one type for q, k, v, "
                        "o and do")
    if lse.dtype != torch.float32:
        raise TypeError("lse must be fp32")
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError("the backward kernel's inputs must lie on one device")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("dco_flash_attention_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], b, sq, h, g, d, int(window or 0), float(scale),
            float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed (code {rc})")
    BWD_LAUNCHES[0] += BWD_KERNELS
    return dq, dk, dv
