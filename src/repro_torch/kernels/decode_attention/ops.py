"""Wrapper of the decode-attention CUDA kernel (csrc/decode_attention.cu)."""

from __future__ import annotations

import ctypes
import math
from typing import Dict
from typing import List
from typing import NamedTuple
from typing import Optional
from typing import Sequence
from typing import Tuple

import torch

from ..build import load
from ..flash_attention.ops import check_window
from .ref import decode_attention_ref

LAUNCHES = [0]                 # kernel launches made by this wrapper
STEP_ROWS = 32                 # rows a block scores a step (csrc: STEP_ROWS)
MAX_HPB = 4                    # query heads a block at most (csrc: MAX_HPB)
BLOCKS_PER_SM = 3              # blocks an SM can hold (csrc: BLOCKS_PER_SM)
MAX_UNITS = 1024               # units a sequence at most (csrc: MAX_UNITS)
MIN_ROWS = 128                 # the least R chosen per call (csrc: MIN_ROWS)
ITEMS_PER_SM = 2               # work items an SM a chosen R aims at (csrc: ITEMS_PER_SM)
MIN_COUNTERS = 1 << 16         # merge counters allocated at least, per stream
HEAD_DIMS = (64, 112, 128)     # head sizes the kernel is compiled for
LANES_PER_ROW = 8              # lanes that share a row's chunks (csrc: LANES_PER_ROW)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the C interface dco_decode_attention: q, k, v, cache_len, out, scratch,
# counters; dtype, B, S, H, G, D, hpb, rows, min_rows, target, blocks, window;
# scale, softcap; strides, stream
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
_fn = None
# merge counters of each (device, stream); zeroed once, when allocated
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_retired: List[torch.Tensor] = []   # outgrown counters: a captured graph may hold them


def _kernel():
    global _fn
    if _fn is None:
        fn = load().dco_decode_attention
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def heads_per_block(group: int) -> int:
    """Query heads of one KV head that share a block (each fetched K/V row
    serves all of them): the whole group up to ``MAX_HPB``, else the largest
    divisor of the group that fits."""
    if group <= MAX_HPB:
        return group
    return next(d for d in range(MAX_HPB, 0, -1) if group % d == 0)


def lane_chunks(d: int, itemsize: int) -> List[List[int]]:
    """The 16-byte chunks of a K/V row (and of q) that each of the
    ``LANES_PER_ROW`` lanes of a lane group copies and reads, as the kernel's
    ``Ring`` deals them: lane l owns chunks l, l + 8, ... of the row's
    ``d * itemsize / 16``.  At head_dim 112 the last chunk of a lane exists
    for some lanes only; every chunk of the row has exactly one owner."""
    row_chunks = d * itemsize // 16
    return [list(range(lane, row_chunks, LANES_PER_ROW)) for lane in range(LANES_PER_ROW)]


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


class DecodePlan(NamedTuple):
    """How the kernel cuts one call into work items.  The grid, scratch and
    counters follow from shapes alone (the host never reads ``cache_len``);
    the rows R of a unit are fixed by the caller or chosen on the device from
    the call's lengths (``rows_for``, as csrc's rows_for).  A sequence's live
    rows (the last ``window`` of its ``n``, or all ``n`` without a window)
    are cut evenly into ceil(live / R) units of a multiple of STEP_ROWS rows
    (at most R) of one (batch row, head block), each a work item; a 1-D grid
    of ``blocks`` blocks walks the items in order, block i taking items i,
    i + blocks, ..."""
    fixed_rows: int      # R given by the caller, or 0: chosen per call
    min_rows: int        # the least R
    capacity: int        # S: rows of the cache; cache_len is clamped to it
    units: int           # ceil(S / min_rows): units a (batch row, head block) at most
    hpb: int             # query heads a block
    head_blocks: int     # G * group / hpb
    batch: int
    blocks: int          # the grid: ITEMS_PER_SM an SM, or the most items there can be
    target: int          # work items a chosen R gives at most: ITEMS_PER_SM an SM
    scratch_floats: int  # partial (acc, m, l) of every unit: B * H * units * (D + 2)
    counters: int        # one merge counter a (batch row, head block)
    window: int = 0      # live rows a sequence at most, or 0: all of them

    def _clamp(self, length: int) -> int:
        return max(0, min(length, self.capacity))

    def first_live(self, length: int) -> int:
        """The first row of a sequence of ``length`` inside its query's
        window (csrc's first_live): no row below it is read."""
        n = self._clamp(length)
        return n - self.window if 0 < self.window < n else 0

    def _live(self, length: int) -> int:
        return self._clamp(length) - self.first_live(length)

    def rows_for(self, lengths: Sequence[int]) -> int:
        """R for a call at ``lengths``: the caller's, or the least multiple of
        STEP_ROWS (at least ``min_rows``, at most S rounded up) that gives at
        most ``target`` items for the call's live rows."""
        if self.fixed_rows:
            return self.fixed_rows
        whole = _round_up(self.capacity, STEP_ROWS)
        total = sum(self._live(n) for n in lengths)
        spare = self.target - self.head_blocks * self.batch
        r = whole
        if spare > 0:
            r = _round_up(-(-self.head_blocks * total // spare), STEP_ROWS)
        return max(min(r, whole), self.min_rows)

    def live_units(self, length: int, rows: int) -> int:
        """Units of ``rows`` rows that hold the live rows of ``length``."""
        return -(-self._live(length) // rows)

    def unit_rows(self, unit: int, length: int, rows: int) -> range:
        """The cache rows unit ``unit`` reads for a sequence of ``length``:
        its live rows cut evenly into ``live_units`` units of a multiple of
        STEP_ROWS rows."""
        n = self._clamp(length)
        even = _round_up(-(-self._live(length) // max(self.live_units(length, rows), 1)),
                         STEP_ROWS)
        start = self.first_live(length) + unit * even
        return range(start, max(start, min(n, start + even)))

    def merges(self, length: int, rows: int) -> bool:
        """Whether the last unit to finish merges partials (more than one
        live unit), rather than the one unit writing ``out`` itself."""
        return self.live_units(length, rows) > 1

    def items(self, lengths: Sequence[int]) -> List[Tuple[int, int, int]]:
        """(batch row, head block, unit) of every work item, in the kernel's
        order: a row with cache_len 0 has one item (it writes zeros)."""
        rows = self.rows_for(lengths)
        return [(b, hb, u) for b, n in enumerate(lengths)
                for hb in range(self.head_blocks)
                for u in range(max(self.live_units(n, rows), 1))]


def decode_plan(b: int, s: int, h: int, g: int, d: int,
                rows_per_split: Optional[int] = None, sm_count: int = 132,
                window: Optional[int] = None) -> DecodePlan:
    if rows_per_split is not None and (rows_per_split <= 0 or rows_per_split % STEP_ROWS):
        raise ValueError(f"rows_per_split must be a positive multiple of {STEP_ROWS}, "
                         f"got {rows_per_split}")
    min_rows = rows_per_split or max(MIN_ROWS, _round_up(-(-s // MAX_UNITS), STEP_ROWS))
    hpb = heads_per_block(h // g)
    units = -(-s // min_rows)
    if units > MAX_UNITS:
        raise ValueError(f"a cache of {s} rows is {units} units of {min_rows} rows; the "
                         f"kernel merges at most {MAX_UNITS}: raise rows_per_split")
    head_blocks = h // hpb
    return DecodePlan(fixed_rows=rows_per_split or 0, min_rows=min_rows, capacity=s,
                      units=units, hpb=hpb, head_blocks=head_blocks, batch=b,
                      blocks=min(b * head_blocks * units, ITEMS_PER_SM * sm_count),
                      target=ITEMS_PER_SM * sm_count,
                      scratch_floats=b * h * units * (d + 2), counters=b * head_blocks,
                      window=window or 0)


def _counter_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed ints for the merge counters of one (device, stream): the kernel
    sets each counter it used back to 0, so they are zeroed only here, once.
    Launches on one stream run one after another; a second stream gets a
    buffer of its own."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, MIN_COUNTERS), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check_options(window: Optional[int], softcap: Optional[float]) -> None:
    check_window(window, causal=True)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap!r}")


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
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     rows_per_split: Optional[int] = None) -> torch.Tensor:
    """q (B, H, D) single new token; k/v (B, S, G, D) KV cache, read in place
    through its strides (any S >= 1, no transposed copy); cache_len (B,)
    valid lengths, read on the device.  Returns (B, H, D).

    ``window``: only the last ``window`` rows below ``cache_len`` are live (the
    rows the query at position ``cache_len - 1`` sees); the others are never
    read.  ``softcap``: scaled scores s become ``tanh(s / softcap) * softcap``
    before the softmax.

    ``rows_per_split`` (a multiple of ``STEP_ROWS``) fixes the rows of one
    work unit, which the kernel otherwise chooses per call from ``cache_len``;
    it changes the schedule, not the result.  On a CUDA tensor this launches
    the kernel (one launch) or raises; on a CPU tensor it computes the plain
    version.  Each (device, stream) has merge counters of its own."""
    _check(q, k, v, cache_len)
    _check_options(window, softcap)
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, cache_len, scale=scale, window=window,
                                    softcap=softcap)
    b, h, d = q.shape
    _, s, g, _ = k.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention kernel takes bf16 or fp32, one type "
                        f"for q, k and v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if k.device != q.device or v.device != q.device or cache_len.device != q.device:
        raise ValueError("q, k, v and cache_len must lie on one device")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte vectors along "
                             "head_dim; it needs stride 1 there and 16-byte "
                             "aligned rows")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = decode_plan(b, s, h, g, d, rows_per_split, sms, window)
    lens = cache_len if cache_len.dtype == torch.int32 else cache_len.to(torch.int32)
    lens = lens.contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        counters = _counter_buffer(q.device, stream, plan.counters)
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                       out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
                       _DTYPES[q.dtype], b, s, h, g, d, plan.hpb, plan.fixed_rows,
                       plan.min_rows, plan.target, plan.blocks, plan.window, float(scale),
                       float(softcap or 0.0), strides, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {rc})")
    LAUNCHES[0] += 1
    return out
