"""Wrappers of the decode-attention CUDA kernels: ``decode_attention`` over a
whole cache (csrc/decode_attention.cu), and ``decode_attention_lse`` over one
rank's slice of a sequence-sharded cache, which also gives each row's
log-sum-exp for the merge across ranks (``sharding.comm.merge_attention``;
csrc/decode_attention_lse.cu, the same bodies compiled as the slice's).

bf16 runs the TMA + ``wgmma`` kernel: a GQA group's query heads are the rows
of one 64-row product tile, and the C blocks of a (batch row, KV head)
(``WgmmaPlan``) cut its live 64-row tiles and merge their partials as one
thread-block cluster.  fp32 runs the FMA kernel with its per-call R
(``DecodePlan``)."""

from __future__ import annotations

import ctypes
import math
from typing import Callable
from typing import Dict
from typing import List
from typing import NamedTuple
from typing import Optional
from typing import Sequence
from typing import Tuple

import torch

from ..build import load
from ..flash_attention.ops import check_window
from ..flash_attention.ops import needs_grad
from .ref import decode_attention_lse_ref
from .ref import decode_attention_ref

LAUNCHES = [0]                 # kernel launches made by decode_attention
LSE_LAUNCHES = [0]             # kernel launches made by decode_attention_lse
TILE_ROWS = 64                 # bf16: cache rows of a K/V tile (csrc: W_TILE)
MAX_GROUP = 64                 # bf16: query heads a KV head at most (csrc: W_MAX_GROUP)
MAX_UNITS_A_HEAD = 8           # bf16: blocks of a (batch row, KV head) (csrc: W_MAX_UNITS)
MIN_UNIT_TILES = 2             # bf16: tiles a unit at least, cut by the kernel (csrc: W_MIN_UNIT_TILES)
SMALL_GROUP = 8                # bf16: groups up to this stage q in 8 rows (csrc: W_SMALL_GROUP)
UNIT_TILES_AT_MOST = 8         # bf16: tiles a block of a sequence as long as the cache, at most
STEP_ROWS = 32                 # fp32: rows a block scores a step (csrc: STEP_ROWS)
MAX_HPB = 4                    # fp32: query heads a block at most (csrc: MAX_HPB)
MAX_HPB_WIDE = 1               # ... above head_dim 128 (csrc: MAX_HPB_WIDE)
BLOCKS_PER_SM = 3              # blocks an SM can hold (csrc: BLOCKS_PER_SM)
MAX_UNITS = 1024               # units a sequence at most (csrc: MAX_UNITS)
MIN_ROWS = 128                 # the least R chosen per call (csrc: MIN_ROWS)
ITEMS_PER_SM = 2               # work items an SM a chosen R aims at (csrc: ITEMS_PER_SM)
MIN_COUNTERS = 1 << 16         # merge counters allocated at least, per stream
HEAD_DIMS = (64, 112, 128, 256)   # head sizes the kernel is compiled for
LANES_PER_ROW = 8              # lanes that share a row's chunks (csrc: LANES_PER_ROW)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the C interface dco_decode_attention: q, k, v, cache_len, out, scratch,
# counters; dtype, B, S, H, G, D, hpb, rows, min_rows, target, blocks, units,
# window; scale, softcap; strides, stream
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 13
            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
# dco_decode_attention_lse: q, k, v, cache_len, out, lse, scratch, counters;
# dtype, B, S, H, G, D, hpb, rows, min_rows, target, blocks, units, window,
# row_offset; scale, softcap; strides, stream
LSE_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 14
                + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
_fns: Dict[str, object] = {}
# clusters of 1 .. MAX_UNITS_A_HEAD blocks the card runs at once, by
# (device index, head size, group of at most SMALL_GROUP)
_rooms: Dict[Tuple[Optional[int], int, bool], List[int]] = {}
# merge counters of each (device, stream); zeroed once, when allocated
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_retired: List[torch.Tensor] = []   # outgrown counters: a captured graph may hold them


def _kernel(name: str = "dco_decode_attention", argtypes=ARGTYPES):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def heads_per_block(group: int, head_dim: int) -> int:
    """Query heads of one KV head that share a block (each fetched K/V row
    serves all of them): the whole group up to the kernel's cap, else the
    largest divisor of the group that fits.  The cap is ``MAX_HPB``, and
    ``MAX_HPB_WIDE`` (one) above head_dim 128, where a lane's q and
    accumulator take 32 + 32 floats a head (csrc's max_hpb)."""
    cap = MAX_HPB_WIDE if head_dim > 128 else MAX_HPB
    if group <= cap:
        return group
    return next(d for d in range(cap, 0, -1) if group % d == 0)


def lane_chunks(d: int, itemsize: int) -> List[List[int]]:
    """The 16-byte chunks of a K/V row (and of q) that each of the
    ``LANES_PER_ROW`` lanes of a lane group copies and reads, as the kernel's
    ``Ring`` deals them: lane l owns chunks l, l + 8, ... of the row's
    ``d * itemsize / 16``.  At head_dim 112 the last chunk of a lane exists
    for some lanes only; at 256 every lane owns 4 (bf16) or 8 (fp32); every
    chunk of the row has exactly one owner."""
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
    row_offset: Optional[int] = None   # a slice's first whole row, or None: a whole cache

    def span(self, length: int) -> Tuple[int, int]:
        """(first live row, end) of a sequence of ``length`` on this cache's
        rows (csrc's live_rows): no row outside them is read; (0, 0) where
        none is live."""
        if self.row_offset is None:
            n = max(0, min(length, self.capacity))
            return (n - self.window if 0 < self.window < n else 0), n
        n = max(length, 0)
        end = min(max(n - self.row_offset, 0), self.capacity)
        first = (n - self.window if 0 < self.window < n else 0) - self.row_offset
        return (0, 0) if first >= end else (max(first, 0), end)

    def first_live(self, length: int) -> int:
        """The first row of a sequence of ``length`` inside its query's
        window (csrc's first_live): no row below it is read."""
        return self.span(length)[0]

    def _live(self, length: int) -> int:
        lo, end = self.span(length)
        return end - lo

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
        lo, n = self.span(length)
        even = _round_up(-(-self._live(length) // max(self.live_units(length, rows), 1)),
                         STEP_ROWS)
        start = lo + unit * even
        return range(start, max(start, min(n, start + even)))

    def merges(self, length: int, rows: int) -> bool:
        """Whether the last unit to finish merges partials (more than one
        live unit), rather than the one unit writing ``out`` itself."""
        return self.live_units(length, rows) > 1

    def items(self, lengths: Sequence[int]) -> List[Tuple[int, int, int]]:
        """(batch row, head block, unit) of every work item, in the kernel's
        order: a row with cache_len 0 has one item (it writes zeros).

    With ``row_offset`` set (``decode_attention_lse``) the cache is a slice:
    its S rows are whole rows [row_offset, row_offset + S), a length counts
    whole rows and the window counts back from it, and only the slice's
    live rows count (none where the window ends below the slice or the
    length before it)."""
        rows = self.rows_for(lengths)
        return [(b, hb, u) for b, n in enumerate(lengths)
                for hb in range(self.head_blocks)
                for u in range(max(self.live_units(n, rows), 1))]


def decode_plan(b: int, s: int, h: int, g: int, d: int,
                rows_per_split: Optional[int] = None, sm_count: int = 132,
                window: Optional[int] = None, row_offset: Optional[int] = None) -> DecodePlan:
    if rows_per_split is not None and (rows_per_split <= 0 or rows_per_split % STEP_ROWS):
        raise ValueError(f"rows_per_split must be a positive multiple of {STEP_ROWS}, "
                         f"got {rows_per_split}")
    min_rows = rows_per_split or max(MIN_ROWS, _round_up(-(-s // MAX_UNITS), STEP_ROWS))
    hpb = heads_per_block(h // g, d)
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
                      window=window or 0, row_offset=row_offset)


def bf16_blocks_per_sm(d: int) -> int:
    """Blocks of the bf16 kernel an SM holds (csrc's w_blocks_per_sm)."""
    return 1 if d > 128 else 3


def units_for(b: int, g: int, s: int, cluster_room: Callable[[int], int],
              window: int = 0) -> int:
    """C, the blocks of one (batch row, KV head) in the bf16 kernel (its
    thread-block cluster): the most, up to MAX_UNITS_A_HEAD, whose B * G
    clusters the card runs at once (``cluster_room(C)``: clusters of C
    blocks that fit at once), but at least 2, and at least enough that a
    sequence as long as the cache (or the window) holds gives no block more
    than UNIT_TILES_AT_MOST tiles; no more than such a sequence can give
    work (MIN_UNIT_TILES tiles a block).  From shapes alone: the host never
    reads ``cache_len``; the kernel cuts each call's rows on the card."""
    wave = max([c for c in range(2, MAX_UNITS_A_HEAD + 1) if b * g <= cluster_room(c)],
               default=2)
    tiles = -(-min(s, window or s) // TILE_ROWS)
    units = max(wave, min(MAX_UNITS_A_HEAD, -(-tiles // UNIT_TILES_AT_MOST)))
    return max(1, min(units, -(-tiles // MIN_UNIT_TILES)))


def estimated_room(d: int, sm_count: int = 132) -> Callable[[int], int]:
    """Clusters of C blocks a card of ``sm_count`` SMs holds at once if they
    packed its SMs perfectly: the plan's default where no card is asked
    (on the card the wrapper asks it, ``dco_decode_clusters``)."""
    return lambda c: bf16_blocks_per_sm(d) * sm_count // c


class WgmmaPlan(NamedTuple):
    """How the bf16 kernel cuts one call: grid (units, G, B), the ``units``
    blocks of a (batch row, KV head) reading its live rows in tiles of
    TILE_ROWS rows from the first live one.  The live tiles are cut into
    units of ``per`` tiles: by default as csrc's span_of, from the call's
    lengths (``unit_tiles``: the least R, at least MIN_UNIT_TILES, that
    keeps the call's blocks with rows within ``target``; ceil(tiles / R)
    units, at most ``units``, cutting them evenly: one unit a block at
    most); with ``rows`` (``rows_per_split`` rounded up to whole tiles)
    units of rows / TILE_ROWS tiles, block r taking units r, r + units, ...
    Blocks with tiles (``active``) merge their partials in block order; one
    alone writes the output.  The window and a slice's row offset are as
    ``DecodePlan``'s."""
    units: int           # C: blocks a (batch row, KV head), the cluster's size
    rows: int            # rows a unit, a multiple of TILE_ROWS, or 0: cut per call
    group: int           # query heads a KV head: rows of the packed tile
    capacity: int        # S: rows of the cache; cache_len is clamped to it
    batch: int
    kv_heads: int
    target: int          # blocks with rows a call at most, where the kernel cuts
    window: int = 0
    row_offset: Optional[int] = None

    def span(self, length: int) -> Tuple[int, int]:
        """(first live row, end) of a sequence of ``length`` on this cache's
        rows, as ``DecodePlan.span``."""
        return DecodePlan.span(self, length)

    def tiles(self, length: int) -> int:
        lo, end = self.span(length)
        return -(-(end - lo) // TILE_ROWS)

    def unit_tiles(self, lengths: Sequence[int]) -> int:
        """R, the least tiles of a unit the kernel cuts for a call at
        ``lengths`` (csrc's span_of)."""
        total = sum(self.tiles(n) for n in lengths)
        live = sum(self.tiles(n) > 0 for n in lengths)
        spare = max(self.target - live * self.kv_heads, 1)
        return max(MIN_UNIT_TILES, -(-self.kv_heads * total // spare))

    def cut(self, length: int, lengths: Sequence[int]) -> Tuple[int, int, int]:
        """(tiles, tiles a unit, units) of a sequence of ``length`` in a call
        at ``lengths``."""
        tiles = self.tiles(length)
        if self.rows:
            per = self.rows // TILE_ROWS
        else:
            units = min(self.units, -(-tiles // self.unit_tiles(lengths)))
            per = -(-tiles // units) if units else 1
        return tiles, per, -(-tiles // per)

    def active(self, length: int, lengths: Sequence[int]) -> int:
        """Blocks of the (batch row, KV head) that hold rows."""
        return min(self.units, self.cut(length, lengths)[2])

    def block_tiles(self, rank: int, length: int, lengths: Sequence[int]) -> List[int]:
        """The tiles block ``rank`` reads, in its order: units rank,
        rank + units, ..."""
        tiles, per, n_units = self.cut(length, lengths)
        return [t for u in range(rank, n_units, self.units)
                for t in range(u * per, min(tiles, (u + 1) * per))]

    def tile_rows(self, tile: int, length: int) -> range:
        """The live cache rows of ``tile``; its box reads TILE_ROWS rows
        from the first, the rest past the end masked (and zeroed in V)."""
        lo, end = self.span(length)
        return range(lo + tile * TILE_ROWS, min(end, lo + (tile + 1) * TILE_ROWS))


def wgmma_plan(b: int, s: int, h: int, g: int, d: int,
               rows_per_split: Optional[int] = None, sm_count: int = 132,
               window: Optional[int] = None, row_offset: Optional[int] = None,
               cluster_room: Optional[Callable[[int], int]] = None) -> WgmmaPlan:
    """The bf16 kernel's plan; raises where the group exceeds the packed
    tile's MAX_GROUP rows (before any launch).  ``cluster_room`` (see
    ``units_for``) defaults to ``estimated_room(d, sm_count)``; the target
    is the blocks of one-block clusters the card holds at once."""
    if rows_per_split is not None and (rows_per_split <= 0 or rows_per_split % STEP_ROWS):
        raise ValueError(f"rows_per_split must be a positive multiple of {STEP_ROWS}, "
                         f"got {rows_per_split}")
    group = h // g
    if group > MAX_GROUP:
        raise ValueError(f"the bf16 decode kernel packs at most {MAX_GROUP} query heads a "
                         f"KV head into its product tile's rows, got {group}")
    room = cluster_room or estimated_room(d, sm_count)
    return WgmmaPlan(units=units_for(b, g, s, room, window or 0),
                     rows=_round_up(rows_per_split, TILE_ROWS) if rows_per_split else 0,
                     group=group, capacity=s, batch=b, kv_heads=g, target=room(1),
                     window=window or 0, row_offset=row_offset)


def _cluster_room(device: torch.device, d: int, group: int) -> Callable[[int], int]:
    """Clusters of C blocks of the bf16 kernel that ``device`` runs at once,
    asked of the card once for each (device, head size, staged q's rows)."""
    key = (device.index, d, group <= SMALL_GROUP)
    room = _rooms.get(key)
    if room is None:
        fn = _kernel("dco_decode_clusters", [ctypes.c_int] * 3)
        with torch.cuda.device(device):
            room = [fn(d, group, c) for c in range(1, MAX_UNITS_A_HEAD + 1)]
        if min(room) < 1:
            raise RuntimeError(f"the card could not size the decode kernel's clusters: {room}")
        _rooms[key] = room
    return lambda c: room[c - 1]


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
    if k.shape[1] < 1:
        raise ValueError("the cache needs at least one row")


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
    work unit, which the kernels otherwise cut: bf16 rounds it up to whole
    64-row tiles (``WgmmaPlan``), fp32 takes it as its R instead of one
    chosen per call from ``cache_len`` (``DecodePlan``); it changes the
    schedule, not the result.  On a CUDA tensor this launches the kernel
    (one launch) or raises: bf16 takes at most ``MAX_GROUP`` query heads a
    KV head; on a CPU tensor it computes the plain version.  Each (device,
    stream) has the fp32 kernel's merge counters of its own.  The kernel has
    no backward: on the card a call that autograd would record raises
    ``NotImplementedError`` rather than give a detached result."""
    _check(q, k, v, cache_len)
    _check_options(window, softcap)
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, cache_len, scale=scale, window=window,
                                    softcap=softcap)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, cache_len, out, None, None, scale, window, softcap, rows_per_split)
    LAUNCHES[0] += 1
    return out


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *, row_offset: int = 0,
                         scale: Optional[float] = None,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         rows_per_split: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``decode_attention`` on one rank's slice of a sequence-sharded cache:
    k/v (B, S, G, D) hold whole rows [row_offset, row_offset + S), and
    cache_len (B,) counts whole rows, so that the slice attends exactly the
    rows of it that the whole cache's query at ``cache_len - 1`` sees (a
    window counts back from the whole length).  Returns the fp32 output
    (B, H, D) over the slice's live rows and each row's log-sum-exp (B, H),
    the natural log of the sum of exp(scaled, capped score) over them; a row
    with none gives zeros and ``-inf``.  ``sharding.comm.merge_attention``
    merges the slices' pairs into the whole cache's output.  One launch on
    a CUDA tensor (or a raise), the plain version on a CPU tensor, as
    ``decode_attention``."""
    _check(q, k, v, cache_len)
    _check_options(window, softcap)
    if isinstance(row_offset, bool) or not isinstance(row_offset, int) or row_offset < 0:
        raise ValueError(f"row_offset must be a non-negative int, got {row_offset!r}")
    if not q.is_cuda:
        return decode_attention_lse_ref(q, k, v, cache_len, row_offset=row_offset, scale=scale,
                                        window=window, softcap=softcap)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(q, k, v, cache_len, out, lse, row_offset, scale, window, softcap, rows_per_split)
    LSE_LAUNCHES[0] += 1
    return out, lse


def _launch(q, k, v, cache_len, out, lse, row_offset, scale, window, softcap,
            rows_per_split) -> None:
    """The card's checks and one launch of the serving kernel (``lse`` None)
    or of the slice's (``lse`` and ``row_offset`` given)."""
    if needs_grad(q, k, v):
        raise NotImplementedError(
            "decode_attention has no backward kernel: decoding is not differentiated "
            "on the card (call it under torch.no_grad())")
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
    lens = cache_len if cache_len.dtype == torch.int32 else cache_len.to(torch.int32)
    lens = lens.contiguous()
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    if q.dtype == torch.bfloat16:
        wplan = wgmma_plan(b, s, h, g, d, rows_per_split, sms, window, row_offset,
                           _cluster_room(q.device, d, h // g))
        scratch = None    # the blocks merge in their cluster: no scratch, no counters
        shape = (0, b, s, h, g, d, h // g, wplan.rows, 0, wplan.target, 0, wplan.units,
                 wplan.window)
    else:
        plan = decode_plan(b, s, h, g, d, rows_per_split, sms, window, row_offset)
        scratch = torch.empty((plan.scratch_floats,), dtype=torch.float32, device=q.device)
        shape = (1, b, s, h, g, d, plan.hpb, plan.fixed_rows, plan.min_rows, plan.target,
                 plan.blocks, 0, plan.window)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr())
        part = (None, None) if scratch is None else (
            scratch.data_ptr(), _counter_buffer(q.device, stream, plan.counters).data_ptr())
        tail = (float(scale), float(softcap or 0.0), strides, stream)
        if lse is None:
            rc = _kernel()(*head, *part, *shape, *tail)
        else:
            rc = _kernel("dco_decode_attention_lse", LSE_ARGTYPES)(
                *head, lse.data_ptr(), *part, *shape, row_offset, *tail)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (code {rc})")
