"""Tensor Management Unit (TMU) — faithful functional model of DCO §IV-B.

The TMU is the liaison between software and the shared-LLC replacement
logic.  Software registers *tensor metadata* before an operator runs
(three "specialized instructions" in the paper: register / clear / set
parameters); at runtime the TMU maintains *live tile info* (per-tile
access counters ``accCnt``) and a bounded *dead-tile-identifier FIFO*.

Semantics implemented bit-exactly per the paper (Table I):

* ``nAcc``      expected number of accesses of each cache line of a tensor
                (known from the dataflow, e.g. #Q-tiles for a K tile).
* ``accCnt``    per-live-tile counter, incremented when the tile's **last
                cache line** (TLL) is accessed; when ``accCnt == nAcc`` the
                tile retires and ``tag[D_MSB:D_LSB]`` is pushed into the
                dead FIFO (depth-bounded; full ⇒ oldest entry dropped).
* dead check    a cache line is considered dead iff ``tag[D_MSB:D_LSB]``
                is present in the dead FIFO.
* priority      ``tag[B_BITS-1:0]`` — the *lowermost bits of the tag
                domain*, uniform across a tensor; shared by the
                anti-thrashing replacement tier and the bypass gear.

Hardware cost defaults follow Table III: 8 tensor metadata entries,
256 tile metadata entries, dead FIFO depth 16, 48-bit physical addresses.
"""

from __future__ import annotations

from collections import OrderedDict
from collections import deque
from dataclasses import dataclass
from typing import Deque
from typing import Dict
from typing import Optional
from typing import Tuple

import numpy as np

PHYS_ADDR_BITS = 48


@dataclass(frozen=True)
class TensorMeta:
    """Static operator metadata registered before execution (paper §IV-B).

    Addresses are byte addresses; ``tile_bytes`` must be a multiple of the
    cache line size so that every line belongs to exactly one tile.
    """

    tensor_id: int
    base_addr: int
    size_bytes: int
    tile_bytes: int
    n_acc: int                 # expected accesses of each cache line
    operand_id: int = 0        # e.g. 0=left, 1=right, 2=output
    bypass_all: bool = False   # bypass the whole tensor from LLC

    def __post_init__(self) -> None:
        if self.size_bytes <= 0 or self.tile_bytes <= 0:
            raise ValueError("tensor/tile sizes must be positive")
        if self.size_bytes % self.tile_bytes != 0:
            raise ValueError(
                f"tensor size {self.size_bytes} not a multiple of tile "
                f"size {self.tile_bytes}"
            )
        if self.base_addr < 0 or self.base_addr + self.size_bytes > (1 << PHYS_ADDR_BITS):
            raise ValueError("tensor does not fit in the physical address space")

    @property
    def end_addr(self) -> int:
        return self.base_addr + self.size_bytes

    @property
    def num_tiles(self) -> int:
        return self.size_bytes // self.tile_bytes

    def tile_of(self, addr: int) -> int:
        return (addr - self.base_addr) // self.tile_bytes

    def tile_last_line(self, tile_idx: int, line_bytes: int) -> int:
        """Byte address of the first byte of the tile's last cache line."""
        end = self.base_addr + (tile_idx + 1) * self.tile_bytes
        return end - line_bytes


@dataclass
class TMUParams:
    """Run-time configurable parameters (the paper's third instruction)."""

    d_lsb: int = 0
    d_msb: int = 11          # inclusive; tag[D_MSB:D_LSB] = 12-bit dead id
    b_bits: int = 3          # priority = tag[B_BITS-1:0] → 2**b_bits tiers

    def __post_init__(self) -> None:
        if not (0 <= self.d_lsb <= self.d_msb):
            raise ValueError("need 0 <= D_LSB <= D_MSB")
        if not (0 <= self.b_bits <= 8):
            raise ValueError("B_BITS out of supported range")

    def dead_id(self, tag: int) -> int:
        width = self.d_msb - self.d_lsb + 1
        return (tag >> self.d_lsb) & ((1 << width) - 1)

    def priority(self, tag: int) -> int:
        if self.b_bits == 0:
            return 0
        return tag & ((1 << self.b_bits) - 1)


class DeadFIFO:
    """Bounded FIFO of dead tile identifiers (tag[D_MSB:D_LSB] values).

    Lookup must complete within a clock cycle in hardware, hence the small
    depth (16 in Table III).  We keep an O(1) membership set alongside the
    FIFO order; duplicate pushes refresh nothing (hardware would simply
    hold two identical entries — membership semantics are identical).
    """

    def __init__(self, depth: int = 16):
        if depth <= 0:
            raise ValueError("FIFO depth must be positive")
        self.depth = depth
        self._fifo: Deque[int] = deque()
        self._counts: Dict[int, int] = {}

    def push(self, dead_id: int) -> Optional[int]:
        """Push an id; returns the evicted (dropped) id if the FIFO was full."""
        dropped: Optional[int] = None
        if len(self._fifo) == self.depth:
            dropped = self._fifo.popleft()
            c = self._counts[dropped] - 1
            if c:
                self._counts[dropped] = c
            else:
                del self._counts[dropped]
        self._fifo.append(dead_id)
        self._counts[dead_id] = self._counts.get(dead_id, 0) + 1
        return dropped

    def __contains__(self, dead_id: int) -> bool:
        return dead_id in self._counts

    def __len__(self) -> int:
        return len(self._fifo)

    def snapshot(self) -> Tuple[int, ...]:
        return tuple(self._fifo)

    def clear(self) -> None:
        self._fifo.clear()
        self._counts.clear()


class TMU:
    """Functional TMU: tensor metadata module + tile metadata module.

    The tile metadata module has bounded capacity (``tile_entries``).  Live
    tile entries are allocated lazily on first TLL access and evicted in
    LRU order when capacity is exceeded (the paper sizes it at 256 entries
    so that the set of tiles concurrently in flight fits; overflow merely
    loses a counter, i.e. a missed dead prediction — never a correctness
    issue).
    """

    def __init__(
        self,
        line_bytes: int = 128,
        tensor_entries: int = 8,
        tile_entries: int = 256,
        dead_fifo_depth: int = 16,
        params: Optional[TMUParams] = None,
    ):
        self.line_bytes = line_bytes
        self.tensor_entries = tensor_entries
        self.tile_entries = tile_entries
        self.params = params or TMUParams()
        self.dead_fifo = DeadFIFO(dead_fifo_depth)
        self._tensors: Dict[int, TensorMeta] = {}
        # live tile info: (tensor_id, tile_idx) -> accCnt, LRU-ordered
        self._live: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        # stats
        self.stats: Dict[str, int] = {
            "tll_accesses": 0,
            "tiles_retired": 0,
            "live_overflow_evictions": 0,
            "dead_fifo_drops": 0,
        }
        # opt-in event telemetry (an object with the simulator's EventSink interface); None on
        # the hot path unless the simulator attached a sink
        self.sink = None

    # ------------------------------------------------------------------
    # The three specialized instructions (paper §IV-B)
    # ------------------------------------------------------------------
    def register(self, meta: TensorMeta) -> None:
        """Instruction 1: register tensor metadata."""
        if meta.tensor_id in self._tensors:
            raise ValueError(f"tensor {meta.tensor_id} already registered")
        if len(self._tensors) >= self.tensor_entries:
            raise RuntimeError(
                f"TMU tensor metadata full ({self.tensor_entries} entries); "
                "clear a tensor first"
            )
        if meta.tile_bytes % self.line_bytes != 0:
            raise ValueError("tile size must be a multiple of the line size")
        self._tensors[meta.tensor_id] = meta

    def register_many(self, metas) -> None:
        """Register a whole dataflow's tensor set (one ``register`` per
        entry, same capacity checks) — the batch form the simulator and
        the dataflow lowerings use."""
        for meta in metas:
            self.register(meta)

    def clear(self, tensor_id: int) -> None:
        """Instruction 2: clear a registration that is no longer needed."""
        self._tensors.pop(tensor_id, None)
        stale = [k for k in self._live if k[0] == tensor_id]
        for k in stale:
            del self._live[k]

    def set_params(self, params: TMUParams) -> None:
        """Instruction 3: set D_LSB / D_MSB / B_BITS."""
        self.params = params

    # ------------------------------------------------------------------
    # Runtime interface used by the LLC
    # ------------------------------------------------------------------
    def lookup_tensor(self, addr: int) -> Optional[TensorMeta]:
        for meta in self._tensors.values():
            if meta.base_addr <= addr < meta.end_addr:
                return meta
        return None

    def on_access(self, addr: int, tag: int) -> None:
        """LLC informs the TMU of an access.  If ``addr`` is a tile's last
        line (TLL), bump ``accCnt``; on reaching ``nAcc`` retire the tile
        into the dead FIFO."""
        meta = self.lookup_tensor(addr)
        if meta is None or meta.bypass_all:
            return
        tile_idx = meta.tile_of(addr)
        line_addr = addr - (addr % self.line_bytes)
        if line_addr != meta.tile_last_line(tile_idx, self.line_bytes):
            return
        self.stats["tll_accesses"] += 1
        key = (meta.tensor_id, tile_idx)
        cnt = self._live.get(key, 0) + 1
        if cnt >= meta.n_acc:
            # retire: move identifier from live tile info to dead ids
            self._live.pop(key, None)
            if self.dead_fifo.push(self.params.dead_id(tag)) is not None:
                self.stats["dead_fifo_drops"] += 1
            self.stats["tiles_retired"] += 1
            if self.sink is not None:
                self.sink.emit_retire([meta.tensor_id], [tile_idx])
        else:
            self._live[key] = cnt
            self._live.move_to_end(key)
            if len(self._live) > self.tile_entries:
                self._live.popitem(last=False)
                self.stats["live_overflow_evictions"] += 1

    def on_access_batch(self, tensor_ids, tile_idxs, tags, n_accs) -> None:
        """Batched :meth:`on_access` over a pre-resolved TLL feed.

        The caller (the compiled-trace simulator) guarantees every entry
        is the tile-last-line of a registered, non-``bypass_all`` tensor,
        so the per-call linear tensor lookup and the TLL address check are
        skipped and the dead-id bit slicing is done vectorized up front.
        State transitions (accCnt bumps, retirement order, dead-FIFO
        pushes, live-table LRU/overflow) are identical to issuing the
        calls one at a time in feed order.
        """
        tensor_ids = np.asarray(tensor_ids)
        n = tensor_ids.shape[0]
        if n == 0:
            return
        self.stats["tll_accesses"] += int(n)
        p = self.params
        width = p.d_msb - p.d_lsb + 1
        dead_ids = ((np.asarray(tags, dtype=np.int64) >> p.d_lsb)
                    & ((1 << width) - 1)).tolist()
        live = self._live
        fifo = self.dead_fifo
        sink = self.sink
        r_tids = [] if sink is not None else None
        r_tiles = [] if sink is not None else None
        retired = drops = overflow = 0
        for tid, tile, did, n_acc in zip(
                tensor_ids.tolist(), np.asarray(tile_idxs).tolist(),
                dead_ids, np.asarray(n_accs).tolist()):
            key = (tid, tile)
            cnt = live.get(key, 0) + 1
            if cnt >= n_acc:
                live.pop(key, None)
                if fifo.push(did) is not None:
                    drops += 1
                retired += 1
                if r_tids is not None:
                    r_tids.append(tid)
                    r_tiles.append(tile)
            else:
                live[key] = cnt
                live.move_to_end(key)
                if len(live) > self.tile_entries:
                    live.popitem(last=False)
                    overflow += 1
        self.stats["tiles_retired"] += retired
        self.stats["dead_fifo_drops"] += drops
        self.stats["live_overflow_evictions"] += overflow
        if sink is not None and r_tids:
            sink.emit_retire(r_tids, r_tiles)

    def is_dead(self, tag: int) -> bool:
        return self.params.dead_id(tag) in self.dead_fifo

    def priority(self, tag: int) -> int:
        return self.params.priority(tag)

    def acc_cnt(self, tensor_id: int, tile_idx: int) -> int:
        return self._live.get((tensor_id, tile_idx), 0)

    @property
    def live_tiles(self) -> int:
        return len(self._live)

    # ------------------------------------------------------------------
    # Structural cost estimate (paper Table II reports 64,438 µm² @15nm,
    # 2 GHz for the full TMU).  We provide a transparent bit-count model
    # so the configuration's storage cost is auditable; the paper's
    # synthesized figure remains the reference value.
    # ------------------------------------------------------------------
    def area_report(self) -> Dict[str, float]:
        tag_bits = PHYS_ADDR_BITS  # upper bound; real tag is addr minus index/offset
        tensor_entry_bits = (
            PHYS_ADDR_BITS          # base address
            + 32                    # size
            + 24                    # tile size
            + 16                    # nAcc
            + 2                     # operand id
            + 1                     # bypass flag
        )
        tile_entry_bits = 16 + 16 + 16   # tensor/tile key + accCnt
        dead_entry_bits = self.params.d_msb - self.params.d_lsb + 1
        bits = (
            self.tensor_entries * tensor_entry_bits
            + self.tile_entries * tile_entry_bits
            + self.dead_fifo.depth * dead_entry_bits
        )
        # NanGate15 ~0.2 µm²/bit for flop-based storage + ~60% logic overhead:
        um2 = bits * 0.2 * 1.6
        return {
            "storage_bits": float(bits),
            "estimated_um2": um2,
            "paper_reference_um2": 64438.0,
            "paper_reference_freq_ghz": 2.0,
            "tag_bits_assumed": float(tag_bits),
        }
