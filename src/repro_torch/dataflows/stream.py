"""Generator-driven chunked lowering for serving replay (DESIGN.md §11).

The suite path materializes a whole :class:`~repro_torch.dataflows.ir.DataflowSpec`,
lowers it to a :class:`~repro_torch.core.traces.Trace`, and compiles that — all
O(total rounds) memory.  Traffic-scale replay (10⁵–10⁶ requests) cannot
afford any of those materializations, so this module provides the
streaming twin: an *emitter* interface that the serve engine's
admit/retire loop drives round by round, producing
:class:`ReplaySegment` windows (a :class:`~repro_torch.core.traces.CompiledTrace`
plus incremental TMU registrations/retirements and seen-bitmap recycling
directives) that :meth:`repro_torch.core.simulator.Simulator.run_stream`
consumes with bounded memory.

Two emitters implement the same protocol so the replay driver is written
once and the bit-identity property (streamed == monolithic) is testable:

* :class:`SpecEmitter` accumulates everything into one ``DataflowSpec``
  — the reference path, feeding the ordinary suite lowerings (trace,
  counts, reuse profile) for small seeds;
* :class:`StreamEmitter` buffers at most ``chunk_lines`` pre-merge line
  requests of rounds, then flushes a window ``CompiledTrace`` built via
  ``CompiledTrace.build(..., dense_map=...)``.

Bit-identity rests on three invariants:

1. **Addresses** — both emitters drive the *same*
   :class:`~repro_torch.dataflows.addr.AddressAllocator` policy over the same
   declare/retire call sequence; allocator state is a pure function of
   that sequence, so the layouts agree by construction.  The default
   :class:`~repro_torch.dataflows.addr.BumpAllocator` reproduces
   :func:`repro_torch.dataflows.lower.assign_addresses` bit-exactly
   (tile-aligned from ``1 << 30``, declaration order); a
   :class:`~repro_torch.dataflows.addr.PooledPageAllocator` recycles retired
   regions identically on both paths (the monolithic emitter bakes the
   resulting bases into the spec via ``TensorSpec.base`` so every
   lowering reproduces them).  Tensor ids are declaration indices.
   Identical addresses ⇒ identical set/tag mapping, MSHR merges, and
   eviction interleaving.  Allocator contract: ``retire`` is only
   called after the round holding the tensor's final access has been
   emitted, so a recycled region's new tensor is never co-accessed
   with its predecessor in one round.
2. **Seen-bitmap recycling** — the monolithic layout gives every tensor
   its own dense range forever; the stream recycles a retired tensor's
   range through a size-keyed free list, but only after a *flush
   boundary* (a quarantine holds ranges freed mid-window), and each
   recycled range is zeroed (``seen_resets``) before the window that
   reuses it.  A fresh tensor therefore observes exactly the cold
   misses it would have observed with a private range, while the bitmap
   stays O(live working set) instead of O(every tensor ever declared).
3. **Exact nAcc** — the replay driver declares true access counts, so
   every tile self-retires from the TMU's live table before ``clear``
   is issued; the incremental register/clear calls are then invisible
   to the simulated cache state (the compiled engine never consults
   tensor metadata on the access path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence
from typing import Tuple

from ..core.tmu import TensorMeta
from ..core.traces import CompiledTrace
from ..core.traces import Step
from ..core.traces import Trace
from .addr import AddressAllocator
from .addr import BumpAllocator
from .addr import Region
from .ir import DataflowSpec
from .ir import LINE_BYTES
from .ir import SpecBuilder

#: default flush budget: pre-merge line requests buffered per window
DEFAULT_CHUNK_LINES = 1 << 18

#: one core's contribution to a round: (core, loads, stores, flops) with
#: loads/stores as sequences of (tensor_name, tile_index)
RoundStep = Tuple[int, Sequence[Tuple[str, int]],
                  Sequence[Tuple[str, int]], float]


@dataclass
class ReplaySegment:
    """One flushed window of the streamed lowering.

    ``Simulator.run_stream`` applies the fields in order: grow the seen
    bitmap to ``n_seen_lines``, zero the ``seen_resets`` ranges, register
    ``new_tensors`` with the TMU (+ event sink), consume ``ct``'s rounds,
    then clear ``clear_tids``.
    """

    ct: CompiledTrace
    new_tensors: List[TensorMeta]
    seen_resets: List[Tuple[int, int]]     # [start, stop) dense-line ranges
    clear_tids: List[int]
    n_seen_lines: int


class SpecEmitter:
    """Reference emitter: accumulate the whole replay into one spec.

    Keeps every tensor and every round, so it is only usable for small
    seeds — exactly the regime where the bit-identity property and the
    suite/conformance registrations need a monolithic
    :class:`DataflowSpec` with reuse-profile epochs intact.
    """

    def __init__(self, name: str, n_cores: int,
                 line_bytes: int = LINE_BYTES,
                 allocator: Optional[AddressAllocator] = None):
        self._b = SpecBuilder(name, n_cores, line_bytes=line_bytes)
        self._n_cores = n_cores
        # with no allocator the spec keeps implicit bases and the
        # lowering's default bump allocation lays it out (the historical
        # byte-identical path); an explicit allocator is run here and
        # its bases are baked into the spec (``TensorSpec.base``)
        self.allocator = allocator
        self._regions: Dict[str, Region] = {}
        if allocator is not None:
            self._b.allocator = allocator.name
        self.rounds = 0

    def declare(self, name: str, *, size_bytes: int, tile_bytes: int,
                n_acc: int, bypass: bool = False, sharers: int = 1,
                epoch: Tuple[int, int] = (0, 0)) -> None:
        base = None
        if self.allocator is not None:
            region = self.allocator.alloc(size_bytes, tile_bytes)
            self._regions[name] = region
            base = region.base
        self._b.tensor(name, size_bytes=size_bytes, tile_bytes=tile_bytes,
                       n_acc=n_acc, bypass=bypass, sharers=sharers,
                       epoch=epoch, base=base)

    def emit_round(self, steps: Sequence[RoundStep]
                   ) -> Optional[ReplaySegment]:
        present = set()
        for core, loads, stores, flops in steps:
            self._b.step(core, loads=list(loads), stores=list(stores),
                         flops=flops)
            present.add(core)
        for core in range(self._n_cores):
            if core not in present:
                self._b.pad(core, 1)
        self.rounds += 1
        return None

    def retire(self, name: str) -> None:
        """Return the tensor's region to the allocator (immediately: the
        driver only retires after the final access round is emitted, so
        a recycled region is never co-accessed with its predecessor).
        Without an explicit allocator this is a no-op — the monolithic
        bump layout never recycles."""
        region = self._regions.pop(name, None)
        if region is not None and self.allocator is not None:
            self.allocator.free(region)

    def finish(self) -> Optional[ReplaySegment]:
        return None

    def build(self) -> DataflowSpec:
        return self._b.build()


@dataclass
class _LiveTensor:
    tid: int
    meta: TensorMeta
    dense_off: int
    n_lines: int
    region: Region


class StreamEmitter:
    """Chunked emitter: flush ``CompiledTrace`` windows on the fly.

    Peak memory is the window buffer (≤ ``chunk_lines`` pre-merge line
    requests of Python ``Step`` rows plus one compiled window) plus the
    recycled seen bitmap (``peak_seen_lines`` lines, O(live working
    set)) — independent of total round count.
    """

    def __init__(self, name: str, n_cores: int, *,
                 chunk_lines: int = DEFAULT_CHUNK_LINES,
                 line_bytes: int = LINE_BYTES,
                 allocator: Optional[AddressAllocator] = None):
        if chunk_lines <= 0:
            raise ValueError("chunk_lines must be positive")
        self.name = name
        self.n_cores = n_cores
        self.chunk_lines = chunk_lines
        self.line_bytes = line_bytes
        # the address-space policy (module docstring, invariant 1);
        # the default BumpAllocator reproduces the monolithic lowering's
        # layout bit-exactly
        self.allocator = allocator if allocator is not None \
            else BumpAllocator()
        self._next_tid = 0
        self._live: Dict[str, _LiveTensor] = {}
        # window state -------------------------------------------------
        self._buf: List[List[Step]] = [[] for _ in range(n_cores)]
        self._buf_lines = 0
        self._window_metas: Dict[int, TensorMeta] = {}   # live + retired
        self._window_dense: Dict[int, int] = {}
        self._new: List[TensorMeta] = []
        self._clears: List[int] = []
        self._resets: List[Tuple[int, int]] = []
        # dense seen-bitmap allocator (invariant 2) --------------------
        self._free: Dict[int, List[int]] = {}
        self._quarantine: List[Tuple[int, int]] = []     # (n_lines, off)
        self._dense_top = 0
        # observability ------------------------------------------------
        self.rounds = 0
        self.segments = 0
        self.peak_seen_lines = 0
        self.total_lines_declared = 0

    # -- protocol -------------------------------------------------------
    def declare(self, name: str, *, size_bytes: int, tile_bytes: int,
                n_acc: int, bypass: bool = False, sharers: int = 1,
                epoch: Tuple[int, int] = (0, 0)) -> None:
        if name in self._live:
            raise ValueError(f"tensor {name!r} already live")
        if size_bytes <= 0 or tile_bytes <= 0:
            raise ValueError(
                f"{self.name}: tensor {name!r} sizes must be positive "
                f"(size={size_bytes}, tile={tile_bytes})")
        if size_bytes % tile_bytes:
            raise ValueError(
                f"{self.name}: tensor {name!r} size {size_bytes} not a "
                f"multiple of tile {tile_bytes}")
        if tile_bytes % self.line_bytes:
            raise ValueError(
                f"{self.name}: tensor {name!r} tile {tile_bytes} not a "
                f"multiple of line {self.line_bytes}")
        region = self.allocator.alloc(size_bytes, tile_bytes)
        base = region.base
        tid = self._next_tid
        self._next_tid += 1
        n_lines = size_bytes // self.line_bytes
        bucket = self._free.get(n_lines)
        if bucket:
            off = bucket.pop()
            self._resets.append((off, off + n_lines))
        else:
            off = self._dense_top
            self._dense_top += n_lines
            self.peak_seen_lines = max(self.peak_seen_lines,
                                       self._dense_top)
        meta = TensorMeta(tensor_id=tid, base_addr=base,
                          size_bytes=size_bytes, tile_bytes=tile_bytes,
                          n_acc=n_acc, bypass_all=bypass)
        lt = _LiveTensor(tid=tid, meta=meta, dense_off=off,
                         n_lines=n_lines, region=region)
        self._live[name] = lt
        self._window_metas[tid] = meta
        self._window_dense[tid] = off
        self._new.append(meta)
        self.total_lines_declared += n_lines

    def emit_round(self, steps: Sequence[RoundStep]
                   ) -> Optional[ReplaySegment]:
        lb = self.line_bytes
        present = set()
        for core, loads, stores, flops in steps:
            l_ids = []
            for nm, tile in loads:
                lt = self._live[nm]
                l_ids.append((lt.tid, tile))
                self._buf_lines += lt.meta.tile_bytes // lb
            s_ids = []
            for nm, tile in stores:
                lt = self._live[nm]
                s_ids.append((lt.tid, tile))
                self._buf_lines += lt.meta.tile_bytes // lb
            self._buf[core].append(Step(loads=l_ids, stores=s_ids,
                                        flops=flops))
            present.add(core)
        for core in range(self.n_cores):
            if core not in present:
                self._buf[core].append(Step())
        self.rounds += 1
        if self._buf_lines >= self.chunk_lines:
            return self._flush()
        return None

    def retire(self, name: str) -> None:
        """Mark a tensor finished: its TMU entry is cleared after the
        window holding its final rounds, its seen range becomes
        recyclable at the next flush boundary (never within the window
        that still references it), and its address region returns to
        the allocator immediately (safe by the retire-after-last-access
        contract; a no-op under bump allocation)."""
        lt = self._live.pop(name)
        self._clears.append(lt.tid)
        self._quarantine.append((lt.n_lines, lt.dense_off))
        self.allocator.free(lt.region)

    def finish(self) -> Optional[ReplaySegment]:
        """Flush whatever remains (possibly a round-less trailer that
        only carries clears)."""
        if (self.rounds and any(self._buf)) or self._new or self._clears:
            return self._flush()
        return None

    # -- internals ------------------------------------------------------
    def _flush(self) -> ReplaySegment:
        trace = Trace(
            name=f"{self.name}@{self.segments}",
            tensors=dict(self._window_metas),
            core_steps=[list(b) for b in self._buf],
            core_group=[-1] * self.n_cores,
            core_is_leader=[True] * self.n_cores,
            line_bytes=self.line_bytes)
        ct = CompiledTrace.build(trace, self.line_bytes,
                                 dense_map=dict(self._window_dense),
                                 n_seen_lines=self._dense_top)
        seg = ReplaySegment(ct=ct, new_tensors=self._new,
                            seen_resets=self._resets,
                            clear_tids=self._clears,
                            n_seen_lines=self._dense_top)
        # reset the window; retired tensors leave the meta tables and
        # their quarantined ranges become recyclable
        for tid in self._clears:
            del self._window_metas[tid]
            del self._window_dense[tid]
        for n_lines, off in self._quarantine:
            self._free.setdefault(n_lines, []).append(off)
        self._quarantine = []
        self._buf = [[] for _ in range(self.n_cores)]
        self._buf_lines = 0
        self._new = []
        self._clears = []
        self._resets = []
        self.segments += 1
        return seg
