"""Structured event-trace telemetry for the DCO simulator (DESIGN.md §10).

Every engine (step reference, compiled, compiled-streaming) can emit a
canonical per-round event stream — fills, hits, MSHR merges, bypasses,
evictions (victim tag + dead/live verdict), write-backs, gear
transitions, TMU tile retirements — into an :class:`EventSink`.  The
stream is flat int64 columns::

    (round, core, tenant, tensor, set, way, kind, aux)

chosen so that a whole run is a single ``(N, 8)`` matrix: cheap to
append block-wise, to export as npz, to diff, and to hash.  ``-1``
marks "not applicable" (e.g. ``way`` of a bypassed line, ``core`` of a
gear transition).  ``aux`` is kind-specific (see the ``EV_*`` constants
below and the schema table in DESIGN.md §10).

Contracts the conformance harness (``repro_torch.conformance``) builds on:

* **Determinism** — emission is a pure function of the simulated
  state machine; two runs of the same (trace, policy, geometry) produce
  byte-identical streams.
* **Segment concatenation** — the streaming compiled engine emits
  segment by segment into one persistent sink; the raw stream is
  bit-identical to a monolithic compiled run (rounds are atomic and the
  round index is global).
* **Engine agreement** — the step and compiled engines produce the
  same event *multiset* per round; :meth:`EventSink.canonical` imposes
  a total order (lexsort over all columns, round-major) so equality is
  byte-comparable and :meth:`EventSink.digest` is engine-independent.
* **Zero cost when disabled** — every emission site is guarded by a
  ``sink is not None`` check; with tracing off (the default) no event
  work, not even argument marshalling, happens on the hot path
  (``benchmarks/sweep_perf.py`` carries the overhead probe).

``SCHEMA_VERSION`` governs both the digest domain and the golden files
under ``tests/golden/``: any change to the column layout, kind codes,
or aux packing must bump it (and refresh the goldens via
``scripts/conformance.py --update-golden``).
"""

from __future__ import annotations

import hashlib
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple

import numpy as np

#: bump on any change to columns, kind codes, or aux packing
SCHEMA_VERSION = 1

#: column layout of the event matrix (one row per event)
COLUMNS: Tuple[str, ...] = ("round", "core", "tenant", "tensor", "set",
                            "way", "kind", "aux")

# Event kinds.  aux packing per kind:
#   FILL     aux = 2*tag + seen          (allocated fill; seen => conflict)
#   HIT      aux = 0                     (LLC tag hit)
#   MSHR     aux = merged duplicates     (same-line requests of the round)
#   BYPASS   aux = seen                  (miss not allocated; seen => conflict)
#   EVICT    aux = 2*victim_tag + dead   (dead: TMU dead-FIFO verdict)
#   WB       aux = victim_tag            (dirty victim written back)
#   GEAR     aux = new gear              (set column holds the slice id)
#   RETIRE   aux = tile index            (TMU accCnt reached nAcc)
EV_FILL = 0
EV_HIT = 1
EV_MSHR = 2
EV_BYPASS = 3
EV_EVICT = 4
EV_WB = 5
EV_GEAR = 6
EV_RETIRE = 7

KIND_NAMES: Tuple[str, ...] = ("FILL", "HIT", "MSHR", "BYPASS", "EVICT",
                               "WB", "GEAR", "RETIRE")

_EMPTY = np.empty((0, len(COLUMNS)), dtype=np.int64)


class EventSink:
    """Collects one run's event stream as flat int64 blocks.

    A sink serves exactly one simulation run: ``Simulator`` binds it to
    the run's trace + cache geometry (address → tensor/tenant
    resolution tables), every emission site appends ``(k, 8)`` blocks,
    and the matrix/canonical/digest views concatenate lazily.  Pass a
    fresh sink per run (``Simulator.run(..., events=EventSink())``) or
    set ``SimConfig.trace_events=True`` to have the run create and
    attach one to ``SimResult.events``.
    """

    def __init__(self) -> None:
        self._blocks: List[np.ndarray] = []
        self._round = -1
        self._geom = None
        self._t_starts: Optional[np.ndarray] = None   # tensor base addrs
        self._t_ids: Optional[np.ndarray] = None
        self._ten_starts: Optional[np.ndarray] = None  # tenant region addrs
        self._ten_ids: Optional[np.ndarray] = None
        self._tenant_by_tid: Dict[int, int] = {}
        self._live_regions: Dict[int, Tuple[int, int]] = {}  # tid -> [s, e)
        self._matrix: Optional[np.ndarray] = None

    # -- binding --------------------------------------------------------
    def bind(self, trace, geom) -> None:
        """Attach the run's address-resolution tables (idempotent for
        the same trace; the streaming engine binds once per run)."""
        self._geom = geom
        starts = sorted((m.base_addr, tid)
                        for tid, m in trace.tensors.items())
        self._t_starts = np.asarray([s for s, _ in starts], dtype=np.int64)
        self._t_ids = np.asarray([t for _, t in starts], dtype=np.int64)
        regions = trace.tenant_region_starts()
        if regions is not None:
            self._ten_starts, self._ten_ids = regions
            self._tenant_by_tid = dict(trace.tenant_of_tensor)
        else:
            self._ten_starts = None
            self._tenant_by_tid = {}

    def register_tensors(self, metas, *, retiring_tids=None) -> None:
        """Register tensors that join the run mid-stream (the serving
        replay registers at request admission).

        Allocator-aware liveness check: a new tensor's ``[base, end)``
        must not overlap any *live* region — addresses may recur across
        generations (a pooled allocator recycles retired regions), but
        never while the previous owner is still live.  The error names
        the offending tensor, its base, and the live region it collides
        with.  ``retiring_tids`` lists tensors this same segment also
        clears (declared *and* retired within one window): their regions
        may already have been recycled in-window, so they are exempt as
        overlap targets.  ``release_tensors`` removes regions when the
        engine clears them.

        The address-resolution fallback table (used only by emissions
        that do not carry explicit tensor ids) is kept sorted: the
        monotone bump case appends; recycled bases re-sort, with the
        newest generation winning a base collision.
        """
        new = sorted((m.base_addr, m.tensor_id, m.size_bytes)
                     for m in metas)
        if not new:
            return
        exempt = set(retiring_tids) if retiring_tids else set()
        for base, tid, size in new:
            end = base + size
            for lt, (ls, le) in self._live_regions.items():
                if lt == tid or lt in exempt:
                    continue
                if base < le and ls < end:
                    raise ValueError(
                        f"register_tensors: tensor {tid} at base "
                        f"0x{base:x} ([0x{base:x}, 0x{end:x})) overlaps "
                        f"the live region [0x{ls:x}, 0x{le:x}) of tensor "
                        f"{lt} — the allocator handed out an address "
                        f"range whose previous owner has not been "
                        f"released")
            self._live_regions[tid] = (base, end)
        starts = np.asarray([s for s, _, _ in new], dtype=np.int64)
        tids = np.asarray([t for _, t, _ in new], dtype=np.int64)
        if self._t_starts is None or self._t_starts.shape[0] == 0:
            self._t_starts, self._t_ids = starts, tids
            return
        if starts[0] > self._t_starts[-1]:
            self._t_starts = np.concatenate([self._t_starts, starts])
            self._t_ids = np.concatenate([self._t_ids, tids])
            return
        merged = dict(zip(self._t_starts.tolist(), self._t_ids.tolist()))
        merged.update(zip(starts.tolist(), tids.tolist()))
        pairs = sorted(merged.items())
        self._t_starts = np.asarray([s for s, _ in pairs], dtype=np.int64)
        self._t_ids = np.asarray([t for _, t in pairs], dtype=np.int64)

    def release_tensors(self, tids) -> None:
        """Drop cleared tensors from the live-region map so a recycling
        allocator may hand their addresses out again."""
        for tid in tids:
            self._live_regions.pop(int(tid), None)

    def begin_round(self, round_idx: int) -> None:
        self._round = round_idx

    # -- address resolution ---------------------------------------------
    def _tensor_of(self, addrs: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self._t_starts, addrs, side="right") - 1
        return self._t_ids[np.maximum(idx, 0)]

    def _tenant_of(self, addrs: np.ndarray) -> np.ndarray:
        if self._ten_starts is None:
            return np.zeros(addrs.shape[0], dtype=np.int64)
        idx = np.searchsorted(self._ten_starts, addrs, side="right") - 1
        return self._ten_ids[np.maximum(idx, 0)]

    # -- emission -------------------------------------------------------
    def emit_lines(self, kind: int, addrs: np.ndarray, sets=None,
                   ways=None, cores=None, aux=None, tensors=None) -> None:
        """Append one block of per-line events.  ``sets=None`` derives
        the set index from the bound geometry; ``ways``/``cores``/``aux``
        default to -1 / -1 / 0.  ``tensors`` carries exact per-line
        tensor ids from the engine (required for correct attribution
        when a pooled allocator recycles addresses across generations);
        ``None`` falls back to address resolution, which is exact for
        unique-address (bump) layouts."""
        k = addrs.shape[0]
        if k == 0:
            return
        mat = np.empty((k, len(COLUMNS)), dtype=np.int64)
        mat[:, 0] = self._round
        mat[:, 1] = -1 if cores is None else cores
        mat[:, 2] = self._tenant_of(addrs)
        mat[:, 3] = self._tensor_of(addrs) if tensors is None else tensors
        mat[:, 4] = self._geom.set_of(addrs) if sets is None else sets
        mat[:, 5] = -1 if ways is None else ways
        mat[:, 6] = kind
        mat[:, 7] = 0 if aux is None else aux
        self._blocks.append(mat)
        self._matrix = None

    def emit_gear(self, slice_ids: np.ndarray, tenant_ids: np.ndarray,
                  gears: np.ndarray) -> None:
        k = slice_ids.shape[0]
        if k == 0:
            return
        mat = np.full((k, len(COLUMNS)), -1, dtype=np.int64)
        mat[:, 0] = self._round
        mat[:, 2] = tenant_ids
        mat[:, 4] = slice_ids
        mat[:, 6] = EV_GEAR
        mat[:, 7] = gears
        self._blocks.append(mat)
        self._matrix = None

    def emit_retire(self, tensor_ids, tile_idxs) -> None:
        tensor_ids = np.asarray(tensor_ids, dtype=np.int64)
        k = tensor_ids.shape[0]
        if k == 0:
            return
        mat = np.full((k, len(COLUMNS)), -1, dtype=np.int64)
        mat[:, 0] = self._round
        if self._tenant_by_tid:
            mat[:, 2] = [self._tenant_by_tid.get(int(t), 0)
                         for t in tensor_ids]
        else:
            mat[:, 2] = 0
        mat[:, 3] = tensor_ids
        mat[:, 6] = EV_RETIRE
        mat[:, 7] = np.asarray(tile_idxs, dtype=np.int64)
        self._blocks.append(mat)
        self._matrix = None

    # -- views ----------------------------------------------------------
    def matrix(self) -> np.ndarray:
        """The raw event stream in emission order, shape ``(N, 8)``.
        This is the view the streaming-concatenation contract is stated
        over (segments append in round order)."""
        if self._matrix is None:
            self._matrix = (np.concatenate(self._blocks)
                            if self._blocks else _EMPTY.copy())
        return self._matrix

    def canonical(self) -> np.ndarray:
        """Engine-independent total order: lexsort over every column,
        round-major — two engines that agree on the per-round event
        multiset produce byte-identical canonical matrices."""
        return canonical_order(self.matrix())

    def digest(self) -> str:
        """SHA-256 of the canonical stream under the schema version —
        the value frozen in the golden files."""
        return stream_digest(self.canonical())

    def counts_by_kind(self) -> Dict[str, int]:
        m = self.matrix()
        c = np.bincount(m[:, 6], minlength=len(KIND_NAMES))
        return {KIND_NAMES[i]: int(c[i]) for i in range(len(KIND_NAMES))}

    def __len__(self) -> int:
        return int(self.matrix().shape[0])

    def to_npz(self, path) -> None:
        """Export the raw stream (one array per column + schema tag)."""
        m = self.matrix()
        arrays = {name: m[:, i] for i, name in enumerate(COLUMNS)}
        arrays["schema_version"] = np.asarray([SCHEMA_VERSION],
                                              dtype=np.int64)
        np.savez(path, **arrays)


# ---------------------------------------------------------------------------
# free functions shared with the conformance harness
# ---------------------------------------------------------------------------
def canonical_order(mat: np.ndarray) -> np.ndarray:
    """Sort an event matrix into the canonical total order (round-major,
    then kind, set, way, tensor, tenant, core, aux)."""
    if mat.shape[0] == 0:
        return mat
    order = np.lexsort((mat[:, 7], mat[:, 1], mat[:, 2], mat[:, 3],
                        mat[:, 5], mat[:, 4], mat[:, 6], mat[:, 0]))
    return mat[order]


def stream_digest(mat: np.ndarray) -> str:
    """Deterministic digest of an event matrix (callers pass the
    canonical order for the engine-independent value)."""
    h = hashlib.sha256()
    h.update(b"dco-events-v%d;" % SCHEMA_VERSION)
    h.update(np.ascontiguousarray(mat, dtype=np.int64).tobytes())
    return h.hexdigest()


def decode_event(row) -> str:
    """One event as a human-readable line (trace_dump / divergence
    reports)."""
    r, core, tenant, tensor, set_, way, kind, aux = (int(x) for x in row)
    name = KIND_NAMES[kind] if 0 <= kind < len(KIND_NAMES) else f"?{kind}"
    base = f"round={r:<6d} {name:7s}"
    if kind in (EV_FILL, EV_EVICT):
        extra = (f"tag={aux >> 1} "
                 + ("conflict" if aux & 1 else "cold")
                 if kind == EV_FILL else
                 f"victim_tag={aux >> 1} {'dead' if aux & 1 else 'live'}")
        return (f"{base} set={set_} way={way} core={core} tenant={tenant} "
                f"tensor={tensor} {extra}")
    if kind == EV_WB:
        return (f"{base} set={set_} way={way} core={core} tenant={tenant} "
                f"tensor={tensor} victim_tag={aux}")
    if kind == EV_HIT:
        return (f"{base} set={set_} way={way} core={core} tenant={tenant} "
                f"tensor={tensor}")
    if kind == EV_MSHR:
        return (f"{base} set={set_} core={core} tenant={tenant} "
                f"tensor={tensor} merged_dups={aux}")
    if kind == EV_BYPASS:
        return (f"{base} set={set_} core={core} tenant={tenant} "
                f"tensor={tensor} {'conflict' if aux else 'cold'}")
    if kind == EV_GEAR:
        return f"{base} slice={set_} tenant={tenant} gear={aux}"
    if kind == EV_RETIRE:
        return f"{base} tensor={tensor} tenant={tenant} tile={aux}"
    return (f"{base} core={core} tenant={tenant} tensor={tensor} "
            f"set={set_} way={way} aux={aux}")


def timeline_digest(timeline: Dict[str, np.ndarray]) -> str:
    """Deterministic digest of a ``SimResult.timeline`` dict (key-sorted
    dtype/shape/bytes) — the per-scenario value suite_bench records."""
    h = hashlib.sha256()
    h.update(b"dco-timeline-v%d;" % SCHEMA_VERSION)
    for key in sorted(timeline):
        a = np.ascontiguousarray(timeline[key])
        h.update(key.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()
