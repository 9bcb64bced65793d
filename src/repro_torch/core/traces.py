"""Dataflow → memory-trace generation for the DCO simulator.

The paper evaluates trace-driven: "directly using memory traces generated
from given dataflows" (§VI-B).  Traces are produced by lowering
declarative dataflow specs (``repro_torch.dataflows``, DESIGN.md §8); this
module keeps the trace data model (:class:`Step`/:class:`Trace`), the
compiled-trace IR, the closed-form :class:`DataflowCounts` record, and
the historical entry points (``build_fa2_trace`` for FlashAttention-2 GQA
with temporal/spatial group allocation §VI-C, optionally multi-batch
§VI-F; ``build_matmul_trace`` for the tiled MatMul of Fig. 2(a)), which
are now thin wrappers over the IR.

A trace is a list of per-core *steps*; each step is one inner iteration of
the dataflow: a set of bulk tile transfers plus the compute executed on
the tiles while they sit in the core's private SPM.  Cores run steps in
lockstep rounds (burst-synchronous simulation, DESIGN.md §7.2).

Spatial group allocation staggers the KV-loop start of the cores inside a
sharing group by one tile per rank ("scheduling skew"), so inter-core
reuses appear as short-reuse-distance LLC hits rather than same-cycle MSHR
merges — this reproduces the paper's observation that blind bypassing
destroys inter-core reuse (§IV-E) while LRU and ``at`` keep it.

Policy sweeps (one trace, many policies — every figure of the paper) go
through :class:`CompiledTrace`: the per-core ``Step`` lists are lowered
*once* into flat round-indexed numpy arrays (line addresses, dense seen
indices, merged write flags, TLL feed, CSR-style round offsets).  The
compiled form is built lazily by :meth:`Trace.compiled` and cached on the
``Trace`` so the lowering cost is shared across all policies of a sweep;
``Simulator.run`` slices these arrays per round instead of re-walking the
Python step lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple

import numpy as np

from .tmu import TensorMeta
from .workloads import AttnWorkload

LINE_BYTES = 128


@dataclass
class Step:
    """One dataflow inner iteration on one core."""

    loads: List[Tuple[int, int]] = field(default_factory=list)   # (tensor_id, tile)
    stores: List[Tuple[int, int]] = field(default_factory=list)
    flops: float = 0.0


@dataclass
class Trace:
    name: str
    tensors: Dict[int, TensorMeta]
    core_steps: List[List[Step]]
    core_group: List[int]            # sharing-group id per core (-1: none)
    core_is_leader: List[bool]       # leader of its sharing group?
    line_bytes: int = LINE_BYTES
    workload: Optional[AttnWorkload] = None
    # multi-tenant composites (DESIGN.md §8.4): tensor_id → tenant index
    # plus tenant display names; the simulator attributes counters by
    # the tenants' (disjoint, region-aligned) address ranges
    tenant_of_tensor: Optional[Dict[int, int]] = None
    tenant_names: Optional[List[str]] = None
    # deterministic content hash of the DataflowSpec this trace was
    # lowered from (repro_torch.dataflows.artifacts); None for hand-built
    # traces.  Keys the on-disk artifact cache for compiled lowerings.
    fingerprint: Optional[str] = None
    _compiled: Dict[int, "CompiledTrace"] = field(
        default_factory=dict, init=False, repr=False, compare=False)
    _line_counts: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)

    @property
    def n_cores(self) -> int:
        return len(self.core_steps)

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_names) if self.tenant_names else 1

    def tenant_region_starts(self) -> Optional[Tuple[np.ndarray,
                                                     np.ndarray]]:
        """Sorted ``(region_start_addrs, tenant_ids)`` for per-tenant
        attribution: a byte address belongs to the tenant whose region
        start is the greatest one <= it (regions are disjoint and
        contiguous per tenant, so the map is exact)."""
        if self.tenant_of_tensor is None:
            return None
        base: Dict[int, int] = {}
        for tid, m in self.tensors.items():
            ten = self.tenant_of_tensor[tid]
            base[ten] = min(base.get(ten, m.base_addr), m.base_addr)
        tens = sorted(base, key=lambda t: base[t])
        return (np.asarray([base[t] for t in tens], dtype=np.int64),
                np.asarray(tens, dtype=np.int64))

    @property
    def n_rounds(self) -> int:
        return max(len(s) for s in self.core_steps)

    def tile_lines(self, tensor_id: int, tile: int) -> np.ndarray:
        meta = self.tensors[tensor_id]
        start = meta.base_addr + tile * meta.tile_bytes
        n = meta.tile_bytes // self.line_bytes
        return start + np.arange(n, dtype=np.int64) * self.line_bytes

    def total_bytes_touched(self) -> int:
        return sum(m.size_bytes for m in self.tensors.values())

    def compiled(self, line_bytes: int = 0) -> "CompiledTrace":
        """Lower to flat round-indexed arrays; built once, cached here.

        ``line_bytes`` is validation only: the simulator passes its
        cache-line size and anything other than the trace's own line
        granularity is rejected (the addresses bake it in).  The single
        cached lowering is shared by every policy and every cache
        geometry of a sweep.
        """
        lb = line_bytes or self.line_bytes
        if lb != self.line_bytes:
            # the trace bakes its line granularity into every address;
            # lowering at another line size would silently corrupt the
            # seen-bitmap layout and the TLL feed
            raise ValueError(
                f"cannot compile a {self.line_bytes}-byte-line trace at "
                f"line_bytes={lb}")
        ct = self._compiled.get(lb)
        if ct is None:
            key = None
            if self.fingerprint is not None:
                from ..dataflows import artifacts
                if artifacts.artifacts_enabled():
                    key = artifacts.compiled_trace_key(self.fingerprint, lb)
                    ct = artifacts.load_compiled_trace(key)
            if ct is None:
                ct = CompiledTrace.build(self, lb)
                if key is not None:
                    from ..dataflows import artifacts
                    artifacts.store_compiled_trace(key, ct)
            ct.cache_key = key
            self._compiled[lb] = ct
        return ct

    # ------------------------------------------------------------------
    def _round_line_counts(self) -> np.ndarray:
        """Pre-merge line-request count per round (== the compiled
        ``n_acc_round``), computed from the step lists alone so segment
        boundaries can be chosen without materializing the full
        lowering."""
        if self._line_counts is None:
            lb = self.line_bytes
            counts = np.zeros(self.n_rounds, dtype=np.int64)
            tensors = self.tensors
            for steps in self.core_steps:
                for r, step in enumerate(steps):
                    for tid, _ in step.loads:
                        counts[r] += tensors[tid].tile_bytes // lb
                    for tid, _ in step.stores:
                        counts[r] += tensors[tid].tile_bytes // lb
            self._line_counts = counts
        return self._line_counts

    def compiled_segments(self, line_bytes: int = 0,
                          chunk_lines: int = 1 << 20):
        """Chunked mode of :meth:`compiled`: lower the rounds into
        fixed-size CSR segments and yield them incrementally.

        Segments pack whole rounds greedily up to ``chunk_lines``
        pre-merge line requests each; rounds are atomic (the MSHR merge
        and same-set pass splitting never cross a round boundary), so a
        single round larger than the budget becomes its own segment and
        the concatenation of the segment arrays is exactly the
        monolithic lowering.  When the full lowering is already cached
        the segments are zero-copy slices of it; otherwise each window
        is built directly from its round range, so streaming consumers
        (the serving-replay path) never hold more than one window of
        per-line arrays.
        """
        lb = line_bytes or self.line_bytes
        if lb != self.line_bytes:
            raise ValueError(
                f"cannot compile a {self.line_bytes}-byte-line trace at "
                f"line_bytes={lb}")
        if chunk_lines <= 0:
            raise ValueError("chunk_lines must be positive")
        bounds = _segment_bounds(self._round_line_counts(), chunk_lines)
        full = self._compiled.get(lb)
        for r0, r1 in zip(bounds[:-1], bounds[1:]):
            if full is not None:
                yield full.slice_rounds(r0, r1)
            else:
                yield CompiledTrace.build(self, lb, r0, r1)


def _segment_bounds(line_counts: np.ndarray, chunk_lines: int) -> List[int]:
    """Round indices cutting a trace into whole-round segments of at most
    ``chunk_lines`` pre-merge line requests (always >= 1 round each)."""
    bounds = [0]
    acc = 0
    for r, c in enumerate(line_counts.tolist()):
        if acc and acc + c > chunk_lines:
            bounds.append(r)
            acc = 0
        acc += c
    bounds.append(int(line_counts.shape[0]))
    return bounds


class CompiledTrace:
    """Flat, round-indexed lowering of a :class:`Trace` (compiled-trace IR).

    One build replaces the per-policy Python walk over ``core_steps``:
    every round's accesses are pre-merged (MSHR semantics: same-line
    requests of one round collapse to the first occurrence, write intents
    OR-ed across duplicates) and stored in CSR layout — ``round_off[r] :
    round_off[r+1]`` slices the per-line arrays of round ``r``.

    Per unique line and round (arrays of length ``U``):

    * ``u_addrs``      byte address of the line (ascending within a round)
    * ``u_dense``      index into the run's global "seen" bitmap
    * ``u_write``      OR of the write intents of all merged duplicates
    * ``u_force``      tensor-level ``bypass_all``
    * ``u_nonleader``  issuing core (first occurrence) is a gqa non-leader
    * ``u_core``       issuing core of the first occurrence (event-trace
                       attribution; the MSHR merge keeps the first
                       requester, matching the step engine's unique())
    * ``u_tid``        tensor id of the line (event-trace attribution
                       that stays exact when a pooled allocator recycles
                       addresses across generations; same-round
                       duplicates of one line always belong to one
                       tensor, so the first occurrence is exact)
    * ``u_dups``       duplicates merged away into this line (MSHR-hit
                       accounting, attributable per tenant)

    Per round: ``n_acc_round`` (pre-merge request count, for MSHR-hit
    accounting) and ``flops_round``.  The TLL feed for the TMU is a second
    CSR block (``tll_*``) holding pre-resolved (tensor, tile, nAcc) per
    tile-last-line access, in issue order.

    Cache-geometry-dependent state (set indices, same-set pass splitting)
    is *not* baked in; :meth:`plans_for` computes it per geometry and
    caches it so every policy of a sweep reuses it.
    """

    def __init__(self, line_bytes: int, n_rounds: int, n_seen_lines: int,
                 u_addrs, u_dense, u_write, u_force, u_nonleader, u_core,
                 u_tid, u_dups, round_off, n_acc_round, flops_round,
                 tll_addrs, tll_tids, tll_tiles, tll_nacc, tll_off):
        self.line_bytes = line_bytes
        self.n_rounds = n_rounds
        self.n_seen_lines = n_seen_lines
        self.u_addrs = u_addrs
        self.u_dense = u_dense
        self.u_write = u_write
        self.u_force = u_force
        self.u_nonleader = u_nonleader
        self.u_core = u_core          # first requester (event attribution)
        self.u_tid = u_tid            # owning tensor (exact under reuse)
        self.u_dups = u_dups          # merged-away duplicates per line
        self.round_off = round_off
        self.n_acc_round = n_acc_round
        self.flops_round = flops_round
        self.tll_addrs = tll_addrs
        self.tll_tids = tll_tids
        self.tll_tiles = tll_tiles
        self.tll_nacc = tll_nacc
        self.tll_off = tll_off
        # artifact-cache key ("<spec-fingerprint>-lb<N>") when this
        # lowering came from a fingerprinted trace; lets plans_for
        # persist its geometry plans too
        self.cache_key: Optional[str] = None
        self._plans: Dict[Tuple[int, bool], list] = {}
        self._tll_tags: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, trace: Trace, line_bytes: int, round_start: int = 0,
              round_stop: Optional[int] = None,
              dense_map: Optional[Dict[int, int]] = None,
              n_seen_lines: Optional[int] = None) -> "CompiledTrace":
        """Lower ``trace`` (or the round window ``[round_start,
        round_stop)`` of it) to the flat CSR arrays.

        A window build touches only the step records of its own rounds —
        the streaming path — and is bit-identical to the same rounds of
        the monolithic lowering: the MSHR merge and the lexsort both
        group by round, so no array element ever crosses a round
        boundary.  The dense seen-bitmap layout stays global
        (``n_seen_lines`` covers every tensor) so one bitmap spans all
        segments of a run.

        ``dense_map``/``n_seen_lines`` override the per-tensor dense
        offsets: the generator-driven replay lowering
        (``repro_torch.dataflows.stream``) recycles retired tensors' bitmap
        ranges, so its offsets come from an external allocator instead
        of the cumulative layout below (which would grow with every
        tensor ever declared).
        """
        if round_stop is None:
            round_stop = trace.n_rounds
        n_rounds = round_stop - round_start
        tensors = trace.tensors
        tr_lb = trace.line_bytes

        # dense "seen"-bitmap layout: one contiguous range per tensor
        if dense_map is not None:
            dense_off = dense_map
            n_seen = int(n_seen_lines)
        else:
            dense_off = {}
            n_seen = 0
            for tid, m in tensors.items():
                dense_off[tid] = n_seen
                n_seen += m.size_bytes // line_bytes

        # one record per bulk tile transfer (expanded to lines vectorized)
        p_round: List[int] = []
        p_start: List[int] = []      # first line's byte address
        p_k: List[int] = []          # lines in the tile
        p_dense0: List[int] = []     # first line's dense seen index
        p_write: List[bool] = []
        p_force: List[bool] = []
        p_nonlead: List[bool] = []
        p_core: List[int] = []
        p_tid: List[int] = []
        t_round: List[int] = []      # TLL feed, in issue order
        t_addr: List[int] = []
        t_tid: List[int] = []
        t_tile: List[int] = []
        t_nacc: List[int] = []
        flops_round = np.zeros(n_rounds, dtype=np.float64)

        nonleader = [not ldr for ldr in trace.core_is_leader]
        for r in range(round_start, round_stop):
            rloc = r - round_start          # window-relative round index
            for c, steps in enumerate(trace.core_steps):
                if r >= len(steps):
                    continue
                step = steps[r]
                flops_round[rloc] += step.flops
                for (tid, tile), is_store in (
                        [(ld, False) for ld in step.loads]
                        + [(s, True) for s in step.stores]):
                    meta = tensors[tid]
                    start = meta.base_addr + tile * meta.tile_bytes
                    p_round.append(rloc)
                    p_start.append(start)
                    p_k.append(meta.tile_bytes // tr_lb)
                    p_dense0.append(dense_off[tid]
                                    + (start - meta.base_addr) // line_bytes)
                    p_write.append(is_store)
                    p_force.append(meta.bypass_all)
                    p_nonlead.append(nonleader[c])
                    p_core.append(c)
                    p_tid.append(tid)
                    if not is_store and not meta.bypass_all:
                        t_round.append(rloc)
                        t_addr.append(meta.tile_last_line(tile, line_bytes))
                        t_tid.append(tid)
                        t_tile.append(tile)
                        t_nacc.append(meta.n_acc)

        k = np.asarray(p_k, dtype=np.int64)
        n_acc_total = int(k.sum()) if k.size else 0
        if n_acc_total:
            # expand tile records to per-line arrays (CSR expansion)
            rep = np.repeat(np.arange(k.size), k)
            within = np.arange(n_acc_total) - np.repeat(
                np.concatenate(([0], np.cumsum(k)[:-1])), k)
            a_round = np.asarray(p_round, dtype=np.int64)[rep]
            a_addr = (np.asarray(p_start, dtype=np.int64)[rep]
                      + within * tr_lb)
            a_dense = np.asarray(p_dense0, dtype=np.int64)[rep] + within
            a_write = np.asarray(p_write, dtype=bool)[rep]
            a_force = np.asarray(p_force, dtype=bool)[rep]
            a_nonlead = np.asarray(p_nonlead, dtype=bool)[rep]
            a_core = np.asarray(p_core, dtype=np.int64)[rep]
            a_tid = np.asarray(p_tid, dtype=np.int64)[rep]

            # per-round MSHR merge: stable sort by (round, addr); the first
            # element of each (round, addr) run is the first occurrence in
            # issue order, so seen/force/nonleader take its values while
            # write intent ORs over the whole run.
            order = np.lexsort((a_addr, a_round))
            s_round = a_round[order]
            s_addr = a_addr[order]
            starts = np.ones(n_acc_total, dtype=bool)
            starts[1:] = (s_round[1:] != s_round[:-1]) \
                | (s_addr[1:] != s_addr[:-1])
            start_idx = np.nonzero(starts)[0]
            u_addrs = s_addr[start_idx]
            u_round = s_round[start_idx]
            u_dense = a_dense[order][start_idx]
            u_force = a_force[order][start_idx]
            u_nonleader = a_nonlead[order][start_idx]
            u_core = a_core[order][start_idx]
            u_tid = a_tid[order][start_idx]
            u_write = np.maximum.reduceat(
                a_write[order].astype(np.int8), start_idx).astype(bool)
            u_dups = np.diff(np.append(start_idx, n_acc_total)) - 1
            round_off = np.searchsorted(u_round,
                                        np.arange(n_rounds + 1))
            n_acc_round = np.bincount(a_round, minlength=n_rounds)
        else:
            u_addrs = u_dense = np.empty(0, dtype=np.int64)
            u_write = u_force = u_nonleader = np.empty(0, dtype=bool)
            u_core = np.empty(0, dtype=np.int64)
            u_tid = np.empty(0, dtype=np.int64)
            u_dups = np.empty(0, dtype=np.int64)
            round_off = np.zeros(n_rounds + 1, dtype=np.int64)
            n_acc_round = np.zeros(n_rounds, dtype=np.int64)

        tll_off = np.concatenate((
            [0], np.cumsum(np.bincount(np.asarray(t_round, dtype=np.int64),
                                       minlength=n_rounds))
        )).astype(np.int64)
        return cls(
            line_bytes, n_rounds, n_seen,
            u_addrs, u_dense, u_write, u_force, u_nonleader, u_core,
            u_tid, u_dups,
            round_off.astype(np.int64), n_acc_round.astype(np.int64),
            flops_round,
            np.asarray(t_addr, dtype=np.int64),
            np.asarray(t_tid, dtype=np.int64),
            np.asarray(t_tile, dtype=np.int64),
            np.asarray(t_nacc, dtype=np.int64),
            tll_off,
        )

    # ------------------------------------------------------------------
    def slice_rounds(self, round_start: int,
                     round_stop: int) -> "CompiledTrace":
        """Zero-copy round-window view: every per-line array is grouped
        by round, so a segment is literally a slice of the monolithic
        arrays with the CSR offsets rebased.  Used by
        :meth:`Trace.compiled_segments` when the full lowering is
        already cached."""
        a0 = int(self.round_off[round_start])
        a1 = int(self.round_off[round_stop])
        t0 = int(self.tll_off[round_start])
        t1 = int(self.tll_off[round_stop])
        return CompiledTrace(
            self.line_bytes, round_stop - round_start, self.n_seen_lines,
            self.u_addrs[a0:a1], self.u_dense[a0:a1], self.u_write[a0:a1],
            self.u_force[a0:a1], self.u_nonleader[a0:a1],
            self.u_core[a0:a1], self.u_tid[a0:a1], self.u_dups[a0:a1],
            self.round_off[round_start:round_stop + 1] - a0,
            self.n_acc_round[round_start:round_stop],
            self.flops_round[round_start:round_stop],
            self.tll_addrs[t0:t1], self.tll_tids[t0:t1],
            self.tll_tiles[t0:t1], self.tll_nacc[t0:t1],
            self.tll_off[round_start:round_stop + 1] - t0,
        )

    # ------------------------------------------------------------------
    def tll_tags_for(self, geom) -> np.ndarray:
        """Cache tags of the TLL feed for one geometry, cached like
        :meth:`plans_for` so a policy sweep computes them once."""
        tags = self._tll_tags.get(geom.num_sets)
        if tags is None:
            tags = (self.tll_addrs // self.line_bytes) // geom.num_sets
            self._tll_tags[geom.num_sets] = tags
        return tags

    # ------------------------------------------------------------------
    def plans_for(self, geom) -> list:
        """Per-round :class:`~repro_torch.core.cache.AccessPlan` list for one
        cache geometry (set mapping + same-set pass splitting), cached so
        every policy of a sweep shares it.  Entries are ``None`` for empty
        rounds."""
        key = (geom.num_sets, geom.hash_sets)
        plans = self._plans.get(key)
        if plans is not None:
            return plans
        from .cache import AccessPlan

        sets_all = geom.set_of(self.u_addrs)
        tags_all = geom.tag_of(self.u_addrs)
        n = self.u_addrs.shape[0]
        pk = None
        pass_idx = None
        if self.cache_key is not None:
            from ..dataflows import artifacts
            pk = artifacts.plan_key(self.cache_key, geom.num_sets,
                                    geom.hash_sets)
            pass_idx = artifacts.load_plan_pass_idx(pk)
            if pass_idx is not None and pass_idx.shape[0] != n:
                pass_idx = None
        if pass_idx is None:
            u_round = np.repeat(np.arange(self.n_rounds),
                                np.diff(self.round_off))
            # occurrence rank of each line's set within its round
            # (stable): rank k goes into same-set pass k, replicating
            # access_burst
            order = np.lexsort((sets_all, u_round))
            s_round = u_round[order]
            s_sets = sets_all[order]
            starts = np.ones(n, dtype=bool)
            if n:
                starts[1:] = (s_round[1:] != s_round[:-1]) \
                    | (s_sets[1:] != s_sets[:-1])
            run_start = np.maximum.accumulate(
                np.where(starts, np.arange(n), 0))
            pass_sorted = np.arange(n) - run_start
            pass_idx = np.empty(n, dtype=np.int64)
            pass_idx[order] = pass_sorted
            if pk is not None:
                from ..dataflows import artifacts
                artifacts.store_plan_pass_idx(pk, pass_idx)

        plans = []
        for r in range(self.n_rounds):
            a0, a1 = self.round_off[r], self.round_off[r + 1]
            if a0 == a1:
                plans.append(None)
                continue
            pi = pass_idx[a0:a1]
            mp = int(pi.max())
            passes = None if mp == 0 else [
                np.nonzero(pi == p)[0] for p in range(mp + 1)]
            plans.append(AccessPlan(self.u_addrs[a0:a1], sets_all[a0:a1],
                                    passes, tags_all[a0:a1]))
        self._plans[key] = plans
        return plans


# ---------------------------------------------------------------------------
# Dataflow builders: thin wrappers over the declarative IR (DESIGN.md §8).
# The hand-written builders these entry points used to contain live on as
# IR spec builders in ``repro_torch.dataflows``; tests/test_dataflow_ir.py pins
# the lowered traces bit-identical to the pre-refactor implementations.
# ---------------------------------------------------------------------------
def build_fa2_trace(wl: AttnWorkload, n_cores: int = 16) -> Trace:
    """FlashAttention-2 GQA trace (temporal or spatial group allocation,
    §VI-C; multi-batch for the §VI-F DBP scenario)."""
    from ..dataflows import fa2_spec, lower_to_trace
    return lower_to_trace(fa2_spec(wl, n_cores))


def build_matmul_trace(m: int, n: int, k: int, tile: int = 128,
                       n_cores: int = 16, dtype_bytes: int = 1) -> Trace:
    """Tiled MatMul trace of Fig. 2(a), C-tiles round-robin over cores."""
    from ..dataflows import lower_to_trace, matmul_spec
    return lower_to_trace(matmul_spec(m, n, k, tile=tile, n_cores=n_cores,
                                      dtype_bytes=dtype_bytes))


# ---------------------------------------------------------------------------
# Closed-form dataflow counts (consumed by the analytical model, §V)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DataflowCounts:
    """All quantities of Eq. 1–3 that derive from the dataflow alone."""

    name: str
    line_bytes: int
    # line-granular request counts, totalled over all cores:
    n_kv_accesses: int          # total K/V line requests (reuse carriers)
    n_kv_distinct: int          # distinct K/V lines (cold misses)
    n_bypass_lines: int         # Q/O traffic (always DRAM, bursty)
    n_intercore_reuse: int      # K/V requests that are inter-core reuses
    s_work_active: int          # active working set, bytes (KV of live groups)
    s_work_total: int           # all K/V bytes of one batch
    flops_total: float
    n_batches: int
    n_rounds: int               # lockstep rounds (scheduling overhead term)
    # IR-derived reuse-distance profile (repro_torch.dataflows.reuse), consumed
    # by the analytical model's ``model="profile"`` path.  Excluded from
    # equality so counts stay pinnable against the frozen closed-form
    # oracles; None when the producer skipped the schedule walk (the
    # model then falls back to the §V-C closed forms).
    reuse_profile: Optional[object] = field(default=None, compare=False,
                                            repr=False)

    @property
    def n_temporal_reuse(self) -> int:
        """K/V requests that revisit a line already streamed this pass."""
        return self.n_kv_accesses - self.n_kv_distinct - self.n_intercore_reuse


def fa2_counts(wl: AttnWorkload, n_cores: int = 16,
               with_profile: bool = False) -> DataflowCounts:
    """Closed-form FA2 request counts, derived from the same IR spec the
    trace is lowered from (pinned bit-identical to the former hand-kept
    formula by tests/test_dataflow_ir.py).

    ``with_profile`` additionally attaches the reuse-distance profile
    (``model="profile"`` input).  Off by default here: this historical
    entry point feeds the closed-form figure sweeps, some at
    long-context shapes where the schedule walk is not free — the IR
    path (``repro_torch.dataflows.lower_to_counts``) attaches it by default.
    """
    from ..dataflows import fa2_spec, lower_to_counts
    return lower_to_counts(fa2_spec(wl, n_cores), with_profile=with_profile)
