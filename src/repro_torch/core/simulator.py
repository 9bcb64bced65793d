"""Trace-driven, burst-synchronous cycle-level simulator (paper §VI-B).

System model follows Table IV: 16 cores (1 vector/tile engine + private
SPM each), a 32-slice shared LLC (assoc 8, MSHR per slice), DDR5-3200
×16-channel-class main memory, 2 GHz.  Cores execute bulk tile transfers
and compute in lockstep *rounds* (one dataflow inner step per round); the
LLC is simulated at cache-line granularity with full replacement/bypass
state (see ``cache.py``), while time is accounted per round with the
paper's bottleneck/overlap semantics (Eq. 1–2):

    t_hit  = max(n_hit  / (N·ipc_mem),  n_hit  / v_LLC)
    t_cold = max(n_cold / (N·ipc_mem),  n_cold / v_LLC,  n'_cold / bw_cold)
    t_cf   = max(n_cf   / (N·ipc_mem),  n_cf   / v_LLC,  n'_cf   / bw_cf)
    t      = t_hit + t_cold + max(t_comp, t_cf)

Cold misses occur in bursts and saturate DRAM at sequential efficiency;
conflict/capacity misses are dispersed and overlap with compute.  The
difference from the analytical model (``analytical.py``) is that all
``n_*`` here come from the *simulated cache state* (real evictions, dead
blocks, per-slice gears), not from closed forms.

Execution engines:

* the default **compiled** engine slices the flat round-indexed arrays of
  a :class:`~repro_torch.core.traces.CompiledTrace` (built once per trace and
  shared across policies — see :func:`run_policies` for batch sweeps);
* the **step** engine re-walks the Python ``Step`` lists per round.  It
  is the original reference implementation, kept as the oracle for the
  compiled path (``tests/test_compiled_trace.py`` asserts bit-identical
  counters) — both engines produce byte-identical ``SimResult``\\ s.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
from dataclasses import replace
from typing import Dict
from typing import Iterable
from typing import List
from typing import Optional
from typing import Tuple
from typing import Union

import numpy as np

from . import cache as C
from .cache import CacheGeometry
from .cache import SharedLLC
from .events import EV_MSHR
from .events import EventSink
from .policies import PolicyConfig
from .policies import named_policy
from .tmu import TMU
from .tmu import TMUParams
from .traces import Trace


@dataclass(frozen=True)
class SimConfig:
    """Hardware configuration (paper Table IV + DESIGN.md §7.3)."""

    n_cores: int = 16
    freq_ghz: float = 2.0
    line_bytes: int = 128
    llc_bytes: int = 4 * 2**20
    llc_assoc: int = 8
    llc_slices: int = 32
    ipc_mem: float = 1.0              # SPM<->LLC lines issued /cycle/core
    v_llc: float = 32.0               # LLC lines served /cycle (all slices)
    core_flops_per_cycle: float = 16384.0  # 64x128 MAC tile engine per core
    dram_bw_bytes_per_cycle: float = 204.8  # DDR5-3200 x16ch @2GHz
    dram_eff_seq: float = 0.90        # burst (cold) efficiency
    dram_eff_rand: float = 0.55       # dispersed (conflict) efficiency
    round_overhead_cycles: float = 8.0
    # TMU hardware parameters (Table III)
    tmu_tensor_entries: int = 4096    # functional-model capacity; the RTL
    tmu_tile_entries: int = 4096      # uses 8/256 with time-multiplexed
    dead_fifo_depth: int = 16         # registration per operator
    # opt-in structured event telemetry (repro_torch.core.events): every run
    # collects the canonical per-round event stream into a fresh
    # EventSink attached to SimResult.events.  Off by default — the
    # emission sites are fully skipped (sweep_perf.py gates the
    # overhead-when-off at ~0%).
    trace_events: bool = False

    @property
    def dram_lines_per_cycle(self) -> float:
        return self.dram_bw_bytes_per_cycle / self.line_bytes


@dataclass
class SimResult:
    name: str
    policy: str
    cycles: float
    hits: int
    mshr_hits: int
    cold_misses: int
    conflict_misses: int
    bypassed: int
    dram_lines: int
    writebacks: int
    dead_evictions: int
    flops: float
    freq_ghz: float = 2.0
    history: Dict[str, np.ndarray] = field(default_factory=dict)
    #: per-tenant counter attribution on multi-tenant composite traces
    #: (DESIGN.md §8.4): tenant name → {hits, mshr_hits, cold_misses,
    #: conflict_misses, bypassed, writebacks}; each counter sums to the
    #: matching global field (conservation pinned by tests).  Empty on
    #: single-tenant traces.
    tenants: Dict[str, Dict[str, int]] = field(default_factory=dict)
    #: per-round metric series (recorded with ``record_history``):
    #: ``round`` (global index of each non-empty round) plus aligned
    #: ``hits``/``misses``/``bypassed``/``writebacks`` int64 series and,
    #: on multi-tenant traces, ``tenant_*`` (rounds, tenants) matrices.
    #: ``repro_torch.core.events.timeline_digest`` hashes it deterministically
    #: (suite_bench records the digest per scenario).
    timeline: Dict[str, np.ndarray] = field(default_factory=dict)
    #: the run's EventSink when event tracing was on (SimConfig.
    #: trace_events or an explicit ``events=`` argument); None otherwise
    events: Optional[EventSink] = None

    @property
    def accesses(self) -> int:
        return (self.hits + self.mshr_hits + self.cold_misses
                + self.conflict_misses)

    @property
    def hit_rate(self) -> float:
        """LLC + MSHR hits over all requests (the paper treats both hit
        classes in a single v_LLC term, §V-C)."""
        served = self.hits + self.mshr_hits
        return served / self.accesses if self.accesses else 0.0

    @property
    def time_ms(self) -> float:
        return self.cycles / (self.freq_ghz * 1e6)

    def summary(self) -> str:
        return (f"{self.name:34s} {self.policy:24s} "
                f"cycles={self.cycles:12.0f} hit={self.hit_rate:6.3f} "
                f"dram_lines={self.dram_lines}")


class _RoundLedger:
    """Per-round accounting shared by both engines.

    One implementation of the outcome-class tallies, per-round
    write-back delta, Eq. 1–2 wall-clock advance, history recording, and
    per-tenant counter attribution — extracted so the compiled and step
    engines cannot drift apart (they are pinned bit-identical, including
    the per-tenant counters, by ``tests/test_compiled_trace.py``).

    Engine contract per non-empty round: ``begin_round()`` before the
    LLC access, then ``end_round(codes, addrs, dup_counts, flops)`` with
    the merged per-line outcome codes, the merged line addresses, and
    the number of MSHR-merged duplicates per line (plus the merged
    per-line owning-tensor ids when an event sink is attached, so MSHR
    events stay exactly attributed under address reuse).  Empty rounds
    call ``idle_round()``.
    """

    def __init__(self, sim: "Simulator", llc: SharedLLC, trace: Trace,
                 record_history: bool, sink: Optional[EventSink] = None):
        self.cfg = sim.cfg
        self.llc = llc
        self.record_history = record_history
        self.sink = sink
        self.clock = 0.0
        self.mshr_hits = 0
        self.dram_lines = 0
        self.flops = 0.0
        self.hist_cycles: List[float] = []
        self.hist_hits: List[int] = []
        self.hist_acc: List[int] = []
        self.hist_gear: List[float] = []
        self.hist_tgear: List[np.ndarray] = []
        # timeline series (one entry per non-empty round)
        self.tl_round: List[int] = []
        self.tl_miss: List[int] = []
        self.tl_byp: List[int] = []
        self.tl_wb: List[int] = []
        self.tl_t_rows: List[np.ndarray] = []   # (tenants, 4) per round
        self.tenant_names = trace.tenant_names
        regions = trace.tenant_region_starts()
        if regions is not None:
            self._t_starts, self._t_ids = regions
            n_t = trace.n_tenants
            self.t_hits = np.zeros(n_t, dtype=np.int64)
            self.t_mshr = np.zeros(n_t, dtype=np.int64)
            self.t_cold = np.zeros(n_t, dtype=np.int64)
            self.t_cf = np.zeros(n_t, dtype=np.int64)
            self.t_byp = np.zeros(n_t, dtype=np.int64)
        else:
            self._t_starts = None
        self._wb_before = 0
        self._t_wb_before: Optional[np.ndarray] = None
        # the ledger owns the global round index: it persists across
        # streaming segments, so event rounds stay monotone and segment
        # concatenation is bit-identical to a monolithic run
        self._r = -1

    # -- engine hooks ---------------------------------------------------
    def idle_round(self) -> None:
        self._r += 1
        self.clock += self.cfg.round_overhead_cycles

    def begin_round(self) -> None:
        self._r += 1
        if self.sink is not None:
            self.sink.begin_round(self._r)
        self._wb_before = self.llc.stats["writebacks"]
        if (self.record_history and self._t_starts is not None
                and self.llc.tenant_wb is not None):
            self._t_wb_before = self.llc.tenant_wb.copy()

    def end_round(self, codes: np.ndarray, addrs: np.ndarray,
                  dup_counts: np.ndarray, flops_round: float,
                  tids: Optional[np.ndarray] = None) -> None:
        if self.sink is not None:
            d = np.nonzero(dup_counts > 0)[0]
            if d.shape[0]:
                self.sink.emit_lines(EV_MSHR, addrs[d],
                                     aux=dup_counts[d].astype(np.int64),
                                     tensors=None if tids is None
                                     else tids[d])
        n_dups = int(dup_counts.sum())
        self.mshr_hits += n_dups
        n_hit = int((codes == C.HIT).sum()) + n_dups
        cold = int(((codes == C.COLD_MISS)
                    | (codes == C.BYPASSED_COLD)).sum())
        cf = int(((codes == C.CONFLICT_MISS)
                  | (codes == C.BYPASSED_CONFLICT)).sum())
        wb_round = self.llc.stats["writebacks"] - self._wb_before
        self.dram_lines += cold + cf + wb_round
        self.flops += flops_round

        if self._t_starts is not None:
            tens = self._t_ids[np.maximum(
                np.searchsorted(self._t_starts, addrs, side="right") - 1,
                0)]
            n_t = self.t_hits.shape[0]
            inc_hits = np.bincount(tens[codes == C.HIT], minlength=n_t)
            inc_mshr = np.bincount(tens, weights=dup_counts,
                                   minlength=n_t).astype(np.int64)
            inc_cold = np.bincount(
                tens[(codes == C.COLD_MISS)
                     | (codes == C.BYPASSED_COLD)], minlength=n_t)
            inc_cf = np.bincount(
                tens[(codes == C.CONFLICT_MISS)
                     | (codes == C.BYPASSED_CONFLICT)], minlength=n_t)
            inc_byp = np.bincount(
                tens[(codes == C.BYPASSED_COLD)
                     | (codes == C.BYPASSED_CONFLICT)], minlength=n_t)
            self.t_hits += inc_hits
            self.t_mshr += inc_mshr
            self.t_cold += inc_cold
            self.t_cf += inc_cf
            self.t_byp += inc_byp
            if self.record_history:
                t_wb = (self.llc.tenant_wb - self._t_wb_before
                        if self._t_wb_before is not None
                        else np.zeros(n_t, dtype=np.int64))
                self.tl_t_rows.append(np.stack(
                    [inc_hits + inc_mshr, inc_cold + inc_cf, inc_byp,
                     t_wb]))

        self.clock += self._round_time(n_hit, cold, cf, cold,
                                       cf + wb_round, flops_round)
        self.llc.tick(self.clock)

        if self.record_history:
            self.hist_cycles.append(self.clock)
            self.hist_hits.append(n_hit)
            self.hist_acc.append(n_hit + cold + cf)
            self.tl_round.append(self._r)
            self.tl_miss.append(cold + cf)
            self.tl_byp.append(int((codes >= C.BYPASSED_COLD).sum()))
            self.tl_wb.append(wb_round)
            ctl = self.llc.controller
            if ctl is not None:
                self.hist_gear.append(float(ctl.gear.mean()))
                if ctl.n_tenants > 1:
                    self.hist_tgear.append(ctl.gear.mean(axis=1))

    # -- result assembly ------------------------------------------------
    def result(self, trace: Trace, policy_name: str,
               freq_ghz: float) -> SimResult:
        llc = self.llc
        history: Dict[str, np.ndarray] = {}
        if self.record_history:
            history = {
                "cycles": np.asarray(self.hist_cycles),
                "hits": np.asarray(self.hist_hits, dtype=np.int64),
                "accesses": np.asarray(self.hist_acc, dtype=np.int64),
            }
            if self.hist_gear:
                history["gear"] = np.asarray(self.hist_gear)
            if self.hist_tgear:
                # (rounds, tenants) mean gear per tenant's feedback loop
                history["tenant_gear"] = np.asarray(self.hist_tgear)

        timeline: Dict[str, np.ndarray] = {}
        if self.record_history:
            timeline = {
                "round": np.asarray(self.tl_round, dtype=np.int64),
                "hits": np.asarray(self.hist_hits, dtype=np.int64),
                "misses": np.asarray(self.tl_miss, dtype=np.int64),
                "bypassed": np.asarray(self.tl_byp, dtype=np.int64),
                "writebacks": np.asarray(self.tl_wb, dtype=np.int64),
            }
            if self.hist_gear:
                timeline["gear"] = np.asarray(self.hist_gear)
            if self.tl_t_rows:
                # (rounds, tenants) series, split out of the per-round
                # (tenants, 4) stacks
                t = np.asarray(self.tl_t_rows, dtype=np.int64)
                timeline["tenant_hits"] = t[:, 0]
                timeline["tenant_misses"] = t[:, 1]
                timeline["tenant_bypassed"] = t[:, 2]
                timeline["tenant_writebacks"] = t[:, 3]

        tenants: Dict[str, Dict[str, int]] = {}
        if self._t_starts is not None:
            wb = llc.tenant_wb if llc.tenant_wb is not None else \
                np.zeros_like(self.t_hits)
            for i, name in enumerate(self.tenant_names):
                tenants[name] = {
                    "hits": int(self.t_hits[i]),
                    "mshr_hits": int(self.t_mshr[i]),
                    "cold_misses": int(self.t_cold[i]),
                    "conflict_misses": int(self.t_cf[i]),
                    "bypassed": int(self.t_byp[i]),
                    "writebacks": int(wb[i]),
                }

        return SimResult(
            name=trace.name, policy=policy_name, cycles=self.clock,
            hits=llc.stats["hits"], mshr_hits=self.mshr_hits,
            cold_misses=llc.stats["cold_misses"],
            conflict_misses=llc.stats["conflict_misses"],
            bypassed=llc.stats["bypassed"],
            dram_lines=self.dram_lines,
            writebacks=llc.stats["writebacks"],
            dead_evictions=llc.stats["dead_evictions"],
            flops=self.flops, freq_ghz=freq_ghz, history=history,
            tenants=tenants, timeline=timeline, events=self.sink,
        )

    # ------------------------------------------------------------------
    def _round_time(self, n_hit: int, n_cold: int, n_cf: int,
                    dram_cold: int, dram_cf: int, flops: float) -> float:
        cfg = self.cfg
        issue = cfg.n_cores * cfg.ipc_mem
        bw = cfg.dram_lines_per_cycle
        t_hit = max(n_hit / issue, n_hit / cfg.v_llc) if n_hit else 0.0
        t_cold = max(n_cold / issue, n_cold / cfg.v_llc,
                     dram_cold / (cfg.dram_eff_seq * bw)) if n_cold else 0.0
        t_cf = max(n_cf / issue, n_cf / cfg.v_llc,
                   dram_cf / (cfg.dram_eff_rand * bw)) if (n_cf or dram_cf) \
            else 0.0
        t_comp = flops / (cfg.n_cores * cfg.core_flops_per_cycle)
        return t_hit + t_cold + max(t_comp, t_cf) + cfg.round_overhead_cycles


class Simulator:
    """Run one trace under one policy."""

    def __init__(self, cfg: SimConfig, policy: PolicyConfig,
                 tmu_params: Optional[TMUParams] = None):
        self.cfg = cfg
        self.policy = policy
        self.tmu_params = tmu_params or TMUParams(b_bits=policy.b_bits)

    # ------------------------------------------------------------------
    def _fresh_state(self, trace: Trace,
                     sink: Optional[EventSink] = None
                     ) -> Tuple[CacheGeometry, TMU, SharedLLC]:
        cfg = self.cfg
        geom = CacheGeometry(cfg.llc_bytes, cfg.line_bytes, cfg.llc_assoc,
                             cfg.llc_slices)
        tmu = TMU(line_bytes=cfg.line_bytes,
                  tensor_entries=cfg.tmu_tensor_entries,
                  tile_entries=cfg.tmu_tile_entries,
                  dead_fifo_depth=cfg.dead_fifo_depth,
                  params=self.tmu_params)
        tmu.register_many(trace.tensors.values())
        llc = SharedLLC(geom, self.policy, tmu=tmu,
                        tenant_map=trace.tenant_region_starts())
        if sink is not None:
            sink.bind(trace, geom)
            llc.sink = sink
            tmu.sink = sink
            if llc.controller is not None:
                llc.controller.sink = sink
        return geom, tmu, llc

    def _resolve_sink(self,
                      events: Optional[EventSink]) -> Optional[EventSink]:
        if events is not None:
            return events
        return EventSink() if self.cfg.trace_events else None

    def run(self, trace: Trace, record_history: bool = True,
            *, engine: str = "compiled",
            chunk_lines: Optional[int] = None,
            events: Optional[EventSink] = None) -> SimResult:
        """Simulate ``trace`` under this simulator's policy.

        ``engine="compiled"`` (default) drives the cached
        :class:`~repro_torch.core.traces.CompiledTrace`; ``engine="steps"``
        re-walks the Python step lists (reference oracle).
        ``chunk_lines`` switches the compiled engine to streaming mode:
        the trace is lowered in whole-round CSR segments of at most that
        many pre-merge line requests, fed incrementally to the same
        round loop — bit-identical counters, bounded lowering memory.
        ``events`` attaches an :class:`~repro_torch.core.events.EventSink`
        (one per run) that collects the canonical event stream;
        ``SimConfig.trace_events=True`` creates one implicitly.  The
        sink comes back on ``SimResult.events``.
        """
        if self.cfg.line_bytes != trace.line_bytes:
            # traces bake line granularity into their addresses; a
            # mismatched cache-line size silently corrupts the seen
            # bitmaps (and used to IndexError deep in the round loop)
            raise ValueError(
                f"SimConfig.line_bytes={self.cfg.line_bytes} does not "
                f"match trace line_bytes={trace.line_bytes}")
        if engine == "compiled":
            return self._run_compiled(trace, record_history, chunk_lines,
                                      events)
        if engine == "steps":
            if chunk_lines is not None:
                raise ValueError("chunk_lines requires engine='compiled'")
            return self._run_steps(trace, record_history, events)
        raise ValueError(f"unknown engine {engine!r}")

    # ------------------------------------------------------------------
    # compiled engine: slice flat per-round arrays
    # ------------------------------------------------------------------
    def _run_compiled(self, trace: Trace, record_history: bool,
                      chunk_lines: Optional[int] = None,
                      events: Optional[EventSink] = None) -> SimResult:
        if chunk_lines is None:
            segments = (trace.compiled(self.cfg.line_bytes),)
        else:
            segments = trace.compiled_segments(self.cfg.line_bytes,
                                               chunk_lines)
        return self.run_segments(trace, segments, record_history,
                                 events=events)

    def run_segments(self, trace: Trace, segments,
                     record_history: bool = True, *,
                     events: Optional[EventSink] = None) -> SimResult:
        """Streaming entry point: consume :class:`CompiledTrace`
        segments incrementally against one persistent cache/TMU/ledger
        state.  Cache state, the global seen bitmap, and the gear
        controller all persist across segment boundaries, so the result
        is bit-identical to a monolithic run — this is the hook the
        serving-replay path (``repro_torch.serve``) uses to drive traces too
        large to materialize up front.  An attached event sink persists
        the same way: the round index lives in the ledger, so segment-
        by-segment emission concatenates bit-identically to the
        monolithic event stream."""
        cfg = self.cfg
        sink = self._resolve_sink(events)
        geom, tmu, llc = self._fresh_state(trace, sink)
        gqa = self.policy.gqa_variant
        led = _RoundLedger(self, llc, trace, record_history, sink)
        seen = np.zeros(0, dtype=bool)
        for ct in segments:
            # the dense seen-bitmap layout is global across segments;
            # grow (never shrink) when a segment raises the high-water
            # mark — new lines start unseen, exactly like a monolithic
            # allocation would
            seen = _grow_seen(seen, ct.n_seen_lines)
            self._consume_segment(ct, geom, tmu, llc, led, seen, gqa)
        return led.result(trace, self.policy.name, cfg.freq_ghz)

    def run_stream(self, stream, *, name: str = "replay",
                   record_history: bool = True,
                   events: Optional[EventSink] = None) -> SimResult:
        """Consume an *open-ended* stream of
        :class:`~repro_torch.dataflows.stream.ReplaySegment` items — segments
        whose tensor population changes over time (the serving-replay
        path, DESIGN.md §11).

        Unlike :meth:`run_segments`, which assumes one fixed trace with
        all tensors registered up front, each segment here carries its
        own TMU registrations (``new_tensors``, applied before the
        segment's rounds), retirements (``clear_tids``, applied after —
        the paper's second specialized instruction at request
        completion), and recycled seen-bitmap ranges (``seen_resets``,
        zeroed before, so a reused dense range observes cold misses
        exactly as a fresh monolithic allocation would).  Cache, gear,
        ledger, and dead-FIFO state persist across segments, so on a
        small seed the counters and the raw event stream are
        bit-identical to lowering the whole replay into one
        ``DataflowSpec`` and calling :meth:`run`.
        """
        cfg = self.cfg
        sink = self._resolve_sink(events)
        n_cores = cfg.n_cores
        header = Trace(name=name, tensors={},
                       core_steps=[[] for _ in range(n_cores)],
                       core_group=[-1] * n_cores,
                       core_is_leader=[True] * n_cores,
                       line_bytes=cfg.line_bytes)
        geom, tmu, llc = self._fresh_state(header, sink)
        gqa = self.policy.gqa_variant
        led = _RoundLedger(self, llc, header, record_history, sink)
        seen = np.zeros(0, dtype=bool)
        for seg in stream:
            seen = _grow_seen(seen, seg.n_seen_lines)
            for s0, s1 in seg.seen_resets:
                seen[s0:s1] = False
            if sink is not None and seg.clear_tids:
                # a pooled allocator may hand a retiring tensor's region
                # to a tensor declared in this same segment window, so
                # the retirements must leave the live-region map before
                # the new registrations are overlap-checked (the actual
                # TMU clear still happens after the segment's rounds)
                sink.release_tensors(seg.clear_tids)
            if seg.new_tensors:
                tmu.register_many(seg.new_tensors)
                if sink is not None:
                    sink.register_tensors(
                        seg.new_tensors,
                        retiring_tids=frozenset(seg.clear_tids))
            self._consume_segment(seg.ct, geom, tmu, llc, led, seen, gqa)
            for tid in seg.clear_tids:
                tmu.clear(tid)
        return led.result(header, self.policy.name, cfg.freq_ghz)

    def _consume_segment(self, ct, geom, tmu, llc, led, seen,
                         gqa) -> None:
        plans = ct.plans_for(geom)
        tll_tags = ct.tll_tags_for(geom)   # per-geometry, sweep-shared
        round_off = ct.round_off
        tll_off = ct.tll_off
        sink = led.sink
        for r in range(ct.n_rounds):
            a0, a1 = round_off[r], round_off[r + 1]
            if a0 == a1:
                led.idle_round()
                continue

            # contention only gates gqa eligibility; reading it has no
            # side effects, so non-gqa policies skip the check
            contended = (gqa and llc.controller is not None
                         and bool(llc.controller.contended().any()))
            sel = slice(a0, a1)
            dense = ct.u_dense[sel]
            seen_b = seen[dense]           # fancy indexing → fresh copy
            seen[dense] = True
            elig = (ct.u_nonleader[sel] & contended) if gqa else True

            led.begin_round()
            tids = ct.u_tid[sel] if sink is not None else None
            codes = llc.access_planned(plans[r],
                                       seen_before=seen_b,
                                       is_write=ct.u_write[sel],
                                       bypass_eligible=elig,
                                       force_bypass=ct.u_force[sel],
                                       cores=ct.u_core[sel]
                                       if sink is not None else None,
                                       tids=tids)
            t0, t1 = tll_off[r], tll_off[r + 1]
            if t1 > t0:
                tmu.on_access_batch(ct.tll_tids[t0:t1], ct.tll_tiles[t0:t1],
                                    tll_tags[t0:t1], ct.tll_nacc[t0:t1])
            led.end_round(codes, ct.u_addrs[sel], ct.u_dups[sel],
                          float(ct.flops_round[r]), tids=tids)

    # ------------------------------------------------------------------
    # step engine: reference implementation over Python Step lists
    # ------------------------------------------------------------------
    def _run_steps(self, trace: Trace, record_history: bool,
                   events: Optional[EventSink] = None) -> SimResult:
        cfg = self.cfg
        sink = self._resolve_sink(events)
        geom, tmu, llc = self._fresh_state(trace, sink)

        # per-tensor "ever fetched" bitmaps for cold/conflict classification
        seen: Dict[int, np.ndarray] = {
            tid: np.zeros(m.size_bytes // cfg.line_bytes, dtype=bool)
            for tid, m in trace.tensors.items()
        }

        n_rounds = trace.n_rounds
        led = _RoundLedger(self, llc, trace, record_history, sink)

        tensors = trace.tensors
        line_b = cfg.line_bytes

        for r in range(n_rounds):
            addrs_parts: List[np.ndarray] = []
            seen_parts: List[np.ndarray] = []
            force_parts: List[np.ndarray] = []
            elig_parts: List[np.ndarray] = []
            write_parts: List[np.ndarray] = []
            core_parts: List[np.ndarray] = []      # only when tracing
            tid_parts: List[np.ndarray] = []       # only when tracing
            # (tensor_id, tile, tag, n_acc) — resolved here, not by
            # address, so TLL accounting stays exact when a pooled
            # allocator recycles address ranges across tensors
            tll_calls: List[Tuple[int, int, int, int]] = []
            flops_round = 0.0

            contended = (llc.controller is not None
                         and bool(llc.controller.contended().any()))

            for c, steps in enumerate(trace.core_steps):
                if r >= len(steps):
                    continue
                step = steps[r]
                flops_round += step.flops
                # gqa_bypass: only non-leader ("slower") cores bypass, and
                # only when the LLC is contended (paper §IV-E).
                if self.policy.gqa_variant:
                    eligible = (not trace.core_is_leader[c]) and contended
                else:
                    eligible = True
                for (tid, tile), is_store in (
                        [(ld, False) for ld in step.loads]
                        + [(s, True) for s in step.stores]):
                    meta = tensors[tid]
                    lines = trace.tile_lines(tid, tile)
                    k = lines.shape[0]
                    idx0 = (lines[0] - meta.base_addr) // line_b
                    sv = seen[tid][idx0:idx0 + k]
                    addrs_parts.append(lines)
                    seen_parts.append(sv.copy())
                    sv[:] = True
                    force_parts.append(
                        np.full(k, meta.bypass_all, dtype=bool))
                    elig_parts.append(np.full(k, eligible, dtype=bool))
                    write_parts.append(np.full(k, is_store, dtype=bool))
                    if sink is not None:
                        core_parts.append(np.full(k, c, dtype=np.int64))
                        tid_parts.append(np.full(k, tid, dtype=np.int64))
                    if not is_store and not meta.bypass_all:
                        tll_addr = meta.tile_last_line(tile, line_b)
                        tll_calls.append(
                            (tid, tile,
                             int(geom.tag_of(np.int64(tll_addr))),
                             meta.n_acc))

            if not addrs_parts:
                led.idle_round()
                continue

            addrs = np.concatenate(addrs_parts)
            seen_b = np.concatenate(seen_parts)
            force_b = np.concatenate(force_parts)
            elig_b = np.concatenate(elig_parts)
            write_b = np.concatenate(write_parts)

            # MSHR merge: same-line requests issued in the same round are
            # merged into one in-flight fill — policy-independent, even for
            # bypassed lines (an MSHR entry exists for the duration of the
            # DRAM fetch whether or not the fill allocates).  Only the
            # first occurrence touches the cache state, but write intent is
            # OR-ed over the duplicates so a load+store merge still dirties
            # the line (writeback accounting).
            u_addrs, first_idx, inv, counts = np.unique(
                addrs, return_index=True, return_inverse=True,
                return_counts=True)
            write_m = np.bincount(inv, weights=write_b,
                                  minlength=first_idx.shape[0]) > 0

            led.begin_round()
            # first merged occurrence keeps its requester/owner,
            # matching the compiled lowering's u_core/u_tid
            tids_m = (np.concatenate(tid_parts)[first_idx]
                      if sink is not None else None)
            codes = llc.access_burst(
                addrs[first_idx],
                seen_before=seen_b[first_idx],
                is_write=write_m,
                bypass_eligible=elig_b[first_idx],
                force_bypass=force_b[first_idx],
                cores=np.concatenate(core_parts)[first_idx]
                if sink is not None else None,
                tids=tids_m)

            if tll_calls:
                t_tid, t_tile, t_tag, t_nacc = zip(*tll_calls)
                tmu.on_access_batch(
                    np.asarray(t_tid, dtype=np.int64),
                    np.asarray(t_tile, dtype=np.int64),
                    np.asarray(t_tag, dtype=np.int64),
                    np.asarray(t_nacc, dtype=np.int64))

            led.end_round(codes, u_addrs, counts - 1, flops_round,
                          tids=tids_m)

        return led.result(trace, self.policy.name, cfg.freq_ghz)


def _grow_seen(seen: np.ndarray, n_lines: int) -> np.ndarray:
    """Grow the dense seen bitmap to ``n_lines`` (new lines unseen)."""
    if n_lines <= seen.shape[0]:
        return seen
    grown = np.zeros(n_lines, dtype=bool)
    grown[:seen.shape[0]] = seen
    return grown


PolicyLike = Union[str, PolicyConfig]


def _resolve_policy(p: PolicyLike) -> PolicyConfig:
    return named_policy(p) if isinstance(p, str) else p


def run_policy(trace: Trace, policy: PolicyLike,
               cfg: Optional[SimConfig] = None,
               record_history: bool = True,
               engine: str = "compiled") -> SimResult:
    return Simulator(cfg or SimConfig(), _resolve_policy(policy)).run(
        trace, record_history=record_history, engine=engine)


def run_policies(trace: Trace, policies: Iterable[PolicyLike],
                 cfg: Optional[SimConfig] = None,
                 record_history: bool = False,
                 tmu_params: Optional[TMUParams] = None,
                 capacities: Optional[Iterable[int]] = None):
    """Batch policy sweep over one trace (the paper's figure workflow).

    The trace is lowered once (``trace.compiled``) and the lowering —
    plus the geometry-dependent access plans — is shared by every policy,
    so sweeping N policies costs one compile plus N fast vectorized runs
    instead of N Python trace walks.  Results come back in input order
    with counters bit-identical to individual :func:`run_policy` calls.

    ``capacities`` adds a capacity axis (the §VI capacity sweeps):
    ``cfg.llc_bytes`` is replaced by each entry and the return value
    becomes a nested list indexed ``[policy][capacity]``.  Plans are
    cached per :class:`~repro_torch.core.cache.CacheGeometry` on the shared
    compiled trace, so the P×C sweep still compiles once and sorts each
    distinct geometry once.
    """
    cfg = cfg or SimConfig()
    trace.compiled(cfg.line_bytes)       # build once, shared by all runs
    pols = [_resolve_policy(p) for p in policies]
    if capacities is None:
        return [
            Simulator(cfg, p, tmu_params).run(
                trace, record_history=record_history)
            for p in pols
        ]
    caps = list(capacities)
    return [
        [Simulator(replace(cfg, llc_bytes=int(c)), p, tmu_params).run(
            trace, record_history=record_history)
         for c in caps]
        for p in pols
    ]
