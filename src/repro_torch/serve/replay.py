"""Traffic-scale serving replay: arrivals → batching → cache simulation.

The end-to-end pipeline of DESIGN.md §11: a seeded
:class:`~repro_torch.serve.traffic.RequestStream` feeds the continuous-
batching :class:`~repro_torch.serve.scheduler.SlotScheduler` (the same
admit/retire discipline as the JAX ``ServeEngine``), and every slot
decision is *emitted* as one lockstep dataflow round — KV pages stored
during prefill, re-read every decode step, shared prompt prefixes
co-read by their group, Q/X/O traffic bypassed — through the emitter
protocol of :mod:`repro_torch.dataflows.stream`.

With a :class:`~repro_torch.dataflows.stream.StreamEmitter` the replay runs in
bounded memory end to end (``Simulator.run_stream`` consumes windows as
they flush); with a :class:`~repro_torch.dataflows.stream.SpecEmitter` the
same driver produces one monolithic ``DataflowSpec`` for the suite /
model-validation / conformance paths and for the bit-identity property
(streamed counters and event stream == monolithic, small seeds).

On top of the cache counters, :func:`slo_metrics` derives serving SLOs
from the simulated clock: TTFT (arrival → first generated token,
queueing + prefill included) and TPOT (mean inter-token gap) as
p50/p95/p99 milliseconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import Iterator
from typing import List
from typing import Optional

import numpy as np

from ..core.policies import named_policy
from ..core.simulator import SimConfig
from ..core.simulator import SimResult
from ..core.simulator import Simulator
from ..dataflows.addr import BUMP
from ..dataflows.addr import make_allocator
from ..dataflows.stream import DEFAULT_CHUNK_LINES
from ..dataflows.stream import ReplaySegment
from ..dataflows.stream import SpecEmitter
from ..dataflows.stream import StreamEmitter
from .scheduler import ServeTruncation
from .scheduler import SlotScheduler
from .traffic import ReplayRequest
from .traffic import RequestStream
from .traffic import TrafficConfig


@dataclass(frozen=True)
class ReplayConfig:
    """Shape of the emitted dataflow (pages are the KV paging unit)."""

    max_batch: int = 16
    n_cores: int = 16
    page_bytes: int = 2048
    prefill_pages_per_round: int = 4
    line_bytes: int = 128
    flops_per_byte: float = 2.0
    #: hard safety ceiling on replay rounds (None: unbounded)
    max_rounds: Optional[int] = None
    #: address-space strategy (repro_torch.dataflows.addr): "bump" mints the
    #: historical monotone layout; "pooled" recycles retired KV regions
    #: from a fixed page pool so tag-derived TMU state (anti-thrashing
    #: tiers, dead ids) keeps covering the live working set at scale
    allocator: str = "bump"
    #: pooled-allocator pool size, in pages of ``page_bytes``.  A fixed
    #: config knob (not derived from the realized stream) so streamed
    #: and monolithic runs of one traffic seed share layouts exactly.
    pool_pages: int = 2048


@dataclass
class ReplayLog:
    """Per-request round indices for SLO derivation (indexed by uid)."""

    arrival: np.ndarray
    first_token: np.ndarray
    last_token: np.ndarray
    n_decode: np.ndarray

    @classmethod
    def empty(cls, n: int) -> "ReplayLog":
        return cls(arrival=np.zeros(n, dtype=np.int64),
                   first_token=np.full(n, -1, dtype=np.int64),
                   last_token=np.full(n, -1, dtype=np.int64),
                   n_decode=np.zeros(n, dtype=np.int64))


@dataclass
class _Active:
    """Per-slot replay state."""

    req: ReplayRequest
    kv: str
    io: str
    pfx: Optional[str]
    prefill_rounds: int
    pages_filled: int = 0
    decoded: int = 0
    io_tile: int = 0


class ReplayEngine:
    """Drives an emitter from the arrival stream; yields flushed
    segments (none for a :class:`SpecEmitter`)."""

    def __init__(self, stream: RequestStream, rcfg: ReplayConfig):
        self.stream = stream
        self.rcfg = rcfg
        self.log = ReplayLog.empty(stream.cfg.n_requests)
        self.rounds = 0

    # ------------------------------------------------------------------
    def _declare(self, emitter, req: ReplayRequest,
                 pfx_declared: set, pfx_refs: Dict[int, int]) -> _Active:
        rc = self.rcfg
        wave = req.uid // rc.max_batch
        pfx_name = None
        if req.prefix_id >= 0:
            pfx_name = f"pfx{req.prefix_id}"
            if req.prefix_id not in pfx_declared:
                info = self.stream.prefix_info(req.prefix_id)
                emitter.declare(
                    pfx_name,
                    size_bytes=self.stream.cfg.prefix_pages * rc.page_bytes,
                    tile_bytes=rc.page_bytes,
                    n_acc=info.total_decode_steps,
                    sharers=1,
                    epoch=(info.uid_min // rc.max_batch,
                           info.uid_max // rc.max_batch))
                pfx_declared.add(req.prefix_id)
                pfx_refs[req.prefix_id] = info.members
        kv = f"kv{req.uid}"
        emitter.declare(kv,
                        size_bytes=req.prefill_pages * rc.page_bytes,
                        tile_bytes=rc.page_bytes,
                        n_acc=req.decode_steps,
                        epoch=(wave, wave))
        prefill_rounds = -(-req.prefill_pages // rc.prefill_pages_per_round)
        io = f"io{req.uid}"
        emitter.declare(io,
                        size_bytes=(prefill_rounds + 2 * req.decode_steps)
                        * rc.line_bytes,
                        tile_bytes=rc.line_bytes,
                        n_acc=1, bypass=True, epoch=(wave, wave))
        return _Active(req=req, kv=kv, io=io, pfx=pfx_name,
                       prefill_rounds=prefill_rounds)

    # ------------------------------------------------------------------
    def drive(self, emitter) -> Iterator[ReplaySegment]:
        rc = self.rcfg
        n_prefix_pages = self.stream.cfg.prefix_pages
        sched: SlotScheduler[ReplayRequest] = SlotScheduler(rc.max_batch)
        state: List[Optional[_Active]] = [None] * rc.max_batch
        arrivals = iter(self.stream)
        pending = next(arrivals, None)
        pfx_declared: set = set()
        pfx_refs: Dict[int, int] = {}
        r = 0
        while pending is not None or not sched.drained:
            if rc.max_rounds is not None and r >= rc.max_rounds:
                raise ServeTruncation(
                    r, sched.n_active,
                    sched.n_queued + (1 if pending is not None else 0))
            while pending is not None and pending.arrival_round <= r:
                sched.add(pending)
                pending = next(arrivals, None)
            for slot, req in sched.admit():
                state[slot] = self._declare(emitter, req, pfx_declared,
                                            pfx_refs)
                self.log.arrival[req.uid] = req.arrival_round
                self.log.n_decode[req.uid] = req.decode_steps

            # one lockstep round: merge slots that map onto one core
            per_core: Dict[int, list] = {}
            for slot in sched.active_slots():
                st = state[slot]
                row = per_core.setdefault(slot % rc.n_cores,
                                          [[], [], 0.0])
                loads, stores = row[0], row[1]
                if st.pages_filled < st.req.prefill_pages:
                    k = min(rc.prefill_pages_per_round,
                            st.req.prefill_pages - st.pages_filled)
                    stores.extend((st.kv, st.pages_filled + j)
                                  for j in range(k))
                    loads.append((st.io, st.io_tile))
                    st.io_tile += 1
                    st.pages_filled += k
                    row[2] += k * rc.page_bytes * rc.flops_per_byte
                else:
                    loads.extend((st.kv, p)
                                 for p in range(st.req.prefill_pages))
                    pages = st.req.prefill_pages
                    if st.pfx is not None:
                        loads.extend((st.pfx, p)
                                     for p in range(n_prefix_pages))
                        pages += n_prefix_pages
                    loads.append((st.io, st.io_tile))
                    stores.append((st.io, st.io_tile + 1))
                    st.io_tile += 2
                    st.decoded += 1
                    if self.log.first_token[st.req.uid] < 0:
                        self.log.first_token[st.req.uid] = r
                    row[2] += pages * rc.page_bytes * rc.flops_per_byte

            seg = emitter.emit_round(
                [(core, loads, stores, flops)
                 for core, (loads, stores, flops)
                 in sorted(per_core.items())])
            if seg is not None:
                yield seg

            for slot in sched.active_slots():
                st = state[slot]
                if st.decoded >= st.req.decode_steps:
                    self.log.last_token[st.req.uid] = r
                    emitter.retire(st.kv)
                    emitter.retire(st.io)
                    if st.pfx is not None:
                        pid = st.req.prefix_id
                        pfx_refs[pid] -= 1
                        if pfx_refs[pid] == 0:
                            emitter.retire(st.pfx)
                    sched.release(slot)
                    state[slot] = None
            r += 1
        self.rounds = r
        final = emitter.finish()
        if final is not None:
            yield final


# ---------------------------------------------------------------------------
@dataclass
class ReplayResult:
    sim: SimResult
    log: ReplayLog
    slo: Dict[str, Dict[str, float]]
    rounds: int
    segments: int = 0
    peak_seen_lines: int = 0
    total_lines_declared: int = 0
    #: online verifier verdict (``run_replay(verify=True)``), else None
    diagnostics: Optional[object] = None


def slo_metrics(log: ReplayLog,
                res: SimResult) -> Dict[str, Dict[str, float]]:
    """TTFT/TPOT percentile milliseconds from the simulated clock.

    The per-round clock comes from ``history["cycles"]`` (recorded at
    non-empty rounds only; a request arriving inside an idle gap is
    anchored to the last non-empty round before it, an error of at most
    the idle rounds' fixed overhead).
    """
    tl = res.timeline.get("round")
    cyc = res.history.get("cycles")
    if tl is None or cyc is None or tl.size == 0:
        return {}
    done = log.last_token >= 0

    def clock_end(rounds: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(tl, rounds, side="right") - 1
        return np.where(idx >= 0, cyc[np.maximum(idx, 0)], 0.0)

    scale = 1.0 / (res.freq_ghz * 1e6)
    ttft = (clock_end(log.first_token[done])
            - clock_end(log.arrival[done] - 1)) * scale
    gaps = np.maximum(log.n_decode[done] - 1, 1)
    tpot = (clock_end(log.last_token[done])
            - clock_end(log.first_token[done])) / gaps * scale

    def pct(a: np.ndarray) -> Dict[str, float]:
        return {"p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99)),
                "mean": float(a.mean())}

    return {"ttft_ms": pct(ttft), "tpot_ms": pct(tpot),
            "completed": {"n": float(done.sum())}}


# ---------------------------------------------------------------------------
def replay_spec(traffic: TrafficConfig,
                rcfg: Optional[ReplayConfig] = None):
    """Monolithic lowering: the whole replay as one ``DataflowSpec``
    (suite/conformance registration path).  Returns ``(spec, log)``."""
    rcfg = rcfg or ReplayConfig()
    eng = ReplayEngine(RequestStream(traffic), rcfg)
    emitter = SpecEmitter(_replay_name(traffic, rcfg), rcfg.n_cores,
                          line_bytes=rcfg.line_bytes,
                          allocator=_replay_allocator(rcfg))
    for _ in eng.drive(emitter):
        pass
    return emitter.build(), eng.log


def _replay_allocator(rcfg: ReplayConfig):
    """Fresh allocator for one replay run; ``None`` for bump, which
    keeps the emitters on their historical implicit-base path (layouts
    byte-identical to the pre-allocator pipeline)."""
    if rcfg.allocator == BUMP:
        return None
    return make_allocator(rcfg.allocator, page_bytes=rcfg.page_bytes,
                          pool_pages=rcfg.pool_pages)


def _replay_name(traffic: TrafficConfig, rcfg: ReplayConfig) -> str:
    name = (f"serve-replay-{traffic.process}"
            f"-n{traffic.n_requests}-s{traffic.seed}")
    if rcfg.allocator != BUMP:
        name += f"-{rcfg.allocator}"
    return name


def run_replay(traffic: TrafficConfig, policy,
               sim_cfg: Optional[SimConfig] = None,
               rcfg: Optional[ReplayConfig] = None, *,
               mode: str = "stream",
               chunk_lines: int = DEFAULT_CHUNK_LINES,
               record_history: bool = True,
               events=None, verify: bool = False) -> ReplayResult:
    """Run one replay under one policy.

    ``mode="stream"`` (default) is the bounded-memory path: generator →
    StreamEmitter windows → ``Simulator.run_stream``.  ``mode=
    "monolithic"`` materializes the whole spec/trace first (reference
    path; small seeds only — every tensor is TMU-registered up front).

    ``verify=True`` turns on the online verifier (DESIGN.md §12): in
    stream mode a :class:`~repro_torch.dataflows.verify.StreamVerifier` audits
    every flushed segment in-line (bounded memory, same pass as the
    simulator); in monolithic mode the built spec goes through
    :func:`~repro_torch.dataflows.verify.verify_spec`.  The resulting
    :class:`~repro_torch.dataflows.verify.VerifyResult` lands on
    ``ReplayResult.diagnostics``; error-tier findings raise
    :class:`~repro_torch.dataflows.verify.SpecVerifyError` before results are
    returned (a corrupt emission must not masquerade as a measurement).
    """
    cfg = sim_cfg or SimConfig()
    rcfg = rcfg or ReplayConfig(n_cores=cfg.n_cores,
                                line_bytes=cfg.line_bytes)
    if rcfg.n_cores != cfg.n_cores:
        raise ValueError("ReplayConfig.n_cores must match SimConfig")
    pol = named_policy(policy) if isinstance(policy, str) else policy
    eng = ReplayEngine(RequestStream(traffic), rcfg)
    name = _replay_name(traffic, rcfg)
    sim = Simulator(cfg, pol)
    diags = None
    if mode == "stream":
        emitter = StreamEmitter(name, rcfg.n_cores,
                                chunk_lines=chunk_lines,
                                line_bytes=rcfg.line_bytes,
                                allocator=_replay_allocator(rcfg))
        segs = eng.drive(emitter)
        verifier = None
        if verify:
            from ..dataflows.verify import StreamVerifier
            verifier = StreamVerifier(name, line_bytes=rcfg.line_bytes,
                                      sim_cfg=cfg,
                                      allocator=rcfg.allocator)

            def audited(source=segs, v=verifier):
                for seg in source:
                    v.on_segment(seg)
                    yield seg

            segs = audited()
        res = sim.run_stream(segs, name=name,
                             record_history=record_history, events=events)
        if verifier is not None:
            diags = verifier.finish()
        segments = emitter.segments
        peak = emitter.peak_seen_lines
        total = emitter.total_lines_declared
    elif mode == "monolithic":
        from ..dataflows import lower_to_trace
        emitter = SpecEmitter(name, rcfg.n_cores,
                              line_bytes=rcfg.line_bytes,
                              allocator=_replay_allocator(rcfg))
        for _ in eng.drive(emitter):
            pass
        spec = emitter.build()
        if verify:
            from ..dataflows.verify import verify_spec
            diags = verify_spec(spec, sim_cfg=cfg)
        trace = lower_to_trace(spec)
        res = sim.run(trace, record_history=record_history, events=events)
        segments = 1
        peak = total = sum(m.size_bytes // rcfg.line_bytes
                           for m in trace.tensors.values())
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if diags is not None and diags.has_errors:
        from ..dataflows.verify import SpecVerifyError
        raise SpecVerifyError(diags)
    return ReplayResult(sim=res, log=eng.log,
                        slo=slo_metrics(eng.log, res),
                        rounds=eng.rounds, segments=segments,
                        peak_seen_lines=peak, total_lines_declared=total,
                        diagnostics=diags)
