"""New dataflow scenarios expressed on the IR (DESIGN.md §8.3).

Four workload classes beyond the seed's FA2/matmul pair, each exercising
a capability the IR provides and a paper mechanism end to end:

* :func:`decode_paged_spec` — decode attention over paged KV with
  staggered sequence completion (§VI-F generalized to serving): dead
  pages pollute the LLC until DBP retires them.
* :func:`moe_ffn_spec` — MoE expert-FFN with skewed routing: hot expert
  weights are co-streamed by several cores through the LLC (inter-core
  sharing, cf. the MoE cache-management line of work in PAPERS.md),
  while cold experts finish early and go dead.
* :func:`mlp_chain_spec` — a 3-matmul MLP chain whose intermediate
  activations are produced by one op and consumed by the next through
  LLC storage (inter-op reuse a single-op builder cannot express).
* :func:`transformer_layer_spec` — a fused attention+FFN layer: the
  attention outputs, bypass-class in stand-alone FA2, become reuse
  carriers read back by the FFN matmuls — cross-op dataflow knowledge is
  exactly what the TMU registration interface exists to convey.
* :func:`spec_decode_spec` — speculative decoding: per-round draft-model
  KV with a short known lifetime (its own liveness epoch, dead at
  verification) interleaved with persistent target-model KV — the
  §VI-F retirement pattern at speculation-round cadence.
* :func:`ssd_scan_spec` — Mamba2 SSD chunked scan: per-chunk running
  states materialized by stores and consumed exactly once by the next
  chunk's recurrence (``nAcc`` ends at the next chunk's
  materialization) — dead-block prediction and dirty-lifetime write-back
  on an attention-free architecture.
* :func:`prefix_share_spec` — prefix-cache sharing: one common prompt
  prefix's KV co-streamed by every request (high ``sharers``; MSHR
  merges plus a lagging rank riding LLC storage) over thrashing
  per-request private suffixes — the gqa_bypass protection scenario.
"""

from __future__ import annotations

from typing import List
from typing import Tuple

from ..core.workloads import AttnWorkload
from ..core.workloads import DecodeWorkload
from ..core.workloads import MoEWorkload
from ..core.workloads import PrefixShareWorkload
from ..core.workloads import SSDScanWorkload
from ..core.workloads import SpecDecodeWorkload
from ..core.workloads import TEMPORAL
from .fa2 import _kv_extent
from .fa2 import emit_matmul_rounds
from .ir import DataflowSpec
from .ir import SpecBuilder


# ---------------------------------------------------------------------------
# Decode attention with paged KV (multi-batch DBP retirement, §VI-F)
# ---------------------------------------------------------------------------
def decode_paged_spec(wl: DecodeWorkload, n_cores: int = 16) -> DataflowSpec:
    b = SpecBuilder(wl.name, n_cores)
    # KV first, contiguously: one sequence's K+V spans exactly one run of
    # tag space, so tile priorities (tag low bits) and dead ids fall out
    # per sequence just as §IV-B intends.
    kv: List = []
    for s in range(wl.n_seqs):
        alive = wl.steps_alive(s)
        epoch = (0, 0) if s < wl.n_short else (0, 1)
        pair = []
        for kind in ("K", "V"):
            pair.append(b.tensor(
                f"{kind}.s{s}", size_bytes=wl.n_pages * wl.page_bytes,
                tile_bytes=wl.page_bytes, n_acc=alive, operand_id=1,
                epoch=epoch))
        kv.append(tuple(pair))
    # per-sequence decode-token streams (Q in, logit/output out): one line
    # per step, always-bypass (the bursty Q/O class)
    q_bytes = wl.head_dim * wl.n_kv_heads * wl.dtype_bytes
    qo = []
    for s in range(wl.n_seqs):
        alive = wl.steps_alive(s)
        q = b.tensor(f"Q.s{s}", size_bytes=alive * q_bytes,
                     tile_bytes=q_bytes, n_acc=1, operand_id=0,
                     bypass=True, epoch=(0, 0) if s < wl.n_short else (0, 1))
        o = b.tensor(f"O.s{s}", size_bytes=alive * q_bytes,
                     tile_bytes=q_bytes, n_acc=1, operand_id=2,
                     bypass=True, epoch=(0, 0) if s < wl.n_short else (0, 1))
        qo.append((q, o))

    half = 2.0 * wl.page_rows * wl.head_dim * wl.n_kv_heads
    for t in range(wl.n_steps):
        for s in range(wl.n_seqs):
            if t >= wl.steps_alive(s):
                continue
            c = s % n_cores
            b.step(c, loads=[(qo[s][0], t)])
            for p in range(wl.n_pages):
                b.step(c, loads=[(kv[s][0], p)], flops=half)
                b.step(c, loads=[(kv[s][1], p)], flops=half)
            b.step(c, stores=[(qo[s][1], t)])
        # cores whose sequences all finished idle in lockstep
        b.pad_to_sync()
    return b.build()


# ---------------------------------------------------------------------------
# MoE expert-FFN with skewed expert routing
# ---------------------------------------------------------------------------
def moe_ffn_spec(wl: MoEWorkload, n_cores: int = 16) -> DataflowSpec:
    if n_cores % wl.n_hot:
        raise ValueError("n_cores must be a multiple of n_hot")
    if wl.n_cold != n_cores - wl.n_hot:
        raise ValueError("need n_cold == n_cores - n_hot (one warm-phase "
                         "core per cold expert)")
    b = SpecBuilder(wl.name, n_cores)
    share = n_cores // wl.n_hot          # cores per hot expert, steady state
    hot_uses = wl.warm_steps + (wl.n_steps - wl.warm_steps) * share
    n_tiles = wl.expert_bytes // wl.tile_bytes

    experts = []
    for e in range(wl.n_experts):
        hot = e < wl.n_hot
        experts.append(b.tensor(
            f"W.e{e}", size_bytes=wl.expert_bytes,
            tile_bytes=wl.tile_bytes, operand_id=1,
            n_acc=hot_uses if hot else wl.warm_steps,
            epoch=(0, 1) if hot else (0, 0),
            sharers=share if hot else 1))
    acts = []
    for c in range(n_cores):
        x = b.tensor(f"X.c{c}", size_bytes=wl.n_steps * wl.act_tile_bytes,
                     tile_bytes=wl.act_tile_bytes, n_acc=1, operand_id=0,
                     bypass=True, epoch=(0, 1))
        y = b.tensor(f"Y.c{c}", size_bytes=wl.n_steps * wl.act_tile_bytes,
                     tile_bytes=wl.act_tile_bytes, n_acc=1, operand_id=2,
                     bypass=True, epoch=(0, 1))
        acts.append((x, y))

    # steady-state sharing groups: ranks of one hot expert; rank 0 leads,
    # later ranks lag `rank` tiles so their reuses ride LLC storage
    b.set_groups([c % wl.n_hot for c in range(n_cores)],
                 [c // wl.n_hot == 0 for c in range(n_cores)])

    tile_flops = wl.flops_per_use / n_tiles
    for s in range(wl.n_steps):
        for c in range(n_cores):
            if s < wl.warm_steps:
                # skewed warm phase: core c serves expert c (the first
                # n_hot cores route hot, the rest one cold expert each)
                e = c
                lag = 0
            else:
                e = c % wl.n_hot
                lag = c // wl.n_hot
            b.step(c, loads=[(acts[c][0], s)])
            for tt in range(n_tiles):
                b.step(c, loads=[(experts[e], (tt - lag) % n_tiles)],
                       flops=tile_flops)
            b.step(c, stores=[(acts[c][1], s)])
    return b.build()


# ---------------------------------------------------------------------------
# 3-matmul MLP chain with inter-op activation reuse
# ---------------------------------------------------------------------------
def _emit_matmul(b: SpecBuilder, A: str, B_: str, C: str,
                 mt: int, kt: int, nt: int, flops: float) -> None:
    """One chained matmul op: shared emission plus a lockstep barrier
    (pad_to_sync) so the next op starts aligned."""
    emit_matmul_rounds(b, A, B_, C, mt, kt, nt, flops)
    b.pad_to_sync()


def mlp_chain_spec(m: int = 1024, dims: tuple = (512, 512, 512, 512),
                   tile: int = 128, n_cores: int = 16,
                   dtype_bytes: int = 1) -> DataflowSpec:
    """Y = act(act(X@W1)@W2)@W3: the intermediate activations H1/H2 are
    written by one op and read back by the next — their ``nAcc`` is the
    *consumer's* read count, dataflow knowledge that spans op boundaries.
    """
    d0, d1, d2, d3 = dims
    for d in (m, *dims):
        if d % tile:
            raise ValueError("dims must be tile-aligned")
    mt = m // tile
    t0, t1, t2, t3 = (d // tile for d in dims)
    tb = tile * tile * dtype_bytes
    b = SpecBuilder(f"mlp-chain-{m}x{'x'.join(str(d) for d in dims)}",
                    n_cores)

    X = b.tensor("X", size_bytes=mt * t0 * tb, tile_bytes=tb,
                 n_acc=t1, operand_id=0)
    W1 = b.tensor("W1", size_bytes=t0 * t1 * tb, tile_bytes=tb,
                  n_acc=mt, operand_id=1)
    W2 = b.tensor("W2", size_bytes=t1 * t2 * tb, tile_bytes=tb,
                  n_acc=mt, operand_id=1)
    W3 = b.tensor("W3", size_bytes=t2 * t3 * tb, tile_bytes=tb,
                  n_acc=mt, operand_id=1)
    H1 = b.tensor("H1", size_bytes=mt * t1 * tb, tile_bytes=tb,
                  n_acc=t2, operand_id=2)     # read back by op 2
    H2 = b.tensor("H2", size_bytes=mt * t2 * tb, tile_bytes=tb,
                  n_acc=t3, operand_id=2)     # read back by op 3
    Y = b.tensor("Y", size_bytes=mt * t3 * tb, tile_bytes=tb,
                 n_acc=1, operand_id=2, bypass=True)

    flops = 2.0 * tile * tile * tile
    _emit_matmul(b, X, W1, H1, mt, t0, t1, flops)
    _emit_matmul(b, H1, W2, H2, mt, t1, t2, flops)
    _emit_matmul(b, H2, W3, Y, mt, t2, t3, flops)
    return b.build()


# ---------------------------------------------------------------------------
# Fused attention + FFN transformer layer
# ---------------------------------------------------------------------------
def transformer_layer_spec(wl: AttnWorkload, d_ff: int = 1024,
                           n_cores: int = 16) -> DataflowSpec:
    """One transformer layer as a single dataflow: FA2 attention (temporal
    group allocation) whose per-head outputs feed an FFN up/down pair.

    Stand-alone FA2 marks O bypass-all (§V-C); fused, each O tile is read
    ``d_ff/tile`` times by the up-projection, so O becomes a reuse
    carrier with a cross-op ``nAcc`` — the fusion changes the optimal
    cache treatment of the same tensor, which is precisely the dataflow
    information the paper's software interface carries to hardware.
    """
    if wl.group_alloc != TEMPORAL:
        raise ValueError("fused layer uses temporal group allocation")
    if wl.n_batches != 1:
        raise ValueError("single-batch layer only")
    tile = wl.q_block
    if wl.head_dim != tile or d_ff % tile:
        raise ValueError("head_dim must equal q_block; d_ff tile-aligned")
    d_model = wl.n_q_heads * wl.head_dim
    mt, ht = wl.n_q_tiles, wl.n_q_heads
    ft, dt = d_ff // tile, d_model // tile
    tb = tile * tile * wl.dtype_bytes
    b = SpecBuilder(f"{wl.name}-layer", n_cores, workload=wl)

    # --- attention tensors (declaration order mirrors fa2_spec) ---------
    per_core: List[List[int]] = [[] for _ in range(n_cores)]
    for g in range(wl.n_kv_heads):
        per_core[g % n_cores].append(g)
    kv_size = wl.seq_len * wl.head_dim * wl.dtype_bytes
    items: List[tuple] = []
    o_of_head = {}
    for c in range(n_cores):
        for g in per_core[c]:
            kv = tuple(b.tensor(
                f"{kind}.g{g}", size_bytes=kv_size,
                tile_bytes=wl.kv_tile_bytes, n_acc=wl.n_q_tiles,
                operand_id=1) for kind in ("K", "V"))
            q_names, o_names = [], []
            for m_ in range(wl.group_size):
                h = g * wl.group_size + m_
                q_names.append(b.tensor(
                    f"Q.h{h}", size_bytes=kv_size,
                    tile_bytes=wl.q_tile_bytes, n_acc=1, bypass=True))
                # fused: O is consumed by the FFN up-projection
                o = b.tensor(f"O.h{h}", size_bytes=kv_size,
                             tile_bytes=wl.q_tile_bytes, n_acc=ft,
                             operand_id=2)
                o_names.append(o)
                o_of_head[h] = o
            items.append((c, kv, q_names, o_names))

    # --- FFN tensors ----------------------------------------------------
    W_up = b.tensor("W_up", size_bytes=dt * ft * tb, tile_bytes=tb,
                    n_acc=mt, operand_id=1)
    W_dn = b.tensor("W_dn", size_bytes=ft * dt * tb, tile_bytes=tb,
                    n_acc=mt, operand_id=1)
    H = b.tensor("H", size_bytes=mt * ft * tb, tile_bytes=tb,
                 n_acc=dt, operand_id=2)
    Y = b.tensor("Y", size_bytes=mt * dt * tb, tile_bytes=tb,
                 n_acc=1, operand_id=2, bypass=True)

    # --- attention rounds (fa2 temporal schedule: a core's assigned
    # groups interleave at Q-tile granularity, keeping every group's K/V
    # stream live concurrently) ------------------------------------------
    half = wl.flops_per_inner_step() * wl.group_size / 2
    for c in range(n_cores):
        for i in range(wl.n_q_tiles):
            for (_, kv, q_names, o_names) in (it for it in items
                                              if it[0] == c):
                b.step(c, loads=[(q, i) for q in q_names])
                for j in range(_kv_extent(wl, i)):
                    b.step(c, loads=[(kv[0], j)], flops=half)
                    b.step(c, loads=[(kv[1], j)], flops=half)
                b.step(c, stores=[(o, i) for o in o_names])
    b.pad_to_sync()

    # --- FFN rounds: H[m, f] = X @ W_up with X tiles read straight from
    # the per-head O tensors (k-block k is head k's output column) -------
    flops = 2.0 * tile * tile * tile
    for idx, (i, j) in enumerate((i, j) for i in range(mt)
                                 for j in range(ft)):
        core = idx % n_cores
        for k in range(ht):
            b.step(core, loads=[(o_of_head[k], i), (W_up, k * ft + j)],
                   flops=flops)
        b.step(core, stores=[(H, i * ft + j)])
    b.pad_to_sync()
    _emit_matmul(b, H, W_dn, Y, mt, ft, dt, flops)
    return b.build()


# ---------------------------------------------------------------------------
# Speculative decoding: short-lived draft KV epochs + persistent target KV
# ---------------------------------------------------------------------------
def spec_decode_spec(wl: SpecDecodeWorkload,
                     n_cores: int = 16) -> DataflowSpec:
    """Draft/verify cycles over paged KV (ROADMAP scenario candidate).

    Per verification cycle ``r`` and sequence: the draft model streams
    its speculation-window KV ``gamma`` times (one autoregressive pass
    per proposed token), then the target model verifies the batch in one
    pass over its full history *plus* the speculation window (its
    attention over the draft suffix reads the draft-layout KV once
    rather than recomputing it), so the dying window's last touches
    interleave with the persistent target stream.  Draft tensors of
    round ``r`` live in epoch ``r`` only and declare
    ``nAcc = gamma + 1`` — the TMU retires the whole window on exactly
    that verification read.  Under DBP the retired window frees its
    capacity immediately; under LRU it is the *most recently used* dead
    mass sitting on top of the target stream's reuse window, which is
    precisely the §VI-F pollution pattern recurring every cycle.
    """
    if wl.n_seqs % n_cores:
        raise ValueError("n_seqs must be a multiple of n_cores")
    b = SpecBuilder(wl.name, n_cores)

    # persistent target KV, declared first: one contiguous run of tag
    # space per sequence (dead-id / priority granularity, §IV-B)
    target: List[tuple] = []
    for s in range(wl.n_seqs):
        target.append(tuple(b.tensor(
            f"T{kind}.s{s}", size_bytes=wl.n_target_pages * wl.page_bytes,
            tile_bytes=wl.page_bytes, n_acc=wl.n_verify, operand_id=1,
            epoch=(0, wl.n_verify - 1)) for kind in ("K", "V")))
    # per-round draft KV: its own epoch, dies at verification
    draft: List[List[tuple]] = []
    for s in range(wl.n_seqs):
        gens = []
        for r in range(wl.n_verify):
            gens.append(tuple(b.tensor(
                f"D{kind}.s{s}.r{r}",
                size_bytes=wl.n_draft_pages * wl.page_bytes,
                tile_bytes=wl.page_bytes, n_acc=wl.gamma + 1, operand_id=1,
                epoch=(r, r)) for kind in ("K", "V")))
        draft.append(gens)
    # bursty token streams (Q in, accepted-token logits out)
    qo = []
    for s in range(wl.n_seqs):
        tokens = wl.n_verify * (wl.gamma + 1)
        q = b.tensor(f"Q.s{s}", size_bytes=tokens * wl.token_bytes,
                     tile_bytes=wl.token_bytes, n_acc=1, operand_id=0,
                     bypass=True, epoch=(0, wl.n_verify - 1))
        o = b.tensor(f"O.s{s}", size_bytes=wl.n_verify * wl.token_bytes,
                     tile_bytes=wl.token_bytes, n_acc=1, operand_id=2,
                     bypass=True, epoch=(0, wl.n_verify - 1))
        qo.append((q, o))

    half = 2.0 * wl.page_rows * wl.head_dim * wl.n_kv_heads
    for r in range(wl.n_verify):
        for s in range(wl.n_seqs):
            c = s % n_cores
            dk, dv = draft[s][r]
            # draft phase: gamma autoregressive passes over the window
            for t in range(wl.gamma):
                b.step(c, loads=[(qo[s][0], r * (wl.gamma + 1) + t)])
                for p in range(wl.n_draft_pages):
                    b.step(c, loads=[(dk, p)], flops=half)
                    b.step(c, loads=[(dv, p)], flops=half)
            # verify phase: one pass over the full target history with
            # the speculation window's pages interleaved (the target's
            # attention over the draft suffix reads them once more —
            # their last access, so retirement lands mid-stream)
            tk, tv = target[s]
            b.step(c, loads=[(qo[s][0], r * (wl.gamma + 1) + wl.gamma)])
            stride = max(wl.n_target_pages // wl.n_draft_pages, 1)
            d_idx = 0
            for p in range(wl.n_target_pages):
                b.step(c, loads=[(tk, p)], flops=half * wl.gamma)
                b.step(c, loads=[(tv, p)], flops=half * wl.gamma)
                if p % stride == stride - 1 and d_idx < wl.n_draft_pages:
                    b.step(c, loads=[(dk, d_idx)], flops=half)
                    b.step(c, loads=[(dv, d_idx)], flops=half)
                    d_idx += 1
            # windows larger than the target history (n_draft_pages >
            # n_target_pages) finish their verify reads here so every
            # draft page still reaches nAcc = gamma + 1 and retires
            while d_idx < wl.n_draft_pages:
                b.step(c, loads=[(dk, d_idx)], flops=half)
                b.step(c, loads=[(dv, d_idx)], flops=half)
                d_idx += 1
            b.step(c, stores=[(qo[s][1], r)])
        b.pad_to_sync()
    return b.build()


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan: running states die at the next chunk
# ---------------------------------------------------------------------------
def ssd_scan_spec(wl: SSDScanWorkload, n_cores: int = 16) -> DataflowSpec:
    """Chunked SSD scan (``models/ssm.py::ssd_chunked``) on the IR.

    Per chunk ``c`` and sequence: stream the chunk's x/B/C input block
    (bypass class), then head by head read the previous chunk's running
    state (its single ``nAcc`` read — the TMU retires it mid-chunk) and
    store this chunk's freshly materialized state (a *dirty* fill whose
    lifetime runs to the next chunk's recurrence).  The final chunk's
    state is drained once at the end, as ``ssd_chunked`` returns it.
    Read-prev/store-next interleave at head granularity, so under LRU
    the dead previous generation is the *most recently used* mass
    sitting on top of the live one — the recurring §VI-F pollution
    pattern DBP clears at chunk cadence.

    All running states are declared first, **chunk-major at head-slab
    granularity**: tensor ``S.c{c}.h{h}`` holds every sequence's head-h
    tile of chunk c (tile index = sequence).  The TMU's dead identifier
    is a tag-domain slice (``tag[D_MSB:D_LSB]``, §IV-B), so the unit
    that must never straddle a dead-id region is the unit that dies
    *atomically* — and a head slab is exactly that: every core's
    recurrence reads its sequence's tile in the same lockstep round, so
    the whole slab retires at that round's TLL feed and the dead-id
    region it fills flips dead with no live residue.  (A sequence-major
    layout interleaves generations inside one region and DBP would
    victimize still-unread states — the layout is part of the dataflow
    knowledge the software side owes the hardware, cf. `decode_paged_spec`.)
    """
    if wl.n_seqs % n_cores:
        raise ValueError("n_seqs must be a multiple of n_cores")
    b = SpecBuilder(wl.name, n_cores)

    last = wl.n_chunks - 1
    states: List[List[str]] = []
    for c in range(wl.n_chunks):
        states.append([b.tensor(
            f"S.c{c}.h{h}", size_bytes=wl.head_slab_bytes,
            tile_bytes=wl.head_state_bytes, n_acc=1, operand_id=2,
            epoch=(c, min(c + 1, last)))
            for h in range(wl.n_heads)])
    io: List[Tuple[str, str]] = []
    for c in range(wl.n_chunks):
        io.append((
            b.tensor(f"X.c{c}", size_bytes=wl.n_seqs * wl.chunk_in_bytes,
                     tile_bytes=wl.chunk_in_bytes, n_acc=1, operand_id=0,
                     bypass=True, epoch=(c, c)),
            b.tensor(f"Y.c{c}", size_bytes=wl.n_seqs * wl.chunk_out_bytes,
                     tile_bytes=wl.chunk_out_bytes, n_acc=1, operand_id=2,
                     bypass=True, epoch=(c, c))))

    intra_h = wl.intra_flops / wl.n_heads
    inter_h = wl.inter_flops / wl.n_heads
    for c in range(wl.n_chunks):
        for s in range(wl.n_seqs):
            core = s % n_cores
            b.step(core, loads=[(io[c][0], s)])
            for h in range(wl.n_heads):
                if c > 0:
                    # inter-chunk recurrence: the consuming read of the
                    # previous chunk's state (reaches nAcc, retires)
                    b.step(core, loads=[(states[c - 1][h], s)],
                           flops=inter_h)
                b.step(core, stores=[(states[c][h], s)], flops=intra_h)
            b.step(core, stores=[(io[c][1], s)])
        b.pad_to_sync()
    # drain the final state (ssd_chunked returns it): its nAcc read
    for s in range(wl.n_seqs):
        core = s % n_cores
        for h in range(wl.n_heads):
            b.step(core, loads=[(states[last][h], s)])
    b.pad_to_sync()
    return b.build()


# ---------------------------------------------------------------------------
# Prefix-cache sharing: one shared prompt prefix, private suffixes
# ---------------------------------------------------------------------------
def prefix_share_spec(wl: PrefixShareWorkload,
                      n_cores: int = 16) -> DataflowSpec:
    """Decode over a shared prompt prefix plus per-request suffixes.

    All ranks stream the shared prefix KV in lockstep — same-round
    same-page requests merge in the MSHRs (distance-0 inter-core mass),
    while the last rank lags one page so its prefix reuses ride LLC
    *storage*, the population blind bypassing destroys (§IV-E).  The
    per-request suffix KV is private and collectively oversubscribes the
    LLC, supplying the contention that would make a blind controller
    ramp its gear into the shared stream; the suite runs this case under
    the conservative ``gqa_bypass`` variant (only the lagging non-leader
    rank may bypass, and only under measured contention).
    """
    if wl.n_reqs % n_cores:
        raise ValueError("n_reqs must be a multiple of n_cores")
    b = SpecBuilder(wl.name, n_cores)

    # one sharing group spanning all cores; the last rank is the lagging
    # non-leader (the only rank gqa_bypass lets bypass, cf. fa2 spatial)
    b.set_groups([0] * n_cores,
                 [c != n_cores - 1 for c in range(n_cores)])

    pre = tuple(b.tensor(
        f"{kind}pre", size_bytes=wl.n_prefix_pages * wl.page_bytes,
        tile_bytes=wl.page_bytes, n_acc=wl.n_reqs * wl.n_steps,
        operand_id=1, sharers=min(wl.n_reqs, n_cores))
        for kind in ("K", "V"))
    suf: List[tuple] = []
    qo: List[tuple] = []
    for s in range(wl.n_reqs):
        suf.append(tuple(b.tensor(
            f"{kind}suf.s{s}", size_bytes=wl.n_suffix_pages * wl.page_bytes,
            tile_bytes=wl.page_bytes, n_acc=wl.n_steps, operand_id=1)
            for kind in ("K", "V")))
        q = b.tensor(f"Q.s{s}", size_bytes=wl.n_steps * wl.token_bytes,
                     tile_bytes=wl.token_bytes, n_acc=1, operand_id=0,
                     bypass=True)
        o = b.tensor(f"O.s{s}", size_bytes=wl.n_steps * wl.token_bytes,
                     tile_bytes=wl.token_bytes, n_acc=1, operand_id=2,
                     bypass=True)
        qo.append((q, o))

    half = 2.0 * wl.page_rows * wl.head_dim * wl.n_kv_heads
    for t in range(wl.n_steps):
        for s in range(wl.n_reqs):
            c = s % n_cores
            lag = 1 if c == n_cores - 1 else 0
            b.step(c, loads=[(qo[s][0], t)])
            for p in range(wl.n_prefix_pages):
                pp = (p - lag) % wl.n_prefix_pages
                b.step(c, loads=[(pre[0], pp)], flops=half)
                b.step(c, loads=[(pre[1], pp)], flops=half)
            for p in range(wl.n_suffix_pages):
                b.step(c, loads=[(suf[s][0], p)], flops=half)
                b.step(c, loads=[(suf[s][1], p)], flops=half)
            b.step(c, stores=[(qo[s][1], t)])
        b.pad_to_sync()
    return b.build()
