"""Reuse-distance profile lowering (DESIGN.md §5/§8.2 — fourth lowering).

``lower_to_reuse_profile(spec)`` walks a :class:`DataflowSpec`'s per-core
round schedule **once** and emits a :class:`ReuseProfile`: for every
repeat access to a reuse-carrier (non-bypass) tile, the *stack distance*
in cache lines since the previous access to the same tile, measured at
round granularity over the burst-synchronous global interleaving
(DESIGN.md §7.2).  The profile is what the analytical model's
``model="profile"`` path evaluates policies against
(`core/analytical.py`): an access hits iff its policy-transformed
distance fits the effective capacity — one evaluation rule for every
replacement/bypass mechanism instead of per-policy closed forms.

Four facts of the schedule that scalar working-set models collapse are
kept explicit:

* **sharer-awareness** — cores are interleaved in the exact lockstep
  order the simulator executes, so inter-core co-streaming shows up as
  short distances (the lagging rank of a sharing group) or as
  distance-0 MSHR merges (same-round same-tile requests), exactly the
  population blind bypassing destroys (paper §IV-E);
* **epoch-awareness** — each distance is split into *live* mass and
  *dead* mass.  A tile is dead once its load count reaches the declared
  ``n_acc`` (the TMU's retirement rule, paper §IV-B); dead tiles of
  retired working-set generations contribute pollution that DBP removes
  (``d_live``) and every other policy suffers (``d_live + d_dead``);
* **priority tiers** — each entry records its tile's first line address,
  so the model can recover the hardware's ``tag[B_BITS-1:0]`` priority
  tier for any cache geometry (anti-thrashing protection and bypass
  gears partition reuse mass by exactly these bits);
* **dirty lifetimes** — entries carry store flags and per-tile chain
  indices, and the tile table carries cold-store flags and tail
  distances, so the model can propagate P(dirty) along each tile's
  access sequence and price write-backs by when a dirtied tile actually
  ages past capacity (the §V-B dirty-eviction traffic term).

The walk is O(accesses · log accesses) at *tile* granularity (two
Fenwick trees over the access sequence), so paper-scale suite specs
profile in milliseconds — cheap enough to thread through
``lower_to_counts`` by default.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple

import numpy as np

from .ir import DataflowSpec


class _Fenwick:
    """Prefix-sum tree over access positions (weights = lines)."""

    __slots__ = ("n", "t")

    def __init__(self, n: int):
        self.n = n
        self.t = [0] * (n + 1)

    def add(self, i: int, v: int) -> None:
        i += 1
        while i <= self.n:
            self.t[i] += v
            i += i & -i

    def prefix(self, i: int) -> int:
        """Sum of weights at positions [0, i]."""
        i += 1
        s = 0
        while i > 0:
            s += self.t[i]
            i -= i & -i
        return s

    def range(self, a: int, b: int) -> int:
        """Sum of weights at positions [a, b] (inclusive); 0 if empty."""
        if b < a:
            return 0
        return self.prefix(b) - (self.prefix(a - 1) if a > 0 else 0)


@dataclass
class ReuseProfile:
    """Round-granularity reuse-distance profile of one dataflow.

    **Reuse entries** (one per repeat access to a reuse-carrier tile;
    parallel arrays):

    * ``e_round``     lockstep round of the access
    * ``e_tensor``    tensor index (declaration order)
    * ``e_line``      first line index of the tile (absolute, for
                      geometry-exact ``tag[B_BITS-1:0]`` tier recovery)
    * ``e_mass``      lines in the tile (the entry's request mass)
    * ``e_dlive``     live stack distance in lines (distinct
                      still-live mass touched since the previous access)
    * ``e_ddead``     dead mass in the same window (TMU-retired tiles —
                      the pollution DBP removes)
    * ``e_intercore`` previous access was issued by another core
    * ``e_mshr``      same-round merge (distance 0, MSHR hit)
    * ``e_store``     the access is a store (dirties the line —
                      write-allocate; input to the dirty-lifetime model)
    * ``e_tile``      index into the distinct-tile table below, so the
                      model can chain a tile's accesses (dirty-bit
                      propagation needs the access *sequence* per tile,
                      not just marginal distances)
    * ``e_prev_round`` round of the tile's previous access — the gear
                      trajectory needs it to know whether the line's
                      last fill was *allocated* (bypass decisions are
                      made at fill time, so a tier bypassed now may
                      still be resident from a lower-gear window)

    **Per-round traffic** that is not reuse, kept per tenant (second
    axis; single-tenant specs have one column): ``cold_rt`` (first
    touches of reuse carriers), ``byp_cold_rt`` / ``byp_rep_rt``
    (whole-tensor-bypass Q/O traffic, first touch vs repeat).  The
    tenant-summed views remain available as ``cold_round`` /
    ``byp_cold_round`` / ``byp_rep_round``; ``flops_round`` stays
    global.  (Write-back volume is not a per-round tally here: the
    model derives it from the dirty-lifetime facts below.)

    **Tenant attribution** (multi-tenant composites, DESIGN.md §8.4):
    ``tenant_names`` and ``tenant_of_tensor`` (tensor index → tenant)
    plus ``t_tensor`` (tile → tensor index) let every mass above be
    keyed by tenant — ``e_tenant`` / ``t_tenant`` are the derived
    per-entry / per-tile tenant indices the model's per-slice gear mode
    evaluates against.

    **Footprint** facts for tier partitioning: the distinct tile table
    (``t_line``/``t_mass``/``t_dies``) and ``max_live_lines`` — the peak
    concurrently-live stack mass (the profile-derived active working
    set).

    **Dirty-lifetime** facts (DESIGN.md §5, the write-back model): per
    tile, whether its *first* touch was a store (``t_cold_store`` —
    produced-then-consumed tensors allocate dirty), the round of its
    last access (``t_last_round``), and the tile's *tail* stack distance
    ``t_tail_dlive``/``t_tail_ddead`` — distinct live/dead mass touched
    between the tile's final access and the end of the schedule.  A tile
    still dirty at its last access writes back iff that forward distance
    ages it past capacity (the same distance-vs-capacity rule hits are
    evaluated under); distances from a store to the tile's next access
    are already the reuse entries themselves (``e_store`` marks them).
    """

    name: str
    line_bytes: int
    n_rounds: int
    tensor_names: List[str]
    e_round: np.ndarray
    e_tensor: np.ndarray
    e_line: np.ndarray
    e_mass: np.ndarray
    e_dlive: np.ndarray
    e_ddead: np.ndarray
    e_intercore: np.ndarray
    e_mshr: np.ndarray
    e_store: np.ndarray
    e_tile: np.ndarray
    e_prev_round: np.ndarray
    cold_rt: np.ndarray                # (n_rounds, n_tenants)
    byp_cold_rt: np.ndarray            # (n_rounds, n_tenants)
    byp_rep_rt: np.ndarray             # (n_rounds, n_tenants)
    flops_round: np.ndarray
    t_line: np.ndarray
    t_mass: np.ndarray
    t_tensor: np.ndarray               # tile → tensor index
    t_dies: np.ndarray                 # tile reaches n_acc (TMU-retired)
    t_cold_store: np.ndarray           # first touch was a store (dirty fill)
    t_cold_round: np.ndarray           # round of the tile's first touch
    t_last_round: np.ndarray           # round of the tile's final access
    t_tail_dlive: np.ndarray           # live mass after the final access
    t_tail_ddead: np.ndarray           # dead mass after the final access
    max_live_lines: int
    tenant_names: List[str] = field(default_factory=lambda: ["t0"])
    tenant_of_tensor: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    _eval_cache: Dict[tuple, dict] = field(default_factory=dict,
                                           init=False, repr=False,
                                           compare=False)

    # ------------------------------------------------------------------
    @property
    def n_entries(self) -> int:
        return int(self.e_mass.shape[0])

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_names)

    @property
    def cold_round(self) -> np.ndarray:
        return self.cold_rt.sum(axis=1)

    @property
    def byp_cold_round(self) -> np.ndarray:
        return self.byp_cold_rt.sum(axis=1)

    @property
    def byp_rep_round(self) -> np.ndarray:
        return self.byp_rep_rt.sum(axis=1)

    @property
    def e_tenant(self) -> np.ndarray:
        return self.tenant_of_tensor[self.e_tensor]

    @property
    def t_tenant(self) -> np.ndarray:
        return self.tenant_of_tensor[self.t_tensor]

    def total_reuse_mass(self) -> int:
        """Total repeat-access mass in lines — pinned equal to
        ``DataflowCounts.n_temporal_reuse + n_intercore_reuse``."""
        return int(self.e_mass.sum())

    def intercore_reuse_mass(self) -> int:
        return int(self.e_mass[self.e_intercore].sum())

    def footprint_lines(self) -> int:
        """Distinct reuse-carrier lines ever touched
        (== ``DataflowCounts.n_kv_distinct``)."""
        return int(self.t_mass.sum())

    def histogram(self, tensor: Optional[str] = None,
                  dbp: bool = False) -> Dict[int, int]:
        """Reuse-distance histogram ``{distance_lines: mass_lines}``.

        ``dbp=True`` buckets by the live distance only (retired-epoch
        pollution removed); default is the full LRU stack distance
        ``d_live + d_dead``.  Restrict to one tensor by name.
        """
        d = self.e_dlive if dbp else self.e_dlive + self.e_ddead
        mass = self.e_mass
        if tensor is not None:
            sel = self.e_tensor == self.tensor_names.index(tensor)
            d, mass = d[sel], mass[sel]
        out: Dict[int, int] = {}
        for dist, m in zip(d.tolist(), mass.tolist()):
            out[dist] = out.get(dist, 0) + m
        return out


# ---------------------------------------------------------------------------
def lower_to_reuse_profile(spec: DataflowSpec) -> ReuseProfile:
    """Derive the :class:`ReuseProfile` from one schedule walk.

    Accesses are visited in the simulator's global order (round-major,
    core order within a round, loads before stores within a step).
    Same-round repeat accesses to a tile merge MSHR-style into
    distance-0 entries; otherwise the distance is the distinct tile mass
    (in lines) touched since the tile's previous access, split into live
    and TMU-dead components by two Fenwick trees over the sequence.
    """
    from .lower import assign_addresses      # lazy: lower.py imports us

    metas = assign_addresses(spec)
    lb = spec.line_bytes
    n_rounds = spec.n_rounds

    lines_per_tile = [t.tile_bytes // lb for t in spec.tensors]
    start_line = [metas[i].base_addr // lb for i in range(len(spec.tensors))]
    n_acc = [t.n_acc for t in spec.tensors]
    is_bypass = [t.bypass for t in spec.tensors]
    if spec.tenant_of_tensor is not None and spec.tenant_names:
        tenant_names = list(spec.tenant_names)
        tn_of = [spec.tenant_of_tensor[t.name] for t in spec.tensors]
    else:
        tenant_names = [spec.name]
        tn_of = [0] * len(spec.tensors)
    n_ten = len(tenant_names)

    # ---- pass 1: flatten the schedule into the global access sequence
    # (reuse carriers only; bypass traffic is tallied per round directly)
    seq_round: List[int] = []
    seq_core: List[int] = []
    seq_tid: List[int] = []
    seq_tile: List[int] = []
    seq_store: List[bool] = []
    cold_rt = np.zeros((n_rounds, n_ten), dtype=np.int64)
    byp_cold_rt = np.zeros((n_rounds, n_ten), dtype=np.int64)
    byp_rep_rt = np.zeros((n_rounds, n_ten), dtype=np.int64)
    flops_round = np.zeros(n_rounds, dtype=np.float64)
    byp_seen: set = set()
    tid_of = {t.name: i for i, t in enumerate(spec.tensors)}

    for r in range(n_rounds):
        for c, prog in enumerate(spec.core_programs):
            if r >= len(prog):
                continue
            step = prog[r]
            flops_round[r] += step.flops
            for (tname, tile), is_store in (
                    [(ld, False) for ld in step.loads]
                    + [(s, True) for s in step.stores]):
                tid = tid_of[tname]
                if is_bypass[tid]:
                    key = (tid, tile)
                    if key in byp_seen:
                        byp_rep_rt[r, tn_of[tid]] += lines_per_tile[tid]
                    else:
                        byp_seen.add(key)
                        byp_cold_rt[r, tn_of[tid]] += lines_per_tile[tid]
                    continue
                seq_round.append(r)
                seq_core.append(c)
                seq_tid.append(tid)
                seq_tile.append(tile)
                seq_store.append(is_store)

    # ---- pass 2: weighted stack distances over the sequence
    P = len(seq_round)
    live = _Fenwick(P)
    dead = _Fenwick(P)
    # per-tile state: [position, core, round, in_dead_tree, load_count]
    state: Dict[Tuple[int, int], list] = {}
    tile_info: Dict[Tuple[int, int], Tuple[int, int]] = {}  # key → (line, mass)
    tile_idx: Dict[Tuple[int, int], int] = {}               # key → table index
    tile_died: set = set()
    cold_store: List[bool] = []        # per table index: first touch a store
    cold_rnd: List[int] = []           # per table index: first-touch round
    live_total = 0
    max_live = 0

    e_round: List[int] = []
    e_tensor: List[int] = []
    e_line: List[int] = []
    e_mass: List[int] = []
    e_dlive: List[int] = []
    e_ddead: List[int] = []
    e_intercore: List[bool] = []
    e_mshr: List[bool] = []
    e_store: List[bool] = []
    e_tile: List[int] = []
    e_prev_round: List[int] = []

    for i in range(P):
        r, c = seq_round[i], seq_core[i]
        tid, tile = seq_tid[i], seq_tile[i]
        is_store = seq_store[i]
        key = (tid, tile)
        mass = lines_per_tile[tid]
        line = start_line[tid] + tile * mass

        st = state.get(key)
        if st is not None and st[2] == r:
            # same-round duplicate: merges in the MSHRs — an in-flight
            # fill exists whatever the policy, so this is always a hit
            e_round.append(r)
            e_tensor.append(tid)
            e_line.append(line)
            e_mass.append(mass)
            e_dlive.append(0)
            e_ddead.append(0)
            e_intercore.append(c != st[1])
            e_mshr.append(True)
            e_store.append(is_store)
            e_tile.append(tile_idx[key])
            e_prev_round.append(st[2])
            if not is_store:
                st[4] += 1
                if st[4] >= n_acc[tid] and not st[3]:
                    # the merged load still bumps accCnt: move the
                    # tile's stack weight into the dead tree in place
                    live.add(st[0], -mass)
                    dead.add(st[0], mass)
                    st[3] = True
                    live_total -= mass
                    tile_died.add(key)
            continue

        if st is not None:
            p = st[0]
            d_live = live.range(p + 1, i - 1)
            d_dead = dead.range(p + 1, i - 1)
            e_round.append(r)
            e_tensor.append(tid)
            e_line.append(line)
            e_mass.append(mass)
            e_dlive.append(d_live)
            e_ddead.append(d_dead)
            e_intercore.append(c != st[1])
            e_mshr.append(False)
            e_store.append(is_store)
            e_tile.append(tile_idx[key])
            e_prev_round.append(st[2])
            (dead if st[3] else live).add(p, -mass)
            if not st[3]:
                live_total -= mass
        else:
            cold_rt[r, tn_of[tid]] += mass
            tile_idx[key] = len(tile_info)
            tile_info[key] = (line, mass)
            cold_store.append(is_store)
            cold_rnd.append(r)

        cnt = (st[4] if st is not None else 0) + (0 if is_store else 1)
        dies = cnt >= n_acc[tid]
        (dead if dies else live).add(i, mass)
        if dies:
            tile_died.add(key)
        else:
            live_total += mass
            if live_total > max_live:
                max_live = live_total
        state[key] = [i, c, r, dies, cnt]

    keys = list(tile_info)
    # tail distances: distinct live/dead mass touched after each tile's
    # final access (its remaining window to survive to end-of-schedule —
    # the dirty-lifetime model's eviction rule for still-dirty tiles)
    n_t = len(keys)
    tail_dlive = np.zeros(n_t, dtype=np.int64)
    tail_ddead = np.zeros(n_t, dtype=np.int64)
    last_round = np.zeros(n_t, dtype=np.int64)
    for key, st in state.items():
        idx = tile_idx[key]
        tail_dlive[idx] = live.range(st[0] + 1, P - 1)
        tail_ddead[idx] = dead.range(st[0] + 1, P - 1)
        last_round[idx] = st[2]
    return ReuseProfile(
        name=spec.name, line_bytes=lb, n_rounds=n_rounds,
        tensor_names=[t.name for t in spec.tensors],
        e_round=np.asarray(e_round, dtype=np.int64),
        e_tensor=np.asarray(e_tensor, dtype=np.int64),
        e_line=np.asarray(e_line, dtype=np.int64),
        e_mass=np.asarray(e_mass, dtype=np.int64),
        e_dlive=np.asarray(e_dlive, dtype=np.int64),
        e_ddead=np.asarray(e_ddead, dtype=np.int64),
        e_intercore=np.asarray(e_intercore, dtype=bool),
        e_mshr=np.asarray(e_mshr, dtype=bool),
        e_store=np.asarray(e_store, dtype=bool),
        e_tile=np.asarray(e_tile, dtype=np.int64),
        e_prev_round=np.asarray(e_prev_round, dtype=np.int64),
        cold_rt=cold_rt, byp_cold_rt=byp_cold_rt,
        byp_rep_rt=byp_rep_rt, flops_round=flops_round,
        t_line=np.asarray([tile_info[k][0] for k in keys], dtype=np.int64),
        t_mass=np.asarray([tile_info[k][1] for k in keys], dtype=np.int64),
        t_tensor=np.asarray([k[0] for k in keys], dtype=np.int64),
        t_dies=np.asarray([k in tile_died for k in keys], dtype=bool),
        t_cold_store=np.asarray(cold_store, dtype=bool),
        t_cold_round=np.asarray(cold_rnd, dtype=np.int64),
        t_last_round=last_round,
        t_tail_dlive=tail_dlive, t_tail_ddead=tail_ddead,
        max_live_lines=int(max_live),
        tenant_names=tenant_names,
        tenant_of_tensor=np.asarray(tn_of, dtype=np.int64),
    )
