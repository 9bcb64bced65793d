"""Shared last-level cache model (sliced, set-associative) for DCO.

The LLC is modeled at cache-line granularity with vectorized numpy state so
that paper-scale traces (hundreds of MB of traffic) simulate in seconds.
Bursts of *unique-set* line addresses are processed in one shot; the
simulator's bulk tile transfers are contiguous in the tiled address layout
so a tile burst touches consecutive sets, and :meth:`SharedLLC.access_burst`
internally splits bursts whose set indices would collide.

Replacement priority (paper §IV-A): dead blocks (TMU dead FIFO match) →
anti-thrashing lowest-``tag[B_BITS-1:0]``-tier → LRU tie-break.
Bypass (paper §IV-D): on a miss, incoming lines whose priority is below the
slice's ``B_GEAR`` are not allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple

import numpy as np

from .events import EV_BYPASS
from .events import EV_EVICT
from .events import EV_FILL
from .events import EV_HIT
from .events import EV_WB
from .policies import BYPASS_NONE
from .policies import GearController
from .policies import PolicyConfig
from .policies import make_controller
from .tmu import TMU

# Access outcome codes (returned per line).  The numeric values encode
# the outcome arithmetically: miss code = 1 + seen_before + 2*bypassed.
HIT = 0
COLD_MISS = 1
CONFLICT_MISS = 2
BYPASSED_COLD = 3
BYPASSED_CONFLICT = 4

_MISS_CODES = (COLD_MISS, CONFLICT_MISS, BYPASSED_COLD, BYPASSED_CONFLICT)

# sentinel for "invalid way" in the last_use / prio state arrays: larger
# than any real LRU stamp or priority, so victim selection needs no
# validity masking on its hot path
_BIG = np.int64(1) << 60


@dataclass(frozen=True)
class CacheGeometry:
    size_bytes: int
    line_bytes: int = 128
    assoc: int = 8
    n_slices: int = 32
    # XOR set-index hashing (standard in sliced LLCs): folds tag bits into
    # the set index so power-of-2 tensor strides don't alias onto the same
    # sets.  tag_of is unchanged (tag = full line//num_sets), so lookups
    # stay exact.
    hash_sets: bool = True

    @property
    def num_lines(self) -> int:
        return self.size_bytes // self.line_bytes

    @property
    def num_sets(self) -> int:
        return self.num_lines // self.assoc

    def __post_init__(self) -> None:
        if self.num_lines % self.assoc:
            raise ValueError("cache size must be a multiple of line*assoc")
        ns = self.num_sets
        if ns & (ns - 1):
            raise ValueError("number of sets must be a power of two")

    def set_of(self, line_addr: np.ndarray) -> np.ndarray:
        line = line_addr // self.line_bytes
        if self.hash_sets:
            # Fibonacci-fold the tag into the index: within one aligned
            # num_sets-line block the mapping stays a bijection (no
            # intra-tile collisions), while blocks at power-of-2 strides
            # land in decorrelated set bands.
            tag = line // self.num_sets
            line = line ^ (tag * 0x9E3779B1)
        return line % self.num_sets

    def tag_of(self, line_addr: np.ndarray) -> np.ndarray:
        return (line_addr // self.line_bytes) // self.num_sets

    def line_addr_of(self, set_idx: np.ndarray,
                     tags: np.ndarray) -> np.ndarray:
        """Inverse of ``(set_of, tag_of)``: reconstruct the byte address
        of a resident line from its (set, tag).  Exact because the
        Fibonacci fold XORs into a power-of-two index — used by the
        event layer to attribute victims back to tensors/tenants."""
        low = set_idx
        if self.hash_sets:
            low = (set_idx ^ (tags * 0x9E3779B1)) % self.num_sets
        return (tags * self.num_sets + low) * self.line_bytes

    def slice_of_set(self, set_idx: np.ndarray) -> np.ndarray:
        return set_idx % self.n_slices


@dataclass
class AccessPlan:
    """Precomputed burst structure for :meth:`SharedLLC.access_planned`.

    Holds what :meth:`SharedLLC.access_burst` would recompute on every
    call for a fixed (addresses, geometry) pair: the set index of every
    line and the same-set pass split.  ``passes`` is ``None`` when all
    sets in the burst are distinct (single-shot fast path); otherwise it
    lists, per pass, the ascending line indices whose set's k-th
    occurrence falls in that pass — byte-identical chunking to
    ``access_burst``.  Plans are geometry-specific but policy-independent,
    so a policy sweep computes them once (see
    ``CompiledTrace.plans_for``)."""

    line_addrs: np.ndarray
    sets: np.ndarray
    passes: Optional[List[np.ndarray]] = None
    tags: Optional[np.ndarray] = None


class SharedLLC:
    """Vectorized set-associative shared cache with DCO policies.

    ``tenant_map`` (multi-tenant composites, DESIGN.md §8.4) is the
    sorted ``(region_start_addrs, tenant_ids)`` pair from
    ``Trace.tenant_region_starts``: write-backs are attributed to the
    *victim line's* tenant (``tenant_wb``), and — with the opt-in
    ``policy.per_tenant_gears`` — the dynamic-bypass controller runs
    one feedback loop per tenant, each access consulting and charging
    its own tenant's gear.
    """

    def __init__(self, geom: CacheGeometry, policy: PolicyConfig,
                 tmu: Optional[TMU] = None,
                 tenant_map: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.geom = geom
        self.policy = policy
        self.tmu = tmu
        S, A = geom.num_sets, geom.assoc
        self.tags = np.full((S, A), -1, dtype=np.int64)
        self.valid = np.zeros((S, A), dtype=bool)
        self.dirty = np.zeros((S, A), dtype=bool)
        # invariant: invalid ways hold _BIG in last_use/prio (and -1 in
        # tags), so lookup and victim selection skip validity masking
        self.last_use = np.full((S, A), _BIG, dtype=np.int64)
        self.prio = np.full((S, A), _BIG, dtype=np.int64)
        # owning tensor id per resident line (event attribution that
        # stays exact when a pooled allocator recycles addresses across
        # tensor generations); maintained only when callers thread tids
        self.owner = np.full((S, A), -1, dtype=np.int64)
        self._clock = 0  # monotone access counter for LRU
        # tenant attribution state: regions are huge and aligned, so the
        # byte-address region map projects exactly onto tag space
        # (tag = line // num_sets is monotone in the address)
        self.n_tenants = 1
        self._tenant_tag_starts: Optional[np.ndarray] = None
        self._tenant_ids: Optional[np.ndarray] = None
        self.tenant_wb: Optional[np.ndarray] = None
        if tenant_map is not None:
            starts, tens = tenant_map
            tag_bytes = geom.line_bytes * geom.num_sets
            if (starts % tag_bytes).any():
                # a region base inside a tag region would silently
                # misattribute every access near the boundary — the
                # composite's region alignment must cover one tag
                # (compose_time_sliced's REGION_ALIGN_BYTES does for
                # every suite geometry; huge LLCs need a larger one)
                raise ValueError(
                    f"tenant region bases must be multiples of the tag "
                    f"granularity num_sets*line_bytes={tag_bytes}; "
                    f"recompose with region_align_bytes>={tag_bytes}")
            self.n_tenants = int(tens.max()) + 1
            self._tenant_tag_starts = starts // tag_bytes
            self._tenant_ids = tens
            self.tenant_wb = np.zeros(self.n_tenants, dtype=np.int64)
        self.controller: Optional[GearController] = make_controller(
            geom.n_slices, policy, self.n_tenants)
        self._per_tenant_gears = (self.controller is not None
                                  and self.controller.n_tenants > 1)
        self.stats: Dict[str, int] = {
            "hits": 0, "cold_misses": 0, "conflict_misses": 0,
            "bypassed": 0, "evictions": 0, "dead_evictions": 0,
            "writebacks": 0,
        }
        self._prio_mask = (1 << policy.b_bits) - 1 if policy.b_bits else 0
        # opt-in event telemetry (repro_torch.core.events.EventSink); every
        # emission site is guarded by `sink is not None` so the hot path
        # is untouched when tracing is off
        self.sink = None

    # ------------------------------------------------------------------
    def tenant_of_tags(self, tags: np.ndarray) -> np.ndarray:
        """Tenant index of each cache tag (requires a tenant map)."""
        idx = np.searchsorted(self._tenant_tag_starts, tags,
                              side="right") - 1
        return self._tenant_ids[np.maximum(idx, 0)]

    # ------------------------------------------------------------------
    def _priorities(self, tags: np.ndarray) -> np.ndarray:
        if self.tmu is not None:
            # TMU owns the bit slicing; mask form is identical but keeps a
            # single source of truth for B_BITS.
            mask = (1 << self.tmu.params.b_bits) - 1
            return tags & mask
        return tags & self._prio_mask

    def gear_of(self, slice_ids: np.ndarray,
                tenant_ids: Optional[np.ndarray] = None) -> np.ndarray:
        if self.controller is None:
            return np.zeros_like(slice_ids)
        return self.controller.gears_at(slice_ids, tenant_ids)

    # ------------------------------------------------------------------
    def access_burst(
        self,
        line_addrs: np.ndarray,
        *,
        seen_before: np.ndarray,
        is_write=False,
        bypass_eligible=True,
        force_bypass=False,
        cores=None,
        tids=None,
    ) -> np.ndarray:
        """Access a burst of line addresses; returns per-line outcome codes.

        ``seen_before``    bool per line: fetched from DRAM before (cold
                           vs conflict classification, paper §V-B).
        ``bypass_eligible`` gqa_bypass gating: only the slower core of a
                           sharing pair may bypass (simulator decides);
                           scalar or per-line bool array.
        ``force_bypass``   whole-tensor bypass (TMU ``bypass_all``), e.g.
                           Q/O tensors in FlashAttention; scalar or array.
        ``cores``          optional int64 array (issuing core per line),
                           only consulted for event-trace attribution
                           when a sink is attached.
        ``tids``           optional int64 array (owning tensor per line):
                           exact event attribution under address reuse —
                           accesses carry their tensor, and the per-way
                           ``owner`` state attributes evictions and
                           write-backs to the victim's tensor.

        Duplicate line addresses within one burst model MSHR behavior:
        the second occurrence of an *allocated* line hits (MSHR/LLC hit —
        the paper treats both classes at ``v_LLC``, §V-C), while duplicates
        of a *bypassed* line miss again (the paper's "bypassing blindly
        will miss some inter-core reuse opportunities", §IV-E).
        """
        line_addrs = np.asarray(line_addrs, dtype=np.int64)
        out = np.empty(line_addrs.shape[0], dtype=np.int64)
        sets = self.geom.set_of(line_addrs)
        n = line_addrs.shape[0]
        if n == 0:
            return out
        # fast path: all sets unique
        if np.unique(sets).shape[0] == n:
            out[:] = self._access_unique(line_addrs, sets, seen_before,
                                         is_write, bypass_eligible,
                                         force_bypass, cores=cores,
                                         tids=tids)
            return out
        # split into chunks with unique sets so state updates don't collide
        order = np.argsort(sets, kind="stable")
        sorted_sets = sets[order]
        # pass index: the k-th occurrence of a set goes into chunk k
        # (vectorized: position within the run of equal sorted sets)
        _, first_pos, counts = np.unique(sorted_sets, return_index=True,
                                         return_counts=True)
        run_start = np.repeat(first_pos, counts)
        pass_idx_sorted = np.arange(n) - run_start
        pass_idx = np.empty(n, dtype=np.int64)
        pass_idx[order] = pass_idx_sorted
        max_pass = int(pass_idx_sorted.max())
        for p in range(max_pass + 1):
            sel = np.nonzero(pass_idx == p)[0]
            out[sel] = self._access_unique(
                line_addrs[sel], sets[sel],
                _index(seen_before, sel), _index(is_write, sel),
                _index(bypass_eligible, sel), _index(force_bypass, sel),
                cores=None if cores is None else cores[sel],
                tids=None if tids is None else tids[sel])
        return out

    # ------------------------------------------------------------------
    def access_planned(
        self,
        plan: AccessPlan,
        *,
        seen_before: np.ndarray,
        is_write=False,
        bypass_eligible=True,
        force_bypass=False,
        cores=None,
        tids=None,
    ) -> np.ndarray:
        """:meth:`access_burst` with the set mapping and pass split taken
        from a precomputed :class:`AccessPlan` (same outcome codes and
        state transitions; the per-call ``argsort``/``unique`` work is
        hoisted out of the policy sweep's inner loop)."""
        n = plan.line_addrs.shape[0]
        out = np.empty(n, dtype=np.int64)
        if n == 0:
            return out
        tags = plan.tags
        if plan.passes is None:
            out[:] = self._access_unique(plan.line_addrs, plan.sets,
                                         seen_before, is_write,
                                         bypass_eligible, force_bypass,
                                         tags=tags, cores=cores,
                                         tids=tids)
            return out
        for sel in plan.passes:
            out[sel] = self._access_unique(
                plan.line_addrs[sel], plan.sets[sel],
                _index(seen_before, sel), _index(is_write, sel),
                _index(bypass_eligible, sel), _index(force_bypass, sel),
                tags=None if tags is None else tags[sel],
                cores=None if cores is None else cores[sel],
                tids=None if tids is None else tids[sel])
        return out

    # ------------------------------------------------------------------
    def _access_unique(self, line_addrs, sets, seen_before, is_write,
                       bypass_eligible, force_bypass,
                       tags=None, cores=None, tids=None) -> np.ndarray:
        n = line_addrs.shape[0]
        sink = self.sink
        if tags is None:
            tags = self.geom.tag_of(line_addrs)
        out = np.empty(n, dtype=np.int64)
        seen_before = _bool_vec(seen_before, n)
        is_write = _bool_vec(is_write, n)
        bypass_eligible = _bool_vec(bypass_eligible, n)
        force_bypass = _bool_vec(force_bypass, n)
        self._clock += 1
        now = self._clock

        # lookup: invalid ways hold tag -1 and real tags are >= 0, so a
        # tag match alone implies validity (no valid-mask gather)
        set_tags = self.tags[sets]            # [n, A]
        hit_mask_ways = set_tags == tags[:, None]
        hit = hit_mask_ways.any(axis=1)
        hit_way = np.argmax(hit_mask_ways, axis=1)
        n_hit = int(hit.sum())

        # --- hits: refresh LRU ------------------------------------------------
        if n_hit:
            hs, hw = sets[hit], hit_way[hit]
            self.last_use[hs, hw] = now
            if tids is not None:
                # a hit under address reuse means the recycled line is
                # adopted by its new tensor generation
                self.owner[hs, hw] = tids[hit]
            w = is_write[hit]
            if w.any():
                self.dirty[hs[w], hw[w]] = True
            out[hit] = HIT
            self.stats["hits"] += n_hit
            # hits feed the eviction-rate denominator of the gear feedback
            if self.controller is not None:
                self._record_controller(hs, np.zeros(n_hit, dtype=bool),
                                        tags[hit])
            if sink is not None:
                sink.emit_lines(EV_HIT, line_addrs[hit], sets=hs, ways=hw,
                                cores=None if cores is None
                                else cores[hit],
                                tensors=None if tids is None
                                else tids[hit])
            if n_hit == n:
                return out

        miss = ~hit
        m_sets = sets[miss]
        m_tags = tags[miss]
        m_seen = seen_before[miss]

        # --- bypass decision (before allocation, paper §IV-D) ----------------
        if self.policy.bypass != BYPASS_NONE:
            m_tenants = (self.tenant_of_tags(m_tags)
                         if self._per_tenant_gears else None)
            gears = self.gear_of(self.geom.slice_of_set(m_sets), m_tenants)
            bypass = ((self._priorities(m_tags) < gears)
                      & bypass_eligible[miss]) | force_bypass[miss]
        else:
            bypass = force_bypass[miss]

        # outcome code = 1 + seen + 2*bypassed (see the constants above)
        out[miss] = 1 + m_seen + 2 * bypass
        n_conf = int(m_seen.sum())
        self.stats["bypassed"] += int(bypass.sum())
        self.stats["cold_misses"] += (n - n_hit) - n_conf
        self.stats["conflict_misses"] += n_conf

        m_tids = None if tids is None else tids[miss]
        if sink is not None:
            m_addrs = line_addrs[miss]
            m_cores = None if cores is None else cores[miss]
            bp = np.nonzero(bypass)[0]
            if bp.shape[0]:
                sink.emit_lines(EV_BYPASS, m_addrs[bp], sets=m_sets[bp],
                                cores=None if m_cores is None
                                else m_cores[bp],
                                aux=m_seen[bp].astype(np.int64),
                                tensors=None if m_tids is None
                                else m_tids[bp])

        # --- allocation (alloc-on-fill; write-allocate) -----------------------
        alloc = ~bypass
        if alloc.any():
            a_sets = m_sets[alloc]
            a_tags = m_tags[alloc]
            way, evicted_valid, evicted_dead = self._select_victims(a_sets)
            # victim tags/owners must be read before the fill overwrites
            v_tags = self.tags[a_sets, way] if sink is not None else None
            v_owner = (self.owner[a_sets, way]
                       if sink is not None and tids is not None else None)
            # writeback accounting for dirty victims
            wb = self.dirty[a_sets, way] & evicted_valid
            self.stats["writebacks"] += int(wb.sum())
            if self.tenant_wb is not None and wb.any():
                # charge the write-back to the *victim's* tenant region
                victim_tenants = self.tenant_of_tags(
                    self.tags[a_sets[wb], way[wb]])
                self.tenant_wb += np.bincount(victim_tenants,
                                              minlength=self.n_tenants)
            self.stats["evictions"] += int(evicted_valid.sum())
            self.stats["dead_evictions"] += int(evicted_dead.sum())
            self.tags[a_sets, way] = a_tags
            self.valid[a_sets, way] = True
            self.dirty[a_sets, way] = is_write[miss][alloc]
            self.last_use[a_sets, way] = now
            self.prio[a_sets, way] = self._priorities(a_tags)
            if tids is not None:
                self.owner[a_sets, way] = m_tids[alloc]
            ev_full = np.zeros(m_sets.shape[0], dtype=bool)
            ev_full[alloc] = evicted_valid
            if sink is not None:
                geom = self.geom
                ev = np.nonzero(evicted_valid)[0]
                if ev.shape[0]:
                    sink.emit_lines(
                        EV_EVICT, geom.line_addr_of(a_sets[ev], v_tags[ev]),
                        sets=a_sets[ev], ways=way[ev],
                        aux=2 * v_tags[ev] + evicted_dead[ev],
                        tensors=None if v_owner is None else v_owner[ev])
                wbi = np.nonzero(wb)[0]
                if wbi.shape[0]:
                    sink.emit_lines(
                        EV_WB, geom.line_addr_of(a_sets[wbi], v_tags[wbi]),
                        sets=a_sets[wbi], ways=way[wbi], aux=v_tags[wbi],
                        tensors=None if v_owner is None else v_owner[wbi])
                sink.emit_lines(
                    EV_FILL, m_addrs[alloc], sets=a_sets, ways=way,
                    cores=None if m_cores is None else m_cores[alloc],
                    aux=2 * a_tags + m_seen[alloc],
                    tensors=None if m_tids is None else m_tids[alloc])
        else:
            ev_full = np.zeros(m_sets.shape[0], dtype=bool)

        if self.controller is not None:
            self._record_controller(m_sets, ev_full, m_tags)
        return out

    # ------------------------------------------------------------------
    def _select_victims(self, a_sets: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized victim choice: invalid → dead → anti-thrash tier → LRU.

        Relies on the state invariant that invalid ways hold ``_BIG`` in
        ``last_use``/``prio``, so the LRU and anti-thrashing tiers need
        no per-call validity masking.  Returns (way, evicted_valid,
        evicted_was_dead) per set.
        """
        set_valid = self.valid[a_sets]       # [n, A]
        set_lru = self.last_use[a_sets]      # invalid ways hold _BIG
        n, A = set_valid.shape

        # 1. invalid way available → fill it (no eviction)
        invalid_ways = ~set_valid
        has_invalid = invalid_ways.any(axis=1)
        invalid_way = np.argmax(invalid_ways, axis=1)

        # 2. dead-block prediction: victimize TMU-dead lines first (LRU among dead)
        if self.policy.dbp and self.tmu is not None and len(self.tmu.dead_fifo):
            fifo = np.asarray(self.tmu.dead_fifo.snapshot(), dtype=np.int64)
            p = self.tmu.params
            width = p.d_msb - p.d_lsb + 1
            dead_ids = (self.tags[a_sets] >> p.d_lsb) & ((1 << width) - 1)
            dead_ways = set_valid & np.isin(dead_ids, fifo)
            has_dead = dead_ways.any(axis=1)
            dead_lru = np.where(dead_ways, set_lru, _BIG)
            dead_way = np.argmin(dead_lru, axis=1)
        else:
            has_dead = None

        # 3. anti-thrashing: lowest-priority tier present, tie-break LRU
        # (invalid ways sit at prio _BIG, so they never define the tier
        # unless the whole set is invalid — where has_invalid wins anyway)
        if self.policy.at:
            set_prio = self.prio[a_sets]
            min_tier = set_prio.min(axis=1, keepdims=True)
            tier_ways = set_prio == min_tier
            tier_lru = np.where(tier_ways, set_lru, _BIG)
            fallback_way = np.argmin(tier_lru, axis=1)
        else:
            # 4. plain LRU (invalid ways at _BIG lose to any valid way)
            fallback_way = np.argmin(set_lru, axis=1)

        evicted_valid = ~has_invalid
        if has_dead is None:
            way = fallback_way
            evicted_dead = np.zeros(n, dtype=bool)
        else:
            way = np.where(has_dead, dead_way, fallback_way)
            evicted_dead = evicted_valid & has_dead
        way = np.where(has_invalid, invalid_way, way)
        return way, evicted_valid, evicted_dead

    # ------------------------------------------------------------------
    def _record_controller(self, sets: np.ndarray, evicted: np.ndarray,
                           tags: Optional[np.ndarray] = None) -> None:
        if self.controller is not None and sets.shape[0]:
            tenants = (self.tenant_of_tags(tags)
                       if self._per_tenant_gears and tags is not None
                       else None)
            self.controller.record(self.geom.slice_of_set(sets), evicted,
                                   tenants)

    def tick(self, now_cycles: float) -> None:
        if self.controller is not None:
            self.controller.tick(now_cycles)

    # ------------------------------------------------------------------
    def hit_rate(self) -> float:
        total = (self.stats["hits"] + self.stats["cold_misses"]
                 + self.stats["conflict_misses"])
        return self.stats["hits"] / total if total else 0.0

    def resident_bytes(self) -> int:
        return int(self.valid.sum()) * self.geom.line_bytes


def _index(x, sel):
    """Index ``x`` by ``sel`` if it is an array; pass scalars through."""
    arr = np.asarray(x)
    return arr[sel] if arr.ndim else x


def _bool_vec(x, n):
    """Per-line bool vector: pass bool arrays through, broadcast scalars."""
    a = np.asarray(x, dtype=bool)
    return a if a.ndim else np.broadcast_to(a, (n,))


def is_miss(codes: np.ndarray) -> np.ndarray:
    return codes != HIT


def goes_to_dram(codes: np.ndarray) -> np.ndarray:
    return np.isin(codes, _MISS_CODES)
