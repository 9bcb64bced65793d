"""Cache-integrated analytical model (paper §V + DESIGN.md §5).

Predicts execution time for a dataflow with no simulation in the loop.
Two hit-estimation engines share the paper's Eq. 1–5 time machinery:

* ``model="profile"`` (default) — evaluates the IR-derived
  reuse-distance profile (``repro_torch.dataflows.reuse``,
  ``DataflowCounts.reuse_profile``).  Every cache mechanism is a small
  *transform of the profile* and the hit mass is the reuse mass whose
  transformed distance fits the effective capacity — one evaluation
  path for all policies (DESIGN.md §5):

  - **DBP** removes dead-epoch pollution: distance drops from
    ``d_live + d_dead`` to ``d_live``.
  - **Anti-thrashing** partitions reuse mass into the hardware's
    ``2^B_BITS`` ``tag``-derived priority tiers and protects the top
    tiers whose footprint fits; unprotected mass competes for the
    remaining capacity with correspondingly shrunk distances.
  - **Bypass gear g** deletes the lowest ``g`` tiers' mass (their
    reuses miss — including inter-core reuses, the §IV-E failure mode)
    and shrinks everyone else's distances by the deleted fraction;
    dynamic bypassing replays the §IV-D feedback law window by window
    (:func:`gear_trajectory`) and charges each round at its transient
    gear instead of assuming the converged one.
  - **Dirty lifetimes**: a stored tile writes back when it is evicted
    while dirty.  P(dirty) chains along each tile's access sequence
    (store → dirty; miss → the eviction wrote it back and reloads
    clean; hit → dirty persists) and still-dirty tiles age out via
    their tail distance — the same distance-vs-capacity rule as hits,
    so every mechanism's effect on write-back volume falls out of its
    profile transform.
  - MSHR-merge mass (distance 0) always hits, under every policy.

* ``model="closed"`` — the original §V-C scalar step functions
  (``kept_fraction``), kept bit-identical as the fallback for counts
  that carry no profile and as the frozen-oracle baseline.

Shared time structure (both engines):

* Eq. 1: each request class is bottlenecked by the slowest of
  {core LSU issue, LLC throughput, DRAM bandwidth}.
* Eq. 2: ``t = t_hit + t_cold + max(t_comp, t_cf)`` — cold misses are
  bursty and exposed; conflict misses are dispersed and overlap with
  compute.  The profile engine applies Eq. 2 at the simulator's own
  time quantum (per lockstep round, DESIGN.md §7.2); the closed engine
  applies it once globally.
* Eq. 3–5: conflict-miss bandwidth from the demand rate ``v_cf,dmd``
  with fitted constants θ1, θ2, θ3, λ (per hardware/policy family,
  §V-D).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product
import math
from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence
from typing import Tuple

import numpy as np

from .simulator import SimConfig
from .traces import DataflowCounts

MODEL_POLICIES = ("lru", "dbp", "at+dbp", "bypass+dbp", "all")
BYPASS_VARIANTS = ("fix1", "fix3", "optimal")
#: every policy name either hit engine resolves (superset of the paper's
#: figure set; the simulator's named_policy uses the same vocabulary)
_KNOWN_POLICIES = ("lru", "at", "dbp", "at+dbp", "lru+bypass", "at+bypass",
                   "bypass+dbp", "all")


@dataclass(frozen=True)
class ModelParams:
    """Fitted constants of Eq. 4–5 (+ per-round scheduling overhead)."""

    theta1: float = 0.90      # cold-burst DRAM efficiency
    theta2: float = 0.25      # conflict-miss bandwidth floor (×BW)
    theta3: float = 0.65      # conflict-miss bandwidth ceiling (×BW)
    lam: float = 1.00         # demand-rate scale λ
    round_overhead: float = 8.0


@dataclass(frozen=True)
class Prediction:
    cycles: float
    t_hit: float
    t_cold: float
    t_cf: float
    t_comp: float
    n_hit: float
    n_cold: float
    n_cf: float
    kept_fraction: float
    #: predicted dirty-eviction (write-back) line volume; the profile
    #: engine's dirty-lifetime model fills it, the closed forms carry no
    #: write-back term and leave it 0
    n_wb: float = 0.0
    #: per-tenant breakdowns on multi-tenant composite profiles
    #: (DESIGN.md §8.4), ordered like the profile's ``tenant_names``:
    #: hit / miss (cold + conflict, incl. bypass traffic) / write-back
    #: line masses.  ``None`` on single-tenant predictions and the
    #: closed forms.
    n_hit_tenant: Optional[Tuple[float, ...]] = None
    n_miss_tenant: Optional[Tuple[float, ...]] = None
    n_wb_tenant: Optional[Tuple[float, ...]] = None


# ---------------------------------------------------------------------------
# §V-C: kept-fraction closed forms
# ---------------------------------------------------------------------------
def kept_fraction(policy: str, s_work: float, s_llc: float, assoc: int,
                  b_bits: int = 3, bypass_variant: str = "optimal",
                  gqa: bool = False, pollution: float = 1.0) -> float:
    """Fraction of the streaming working set whose reuses hit.

    ``pollution`` scales the effective cache size down (dead data from
    retired batches, §VI-F) — 1.0 with DBP, 1/n_batches without.
    """
    if s_work <= 0:
        return 1.0
    s_eff_at = s_llc * (assoc - 1) / assoc * pollution
    s_eff_full = s_llc * pollution
    tiers = 1 << b_bits

    def at_fraction(work: float, cap: float) -> float:
        if work <= cap:
            return 1.0
        m = int(cap / (work / tiers))
        return min(m, tiers) / tiers

    if policy == "lru":
        return 1.0 if s_work <= s_eff_at else 0.0
    if policy == "dbp":
        # clean separation between adjacent working sets → full cache usable
        return 1.0 if s_work <= s_eff_full else 0.0
    if policy == "at+dbp" or policy == "at":
        return at_fraction(s_work, s_eff_at)
    if policy in ("bypass+dbp", "lru+bypass", "at+bypass", "all"):
        if gqa:
            # conservative gqa_bypass pins nothing beyond LRU behavior
            # (paper Fig. 10 d–f: bypass+dbp ≈ 1.0 under inter-core sharing)
            extra = 1.0 if s_work <= s_eff_full else 0.0
            if policy == "all":
                return max(extra, at_fraction(s_work, s_eff_at))
            return extra
        if bypass_variant == "optimal" or policy == "all":
            return min(1.0, s_eff_full / s_work)
        gear = int(bypass_variant[3:])        # fix1 / fix3 …
        protected = (tiers - gear) / tiers
        s_prot = protected * s_work
        if s_prot <= s_eff_full:
            return protected
        # at (always on with static gears) keeps top tiers of the
        # protected stream
        return at_fraction(s_prot, s_eff_at) * protected
    raise KeyError(f"unknown model policy {policy!r}")


# ---------------------------------------------------------------------------
# Profile engine: policy transforms over the reuse-distance profile
# (DESIGN.md §5; the profile itself is lowered in repro_torch.dataflows.reuse)
# ---------------------------------------------------------------------------
def parse_model_policy(policy: str) -> Tuple[bool, bool, bool]:
    """Resolve a policy name to its mechanism flags ``(at, dbp, bypass)``."""
    if policy not in _KNOWN_POLICIES:
        raise KeyError(f"unknown model policy {policy!r}")
    return (policy in ("at", "at+dbp", "at+bypass", "all"),
            "dbp" in policy or policy == "all",
            "bypass" in policy or policy == "all")


def _static_gear(bypass: bool, variant: str, gqa: bool) -> int:
    """Gear for the non-emulated paths: none → gear 0; static fixN →
    that gear; the conservative gqa variant bypasses nothing the model
    credits (§IV-E).  Dynamic bypassing does not reduce to one gear —
    it runs the window-by-window trajectory (:func:`_gear_trajectory`)."""
    if not bypass or gqa:
        return 0
    return int(variant[3:])


def _hit_prob(d: np.ndarray, lo, hi) -> np.ndarray:
    """Set-associative capacity ramp: certain hit up to ``lo`` =
    ``C·(A-1)/A`` stack lines, certain miss past ``hi`` = ``C·(A+1)/A``,
    linear in between (hashed set mapping spreads a burst binomially
    over sets, so the all-or-nothing step of the closed forms becomes a
    band around the capacity).  ``lo``/``hi`` may be per-element arrays
    (the gear-trajectory path evaluates each access under the band of
    its own round's gear)."""
    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    span = hi - lo
    safe = np.where(span > 0, span, 1.0)
    p = np.clip((hi - d) / safe, 0.0, 1.0)
    return np.where(span > 0, p, (d <= lo).astype(float))


def _profile_outcome(prof, llc_bytes: int, assoc: int, at: bool, dbp: bool,
                     gear, b_bits: int) -> dict:
    """Per-round request-class masses under one transformed profile.

    The single evaluation rule: a reuse entry hits with the probability
    that its transformed distance fits the effective capacity left to
    its mass class.  All mechanism effects are transforms applied before
    that comparison.  Cached on the profile per (geometry, mechanism)
    key — θ/λ only enter the time aggregation, so calibration reuses
    these aggregates.

    ``gear`` is either a scalar (one gear everywhere — the static and
    converged cases), a per-round int array from the §IV-D trajectory
    emulation, or an ``(n_rounds, n_tenants)`` matrix from the
    per-tenant ("per-slice") trajectory mode — each access is then
    evaluated under its own tenant's transient gear.  The per-round
    forms are *residency-aware*: bypass decisions happen at fill time,
    so an access to a currently-bypassed tier still hits if the gear
    **at its previous access** admitted the fill — exactly the
    transient population a gear ramp leaves resident (and the reason a
    converged-gear model overstates bypass losses).
    """
    nr = prof.n_rounds
    if np.ndim(gear) == 0:
        g_r = np.full(nr, int(gear), dtype=np.int64)
        key = (llc_bytes, assoc, at, dbp, int(gear), b_bits)
    else:
        g_r = np.asarray(gear, dtype=np.int64)
        key = (llc_bytes, assoc, at, dbp, g_r.ndim, g_r.tobytes(), b_bits)
    out = prof._eval_cache.get(key)
    if out is not None:
        return out

    e_ten = prof.e_tenant
    t_ten = prof.t_tenant
    n_ten = prof.n_tenants

    def g_at(rounds, tenants):
        return g_r[rounds] if g_r.ndim == 1 else g_r[rounds, tenants]

    cap_lines = llc_bytes // prof.line_bytes
    c_lo = cap_lines * (assoc - 1) / assoc
    c_hi = cap_lines * (assoc + 1) / assoc
    num_sets = max(cap_lines // assoc, 1)
    n_tiers = 1 << b_bits

    # hardware priority tier = tag[B_BITS-1:0]; tag = line // num_sets
    t_prio = (prof.t_line // num_sets) % n_tiers
    e_prio = (prof.e_line // num_sets) % n_tiers
    fp = np.bincount(t_prio, weights=prof.t_mass.astype(float),
                     minlength=n_tiers)
    total_fp = float(fp.sum())
    if dbp and total_fp > 0:
        # dead generations retire on the fly: only the peak live stack
        # competes for capacity, spread over the tiers proportionally
        fp = fp * (prof.max_live_lines / total_fp)
    stack_total = float(fp.sum())

    # per-gear transform tables (bypass survivors, anti-thrashing
    # eviction-order stratification, distance shrink); a trajectory
    # indexes them per access
    max_g = 1 << b_bits
    # at: the victim is always the lowest tier *present in the set*
    # (§IV-A), so a tier-t line survives through two regimes and hits if
    # either keeps it resident:
    #
    # * **stratified** — higher-tier lines are never victimized while a
    #   lower tier is present, so their *standing* occupancy (their
    #   share of the distinct mass touched so far in the run —
    #   time-aware: early accesses see an empty cache, late ones the
    #   accumulated high-tier residue dead tiles pin there without DBP)
    #   shrinks the capacity left to tier t, inside which the line
    #   competes in LRU order against its own tier's window mass.
    #   Tiers below the gear are not refilled, but their *resident*
    #   lines sit at the very bottom of this order: every surviving
    #   allocation victimizes them first, so their competing mass is
    #   the whole surviving stream under the capacity the whole
    #   surviving standing occupancy leaves over (the ROADMAP
    #   "resident bypassed-tier" coupling).
    # * **churn** — alloc-on-fill keeps ~one way per set of streaming
    #   churn even when the standing tiers saturate capacity: a
    #   *just-used* line of any tier survives until its set's next
    #   allocation — a recency window of one line per set
    #   (capacity/assoc) against the allocation stream between its
    #   accesses.
    dscale_tab = np.zeros((max_g + 1, n_tiers))
    above_tab = np.zeros((max_g + 1, n_tiers))   # standing mass, tiers > t
    shrink_tab = np.ones(max_g + 1)     # no-at: deleted-fraction scale
    for g in np.unique(g_r).tolist():
        surv = np.arange(n_tiers) >= g
        fp_surv = np.where(surv, fp, 0.0)
        W = float(fp_surv.sum())
        shrink_tab[g] = (W / stack_total) if stack_total else 1.0
        if at:
            dscale_tab[g] = np.where(
                surv, fp_surv / stack_total if stack_total else 0.0,
                shrink_tab[g])
            above_tab[g] = np.where(
                surv,
                np.concatenate((np.cumsum(fp_surv[::-1])[::-1][1:], [0.0])),
                W)

    # fraction of the run's distinct footprint touched by each round —
    # the ramp of the standing higher-tier occupancy above
    if at:
        touched = np.cumsum(prof.cold_round.astype(float))
        touched_frac = touched / total_fp if total_fp else touched

    e_gear = g_at(prof.e_round, e_ten)
    e_prev_gear = g_at(prof.e_prev_round, e_ten)
    # residency: the line's last fill allocated iff its tier survived
    # the gear active *then* (with one gear everywhere this reduces to
    # the plain "bypassed tiers never hit" transform)
    not_resident = (e_prio < e_prev_gear) & ~prof.e_mshr

    # --- dbp transform: dead-epoch pollution leaves the stack ----------
    d = (prof.e_dlive if dbp else prof.e_dlive + prof.e_ddead).astype(float)
    w = prof.e_mass.astype(float)
    alloc_now = e_prio >= e_gear          # this access's fill allocates
    t_cold_gear = g_at(prof.t_cold_round, t_ten)
    cold_alloc_r = np.bincount(
        prof.t_cold_round,
        weights=prof.t_mass * (t_prio >= t_cold_gear), minlength=nr)

    def _finalize(p):
        p = np.where(not_resident, 0.0, p)
        return np.where(prof.e_mshr, 1.0, p)

    if at:
        occ = touched_frac[prof.e_round] * above_tab[e_gear, e_prio]
        p_strat = _hit_prob(d * dscale_tab[e_gear, e_prio],
                            c_lo - occ, c_hi - occ)
        p_hit = _finalize(p_strat)
        # churn term, as a short fixed point: the eviction threat to a
        # just-used line is the *allocation* stream between its two
        # accesses (hits evict nothing), which itself depends on the hit
        # probabilities — two rounds of alternation starting from the
        # strat-only (allocation-heaviest) estimate converge from below
        for _ in range(2):
            ar = (np.bincount(prof.e_round,
                              weights=w * (1.0 - p_hit) * alloc_now,
                              minlength=nr) + cold_alloc_r)
            cum_a = np.concatenate(([0.0], np.cumsum(ar)))
            a_win = cum_a[prof.e_round + 1] - cum_a[prof.e_prev_round + 1]
            p_churn = _hit_prob(a_win, c_lo / assoc, c_hi / assoc)
            p_hit = _finalize(np.maximum(p_strat, p_churn))
    else:
        p_hit = _finalize(_hit_prob(d * shrink_tab[e_gear], c_lo, c_hi))
    h_r = np.bincount(prof.e_round, weights=w * p_hit, minlength=nr)
    cf_reuse_r = np.bincount(prof.e_round, weights=w * (1.0 - p_hit),
                             minlength=nr)
    cold_r = (prof.cold_round + prof.byp_cold_round).astype(float)
    cf_r = cf_reuse_r + prof.byp_rep_round
    total_reuse = float(w.sum())

    # --- dirty-lifetime write-back model (DESIGN.md §5) ----------------
    # Chain each tile's accesses and propagate P(dirty): a store dirties
    # the line (write-allocate, unless its fill is bypassed); a later
    # access that *misses* under the profile's own hit rule means the
    # line aged past capacity in between — if it was dirty, that
    # eviction wrote it back (and the reload is clean).  A hit leaves
    # the dirty bit in place.
    t_last_gear = g_at(prof.t_last_round, t_ten)
    dirty0 = prof.t_cold_store & (t_prio >= t_cold_gear)
    wb_list = [0.0] * nr
    chain_w = [0.0] * prof.t_mass.shape[0]   # per-tile, tenant breakdown
    dl = dirty0.astype(float).tolist()
    for t, r, m, s, p, a in zip(
            prof.e_tile.tolist(), prof.e_round.tolist(),
            prof.e_mass.tolist(), prof.e_store.tolist(),
            p_hit.tolist(), alloc_now.tolist()):
        dcur = dl[t]
        if dcur > 0.0 and p < 1.0:
            amt = dcur * (1.0 - p) * m
            wb_list[r] += amt
            chain_w[t] += amt
        # store: hit keeps residency (dirtied either way), miss
        # re-allocates dirty only if the fill is admitted
        dl[t] = (p + (1.0 - p) * a) if s else dcur * p
    # tail: tiles still dirty at their last access write back iff the
    # remaining schedule ages them past capacity — same transformed
    # distance-vs-capacity rule as hits, under the gear of their final
    # round.
    dirty = np.asarray(dl)
    d_tail_full = (prof.t_tail_dlive + prof.t_tail_ddead).astype(float)
    d_tail = prof.t_tail_dlive.astype(float) if dbp else d_tail_full
    if at:
        # survival to the end of the schedule faces the *final* standing
        # occupancy of the tiers ranked above (touched_frac = 1: by then
        # every high-tier line that will ever stand does), against the
        # tile's own tier's share of the remaining traffic
        occ_t = above_tab[t_last_gear, t_prio]
        p_surv = _hit_prob(d_tail * dscale_tab[t_last_gear, t_prio],
                           c_lo - occ_t, c_hi - occ_t)
    else:
        p_surv = _hit_prob(d_tail * shrink_tab[t_last_gear], c_lo, c_hi)
    if dbp:
        # retired tiles lose both stack recency and tier protection (the
        # dead FIFO victimizes them first): their dirty lines survive
        # only if the remaining schedule's raw traffic never fills the
        # cache — the untransformed full distance against the plain band
        p_surv = np.where(prof.t_dies,
                          _hit_prob(d_tail_full, c_lo, c_hi), p_surv)
    wb_tail = dirty * (1.0 - p_surv) * prof.t_mass
    wb_r = np.asarray(wb_list)
    np.add.at(wb_r, prof.t_last_round, wb_tail)

    # feedback observables for the dynamic-gear controller emulation:
    # per-round allocations (misses beyond bypass; the trajectory
    # credits the first cap_lines fills as warm-up, which land in
    # invalid ways and evict nothing) and per-round request totals
    alloc_ew = w * (1.0 - p_hit) * alloc_now
    cold_aw = prof.t_mass * (t_prio >= t_cold_gear)
    alloc_r = (np.bincount(prof.e_round, weights=alloc_ew, minlength=nr)
               + np.bincount(prof.t_cold_round, weights=cold_aw,
                             minlength=nr))
    req_r = h_r + cold_r + cf_r

    out = {
        "h_r": h_r, "cold_r": cold_r, "cf_r": cf_r, "wb_r": wb_r,
        "alloc_r": alloc_r, "req_r": req_r, "cap_lines": cap_lines,
        "n_hit": float(h_r.sum()), "n_cold": float(cold_r.sum()),
        "n_cf": float(cf_r.sum()), "n_wb": float(wb_r.sum()),
        "kept": float((w * p_hit).sum() / total_reuse)
        if total_reuse else 1.0,
    }

    if n_ten > 1:
        # per-tenant attribution (DESIGN.md §8.4): entry masses key by
        # the accessing tenant, tile masses (cold fills, write-backs) by
        # the owning tenant — regions are disjoint so they coincide
        flat_e = prof.e_round * n_ten + e_ten
        flat_t = prof.t_cold_round * n_ten + t_ten
        h_rt = np.bincount(flat_e, weights=w * p_hit,
                           minlength=nr * n_ten).reshape(nr, n_ten)
        cf_rt = (np.bincount(flat_e, weights=w * (1.0 - p_hit),
                             minlength=nr * n_ten).reshape(nr, n_ten)
                 + prof.byp_rep_rt)
        cold_rt = (prof.cold_rt + prof.byp_cold_rt).astype(float)
        alloc_rt = (np.bincount(flat_e, weights=alloc_ew,
                                minlength=nr * n_ten).reshape(nr, n_ten)
                    + np.bincount(flat_t, weights=cold_aw,
                                  minlength=nr * n_ten).reshape(nr, n_ten))
        wb_t = (np.bincount(t_ten, weights=wb_tail, minlength=n_ten)
                + np.bincount(t_ten, weights=chain_w, minlength=n_ten))
        out.update({
            "alloc_rt": alloc_rt, "req_rt": h_rt + cold_rt + cf_rt,
            "n_hit_t": h_rt.sum(axis=0),
            "n_miss_t": (cold_rt + cf_rt).sum(axis=0),
            "n_wb_t": wb_t,
        })

    prof._eval_cache[key] = out
    return out


def _round_time_components(prof, outcome: dict, hw: SimConfig,
                           params: ModelParams
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """Per-round (t_hit, t_cold, t_cf, t_comp) arrays — Eq. 1–5 at the
    simulator's round granularity, shared by the aggregate prediction and
    the window-by-window gear-trajectory emulation."""
    issue = hw.n_cores * hw.ipc_mem
    v = hw.v_llc
    bw = hw.dram_lines_per_cycle
    h_r, cold_r = outcome["h_r"], outcome["cold_r"]
    cf_r, wb_r = outcome["cf_r"], outcome["wb_r"]
    flops_r = prof.flops_round

    t_hit = np.maximum(h_r / issue, h_r / v)
    t_cold = np.maximum(np.maximum(cold_r / issue, cold_r / v),
                        cold_r / (params.theta1 * bw))
    # Eq. 3 per round: conflict-demand density over the round's stream.
    # Dirty evictions are dispersed DRAM traffic exactly like conflict
    # misses (§V-B), so write-back volume counts toward the demand rate
    # — without it a store-heavy round with few conflict misses would
    # drain its write-backs at the θ2 floor.
    n_mem = h_r + cold_r + cf_r
    denom = n_mem / hw.ipc_mem + flops_r / hw.core_flops_per_cycle
    eta = np.divide((cf_r + wb_r) / hw.ipc_mem, denom,
                    out=np.zeros_like(cf_r), where=denom > 0)
    v_dmd = np.minimum(eta * issue, v)
    bw_cf = np.clip(params.lam * v_dmd, params.theta2 * bw,
                    params.theta3 * bw)
    t_cf = np.maximum(np.maximum(cf_r / issue, cf_r / v),
                      (cf_r + wb_r) / bw_cf)
    t_comp = flops_r / (hw.n_cores * hw.core_flops_per_cycle)
    return t_hit, t_cold, t_cf, t_comp


def _profile_prediction(prof, outcome: dict, hw: SimConfig,
                        params: ModelParams,
                        n_rounds: Optional[int] = None) -> Prediction:
    """Eq. 1–5 applied at the simulator's round granularity (§7.2).

    ``n_rounds`` overrides the scheduling-overhead round count like the
    closed path's parameter does; by default the profile's own round
    count is charged.
    """
    t_hit, t_cold, t_cf, t_comp = _round_time_components(prof, outcome,
                                                         hw, params)
    overhead_rounds = prof.n_rounds if n_rounds is None else n_rounds
    cycles = float((t_hit + t_cold + np.maximum(t_comp, t_cf)).sum()) \
        + params.round_overhead * overhead_rounds
    def tup(key):
        return tuple(float(x) for x in outcome[key]) \
            if key in outcome else None

    return Prediction(
        cycles=cycles, t_hit=float(t_hit.sum()), t_cold=float(t_cold.sum()),
        t_cf=float(t_cf.sum()), t_comp=float(t_comp.sum()),
        n_hit=outcome["n_hit"], n_cold=outcome["n_cold"],
        n_cf=outcome["n_cf"], kept_fraction=outcome["kept"],
        n_wb=outcome.get("n_wb", 0.0),
        n_hit_tenant=tup("n_hit_t"), n_miss_tenant=tup("n_miss_t"),
        n_wb_tenant=tup("n_wb_t"))


def _gear_trajectory(prof, llc_bytes: int, hw: SimConfig,
                     params: ModelParams, at: bool, dbp: bool,
                     b_bits: int, pcfg=None
                     ) -> Tuple[np.ndarray, dict]:
    """Window-by-window emulation of the §IV-D dynamic-gear feedback law.

    Instead of assuming the converged gear everywhere, the trajectory
    replays the controller: per feedback window (``window_cycles`` of
    *modeled* time), the predicted eviction rate — allocations beyond
    the warm-up fill credit over requests — moves the gear one step up
    when it exceeds ``bypass_ub``, and one step down only after
    ``down_streak`` consecutive low-rate windows (the fast-up /
    slow-down hysteresis).  Each round's request classes are charged at
    the gear active *during that round*, so the ramp-up transient before
    equilibrium (the residual error on ``at+bypass`` rows the converged
    pick left) is part of the prediction.  The emulated trajectory is
    validated against ``SimResult.history["gear"]``.

    Returns ``(gear_per_round, composite_outcome)`` where the composite
    outcome mixes each round's masses from the per-gear steady-state
    outcomes along the trajectory.
    """
    g_rt, outcome = _replay_gear_law(prof, llc_bytes, hw, params, at,
                                     dbp, b_bits, pcfg, n_ten=1)
    return g_rt[:, 0], outcome


def _gear_trajectory_tenant(prof, llc_bytes: int, hw: SimConfig,
                            params: ModelParams, at: bool, dbp: bool,
                            b_bits: int, pcfg=None
                            ) -> Tuple[np.ndarray, dict]:
    """Per-slice (per-tenant) mode of the §IV-D emulation (DESIGN.md
    §8.4): one independent feedback loop per tenant, mirroring the
    simulator's opt-in ``per_tenant_gears`` controller.

    The loops share modeled *time* (windows close on the composite
    clock) and the one physical cache (the warm-up fill credit is one
    shared pool, split over a chunk by each tenant's allocation share),
    but each tenant's eviction mass moves only that tenant's gear and
    every access is evaluated under its own tenant's transient gear —
    the per-tenant divergence a single mean-field controller emulation
    cannot express.  Returns ``(gear_matrix[n_rounds, n_tenants],
    composite_outcome)``.
    """
    return _replay_gear_law(prof, llc_bytes, hw, params, at, dbp, b_bits,
                            pcfg, n_ten=prof.n_tenants)


def _replay_gear_law(prof, llc_bytes: int, hw: SimConfig,
                     params: ModelParams, at: bool, dbp: bool,
                     b_bits: int, pcfg, n_ten: int
                     ) -> Tuple[np.ndarray, dict]:
    """One implementation of the window replay for both modes — the
    single-controller case is exactly ``n_ten=1`` (scalar gears are
    passed through to ``_profile_outcome`` so its cache keys and the
    composite 1-D trajectory path are unchanged)."""
    if pcfg is None:
        from .policies import PolicyConfig
        pcfg = PolicyConfig()
    nr = prof.n_rounds
    assoc = hw.llc_assoc
    max_gear = 1 << b_bits
    outs: Dict[tuple, dict] = {}
    cum: Dict[tuple, tuple] = {}

    def gear_arg(gt: tuple):
        """What _profile_outcome sees for one constant gear state."""
        if n_ten == 1:
            return int(gt[0])
        return np.broadcast_to(np.asarray(gt, dtype=np.int64),
                               (nr, n_ten)).copy()

    def outcome(gt: tuple) -> dict:
        o = outs.get(gt)
        if o is None:
            o = outs[gt] = _profile_outcome(prof, llc_bytes, assoc, at,
                                            dbp, gear_arg(gt), b_bits)
            th, tc, tcf, tcomp = _round_time_components(prof, o, hw,
                                                        params)
            if n_ten == 1:
                ca = np.cumsum(o["alloc_r"])[:, None]
                cq = np.cumsum(o["req_r"])[:, None]
            else:
                ca = np.cumsum(o["alloc_rt"], axis=0)
                cq = np.cumsum(o["req_rt"], axis=0)
            cum[gt] = (np.cumsum(th + tc + np.maximum(tcomp, tcf)
                                 + params.round_overhead), ca, cq)
        return o

    gears = tuple(pcfg.b_gear for _ in range(n_ten))
    cap = float(outcome(gears)["cap_lines"])
    clock = win_start = 0.0
    ev = np.zeros(n_ten)
    acc = np.zeros(n_ten)
    cum_alloc = 0.0
    streak = np.zeros(n_ten, dtype=np.int64)
    g_rt = np.zeros((nr, n_ten), dtype=np.int64)
    r = 0
    while r < nr:
        outcome(gears)
        ct, ca, cq = cum[gears]
        base_t = ct[r - 1] if r else 0.0
        # first round whose end crosses the current window boundary
        j = int(np.searchsorted(ct, win_start + pcfg.window_cycles
                                - clock + base_t))
        j = min(j, nr - 1)
        g_rt[r:j + 1] = gears
        base = r - 1
        chunk_t = ca[j] - (ca[base] if r else 0.0)       # (n_tenants,)
        total = float(chunk_t.sum())
        # warm-up fill credit: the first cap allocations land in invalid
        # ways and evict nothing (mirrors the simulator's cold start);
        # one shared pool, split by each tenant's share of the chunk
        evictable = max(cum_alloc + total - max(cap, cum_alloc), 0.0)
        if total > 0:
            ev += chunk_t * (evictable / total)
        cum_alloc += total
        acc += cq[j] - (cq[base] if r else 0.0)
        clock += ct[j] - base_t
        r = j + 1
        elapsed = clock - win_start
        if elapsed >= pcfg.window_cycles:
            # one gear step per crossing, then advance in whole window
            # multiples — GearController.tick is invoked once per round
            # and moves one step at most, so a round spanning several
            # windows ramps exactly one step there too
            rate = ev / np.maximum(acc, 1.0)
            g = np.asarray(gears, dtype=np.int64)
            up = rate > pcfg.bypass_ub
            low = rate < pcfg.bypass_lb
            streak = np.where(low, streak + 1, 0)
            down = streak >= pcfg.down_streak
            streak[down] = 0
            g = np.clip(g + up.astype(np.int64) - down.astype(np.int64),
                        0, max_gear)
            gears = tuple(int(x) for x in g)
            ev[:] = 0.0
            acc[:] = 0.0
            win_start += (elapsed // pcfg.window_cycles) \
                * pcfg.window_cycles

    # composite outcome: every access re-evaluated under the gear of its
    # own round, residency-aware across gear changes (an access whose
    # tier the *current* gear bypasses still hits if its last fill was
    # admitted under a lower transient gear) — cached per trajectory
    segments = {tuple(row) for row in g_rt.tolist()}
    if len(segments) == 1:
        return g_rt, outcome(next(iter(segments)))
    traj = g_rt[:, 0] if n_ten == 1 else g_rt
    return g_rt, _profile_outcome(prof, llc_bytes, assoc, at, dbp, traj,
                                  b_bits)


def _predict_profile(counts: DataflowCounts, llc_bytes: int, policy: str,
                     hw: SimConfig, params: ModelParams,
                     bypass_variant: str, gqa: bool, b_bits: int,
                     n_rounds: Optional[int] = None,
                     per_tenant_gears: bool = False) -> Prediction:
    prof = counts.reuse_profile
    at, dbp, bypass = parse_model_policy(policy)
    if bypass and bypass_variant.startswith("fix"):
        at = True          # static gears run with at enabled (§VI-E)
    if bypass and not gqa and not bypass_variant.startswith("fix"):
        # dynamic bypassing: replay the per-window feedback law (§IV-D)
        # round by round — the controller ramps the gear until the
        # eviction rate drops under its upper bound, and the pre-
        # equilibrium windows run (and are charged) at their lower
        # transient gears, even when the converged gear over-bypasses
        # and destroys inter-core reuse (the §IV-E failure the gqa
        # variant exists to avoid).
        traj = (_gear_trajectory_tenant
                if per_tenant_gears and prof.n_tenants > 1
                else _gear_trajectory)
        _, outcome = traj(prof, llc_bytes, hw, params, at, dbp, b_bits)
        return _profile_prediction(prof, outcome, hw, params, n_rounds)
    gear = _static_gear(bypass, bypass_variant, gqa)
    outcome = _profile_outcome(prof, llc_bytes, hw.llc_assoc, at, dbp,
                               gear, b_bits)
    return _profile_prediction(prof, outcome, hw, params, n_rounds)


def gear_trajectory(counts: DataflowCounts, llc_bytes: int,
                    policy: str = "at+bypass",
                    hw: Optional[SimConfig] = None,
                    params: Optional[ModelParams] = None,
                    b_bits: int = 3, policy_cfg=None,
                    per_tenant: bool = False) -> np.ndarray:
    """Emulated per-round gear trajectory of the §IV-D feedback law.

    The validation-facing entry point: rounds with no requests keep the
    gear of the preceding window, matching where the simulator skips
    its controller tick.  Compare against the per-round mean gear the
    simulator records in ``SimResult.history["gear"]`` (which omits the
    empty rounds).

    ``per_tenant=True`` (multi-tenant composite profiles, DESIGN.md
    §8.4) runs one feedback loop per tenant and returns an
    ``(n_rounds, n_tenants)`` matrix — compare column ``i`` against
    ``SimResult.history["tenant_gear"][:, i]`` recorded under the
    simulator's ``per_tenant_gears`` policy flag."""
    hw = hw or SimConfig()
    params = params or ModelParams()
    prof = counts.reuse_profile
    if prof is None:
        raise ValueError("counts carry no reuse profile "
                         "(lower_to_counts(with_profile=True))")
    at, dbp, bypass = parse_model_policy(policy)
    if not bypass:
        raise ValueError(f"policy {policy!r} does not bypass")
    if per_tenant:
        if prof.n_tenants < 2:
            raise ValueError("per_tenant gear trajectory needs a "
                             "multi-tenant composite profile")
        g_rt, _ = _gear_trajectory_tenant(prof, llc_bytes, hw, params,
                                          at, dbp, b_bits, policy_cfg)
        return g_rt
    g_r, _ = _gear_trajectory(prof, llc_bytes, hw, params, at, dbp,
                              b_bits, policy_cfg)
    return g_r


# ---------------------------------------------------------------------------
# Eq. 1–5
# ---------------------------------------------------------------------------
def predict(counts: DataflowCounts, llc_bytes: int, policy: str,
            hw: Optional[SimConfig] = None,
            params: Optional[ModelParams] = None,
            bypass_variant: str = "optimal",
            gqa: bool = False,
            b_bits: int = 3,
            n_rounds: Optional[int] = None,
            model: str = "profile",
            per_tenant_gears: bool = False) -> Prediction:
    """Predict cycles for one (dataflow, cache size, policy) point.

    ``model="profile"`` (default) evaluates the reuse-distance profile
    attached to ``counts`` and falls back to the closed forms when the
    producer skipped the profile lowering; ``model="closed"`` forces the
    original §V-C scalar step functions.  ``per_tenant_gears`` mirrors
    the simulator's opt-in policy flag on multi-tenant composites: the
    dynamic-bypass emulation runs one feedback loop per tenant
    (DESIGN.md §8.4) instead of the single mean-field controller.
    """
    hw = hw or SimConfig()
    params = params or ModelParams()
    if model not in ("profile", "closed"):
        raise KeyError(f"unknown model {model!r}")
    if model == "profile" and counts.reuse_profile is not None:
        return _predict_profile(counts, llc_bytes, policy, hw, params,
                                bypass_variant, gqa, b_bits, n_rounds,
                                per_tenant_gears)

    # dead data of retired batches pollutes every policy that does not
    # predict dead blocks (§VI-F); "all" names its mechanisms implicitly
    # but its closed-form treatment keeps the polluted stack, so the
    # substring test is the behavior-defining check for every policy in
    # ``_KNOWN_POLICIES`` (pinned by tests/test_analytical.py)
    pollution = 1.0
    if counts.n_batches > 1 and "dbp" not in policy:
        pollution = 1.0 / counts.n_batches

    f = kept_fraction(policy, counts.s_work_active, llc_bytes,
                      hw.llc_assoc, b_bits, bypass_variant, gqa, pollution)

    temporal_hits = f * counts.n_temporal_reuse
    intercore_hits = float(counts.n_intercore_reuse)
    lost_intercore = 0.0
    if (not gqa and counts.n_intercore_reuse
            and policy in ("bypass+dbp", "all", "lru+bypass", "at+bypass")):
        # blind bypassing in sharing dataflows loses the bypassed share of
        # inter-core reuses and pays extra DRAM fetches (paper §IV-E)
        if bypass_variant.startswith("fix"):
            gear_frac = int(bypass_variant[3:]) / (1 << b_bits)
        else:
            gear_frac = max(0.0, 1.0 - f)
        lost_intercore = gear_frac * intercore_hits
        intercore_hits -= lost_intercore

    n_hit = temporal_hits + intercore_hits
    n_cold = counts.n_kv_distinct + counts.n_bypass_lines
    n_cf = (counts.n_temporal_reuse - temporal_hits) + lost_intercore
    n_mem = counts.n_kv_accesses + counts.n_bypass_lines

    N, ipc = hw.n_cores, hw.ipc_mem
    v_llc = hw.v_llc
    bw = hw.dram_lines_per_cycle

    t_comp = counts.flops_total / (N * hw.core_flops_per_cycle)
    t_hit = max(n_hit / (N * ipc), n_hit / v_llc)
    bw_cold = params.theta1 * bw
    t_cold = max(n_cold / (N * ipc), n_cold / v_llc, n_cold / bw_cold)

    # Eq. 3: conflict-miss demand density over the instruction stream
    ipc_comp = hw.core_flops_per_cycle
    denom = n_mem / ipc + counts.flops_total / ipc_comp
    eta_cf = (n_cf / ipc) / denom if denom > 0 else 0.0
    v_cf_dmd = min(eta_cf * N * ipc, v_llc)
    bw_cf = float(np.clip(params.lam * v_cf_dmd,
                          params.theta2 * bw, params.theta3 * bw))
    t_cf = max(n_cf / (N * ipc), n_cf / v_llc, n_cf / bw_cf) if n_cf else 0.0

    cycles = t_hit + t_cold + max(t_comp, t_cf)
    if n_rounds:
        cycles += params.round_overhead * n_rounds

    return Prediction(cycles=cycles, t_hit=t_hit, t_cold=t_cold, t_cf=t_cf,
                      t_comp=t_comp, n_hit=n_hit, n_cold=n_cold, n_cf=n_cf,
                      kept_fraction=f)


# ---------------------------------------------------------------------------
# Batched prediction: one shared reuse histogram, many policies
# ---------------------------------------------------------------------------
def predict_batch(counts: DataflowCounts, llc_bytes: int,
                  policies: Sequence[str],
                  hw: Optional[SimConfig] = None,
                  params: Optional[ModelParams] = None,
                  bypass_variant: str = "optimal",
                  gqa: bool = False,
                  b_bits: int = 3,
                  n_rounds: Optional[int] = None,
                  model: str = "profile",
                  per_tenant_gears: bool = False) -> List[Prediction]:
    """Predict one (dataflow, cache size) point for a whole policy set.

    Each policy's request classes are a reweighting of the *same* reuse
    histogram (``_profile_outcome``, cached per (policy-flags, gear) on
    the profile), and the Eq. 1–5 time aggregation runs once on the
    stacked ``(n_policies, n_rounds)`` class matrix instead of per
    policy.  Every returned :class:`Prediction` is bit-identical to the
    corresponding scalar :func:`predict` call — the stacked arithmetic
    is elementwise and the per-policy sums reduce contiguous rows
    exactly like the 1-D path (pinned by tests/test_fit_batched.py).
    """
    hw = hw or SimConfig()
    params = params or ModelParams()
    if model not in ("profile", "closed"):
        raise KeyError(f"unknown model {model!r}")
    prof = counts.reuse_profile
    if model != "profile" or prof is None:
        # closed forms are scalar arithmetic — nothing to batch
        return [predict(counts, llc_bytes, p, hw, params, bypass_variant,
                        gqa, b_bits, n_rounds, model=model,
                        per_tenant_gears=per_tenant_gears)
                for p in policies]

    outcomes = []
    for policy in policies:
        at, dbp, bypass = parse_model_policy(policy)
        if bypass and bypass_variant.startswith("fix"):
            at = True
        if bypass and not gqa and not bypass_variant.startswith("fix"):
            traj = (_gear_trajectory_tenant
                    if per_tenant_gears and prof.n_tenants > 1
                    else _gear_trajectory)
            _, o = traj(prof, llc_bytes, hw, params, at, dbp, b_bits)
        else:
            o = _profile_outcome(prof, llc_bytes, hw.llc_assoc, at, dbp,
                                 _static_gear(bypass, bypass_variant, gqa),
                                 b_bits)
        outcomes.append(o)

    # one stacked Eq. 1–5 evaluation: _round_time_components is purely
    # elementwise over the class arrays, so feeding it (P, nr) stacks
    # yields each policy's rows bit-identical to its own 1-D call
    stacked = {k: np.stack([o[k] for o in outcomes])
               for k in ("h_r", "cold_r", "cf_r", "wb_r")}
    t_hit, t_cold, t_cf, t_comp = _round_time_components(prof, stacked,
                                                         hw, params)
    overhead_rounds = prof.n_rounds if n_rounds is None else n_rounds
    preds = []
    for i, o in enumerate(outcomes):
        th, tc, tcf = t_hit[i], t_cold[i], t_cf[i]
        cycles = float((th + tc + np.maximum(t_comp, tcf)).sum()) \
            + params.round_overhead * overhead_rounds

        def tup(key):
            return tuple(float(x) for x in o[key]) if key in o else None

        preds.append(Prediction(
            cycles=cycles, t_hit=float(th.sum()), t_cold=float(tc.sum()),
            t_cf=float(tcf.sum()), t_comp=float(t_comp.sum()),
            n_hit=o["n_hit"], n_cold=o["n_cold"], n_cf=o["n_cf"],
            kept_fraction=o["kept"], n_wb=o.get("n_wb", 0.0),
            n_hit_tenant=tup("n_hit_t"), n_miss_tenant=tup("n_miss_t"),
            n_wb_tenant=tup("n_wb_t")))
    return preds


# ---------------------------------------------------------------------------
# Calibration (§V-D: θ, λ fitted per hardware/policy combination)
# ---------------------------------------------------------------------------
class _ThetaGrid:
    """A candidate batch masquerading as :class:`ModelParams`.

    The θ fields are ``(K, 1)`` column arrays, so feeding a grid through
    ``_round_time_components`` broadcasts the round arrays to ``(K,
    n_rounds)`` — one row per candidate, each bit-identical to the
    scalar call (every op is elementwise, and scalar products like
    ``theta1 * bw`` happen in the same order)."""

    __slots__ = ("params", "k", "key", "theta1", "theta2", "theta3",
                 "lam", "round_overhead")

    def __init__(self, cands: Sequence[ModelParams]):
        self.params = list(cands)
        self.k = len(self.params)
        self.key = tuple((p.theta1, p.theta2, p.theta3, p.lam,
                          p.round_overhead) for p in self.params)
        col = np.asarray(self.key, dtype=np.float64).reshape(self.k, 5)
        self.theta1 = col[:, 0:1]
        self.theta2 = col[:, 1:2]
        self.theta3 = col[:, 2:3]
        self.lam = col[:, 3:4]
        self.round_overhead = col[:, 4:5]

    def subset(self, idx: Sequence[int]) -> "_ThetaGrid":
        return _ThetaGrid([self.params[i] for i in idx])


class _FitPointEval:
    """One calibration point, evaluated for a whole candidate batch.

    Splits ``predict``'s three regimes — closed form, static-gear
    profile, dynamic-gear profile — and batches each across the θ axis:
    the θ-independent work (class reweighting, per-gear cumulative
    observables) runs once, the θ-dependent Eq. 1–5 rows vectorize via
    :class:`_ThetaGrid`, and only the inherently sequential feedback-law
    replay stays a per-candidate scalar loop (over its cheap cumulative
    tables).  Batch results are cached on the profile keyed by the
    candidate set, so repeated fits over shared points (the LOSO loop)
    evaluate each grid once."""

    def __init__(self, point, hw: SimConfig, model: str):
        counts, llc, pol, variant, gqa, rounds, target = point
        self.log_target = math.log(max(target, 1.0))
        self.hw = hw
        self.llc = llc
        self.b_bits = 3                      # predict()'s default
        prof = counts.reuse_profile
        self.prof = None
        if model == "profile" and prof is not None:
            self.prof = prof
            self.overhead = prof.n_rounds if rounds is None else rounds
            at, dbp, bypass = parse_model_policy(pol)
            if bypass and variant.startswith("fix"):
                at = True
            self.at, self.dbp = at, dbp
            self.dynamic = (bypass and not gqa
                            and not variant.startswith("fix"))
            self.gear = (None if self.dynamic
                         else _static_gear(bypass, variant, gqa))
            hwk = (hw.n_cores, hw.ipc_mem, hw.v_llc,
                   hw.core_flops_per_cycle, hw.dram_bw_bytes_per_cycle,
                   hw.dram_eff_seq, hw.dram_eff_rand, hw.llc_assoc,
                   hw.line_bytes)
            self._key = ("fit_cyc", llc, at, dbp,
                         "dyn" if self.dynamic else int(self.gear),
                         self.b_bits, self.overhead, hwk)
        else:
            self._closed_setup(counts, llc, pol, variant, gqa, rounds)

    # -- closed form (§V-C): θ-independent scalars precomputed once ------
    def _closed_setup(self, counts, llc, pol, variant, gqa, rounds):
        hw = self.hw
        pollution = 1.0
        if counts.n_batches > 1 and "dbp" not in pol:
            pollution = 1.0 / counts.n_batches
        f = kept_fraction(pol, counts.s_work_active, llc, hw.llc_assoc,
                          self.b_bits, variant, gqa, pollution)
        temporal_hits = f * counts.n_temporal_reuse
        intercore_hits = float(counts.n_intercore_reuse)
        lost = 0.0
        if (not gqa and counts.n_intercore_reuse
                and pol in ("bypass+dbp", "all", "lru+bypass",
                            "at+bypass")):
            if variant.startswith("fix"):
                gear_frac = int(variant[3:]) / (1 << self.b_bits)
            else:
                gear_frac = max(0.0, 1.0 - f)
            lost = gear_frac * intercore_hits
            intercore_hits -= lost
        n_hit = temporal_hits + intercore_hits
        n_cold = counts.n_kv_distinct + counts.n_bypass_lines
        n_cf = (counts.n_temporal_reuse - temporal_hits) + lost
        n_mem = counts.n_kv_accesses + counts.n_bypass_lines
        N, ipc = hw.n_cores, hw.ipc_mem
        v_llc = hw.v_llc
        self._bw = hw.dram_lines_per_cycle
        self._t_comp = counts.flops_total / (N * hw.core_flops_per_cycle)
        self._t_hit = max(n_hit / (N * ipc), n_hit / v_llc)
        self._m_cold = max(n_cold / (N * ipc), n_cold / v_llc)
        self._n_cold = n_cold
        denom = n_mem / ipc + counts.flops_total / hw.core_flops_per_cycle
        eta_cf = (n_cf / ipc) / denom if denom > 0 else 0.0
        self._v_cf_dmd = min(eta_cf * N * ipc, v_llc)
        self._m_cf = max(n_cf / (N * ipc), n_cf / v_llc)
        self._n_cf = n_cf
        self._rounds = rounds

    def _closed_cycles(self, grid: _ThetaGrid) -> np.ndarray:
        t1 = grid.theta1[:, 0]
        t2 = grid.theta2[:, 0]
        t3 = grid.theta3[:, 0]
        lam = grid.lam[:, 0]
        ro = grid.round_overhead[:, 0]
        bw = self._bw
        t_cold = np.maximum(self._m_cold, self._n_cold / (t1 * bw))
        if self._n_cf:
            bw_cf = np.clip(lam * self._v_cf_dmd, t2 * bw, t3 * bw)
            t_cf = np.maximum(self._m_cf, self._n_cf / bw_cf)
        else:
            t_cf = 0.0
        cycles = self._t_hit + t_cold + np.maximum(self._t_comp, t_cf)
        if self._rounds:
            cycles = cycles + ro * self._rounds
        return np.asarray(cycles, dtype=np.float64)

    # -- shared Eq. 1–5 row aggregation ----------------------------------
    def _rows_cycles(self, outcome: dict, grid: _ThetaGrid) -> np.ndarray:
        t_hit, t_cold, t_cf, t_comp = _round_time_components(
            self.prof, outcome, self.hw, grid)
        body = t_hit + t_cold + np.maximum(t_comp, t_cf)   # (K, nr)
        sums = np.empty(grid.k)
        for i in range(grid.k):
            # contiguous row views reduce exactly like the 1-D arrays of
            # the scalar path (same pairwise-summation blocking)
            sums[i] = body[i].sum()
        return sums + grid.round_overhead[:, 0] * self.overhead

    def _static_cycles(self, grid: _ThetaGrid) -> np.ndarray:
        o = _profile_outcome(self.prof, self.llc, self.hw.llc_assoc,
                             self.at, self.dbp, self.gear, self.b_bits)
        return self._rows_cycles(o, grid)

    # -- dynamic gears: scalar replay per candidate over batched tables --
    def _dynamic_cycles(self, grid: _ThetaGrid) -> np.ndarray:
        from .policies import PolicyConfig
        prof, hw = self.prof, self.hw
        pcfg = PolicyConfig()
        nr = prof.n_rounds
        max_gear = 1 << self.b_bits
        W = pcfg.window_cycles
        gear_data: Dict[int, dict] = {}

        def entry(g: int) -> dict:
            e = gear_data.get(g)
            if e is None:
                o = _profile_outcome(prof, self.llc, hw.llc_assoc,
                                     self.at, self.dbp, int(g),
                                     self.b_bits)
                th, tc, tcf, tcomp = _round_time_components(prof, o, hw,
                                                            grid)
                e = gear_data[g] = {
                    "o": o,
                    "ct": np.cumsum(th + tc + np.maximum(tcomp, tcf)
                                    + grid.round_overhead, axis=-1),
                    "ca": np.cumsum(o["alloc_r"]),
                    "cq": np.cumsum(o["req_r"]),
                    "cap": float(o["cap_lines"]),
                }
            return e

        trajs = []
        for k in range(grid.k):
            g = pcfg.b_gear
            cap = entry(g)["cap"]
            clock = win_start = 0.0
            ev = acc = cum_alloc = 0.0
            streak = 0
            traj: List[int] = []
            r = 0
            while r < nr:
                e = entry(g)
                ct = e["ct"][k]
                ca, cq = e["ca"], e["cq"]
                base_t = ct[r - 1] if r else 0.0
                j = int(np.searchsorted(ct, win_start + W - clock
                                        + base_t))
                if j > nr - 1:
                    j = nr - 1
                traj.extend([g] * (j + 1 - r))
                base = r - 1
                total = float(ca[j] - (ca[base] if r else 0.0))
                evictable = max(cum_alloc + total - max(cap, cum_alloc),
                                0.0)
                if total > 0:
                    ev += total * (evictable / total)
                cum_alloc += total
                acc += float(cq[j] - (cq[base] if r else 0.0))
                clock += float(ct[j] - base_t)
                r = j + 1
                elapsed = clock - win_start
                if elapsed >= W:
                    rate = ev / (acc if acc > 1.0 else 1.0)
                    streak = streak + 1 if rate < pcfg.bypass_lb else 0
                    down = streak >= pcfg.down_streak
                    if down:
                        streak = 0
                    g = (g + (1 if rate > pcfg.bypass_ub else 0)
                         - (1 if down else 0))
                    g = min(max(g, 0), max_gear)
                    ev = acc = 0.0
                    win_start += (elapsed // W) * W
            trajs.append(tuple(traj))

        # candidates sharing a trajectory share its composite outcome
        out = np.empty(grid.k)
        groups: Dict[tuple, List[int]] = {}
        for k, t in enumerate(trajs):
            groups.setdefault(t, []).append(k)
        for t, ks in groups.items():
            if len(set(t)) == 1:
                o = entry(t[0])["o"]
            else:
                o = _profile_outcome(prof, self.llc, hw.llc_assoc,
                                     self.at, self.dbp,
                                     np.asarray(t, dtype=np.int64),
                                     self.b_bits)
            out[np.asarray(ks)] = self._rows_cycles(o, grid.subset(ks))
        return out

    # -- entry point -----------------------------------------------------
    def cycles(self, grid: _ThetaGrid) -> np.ndarray:
        """Predicted cycles per candidate, cached per candidate set on
        the profile so repeated fits over shared points (LOSO) evaluate
        each grid once."""
        if self.prof is None:
            return self._closed_cycles(grid)
        key = self._key + (grid.key,)
        hit = self.prof._eval_cache.get(key)
        if hit is not None:
            return hit
        out = (self._dynamic_cycles(grid) if self.dynamic
               else self._static_cycles(grid))
        self.prof._eval_cache[key] = out
        return out


def fit_params(points: Sequence[Tuple[DataflowCounts, int, str, str, bool,
                                      Optional[int], float]],
               hw: Optional[SimConfig] = None,
               model: str = "profile") -> ModelParams:
    """Fit (θ1, θ2, θ3, λ) to simulator measurements.

    ``points``: (counts, llc_bytes, policy, bypass_variant, gqa, n_rounds,
    simulated_cycles) tuples.  Coarse grid search + refinement on mean
    squared log error, mirroring the paper's empirical fitting.  ``model``
    selects the hit engine the constants are fitted for.

    The search is batched across the candidate axis
    (:class:`_FitPointEval`): each point's θ-independent aggregates are
    computed once and the Eq. 1–5 rows for a whole candidate grid
    evaluate in one broadcast, with per-(point, grid) results cached on
    the reuse profiles — the stage the suite leans on for its LOSO
    loop.  The selected parameters are bit-identical to the sequential
    reference scan (``_fit_params_reference``, pinned by
    tests/test_fit_batched.py): elementwise float ops, first-occurrence
    ``argmin`` (ties keep the earlier candidate, exactly like the strict
    ``<`` scan), and NaN losses dropped the way the scan skips them.
    """
    hw = hw or SimConfig()
    evals = [_FitPointEval(p, hw, model) for p in points]
    inv = max(len(points), 1)

    def losses(cands: List[ModelParams]) -> np.ndarray:
        grid = _ThetaGrid(cands)
        err = np.zeros(grid.k)
        for ev in evals:
            lt = ev.log_target
            err += np.asarray(
                [(math.log(max(c, 1.0)) - lt) ** 2
                 for c in ev.cycles(grid).tolist()])
        return err / inv

    default = ModelParams()
    cands = [default]
    for t1, t2, t3, lam in product(
            (0.7, 0.8, 0.9, 1.0),          # theta1
            (0.1, 0.2, 0.3),               # theta2
            (0.45, 0.6, 0.75, 0.9),        # theta3
            (0.6, 0.8, 1.0, 1.25)):        # lambda
        if t2 >= t3:
            continue
        cands.append(ModelParams(t1, t2, t3, lam))
    L = losses(cands)
    if math.isnan(float(L[0])):
        # a NaN baseline loss beats nothing in the strict-< scan
        return default
    L = np.where(np.isnan(L), np.inf, L)
    bi = int(np.argmin(L))
    best, best_loss = cands[bi], float(L[bi])

    # local refinement around the best point
    for _ in range(2):
        t1, t2, t3, lam = best.theta1, best.theta2, best.theta3, best.lam
        cands = []
        for d1, d2, d3, dl in product((-0.05, 0.0, 0.05), repeat=4):
            p = ModelParams(
                float(np.clip(t1 + d1, 0.3, 1.0)),
                float(np.clip(t2 + d2, 0.05, 0.5)),
                float(np.clip(t3 + d3, 0.2, 1.0)),
                float(np.clip(lam + dl, 0.2, 2.0)))
            if p.theta2 >= p.theta3:
                continue
            cands.append(p)
        if not cands:
            continue
        L = losses(cands)
        L = np.where(np.isnan(L), np.inf, L)
        bi = int(np.argmin(L))
        if float(L[bi]) < best_loss:
            best, best_loss = cands[bi], float(L[bi])
    return best


def _fit_params_reference(points: Sequence[Tuple[DataflowCounts, int, str,
                                                 str, bool, Optional[int],
                                                 float]],
                          hw: Optional[SimConfig] = None,
                          model: str = "profile") -> ModelParams:
    """Pre-batching sequential fit — one ``predict`` per (candidate,
    point).  Kept as the oracle for the batched :func:`fit_params`
    (tests/test_fit_batched.py asserts the selected parameters are
    bit-identical); not used on any hot path."""
    hw = hw or SimConfig()

    def loss(p: ModelParams) -> float:
        err = 0.0
        for counts, llc, pol, variant, gqa, rounds, target in points:
            pred = predict(counts, llc, pol, hw, p, variant, gqa,
                           n_rounds=rounds, model=model).cycles
            err += (math.log(max(pred, 1.0)) - math.log(max(target, 1.0))) ** 2
        return err / max(len(points), 1)

    best = ModelParams()
    best_loss = loss(best)
    grid = product(
        (0.7, 0.8, 0.9, 1.0),          # theta1
        (0.1, 0.2, 0.3),               # theta2
        (0.45, 0.6, 0.75, 0.9),        # theta3
        (0.6, 0.8, 1.0, 1.25),         # lambda
    )
    for t1, t2, t3, lam in grid:
        if t2 >= t3:
            continue
        p = ModelParams(t1, t2, t3, lam)
        cur = loss(p)
        if cur < best_loss:
            best, best_loss = p, cur
    # local refinement around the best point
    for _ in range(2):
        t1, t2, t3, lam = best.theta1, best.theta2, best.theta3, best.lam
        for d1, d2, d3, dl in product((-0.05, 0.0, 0.05), repeat=4):
            p = ModelParams(
                float(np.clip(t1 + d1, 0.3, 1.0)),
                float(np.clip(t2 + d2, 0.05, 0.5)),
                float(np.clip(t3 + d3, 0.2, 1.0)),
                float(np.clip(lam + dl, 0.2, 2.0)))
            if p.theta2 >= p.theta3:
                continue
            cur = loss(p)
            if cur < best_loss:
                best, best_loss = p, cur
    return best


# ---------------------------------------------------------------------------
# Validation metrics (paper §VI-G1: R² = 0.997, Kendall τ = 0.934)
# ---------------------------------------------------------------------------
def r_squared(pred: np.ndarray, target: np.ndarray) -> float:
    target = np.asarray(target, dtype=float)
    pred = np.asarray(pred, dtype=float)
    ss_res = float(((target - pred) ** 2).sum())
    ss_tot = float(((target - target.mean()) ** 2).sum())
    return 1.0 - ss_res / ss_tot if ss_tot else 1.0


def kendall_tau(pred: np.ndarray, target: np.ndarray) -> float:
    """Kendall's τ-b (tie-adjusted): tied pairs leave the numerator but
    also shrink the denominator, ``sqrt((n0-n1)(n0-n2))`` with ``n1``/
    ``n2`` the pairs tied in each input — the paper's §VI-G1 τ = 0.934
    is a τ-b figure.  (The τ-a denominator ``n(n-1)/2`` biases τ low
    whenever predictions tie, e.g. two policies collapsing to the same
    predicted cycles.)"""
    pred = np.asarray(pred, dtype=float)
    target = np.asarray(target, dtype=float)
    n = pred.shape[0]
    if n < 2:
        return 1.0
    dp = np.sign(pred[:, None] - pred[None, :])
    dt = np.sign(target[:, None] - target[None, :])
    iu = np.triu_indices(n, k=1)
    s = dp[iu] * dt[iu]
    concordant = float((s > 0).sum())
    discordant = float((s < 0).sum())
    n0 = n * (n - 1) / 2
    n1 = float((dp[iu] == 0).sum())
    n2 = float((dt[iu] == 0).sum())
    denom = math.sqrt((n0 - n1) * (n0 - n2))
    if denom == 0.0:
        # at least one input is constant: perfect agreement only if both
        # are (no orderable pair disagrees), else no rank information
        return 1.0 if n1 == n2 == n0 else 0.0
    return (concordant - discordant) / denom
