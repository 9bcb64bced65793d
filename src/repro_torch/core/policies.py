"""Replacement / bypass policy configuration for the DCO shared LLC.

The paper composes three mechanisms (§IV):

* ``dbp``      dead-block prediction (victimize TMU-predicted dead lines first)
* ``at``       self-adaptive anti-thrashing (evict the lowest
               ``tag[B_BITS-1:0]`` tier first; ties → LRU)
* bypassing    on a miss, lines with ``tag[B_BITS-1:0] < B_GEAR`` are not
               allocated.  Variants: static gear (fix1/fix2/fix3), dynamic
               (per-slice eviction-rate feedback), and ``gqa_bypass`` (only
               the slower core of a sharing pair bypasses, and only under
               high contention).

Named policies used throughout the paper's figures are exposed through
:func:`named_policy` (``lru``, ``at``, ``dbp``, ``at+dbp``, ``lru+bypass``,
``at+bypass``, ``all``, ``fix1`` …).
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace
from typing import Optional

import numpy as np

BYPASS_NONE = "none"
BYPASS_STATIC = "static"
BYPASS_DYNAMIC = "dynamic"


@dataclass(frozen=True)
class PolicyConfig:
    """A full replacement+bypass policy configuration."""

    dbp: bool = False
    at: bool = False
    bypass: str = BYPASS_NONE           # none | static | dynamic
    gqa_variant: bool = False           # conservative inter-core-sharing variant
    b_bits: int = 3                     # priority tiers = 2**b_bits
    b_gear: int = 0                     # initial (static: fixed) gear
    # dynamic-gear feedback (evictions per window per slice):
    window_cycles: int = 4096
    bypass_ub: float = 0.12             # eviction rate upper bound → gear++
    bypass_lb: float = 0.05             # eviction rate lower bound → gear--
    # gear decrease only after this many consecutive low-rate windows
    # (fast-up / slow-down hysteresis: over-bypassing shows up as a rate
    # cliff at the optimal gear, so probing down must be gentle)
    down_streak: int = 4
    # gqa_bypass: contention level (eviction rate) above which the slower
    # core of a sharing pair starts bypassing.
    gqa_contention_threshold: float = 0.30
    # multi-tenant composites only (DESIGN.md §8.4): run one gear
    # feedback loop per tenant's address region instead of one global
    # law — each tenant's eviction rate moves only that tenant's gear,
    # and a line's bypass decision consults its own tenant's gear.
    # Ignored (bit-identical to the global controller) on traces that
    # carry no tenant map.
    per_tenant_gears: bool = False

    def __post_init__(self) -> None:
        if self.bypass not in (BYPASS_NONE, BYPASS_STATIC, BYPASS_DYNAMIC):
            raise ValueError(f"unknown bypass mode {self.bypass!r}")
        if not (0 <= self.b_gear <= (1 << self.b_bits)):
            raise ValueError("B_GEAR must lie in [0, 2**B_BITS]")

    @property
    def name(self) -> str:
        parts = []
        parts.append("at" if self.at else "lru")
        if self.bypass != BYPASS_NONE:
            suffix = "gqa_bypass" if self.gqa_variant else "bypass"
            if self.bypass == BYPASS_STATIC:
                suffix += f"[gear={self.b_gear}]"
            parts.append(suffix)
        if self.dbp:
            parts.append("dbp")
        return "+".join(parts)


def named_policy(name: str, *, b_bits: int = 3, gqa: bool = False,
                 **overrides) -> PolicyConfig:
    """Resolve the policy names used in the paper's figures.

    ``gqa=True`` selects the conservative gqa_bypass variant for any policy
    that bypasses (the paper always uses it for spatial group allocation).
    """
    base = dict(b_bits=b_bits, gqa_variant=gqa)
    presets = {
        "lru": dict(),
        "at": dict(at=True),
        "dbp": dict(dbp=True),
        "at+dbp": dict(at=True, dbp=True),
        "lru+bypass": dict(bypass=BYPASS_DYNAMIC),
        "at+bypass": dict(at=True, bypass=BYPASS_DYNAMIC),
        "bypass+dbp": dict(bypass=BYPASS_DYNAMIC, dbp=True),
        "all": dict(at=True, bypass=BYPASS_DYNAMIC, dbp=True),
    }
    if name in presets:
        cfg = dict(base, **presets[name])
    elif name.startswith("fix"):
        # fixN: static gear, ascending aggressiveness; at always enabled
        # (the paper evaluates bypassing with at on, §VI-E).
        gear = int(name[3:])
        cfg = dict(base, at=True, bypass=BYPASS_STATIC, b_gear=gear)
    else:
        raise KeyError(f"unknown policy {name!r}")
    cfg.update(overrides)
    return PolicyConfig(**cfg)


class GearController:
    """Per-slice dynamic ``B_GEAR`` controller (paper §IV-D).

    Each LLC slice tracks its eviction count over a sliding window of
    cycles.  When the window closes, the eviction *rate* (evictions per
    LLC-access) is compared against ``bypass_ub`` / ``bypass_lb`` and the
    slice's gear moves one step up / down.

    ``n_tenants > 1`` (the opt-in multi-tenant mode, DESIGN.md §8.4)
    runs the identical feedback law independently per tenant: state
    arrays grow a leading tenant axis and ``record`` attributes each
    access to the tenant of the line that issued it, so one tenant's
    thrashing ramps only that tenant's gear.  With one tenant every
    array collapses to the original per-slice shape — bit-identical to
    the single-controller behavior.
    """

    def __init__(self, n_slices: int, cfg: PolicyConfig,
                 n_tenants: int = 1):
        self.cfg = cfg
        self.n_slices = n_slices
        self.n_tenants = n_tenants
        shape = (n_tenants, n_slices) if n_tenants > 1 else (n_slices,)
        self.gear = np.full(shape, cfg.b_gear, dtype=np.int64)
        self._evictions = np.zeros(shape, dtype=np.int64)
        self._accesses = np.zeros(shape, dtype=np.int64)
        self._low_streak = np.zeros(shape, dtype=np.int64)
        self._window_start = 0.0
        self.max_gear = 1 << cfg.b_bits
        # last observed eviction rate (for gqa_bypass contention)
        self.last_rate = np.zeros(shape, dtype=np.float64)
        # opt-in event telemetry (repro_torch.core.events.EventSink): gear
        # transitions are emitted per (tenant, slice) when attached
        self.sink = None

    def _flat(self, slice_ids: np.ndarray,
              tenant_ids: Optional[np.ndarray]) -> np.ndarray:
        if self.n_tenants == 1:
            return slice_ids
        return tenant_ids * self.n_slices + slice_ids

    def record(self, slice_ids: np.ndarray, evicted: np.ndarray,
               tenant_ids: Optional[np.ndarray] = None) -> None:
        flat = self._flat(slice_ids, tenant_ids)
        n = self.gear.size
        self._accesses += np.bincount(flat, minlength=n).reshape(
            self._accesses.shape)
        if evicted.any():
            self._evictions += np.bincount(
                flat[evicted], minlength=n).reshape(self._evictions.shape)

    def gears_at(self, slice_ids: np.ndarray,
                 tenant_ids: Optional[np.ndarray] = None) -> np.ndarray:
        if self.n_tenants == 1 or tenant_ids is None:
            gear = self.gear if self.gear.ndim == 1 else self.gear[0]
            return gear[slice_ids]
        return self.gear[tenant_ids, slice_ids]

    def tick(self, now_cycles: float) -> None:
        elapsed = now_cycles - self._window_start
        if elapsed < self.cfg.window_cycles:
            return
        acc = np.maximum(self._accesses, 1)
        rate = self._evictions / acc
        self.last_rate = rate
        if self.cfg.bypass == BYPASS_DYNAMIC:
            up = rate > self.cfg.bypass_ub
            low = rate < self.cfg.bypass_lb
            self._low_streak = np.where(low, self._low_streak + 1, 0)
            down = self._low_streak >= self.cfg.down_streak
            self._low_streak[down] = 0
            old = self.gear if self.sink is not None else None
            self.gear = np.clip(self.gear + up.astype(np.int64)
                                - down.astype(np.int64), 0, self.max_gear)
            if self.sink is not None:
                changed = np.nonzero(old != self.gear)
                if changed[0].shape[0]:
                    if self.gear.ndim == 1:
                        sl = changed[0]
                        ten = np.zeros_like(sl)
                    else:
                        ten, sl = changed
                    self.sink.emit_gear(sl, ten, self.gear[changed])
        self._evictions[:] = 0
        self._accesses[:] = 0
        # advance in whole window multiples: snapping to now_cycles would
        # let a late tick stretch the next feedback window by the
        # overshoot, skewing the eviction *rate* the gear law compares
        # against its fixed thresholds
        self._window_start += (elapsed // self.cfg.window_cycles) \
            * self.cfg.window_cycles

    def contended(self) -> np.ndarray:
        """Per-slice contention flag used by the gqa_bypass variant."""
        return self.last_rate > self.cfg.gqa_contention_threshold


def make_controller(n_slices: int, cfg: PolicyConfig,
                    n_tenants: int = 1) -> Optional[GearController]:
    if cfg.bypass == BYPASS_NONE:
        return None
    return GearController(
        n_slices, cfg, n_tenants if cfg.per_tenant_gears else 1)


def with_gear(cfg: PolicyConfig, gear: int) -> PolicyConfig:
    return replace(cfg, b_gear=gear)
