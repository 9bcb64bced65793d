"""Unit + property tests for the shared LLC and DCO policies."""

import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given
from hypothesis import settings
from hypothesis import strategies as st

# the port
from repro_torch.core.cache import BYPASSED_COLD
from repro_torch.core.cache import COLD_MISS
from repro_torch.core.cache import CONFLICT_MISS
from repro_torch.core.cache import CacheGeometry
from repro_torch.core.cache import HIT
from repro_torch.core.cache import SharedLLC
from repro_torch.core.policies import named_policy
from repro_torch.core.tmu import TMU
from repro_torch.core.tmu import TMUParams
from repro_torch.core.tmu import TensorMeta

GEOM = CacheGeometry(64 * 1024, line_bytes=128, assoc=4, n_slices=4)


def mk_llc(policy="lru", tmu=None, geom=GEOM, **kw):
    return SharedLLC(geom, named_policy(policy, **kw), tmu=tmu)


def addrs(lines):
    return np.asarray(lines, dtype=np.int64) * 128


def test_geometry_set_hash_is_bijective_per_block():
    g = CacheGeometry(64 * 1024, 128, 4, 4)
    ns = g.num_sets
    lines = np.arange(ns, dtype=np.int64) * 128 + 7 * ns * 128
    sets = g.set_of(lines)
    assert np.unique(sets).shape[0] == ns    # bijection within a block


def test_cold_then_hit():
    llc = mk_llc()
    a = addrs(range(16))
    seen = np.zeros(16, dtype=bool)
    codes = llc.access_burst(a, seen_before=seen)
    assert (codes == COLD_MISS).all()
    codes = llc.access_burst(a, seen_before=np.ones(16, dtype=bool))
    assert (codes == HIT).all()
    assert llc.hit_rate() == 0.5


def test_force_bypass_never_allocates():
    llc = mk_llc()
    a = addrs(range(8))
    codes = llc.access_burst(a, seen_before=np.zeros(8, bool),
                             force_bypass=True)
    assert (codes == BYPASSED_COLD).all()
    codes = llc.access_burst(a, seen_before=np.ones(8, bool),
                             force_bypass=True)
    assert (codes != HIT).all()
    assert llc.resident_bytes() == 0


def test_lru_evicts_oldest():
    geom = CacheGeometry(4 * 128 * 2, 128, 4, 1)   # 2 sets, 4 ways
    llc = SharedLLC(geom, named_policy("lru"))
    # 5 lines mapping to the same set → evicts the first
    lines = [geom_line_for_set(geom, 0, k) for k in range(5)]
    for ln in lines:
        llc.access_burst(addrs([ln]), seen_before=np.zeros(1, bool))
    # first line should be gone
    code = llc.access_burst(addrs([lines[0]]),
                            seen_before=np.ones(1, bool))
    assert code[0] == CONFLICT_MISS
    # others (2..4) still resident
    for ln in lines[2:]:
        code = llc.access_burst(addrs([ln]), seen_before=np.ones(1, bool))
        assert code[0] == HIT


def geom_line_for_set(geom, set_idx, k):
    """Find the k-th line number mapping to set_idx (scan; small geoms)."""
    found = 0
    ln = 0
    while True:
        if int(geom.set_of(np.int64(ln * 128))) == set_idx:
            if found == k:
                return ln
            found += 1
        ln += 1


def test_anti_thrash_evicts_lowest_priority_tier():
    geom = CacheGeometry(2 * 128 * 4, 128, 4, 1, hash_sets=False)  # 2 sets
    llc = SharedLLC(geom, named_policy("at", b_bits=3))
    ns = geom.num_sets
    # fill one set with tags of priorities 5, 6, 7, 4 (same set: stride ns)
    prios = [5, 6, 7, 4]
    lines = [p * ns for p in prios]             # tag == p
    for ln in lines:
        llc.access_burst(addrs([ln]), seen_before=np.zeros(1, bool))
    # insert a new line in the same set: victim must be the prio-4 line
    new = 9 * ns + 0                             # tag 9 → prio 1
    llc.access_burst(addrs([new]), seen_before=np.zeros(1, bool))
    code = llc.access_burst(addrs([4 * ns]), seen_before=np.ones(1, bool))
    assert code[0] == CONFLICT_MISS              # prio-4 was evicted
    for p in (5, 6, 7):
        code = llc.access_burst(addrs([p * ns]),
                                seen_before=np.ones(1, bool))
        assert code[0] == HIT


def test_dbp_victimizes_dead_lines_first():
    geom = CacheGeometry(2 * 128 * 4, 128, 4, 1, hash_sets=False)
    tmu = TMU(line_bytes=128, params=TMUParams(d_lsb=0, d_msb=11, b_bits=3))
    llc = SharedLLC(geom, named_policy("dbp"), tmu=tmu)
    ns = geom.num_sets
    # register a tensor covering the line with tag 6 (one-tile tensor)
    base = 6 * ns * 128
    meta = TensorMeta(0, base_addr=base, size_bytes=128, tile_bytes=128,
                      n_acc=1)
    tmu.register(meta)
    # fill set 0 with tags 5, 6, 7, 8; mark tag-6 line dead via TLL access
    for tag in (5, 6, 7, 8):
        llc.access_burst(addrs([tag * ns]), seen_before=np.zeros(1, bool))
    tmu.on_access(base, 6)
    assert tmu.is_dead(6)
    # new fill: victim must be the dead tag-6 line, not LRU (tag 5)
    llc.access_burst(addrs([9 * ns]), seen_before=np.zeros(1, bool))
    assert llc.access_burst(addrs([5 * ns]),
                            seen_before=np.ones(1, bool))[0] == HIT
    assert llc.access_burst(addrs([6 * ns]),
                            seen_before=np.ones(1, bool))[0] == CONFLICT_MISS
    assert llc.stats["dead_evictions"] == 1


def test_static_bypass_gear_filters_low_priority():
    geom = CacheGeometry(2 * 128 * 4, 128, 4, 1, hash_sets=False)
    llc = SharedLLC(geom, named_policy("fix4", b_bits=3))
    ns = geom.num_sets
    lo = 2 * ns      # tag 2 → prio 2 < gear 4 → bypass
    hi = 6 * ns      # tag 6 → prio 6 ≥ gear 4 → allocate
    llc.access_burst(addrs([lo, hi]), seen_before=np.zeros(2, bool))
    codes = llc.access_burst(addrs([lo, hi]), seen_before=np.ones(2, bool))
    assert codes[0] != HIT and codes[1] == HIT


def test_bypass_eligibility_gates_gqa_variant():
    geom = CacheGeometry(2 * 128 * 4, 128, 4, 1, hash_sets=False)
    llc = SharedLLC(geom, named_policy("fix4", b_bits=3, gqa=True))
    ns = geom.num_sets
    lo = 2 * ns
    # not eligible (leader core) → allocated despite low priority
    llc.access_burst(addrs([lo]), seen_before=np.zeros(1, bool),
                     bypass_eligible=False)
    assert llc.access_burst(addrs([lo]),
                            seen_before=np.ones(1, bool))[0] == HIT


def test_duplicate_sets_within_burst_are_split_correctly():
    geom = CacheGeometry(2 * 128 * 4, 128, 4, 1, hash_sets=False)
    llc = SharedLLC(geom, named_policy("lru"))
    ns = geom.num_sets
    # two lines in the same set in one burst: both must be processed
    a = addrs([1 * ns, 3 * ns])
    codes = llc.access_burst(a, seen_before=np.zeros(2, bool))
    assert (codes == COLD_MISS).all()
    codes = llc.access_burst(a, seen_before=np.ones(2, bool))
    assert (codes == HIT).all()


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=2000), min_size=1,
                max_size=300))
def test_property_stats_conservation(lines):
    """hits + cold + conflict == total accesses, and cold misses equal the
    number of distinct lines on first touch (with a policy-free cache)."""
    llc = mk_llc("lru")
    seen = set()
    total = 0
    for chunk_start in range(0, len(lines), 50):
        chunk = lines[chunk_start:chunk_start + 50]
        # dedupe within chunk (simulator-level MSHR contract)
        chunk = list(dict.fromkeys(chunk))
        sb = np.array([ln in seen for ln in chunk], dtype=bool)
        llc.access_burst(addrs(chunk), seen_before=sb)
        seen.update(chunk)
        total += len(chunk)
    s = llc.stats
    assert s["hits"] + s["cold_misses"] + s["conflict_misses"] == total
    assert s["cold_misses"] == len(seen) >= 1


def test_gear_window_advances_in_whole_multiples():
    """A late tick must not stretch the next feedback window: the window
    start advances by whole ``window_cycles`` multiples, never snaps to
    ``now_cycles`` (the drift skewed every subsequent eviction *rate*)."""
    from repro_torch.core.policies import GearController

    cfg = named_policy("at+bypass", window_cycles=100)
    gc = GearController(1, cfg)
    gc.record(np.zeros(50, dtype=np.int64), np.ones(50, dtype=bool))
    gc.tick(150.0)                     # closes the [0, 100) window late
    assert gc._window_start == 100.0   # not 150.0
    assert gc.gear[0] == 1             # rate 1.0 > ub → gear up
    # the next window closes at 200, unaffected by the 50-cycle overshoot
    gc.record(np.zeros(10, dtype=np.int64), np.ones(10, dtype=bool))
    gc.tick(199.0)
    assert gc._window_start == 100.0 and gc.gear[0] == 1
    gc.tick(205.0)
    assert gc._window_start == 200.0 and gc.gear[0] == 2
    # a very late tick skips whole windows, landing on a boundary
    gc.tick(565.0)
    assert gc._window_start == 500.0


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=8))
def test_property_gear_zero_equals_at(gear):
    """B_GEAR=0 bypasses nothing → static bypass degenerates to plain at
    (paper Fig. 7: 'B_GEAR = 0 … degenerates to ordinary at')."""
    rng = np.random.default_rng(0)
    lines = rng.integers(0, 4096, size=600)
    def run(policy):
        llc = mk_llc(policy)
        seen = set()
        for i in range(0, 600, 40):
            chunk = list(dict.fromkeys(lines[i:i + 40].tolist()))
            sb = np.array([ln in seen for ln in chunk], dtype=bool)
            llc.access_burst(addrs(chunk), seen_before=sb)
            seen.update(chunk)
        return llc.stats["hits"]
    if gear == 0:
        assert run("fix0") == run("at")
