"""Address-space layer (DESIGN.md §13): bump bit-identity, pooled
free-list invariants (no live overlap, idempotent-safe frees,
deterministic recycling), and the replay-level DCO210/DCO202 contract."""

import numpy as np
import pytest

# the port
from repro_torch.dataflows.addr import ALLOCATOR_NAMES
from repro_torch.dataflows.addr import BumpAllocator
from repro_torch.dataflows.addr import DEFAULT_BASE
from repro_torch.dataflows.addr import PooledPageAllocator
from repro_torch.dataflows.addr import Region
from repro_torch.dataflows.addr import make_allocator

# Hypothesis widens the sequence coverage where installed (CI); the
# seeded variants below keep the invariants exercised without it.
try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

PAGE = 2048


# ---------------------------------------------------------------------------
# BumpAllocator: the pinned historical arithmetic
# ---------------------------------------------------------------------------
def test_bump_allocator_matches_historical_arithmetic():
    al = BumpAllocator()
    r1 = al.alloc(5000, 1024)
    r2 = al.alloc(300, 256)
    r3 = al.alloc(100, 256, align=4096)
    assert r1.base == DEFAULT_BASE                  # base is tile-aligned
    next1 = r1.base + 5000
    assert r2.base == (next1 + 255) // 256 * 256    # ceil to tile
    next2 = r2.base + 300
    assert r3.base == (next2 + 4095) // 4096 * 4096
    assert al.monotone and r1.base < r2.base < r3.base
    al.free(r1)                                     # no-op, never reused
    assert al.alloc(64, 64).base > r3.base


def test_make_allocator_registry():
    assert make_allocator("bump").name == "bump"
    assert make_allocator("pooled").name == "pooled"
    assert set(ALLOCATOR_NAMES) == {"bump", "pooled"}
    with pytest.raises(ValueError, match="unknown allocator"):
        make_allocator("slab")


# ---------------------------------------------------------------------------
# PooledPageAllocator: live-overlap freedom over random sequences
# ---------------------------------------------------------------------------
def _drive_random_sequence(seed, n_ops=400, pool_pages=64):
    """Random alloc/free workload; returns the realized (op, base, size)
    trace while asserting the no-live-overlap invariant at every step."""
    rng = np.random.default_rng(seed)
    al = PooledPageAllocator(page_bytes=PAGE, pool_pages=pool_pages)
    live = {}                                        # id -> Region
    trace = []
    for i in range(n_ops):
        if live and rng.random() < 0.45:
            key = list(live)[int(rng.integers(len(live)))]
            reg = live.pop(key)
            al.free(reg)
            trace.append(("free", reg.base, reg.size_bytes))
        else:
            size = int(rng.integers(1, 8 * PAGE))
            reg = al.alloc(size, PAGE)
            span = (size + PAGE - 1) // PAGE * PAGE
            for other in live.values():
                o_span = ((other.size_bytes + PAGE - 1) // PAGE * PAGE)
                assert (reg.base + span <= other.base
                        or other.base + o_span <= reg.base), (
                    f"op {i}: pooled alloc [{reg.base:#x}, "
                    f"{reg.base + span:#x}) overlaps live "
                    f"[{other.base:#x}, {other.base + o_span:#x})")
            live[i] = reg
            trace.append(("alloc", reg.base, reg.size_bytes))
    return trace, al


@pytest.mark.parametrize("seed", [0, 7, 123, 99991])
def test_pooled_never_overlaps_live_regions(seed):
    _drive_random_sequence(seed)


@pytest.mark.parametrize("seed", [3, 17, 4242])
def test_pooled_sequence_seed_deterministic(seed):
    """Re-driving the identical op sequence reproduces the identical
    region sequence — allocator state is a pure function of the call
    sequence (mirrors RequestStream's determinism contract, and is what
    makes streamed and monolithic replay layouts agree)."""
    first, al1 = _drive_random_sequence(seed)
    again, al2 = _drive_random_sequence(seed)
    assert first == again
    assert al1.stats() == al2.stats()


def test_pooled_recycles_at_lowest_address():
    al = PooledPageAllocator(page_bytes=PAGE, pool_pages=16)
    a = al.alloc(PAGE, PAGE)
    b = al.alloc(PAGE, PAGE)
    c = al.alloc(PAGE, PAGE)
    assert (a.base, b.base, c.base) == (
        DEFAULT_BASE, DEFAULT_BASE + PAGE, DEFAULT_BASE + 2 * PAGE)
    al.free(a)
    al.free(c)
    # first-fit at the lowest free address: a's slot, not c's
    assert al.alloc(PAGE, PAGE).base == a.base
    assert al.alloc(PAGE, PAGE).base == c.base
    assert al.overflow_allocs == 0


def test_pooled_overflow_grows_then_recycles():
    al = PooledPageAllocator(page_bytes=PAGE, pool_pages=2)
    a = al.alloc(2 * PAGE, PAGE)                    # drains the pool
    b = al.alloc(PAGE, PAGE)                        # overflow growth
    assert b.base == a.base + 2 * PAGE
    assert al.overflow_allocs == 1
    al.free(b)                                      # overflow pages pool
    assert al.alloc(PAGE, PAGE).base == b.base
    assert al.high_water_pages() == 3


def test_pooled_free_idempotent_and_partial_overlap_raises():
    al = PooledPageAllocator(page_bytes=PAGE, pool_pages=8)
    a = al.alloc(3 * PAGE, PAGE)
    al.free(a)
    al.free(a)                                      # idempotent no-op
    assert al.free_pages() == 8
    b = al.alloc(2 * PAGE, PAGE)
    # b occupies a's first two pages; re-freeing a now straddles the
    # live b and the free tail — a real double free racing reallocation
    with pytest.raises(ValueError, match="partially overlaps"):
        al.free(a)
    with pytest.raises(ValueError, match="never handed out"):
        al.free(Region(base=DEFAULT_BASE - PAGE, size_bytes=PAGE))
    with pytest.raises(ValueError, match="never handed out"):
        al.free(Region(base=b.base + 1, size_bytes=PAGE))


def test_pooled_alignment_must_divide_page():
    al = PooledPageAllocator(page_bytes=PAGE, pool_pages=8)
    al.alloc(PAGE, 512)                             # 512 divides 2048
    with pytest.raises(ValueError, match="does not divide"):
        al.alloc(PAGE, 3000)


if HAVE_HYPOTHESIS:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           pool_pages=st.sampled_from([4, 16, 64, 256]))
    def test_pooled_invariants_property(seed, pool_pages):
        first, al1 = _drive_random_sequence(seed, n_ops=200,
                                            pool_pages=pool_pages)
        again, al2 = _drive_random_sequence(seed, n_ops=200,
                                            pool_pages=pool_pages)
        assert first == again
        assert al1.stats() == al2.stats()


# ---------------------------------------------------------------------------
# Replay-level contract: pooled recycling is DCO210-clean and keeps the
# DCO202 tier-aliasing count flat where bump's grows
# ---------------------------------------------------------------------------
def _replay_diags(n_requests, allocator):
    from repro_torch.core.simulator import SimConfig
    from repro_torch.serve.replay import ReplayConfig
    from repro_torch.serve.replay import run_replay
    from repro_torch.serve.traffic import TrafficConfig
    traffic = TrafficConfig(n_requests=n_requests, seed=0)
    res = run_replay(traffic, "lru", SimConfig(llc_bytes=128 * 1024),
                     ReplayConfig(allocator=allocator), verify=True)
    return res.diagnostics


def test_pooled_replay_recycles_without_overlap_diagnostics():
    """Driven by a real request stream, the pooled replay re-hands-out
    retired KV regions (bounded address footprint) with zero DCO210
    overlap findings, and its DCO202 count stays flat while bump's
    grows with replay length — the ROADMAP acceptance metric."""
    pooled_small = _replay_diags(96, "pooled")
    pooled_large = _replay_diags(600, "pooled")
    bump_small = _replay_diags(96, "bump")
    bump_large = _replay_diags(600, "bump")
    assert pooled_small.count("DCO210") == 0
    assert pooled_large.count("DCO210") == 0
    assert bump_large.count("DCO202") > bump_small.count("DCO202")
    assert (pooled_large.count("DCO202")
            <= pooled_small.count("DCO202") + 8)
