"""Pluggable address-space layer (DESIGN.md §13).

Address assignment used to be an *implicit invariant* — "bases are
monotone, bump-allocated from ``1 << 30``" — replicated in the lowering
(`lower.assign_addresses`), both stream emitters, the event sink's
registration check, and the verifier's DCO211 rule.  The serving
replay showed why that matters: a bump allocator mints fresh addresses
forever, so the anti-thrashing ``tag[B_BITS-1:0]`` tiers decay with
replay length (at+dbp 1.25× at 96 requests → 0.67× at 1000).  Real
paged-KV servers recycle pages from a fixed pool (vLLM-style), which
keeps the tag map stationary.

This module makes the policy explicit: an :class:`AddressAllocator`
hands out :class:`Region`\\ s and (optionally) takes them back.  Two
implementations:

* :class:`BumpAllocator` — today's behavior, bit-identical to the
  historical ``lower._Allocator`` / ``StreamEmitter`` arithmetic
  (tile-aligned bump from ``1 << 30``; ``free`` is a no-op).  The
  pinned default: every existing spec, golden digest, and frozen
  oracle lays out byte-identically.
* :class:`PooledPageAllocator` — a fixed page pool with a sorted,
  coalescing free list.  ``free`` returns a region's pages
  immediately; ``alloc`` recycles first-fit at the lowest address.
  Deterministic: allocator state is a pure function of the
  alloc/free call sequence, so the monolithic and streaming replay
  emitters (which see the same declare/retire sequence from
  ``ReplayEngine.drive``) produce identical layouts.

Allocator contract for callers: ``free`` may only be called once the
region's final access round has been emitted (the replay engine retires
a request *after* its last decode round), so a recycled region's new
tensor is never accessed in the same round as its predecessor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple

#: shared default base — away from address 0 so tag bits are
#: non-degenerate (matches the historical ``lower._Allocator``)
DEFAULT_BASE = 1 << 30

#: allocator registry names (``DataflowSpec.allocator`` tags)
BUMP = "bump"
POOLED = "pooled"
ALLOCATOR_NAMES = (BUMP, POOLED)


@dataclass(frozen=True)
class Region:
    """One allocated address range, as handed out by an allocator."""

    base: int
    size_bytes: int

    @property
    def end(self) -> int:
        return self.base + self.size_bytes


class AddressAllocator:
    """Protocol for address-space policies.

    ``name`` is the registry tag recorded on specs the allocator laid
    out (``DataflowSpec.allocator``); ``monotone`` states whether bases
    ascend in allocation order (the fact DCO211 checks — a
    BumpAllocator property, not an IR property).
    """

    name: str = "abstract"
    monotone: bool = False

    def alloc(self, size_bytes: int, tile_bytes: int, *,
              align: Optional[int] = None) -> Region:
        raise NotImplementedError

    def free(self, region: Region) -> None:
        raise NotImplementedError

    def stats(self) -> Dict[str, int]:
        return {}


class BumpAllocator(AddressAllocator):
    """Monotone bump allocation, tile-aligned, from ``base``.

    Bit-identical to the historical arithmetic: the aligned base is
    ``ceil(next / align) * align`` and ``next`` advances past the
    allocation.  ``free`` is a no-op — addresses are never reused, which
    is exactly the tier-decay regime."""

    name = BUMP
    monotone = True

    def __init__(self, base: int = DEFAULT_BASE):
        self._base = base
        self._next = base

    def alloc(self, size_bytes: int, tile_bytes: int, *,
              align: Optional[int] = None) -> Region:
        if size_bytes <= 0 or tile_bytes <= 0:
            raise ValueError("alloc: sizes must be positive")
        a = align if align is not None else tile_bytes
        base = (self._next + a - 1) // a * a
        self._next = base + size_bytes
        return Region(base=base, size_bytes=size_bytes)

    def free(self, region: Region) -> None:  # noqa: ARG002 - by contract
        """No-op: bump allocation never reuses addresses."""

    def stats(self) -> Dict[str, int]:
        return {"allocated_bytes": self._next - self._base}


class PooledPageAllocator(AddressAllocator):
    """Fixed page pool with free-list recycling (vLLM-style).

    The pool is ``pool_pages`` pages of ``page_bytes`` starting at
    ``base``.  Allocations are rounded up to whole pages and placed
    first-fit at the lowest free address; frees return pages to a
    sorted, coalescing interval list immediately.  If no free interval
    fits, the pool grows deterministically past its configured top
    (``overflow_allocs`` counts these — a sizing signal, not an error),
    and overflowed pages recycle like any others once freed.

    ``free`` is idempotent-safe: freeing a region whose pages are
    already entirely free is a no-op; a *partial* overlap with the free
    list (a region that was never handed out, or a double free racing a
    reallocation) raises.
    """

    name = POOLED
    monotone = False

    def __init__(self, page_bytes: int = 2048, pool_pages: int = 2048,
                 base: int = DEFAULT_BASE):
        if page_bytes <= 0 or pool_pages <= 0:
            raise ValueError("pooled allocator: page/pool sizes "
                             "must be positive")
        if base % page_bytes:
            raise ValueError("pooled allocator: base must be "
                             "page-aligned")
        self.page_bytes = page_bytes
        self.pool_pages = pool_pages
        self._base = base
        self._pool_end = base + pool_pages * page_bytes
        self._top = self._pool_end          # grows only on overflow
        #: sorted, disjoint, coalesced free intervals [start, end)
        self._free: List[Tuple[int, int]] = [(base, self._pool_end)]
        self.overflow_allocs = 0
        self.n_allocs = 0
        self.n_frees = 0

    def _span(self, size_bytes: int) -> int:
        p = self.page_bytes
        return (size_bytes + p - 1) // p * p

    def alloc(self, size_bytes: int, tile_bytes: int, *,
              align: Optional[int] = None) -> Region:
        if size_bytes <= 0 or tile_bytes <= 0:
            raise ValueError("alloc: sizes must be positive")
        a = align if align is not None else tile_bytes
        if self.page_bytes % a:
            raise ValueError(
                f"pooled allocator: alignment {a} does not divide the "
                f"page size {self.page_bytes} (page-aligned bases could "
                f"violate it)")
        span = self._span(size_bytes)
        self.n_allocs += 1
        for i, (start, end) in enumerate(self._free):
            if end - start >= span:
                if end - start == span:
                    del self._free[i]
                else:
                    self._free[i] = (start + span, end)
                return Region(base=start, size_bytes=size_bytes)
        base = self._top
        self._top += span
        self.overflow_allocs += 1
        return Region(base=base, size_bytes=size_bytes)

    def free(self, region: Region) -> None:
        start = region.base
        end = start + self._span(region.size_bytes)
        if start % self.page_bytes or start < self._base or end > self._top:
            raise ValueError(
                f"free: region [0x{start:x}, 0x{end:x}) was never "
                f"handed out by this pool")
        self.n_frees += 1
        # locate the insertion point in the sorted interval list
        lo = 0
        hi = len(self._free)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._free[mid][0] < start:
                lo = mid + 1
            else:
                hi = mid
        # idempotent no-op: the pages are already entirely free
        if lo > 0 and self._free[lo - 1][1] >= end:
            return
        if lo < len(self._free) and self._free[lo][0] == start \
                and self._free[lo][1] >= end:
            return
        # partial overlap with a free interval is a real double free
        if lo > 0 and self._free[lo - 1][1] > start:
            raise ValueError(
                f"free: [0x{start:x}, 0x{end:x}) partially overlaps the "
                f"free interval [0x{self._free[lo - 1][0]:x}, "
                f"0x{self._free[lo - 1][1]:x})")
        if lo < len(self._free) and self._free[lo][0] < end:
            raise ValueError(
                f"free: [0x{start:x}, 0x{end:x}) partially overlaps the "
                f"free interval [0x{self._free[lo][0]:x}, "
                f"0x{self._free[lo][1]:x})")
        # insert, coalescing with both neighbors
        if lo > 0 and self._free[lo - 1][1] == start:
            start = self._free[lo - 1][0]
            del self._free[lo - 1]
            lo -= 1
        if lo < len(self._free) and self._free[lo][0] == end:
            end = self._free[lo][1]
            del self._free[lo]
        self._free.insert(lo, (start, end))

    # ------------------------------------------------------------------
    def free_pages(self) -> int:
        return sum(e - s for s, e in self._free) // self.page_bytes

    def high_water_pages(self) -> int:
        """Peak footprint in pages, counting overflow growth."""
        return (self._top - self._base) // self.page_bytes

    def stats(self) -> Dict[str, int]:
        return {"pool_pages": self.pool_pages,
                "page_bytes": self.page_bytes,
                "n_allocs": self.n_allocs,
                "n_frees": self.n_frees,
                "overflow_allocs": self.overflow_allocs,
                "high_water_pages": self.high_water_pages(),
                "free_pages": self.free_pages()}


def make_allocator(name: str, *, page_bytes: int = 2048,
                   pool_pages: int = 2048,
                   base: int = DEFAULT_BASE) -> AddressAllocator:
    """Factory keyed by the registry tag (``ReplayConfig.allocator``)."""
    if name == BUMP:
        return BumpAllocator(base=base)
    if name == POOLED:
        return PooledPageAllocator(page_bytes=page_bytes,
                                   pool_pages=pool_pages, base=base)
    raise ValueError(f"unknown allocator {name!r} "
                     f"(expected one of {ALLOCATOR_NAMES})")
