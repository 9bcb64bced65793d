"""CacheOrchestrator — the DCO policies as a planner, budgeted for Hopper.

On an H100 there is no shared LLC under policy control either; the
capacity-constrained fast memory a kernel controls is an SM's shared
memory (``vmem_budget_bytes`` keeps the planner's historical argument
name; here it counts shared-memory bytes).  The orchestrator executes
the paper's *policies* as a planner:

* **anti-thrashing → pinned subset**: score a KV tile by the low
  ``B_BITS`` bits of its tile index; the deterministic subset
  ``S_kept = S_work · M / 2^B_BITS ≤ budget`` stays resident in shared
  memory across the whole Q loop of the flash-attention kernel.
* **dynamic bypassing → streamed remainder**: tiles below the chosen gear
  are re-fetched per Q tile and never claim persistent shared memory.
  The gear is chosen *per shape* from the budget instead of a runtime
  eviction-rate loop.
* **dead-block prediction → buffer lifetime**: per-tensor ``nAcc`` from
  the dataflow tells the serve engine when a request's KV slot retires
  so it is reused immediately.

The plan is consumed by ``repro_torch.kernels.flash_attention``
(pinned/streamed split; budget from :func:`hopper_pin_budget_bytes`) and
by ``repro_torch.serve`` (slot retirement).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import Tuple

import numpy as np

from .tmu import TensorMeta


@dataclass(frozen=True)
class TensorPlanEntry:
    """Residency decision for one tensor."""

    tensor_id: int
    pinned_tiles: Tuple[int, ...]     # tile indices kept resident
    streamed_tiles: Tuple[int, ...]   # tile indices re-fetched per use
    gear: int                         # chosen B_GEAR (tiles with prio<gear stream)
    n_acc: int                        # dataflow lifetime (for retirement)


@dataclass(frozen=True)
class OrchestrationPlan:
    entries: Dict[int, TensorPlanEntry]
    vmem_budget_bytes: int
    pinned_bytes: int
    b_bits: int

    @property
    def pinned_fraction(self) -> float:
        total = sum(len(e.pinned_tiles) + len(e.streamed_tiles)
                    for e in self.entries.values())
        pinned = sum(len(e.pinned_tiles) for e in self.entries.values())
        return pinned / total if total else 1.0


class CacheOrchestrator:
    """Plan fast-memory residency for a set of registered tensors.

    Mirrors the TMU software interface: ``register`` tensors with their
    dataflow metadata, then ``plan`` against a fast-memory budget.
    """

    def __init__(self, vmem_budget_bytes: int, b_bits: int = 3,
                 reserve_fraction: float = 1.0 / 8.0):
        """``reserve_fraction`` mirrors the paper's (A-1)/A term: a share
        of the budget is set aside for streaming double-buffers, just as
        ``at`` leaves one way per set for in-flight lines."""
        self.vmem_budget = vmem_budget_bytes
        self.b_bits = b_bits
        self.reserve_fraction = reserve_fraction
        self._tensors: Dict[int, TensorMeta] = {}

    def register(self, meta: TensorMeta) -> None:
        if meta.tensor_id in self._tensors:
            raise ValueError(f"tensor {meta.tensor_id} already registered")
        self._tensors[meta.tensor_id] = meta

    def register_many(self, metas) -> None:
        """Register a whole dataflow's tensors (e.g. the output of
        a dataflow's TMU metadata) in one call."""
        for meta in metas:
            self.register(meta)

    def clear(self, tensor_id: int) -> None:
        self._tensors.pop(tensor_id, None)

    # ------------------------------------------------------------------
    def plan(self) -> OrchestrationPlan:
        """Choose the pinned subset with the paper's S_kept rule.

        Tensors are ranked by reuse (``n_acc``) so the most-reused streams
        claim residency first; within a tensor, the priority score is the
        low ``B_BITS`` bits of the tile index and the gear is the largest
        value such that pinned bytes fit the budget — the compile-time
        equivalent of the self-adaptive mechanism.
        """
        usable = int(self.vmem_budget * (1.0 - self.reserve_fraction))
        tiers = 1 << self.b_bits
        entries: Dict[int, TensorPlanEntry] = {}
        pinned_bytes = 0

        order = sorted(self._tensors.values(),
                       key=lambda m: (-m.n_acc, m.tensor_id))
        for meta in order:
            tiles = np.arange(meta.num_tiles)
            prio = tiles & (tiers - 1)
            if meta.bypass_all or meta.n_acc <= 1:
                gear = tiers          # stream everything: no reuse to save
            else:
                remaining = usable - pinned_bytes
                # pin tiers from the top (highest priority) downwards
                gear = tiers
                for g in range(tiers, -1, -1):
                    n_pinned = int((prio >= g).sum())
                    if n_pinned * meta.tile_bytes <= remaining:
                        gear = g
                    else:
                        break
            keep = prio >= gear
            pinned = tuple(int(t) for t in tiles[keep])
            streamed = tuple(int(t) for t in tiles[~keep])
            pinned_bytes += len(pinned) * meta.tile_bytes
            entries[meta.tensor_id] = TensorPlanEntry(
                tensor_id=meta.tensor_id, pinned_tiles=pinned,
                streamed_tiles=streamed, gear=gear, n_acc=meta.n_acc)

        return OrchestrationPlan(entries=entries,
                                 vmem_budget_bytes=self.vmem_budget,
                                 pinned_bytes=pinned_bytes,
                                 b_bits=self.b_bits)

    # ------------------------------------------------------------------
    def plan_kv_split(self, seq_len: int, kv_tile_rows: int,
                      bytes_per_row: int) -> Tuple[int, int]:
        """Convenience for the flash-attention kernel: split a KV stream of
        ``seq_len`` rows into (pinned_rows, streamed_rows), pinned rows
        chosen as a contiguous prefix (one dense block of shared memory)
        whose size matches the S_kept the tag-bit policy would keep."""
        usable = int(self.vmem_budget * (1.0 - self.reserve_fraction))
        total_rows = seq_len
        total_bytes = total_rows * bytes_per_row
        tiers = 1 << self.b_bits
        if total_bytes <= usable:
            return total_rows, 0
        tile_bytes = kv_tile_rows * bytes_per_row
        n_tiles = total_rows // kv_tile_rows
        m = min(int(usable / max(tile_bytes, 1) / max(n_tiles / tiers, 1e-9)),
                tiers)
        kept_tiles = n_tiles * m // tiers
        pinned_rows = kept_tiles * kv_tile_rows
        return pinned_rows, total_rows - pinned_rows


# ---------------------------------------------------------------------------
# Hopper budget: the shared-memory layout of csrc/flash_attention.cu
# ---------------------------------------------------------------------------
H100_SMEM_PER_BLOCK = 232448      # bytes of dynamic shared memory a block may take
FLASH_TILE_ROWS = 64              # KV-tile rows of the flash kernel (and the fp32 Q tile)
FLASH_STAGES = 2                  # bf16: streamed K/V tiles in the kernel's ring
FLASH_ROW_ALIGN = 128             # bf16: bytes a staged row is rounded up to (row_bytes)


def flash_smem_row_words(head_dim: int, itemsize: int) -> int:
    """32-bit words one staged Q/K/V row takes in the flash kernel's shared
    memory.  bf16: the row's data rounded up to ``FLASH_ROW_ALIGN`` bytes
    (16-byte chunks XOR-swizzled by row inside it; no pad at head_dim 64 and
    128, 224 bytes staged at 256 at head_dim 112).  fp32: the data plus one
    pad word (odd stride: no bank conflicts when 16 lanes read 16
    consecutive rows)."""
    if itemsize == 2:
        return -(-2 * head_dim // FLASH_ROW_ALIGN) * FLASH_ROW_ALIGN // 4
    return head_dim * itemsize // 4 + 1


def flash_kv_row_bytes(head_dim: int, itemsize: int) -> int:
    """Shared-memory bytes one pinned KV position takes (its K row and its V
    row as the kernel stages them): the ``bytes_per_row`` to hand
    ``CacheOrchestrator.plan_kv_split``."""
    return 2 * 4 * flash_smem_row_words(head_dim, itemsize)


def flash_smem_work_bytes(head_dim: int, itemsize: int) -> int:
    """Shared memory the flash kernel needs whatever ``pinned_rows`` is.
    bf16: a ring of ``FLASH_STAGES`` streamed K and V tiles, through which Q
    is staged as well.  fp32: one Q tile, one streamed K and one streamed V
    tile, and the fp32 probability tile."""
    row = 4 * flash_smem_row_words(head_dim, itemsize)
    if itemsize == 2:
        return FLASH_STAGES * 2 * FLASH_TILE_ROWS * row
    return 3 * FLASH_TILE_ROWS * row + 4 * FLASH_TILE_ROWS * (FLASH_TILE_ROWS + 1)


def flash_smem_bytes(pinned_rows: int, head_dim: int, itemsize: int) -> int:
    """Total dynamic shared memory of one flash-kernel block.  bf16 stages
    the pinned prefix in whole KV tiles, so a prefix of any length takes
    whole tiles."""
    row = 4 * flash_smem_row_words(head_dim, itemsize)
    if itemsize == 2:
        pinned_rows = -(-pinned_rows // FLASH_TILE_ROWS) * FLASH_TILE_ROWS
    return 2 * pinned_rows * row + flash_smem_work_bytes(head_dim, itemsize)


def hopper_pin_budget_bytes(head_dim: int, itemsize: int) -> int:
    """Bytes of an H100 block's shared memory that the flash kernel keeps
    for the pinned KV prefix: what is left of the 227 KB a block may take
    after the kernel's working tiles.  Hand it to
    ``CacheOrchestrator(vmem_budget_bytes=...)`` with ``bytes_per_row =
    flash_kv_row_bytes(head_dim, itemsize)``: a prefix that is the whole KV
    length (at most 285 rows at head_dim 112 and 128, 682 at 64, in bf16)
    still fits once rounded up to whole tiles, and every split the planner
    returns fits the kernel."""
    return H100_SMEM_PER_BLOCK - flash_smem_work_bytes(head_dim, itemsize)
