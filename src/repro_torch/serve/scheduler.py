"""Continuous-batching slot scheduler (pure Python).

The admit/retire bookkeeping of :class:`~repro_torch.serve.engine.ServeEngine`
— a fixed pool of KV slots, a FIFO queue, first-free-slot admission,
immediate slot reuse on retirement — kept apart from the engine so the
batching decisions can be driven and tested without a model.  Slots hold arbitrary payloads; the scheduler knows nothing about
caches or tokens.
"""

from __future__ import annotations

from typing import Generic
from typing import List
from typing import Optional
from typing import Tuple
from typing import TypeVar

T = TypeVar("T")


class ServeTruncation(RuntimeError):
    """``run_to_completion`` exhausted its step budget with work left.

    Carries how much was still pending so callers can size budgets; the
    silent-return behaviour this replaces made truncated generations
    indistinguishable from finished ones.
    """

    def __init__(self, steps: int, active: int, queued: int):
        self.steps = steps
        self.active = active
        self.queued = queued
        super().__init__(
            f"serve loop truncated after {steps} steps with {active} "
            f"active slot(s) and {queued} queued request(s) remaining")


class SlotScheduler(Generic[T]):
    """First-free-slot continuous batching over ``max_batch`` slots."""

    def __init__(self, max_batch: int):
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self.max_batch = max_batch
        self.slots: List[Optional[T]] = [None] * max_batch
        self.queue: List[T] = []

    # -- queue ----------------------------------------------------------
    def add(self, item: T) -> None:
        self.queue.append(item)

    def admit(self) -> List[Tuple[int, T]]:
        """Fill free slots from the queue head; returns the new
        ``(slot, item)`` placements in admission order."""
        placed: List[Tuple[int, T]] = []
        for slot, occupant in enumerate(self.slots):
            if occupant is not None:
                continue
            if not self.queue:
                break
            item = self.queue.pop(0)
            self.slots[slot] = item
            placed.append((slot, item))
        return placed

    def release(self, slot: int) -> T:
        item = self.slots[slot]
        if item is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.slots[slot] = None
        return item

    # -- views ----------------------------------------------------------
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    @property
    def n_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def drained(self) -> bool:
        return self.n_active == 0 and not self.queue
