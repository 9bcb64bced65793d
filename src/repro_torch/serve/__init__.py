"""Serving layer: continuous batching over a slotted KV pool."""

from .engine import Request
from .engine import ServeEngine
from .scheduler import ServeTruncation
from .scheduler import SlotScheduler

__all__ = ["Request", "ServeEngine", "ServeTruncation", "SlotScheduler"]
