"""DCO core pieces the serving path needs: the TMU model and the cache
orchestrator with its Hopper shared-memory budget."""

from .orchestrator import CacheOrchestrator
from .orchestrator import OrchestrationPlan
from .orchestrator import hopper_pin_budget_bytes
from .tmu import DeadFIFO
from .tmu import TMU
from .tmu import TMUParams
from .tmu import TensorMeta

__all__ = ["CacheOrchestrator", "OrchestrationPlan", "DeadFIFO", "TMU",
           "TMUParams", "TensorMeta", "hopper_pin_budget_bytes"]
