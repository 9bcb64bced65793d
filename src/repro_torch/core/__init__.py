"""DCO core: TMU, shared-LLC policies, cycle-level simulator, analytical
model, and the cache orchestrator with its Hopper shared-memory budget."""

from .analytical import ModelParams
from .analytical import Prediction
from .analytical import fit_params
from .analytical import gear_trajectory
from .analytical import kendall_tau
from .analytical import kept_fraction
from .analytical import predict
from .analytical import predict_batch
from .analytical import r_squared
from .cache import CacheGeometry
from .cache import SharedLLC
from .events import COLUMNS as EVENT_COLUMNS
from .events import EventSink
from .events import KIND_NAMES as EVENT_KINDS
from .events import SCHEMA_VERSION as EVENT_SCHEMA_VERSION
from .events import canonical_order
from .events import decode_event
from .events import stream_digest
from .events import timeline_digest
from .orchestrator import CacheOrchestrator
from .orchestrator import OrchestrationPlan
from .orchestrator import hopper_pin_budget_bytes
from .policies import PolicyConfig
from .policies import named_policy
from .simulator import SimConfig
from .simulator import SimResult
from .simulator import Simulator
from .simulator import run_policies
from .simulator import run_policy
from .tmu import DeadFIFO
from .tmu import TMU
from .tmu import TMUParams
from .tmu import TensorMeta
from .traces import CompiledTrace
from .traces import DataflowCounts
from .traces import Step
from .traces import Trace
from .traces import build_fa2_trace
from .traces import build_matmul_trace
from .traces import fa2_counts
from .workloads import AttnWorkload
from .workloads import DecodeWorkload
from .workloads import MoEWorkload
from .workloads import PAPER_WORKLOADS
from .workloads import PrefixShareWorkload
from .workloads import SPATIAL
from .workloads import SSDScanWorkload
from .workloads import SpecDecodeWorkload
from .workloads import TEMPORAL
from .workloads import get_workload

__all__ = [
    "ModelParams", "Prediction", "fit_params", "gear_trajectory",
    "kendall_tau", "kept_fraction", "predict", "predict_batch",
    "r_squared",
    "CacheGeometry", "SharedLLC",
    "EVENT_COLUMNS", "EVENT_KINDS", "EVENT_SCHEMA_VERSION", "EventSink",
    "canonical_order", "decode_event", "stream_digest", "timeline_digest",
    "CacheOrchestrator", "OrchestrationPlan", "hopper_pin_budget_bytes",
    "PolicyConfig", "named_policy",
    "SimConfig", "SimResult", "Simulator", "run_policies", "run_policy",
    "TMU", "DeadFIFO", "TMUParams", "TensorMeta",
    "CompiledTrace", "DataflowCounts", "Step", "Trace", "build_fa2_trace",
    "build_matmul_trace", "fa2_counts",
    "PAPER_WORKLOADS", "SPATIAL", "TEMPORAL", "AttnWorkload",
    "DecodeWorkload", "MoEWorkload", "PrefixShareWorkload",
    "SpecDecodeWorkload", "SSDScanWorkload", "get_workload",
]
