"""Declarative dataflow IR with shared lowerings (DESIGN.md §8).

One :class:`DataflowSpec` per scenario; ``lower_to_trace`` /
``lower_to_counts`` / ``lower_to_plan`` derive the simulator trace, the
analytical model's counts, and the orchestrator plan from that single
description.  The scenario registry (``build_suite``) is the canonical
entry point for sweeping every expressible dataflow.
"""

from .artifacts import artifacts_enabled
from .artifacts import cache_dir
from .artifacts import spec_fingerprint
from .artifacts import try_spec_fingerprint
from .compose import compose_time_sliced
from .compose import tenant_regions
from .fa2 import fa2_spec
from .fa2 import matmul_spec
from .ir import DataflowSpec
from .ir import SpecBuilder
from .ir import StepSpec
from .ir import TensorSpec
from .lower import assign_addresses
from .lower import lower_to_counts
from .lower import lower_to_plan
from .lower import lower_to_trace
from .lower import tmu_metadata
from .reuse import ReuseProfile
from .reuse import lower_to_reuse_profile
from .scenarios import decode_paged_spec
from .scenarios import mlp_chain_spec
from .scenarios import moe_ffn_spec
from .scenarios import prefix_share_spec
from .scenarios import spec_decode_spec
from .scenarios import ssd_scan_spec
from .scenarios import transformer_layer_spec
from .stream import DEFAULT_CHUNK_LINES
from .stream import ReplaySegment
from .stream import SpecEmitter
from .stream import StreamEmitter
from .suite import SUITE_POLICIES
from .suite import SuiteCase
from .suite import build_suite
from .suite import registry_keys
from .suite import suite_case
from .verify import Diagnostic
from .verify import SpecVerifyError
from .verify import StreamVerifier
from .verify import VerifyResult
from .verify import assert_clean
from .verify import cross_check_case
from .verify import predicted_retirements
from .verify import rules_inventory
from .verify import verify_metas
from .verify import verify_spec

__all__ = [
    "DataflowSpec", "SpecBuilder", "StepSpec", "TensorSpec",
    "compose_time_sliced", "tenant_regions",
    "assign_addresses", "lower_to_counts", "lower_to_plan",
    "lower_to_trace", "tmu_metadata",
    "ReuseProfile", "lower_to_reuse_profile",
    "artifacts_enabled", "cache_dir", "spec_fingerprint",
    "try_spec_fingerprint",
    "fa2_spec", "matmul_spec",
    "decode_paged_spec", "mlp_chain_spec", "moe_ffn_spec",
    "prefix_share_spec", "spec_decode_spec", "ssd_scan_spec",
    "transformer_layer_spec",
    "DEFAULT_CHUNK_LINES", "ReplaySegment", "SpecEmitter", "StreamEmitter",
    "SUITE_POLICIES", "SuiteCase", "build_suite", "registry_keys",
    "suite_case",
    "Diagnostic", "SpecVerifyError", "StreamVerifier", "VerifyResult",
    "assert_clean", "cross_check_case", "predicted_retirements",
    "rules_inventory", "verify_metas", "verify_spec",
]
