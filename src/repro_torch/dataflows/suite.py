"""The scenario suite: every dataflow the stack can express, one registry.

Each :class:`SuiteCase` bundles a spec builder with the cache
configuration that puts it in the regime the paper studies (working set
vs. LLC capacity) and the policy-variant flag (gqa bypass for spatially
shared dataflows, §IV-E).  ``benchmarks/suite_bench.py`` sweeps the fig-4
policy set across this registry and cross-validates the simulator against
the analytical model; tests and future scenario PRs extend the registry
rather than writing new one-off builders.

The registry is **lazy**: ``_REGISTRY`` maps each key to a builder thunk
and specs are only constructed when a case is actually requested —
``suite_case(key)`` builds exactly one case (CI smoke used to pay the
full ~10× suite build cost per single-scenario invocation), while
``build_suite()`` materializes all of them in registration order exactly
as before.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable
from typing import Dict
from typing import List
from typing import Tuple

from ..core.simulator import SimConfig
from ..core.workloads import AttnWorkload
from ..core.workloads import DecodeWorkload
from ..core.workloads import MoEWorkload
from ..core.workloads import PrefixShareWorkload
from ..core.workloads import SSDScanWorkload
from ..core.workloads import SpecDecodeWorkload
from ..core.workloads import get_workload
from .compose import compose_time_sliced
from .fa2 import fa2_spec
from .fa2 import matmul_spec
from .ir import DataflowSpec
from .scenarios import decode_paged_spec
from .scenarios import mlp_chain_spec
from .scenarios import moe_ffn_spec
from .scenarios import prefix_share_spec
from .scenarios import spec_decode_spec
from .scenarios import ssd_scan_spec
from .scenarios import transformer_layer_spec

MB = 2 ** 20

#: the fig-4 policy set plus the DBP-bearing variants the new scenarios
#: exercise (fig-8 style)
SUITE_POLICIES: Tuple[str, ...] = ("lru", "at", "at+bypass", "at+dbp",
                                   "all")


@dataclass
class SuiteCase:
    key: str
    spec: DataflowSpec
    cfg: SimConfig
    gqa: bool = False
    #: scenarios where dead-block prediction must beat plain LRU
    expect_dbp_win: bool = False

    @property
    def fingerprint(self) -> str:
        """Deterministic content hash of this case's spec — the
        registry-level handle into the artifact cache
        (``repro_torch.dataflows.artifacts``)."""
        from .artifacts import spec_fingerprint
        return spec_fingerprint(self.spec)


# ---------------------------------------------------------------------------
# Case builders (lazy: invoked per requested case, not at import / lookup)
# ---------------------------------------------------------------------------
def _fa2_temporal(full: bool, n_cores: int) -> SuiteCase:
    seq = 2048 if full else 1024
    wl = get_workload("gemma3-27b", seq_len=seq)
    return SuiteCase(
        "fa2-temporal", fa2_spec(wl, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=(4 if full else 2) * MB))


def _fa2_spatial(full: bool, n_cores: int) -> SuiteCase:
    seq = 2048 if full else 1024
    wl = get_workload("qwen3-8b", seq_len=seq)
    return SuiteCase(
        "fa2-spatial", fa2_spec(wl, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=(2 if full else 1) * MB),
        gqa=True)


def _matmul(full: bool, n_cores: int) -> SuiteCase:
    dim = 2048 if full else 1024
    return SuiteCase(
        "matmul", matmul_spec(dim, dim, dim, tile=128, n_cores=n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=1 * MB))


def _decode_paged(full: bool, n_cores: int) -> SuiteCase:
    dec = DecodeWorkload(seq_len=4096 if full else 2048)
    return SuiteCase(
        "decode-paged", decode_paged_spec(dec, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=4 * MB),
        expect_dbp_win=True)


def _moe_ffn(full: bool, n_cores: int) -> SuiteCase:
    moe = MoEWorkload(n_steps=12 if full else 8)
    return SuiteCase(
        "moe-ffn", moe_ffn_spec(moe, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=2 * MB),
        expect_dbp_win=True)


def _spec_decode(full: bool, n_cores: int) -> SuiteCase:
    spd = SpecDecodeWorkload(target_len=1024 if full else 512)
    return SuiteCase(
        "spec-decode", spec_decode_spec(spd, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=(8 if full else 4) * MB),
        expect_dbp_win=True)


def _mlp_chain(full: bool, n_cores: int) -> SuiteCase:
    return SuiteCase(
        "mlp-chain",
        mlp_chain_spec(m=2048 if full else 1024, n_cores=n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=1 * MB))


def _transformer_layer(full: bool, n_cores: int) -> SuiteCase:
    seq = 2048 if full else 1024
    wl = AttnWorkload("tl-8h", n_q_heads=8, n_kv_heads=4, head_dim=128,
                      seq_len=seq, group_alloc="temporal")
    return SuiteCase(
        "transformer-layer", transformer_layer_spec(wl, d_ff=1024,
                                                    n_cores=n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=2 * MB))


def _ssd_scan(full: bool, n_cores: int) -> SuiteCase:
    # one state generation is n_seqs × n_heads × P × N = 1.5 MB and
    # head slabs retire incrementally (a read slab dies as the matching
    # new slab is stored), so the live stack peaks at ~1 generation
    # (12288 lines): under a 2 MB LLC the live states fit once the
    # consumed slabs retire, while LRU drags them as MRU dead mass and
    # thrashes — the recurring chunk-cadence DBP win
    ssd = SSDScanWorkload(n_chunks=8 if full else 6)
    return SuiteCase(
        "ssd-scan", ssd_scan_spec(ssd, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=2 * MB),
        expect_dbp_win=True)


def _prefix_share(full: bool, n_cores: int) -> SuiteCase:
    # shared prefix 0.5 MB + 2 MB of private suffixes over a 1 MB LLC:
    # the private streams thrash while the co-streamed prefix is the
    # inter-core reuse blind bypassing would destroy (gqa variant on)
    pfx = PrefixShareWorkload(prefix_len=4096 if full else 2048)
    return SuiteCase(
        "prefix-share", prefix_share_spec(pfx, n_cores),
        SimConfig(n_cores=n_cores, llc_bytes=1 * MB),
        gqa=True)


# --- multi-tenant mixes (DESIGN.md §8.4) -----------------------------------
def _mt_prefill_decode(full: bool, n_cores: int) -> SuiteCase:
    # the classic serving mix: a compute-heavy prefill tenant (FA2 over
    # one attention unit) time-sliced against a decode tenant whose
    # paged KV pollutes the shared LLC as sequences finish — DBP retires
    # the dead pages of *both* tenants' regions, and the prefill
    # tenant's KV reuse must survive the decode tenant's thrash
    seq = 1024 if full else 512
    wl = AttnWorkload("prefill", n_q_heads=16, n_kv_heads=8, head_dim=128,
                      seq_len=seq, group_alloc="temporal")
    dec = DecodeWorkload(seq_len=2048 if full else 1024,
                         n_steps=6, retire_step=3)
    spec = compose_time_sliced(
        [fa2_spec(wl, n_cores), decode_paged_spec(dec, n_cores)],
        quantum_rounds=16, name="mt-prefill-decode")
    return SuiteCase(
        "mt-prefill-decode", spec,
        SimConfig(n_cores=n_cores, llc_bytes=(4 if full else 2) * MB),
        expect_dbp_win=True)


def _mt_spec_ssd(full: bool, n_cores: int) -> SuiteCase:
    # two DBP-heavy epoch structures colliding on one LLC: speculative
    # decoding's per-cycle draft windows and the SSD scan's chunk-state
    # generations retire at *different* cadences, so the dead-mass mix
    # the shared cache carries is never aligned with either tenant's
    # epoch boundary — the recurring pollution pattern per tenant
    spd = SpecDecodeWorkload(target_len=512 if full else 256,
                             draft_len=128, n_verify=3)
    ssd = SSDScanWorkload(n_chunks=6 if full else 5, n_heads=4)
    spec = compose_time_sliced(
        [spec_decode_spec(spd, n_cores), ssd_scan_spec(ssd, n_cores)],
        quantum_rounds=16, name="mt-spec-ssd")
    return SuiteCase(
        "mt-spec-ssd", spec,
        SimConfig(n_cores=n_cores, llc_bytes=2 * MB),
        expect_dbp_win=True)


def _serve_replay(full: bool, n_cores: int) -> SuiteCase:
    # the §VI-F regime end to end: bursty arrivals through the
    # continuous-batching scheduler, so completed requests' KV pages sit
    # dead in the LLC while their slots refill — the at-tier protects
    # live KV against the bypassed Q/O stream and DBP reclaims the dead
    # pages at retirement cadence (at+dbp ≈ 1.25×/1.14× over LRU under
    # a 128 KB LLC that holds roughly the live working set)
    from ..serve.replay import ReplayConfig, replay_spec
    from ..serve.traffic import TrafficConfig
    traffic = TrafficConfig(n_requests=128 if full else 96, seed=7,
                            process="bursty")
    spec, _ = replay_spec(traffic, ReplayConfig(n_cores=n_cores))
    return SuiteCase(
        "serve-replay", spec,
        SimConfig(n_cores=n_cores, llc_bytes=128 * 1024),
        expect_dbp_win=True)


def _serve_replay_pooled(full: bool, n_cores: int) -> SuiteCase:
    # same traffic as serve-replay, but KV pages come from the fixed
    # page pool instead of the monotone bump stream: retired requests'
    # regions are recycled, so `tag[B_BITS-1:0]` tiers stay correlated
    # with liveness at serving scale (the at-tier recovery the pooled
    # allocator exists for — DESIGN.md §13)
    from ..serve.replay import ReplayConfig, replay_spec
    from ..serve.traffic import TrafficConfig
    traffic = TrafficConfig(n_requests=128 if full else 96, seed=7,
                            process="bursty")
    spec, _ = replay_spec(traffic, ReplayConfig(n_cores=n_cores,
                                                allocator="pooled"))
    return SuiteCase(
        "serve-replay-pooled", spec,
        SimConfig(n_cores=n_cores, llc_bytes=128 * 1024),
        expect_dbp_win=True)


#: key → builder thunk, in suite order; ``build_suite`` materializes all
#: of them, ``suite_case`` exactly one
_REGISTRY: Dict[str, Callable[[bool, int], SuiteCase]] = {
    "fa2-temporal": _fa2_temporal,
    "fa2-spatial": _fa2_spatial,
    "matmul": _matmul,
    "decode-paged": _decode_paged,
    "moe-ffn": _moe_ffn,
    "spec-decode": _spec_decode,
    "mlp-chain": _mlp_chain,
    "transformer-layer": _transformer_layer,
    "ssd-scan": _ssd_scan,
    "prefix-share": _prefix_share,
    "mt-prefill-decode": _mt_prefill_decode,
    "mt-spec-ssd": _mt_spec_ssd,
    "serve-replay": _serve_replay,
    "serve-replay-pooled": _serve_replay_pooled,
}


def registry_keys() -> List[str]:
    """Registered scenario keys, in suite order (no spec is built)."""
    return list(_REGISTRY)


def _gated(case: SuiteCase) -> SuiteCase:
    """Registry gate: no case leaves the registry carrying error-tier
    diagnostics (DESIGN.md §12).  Runs against the case's own sim
    config so the layout rules see the geometry the case simulates."""
    from .verify import assert_clean
    assert_clean(case.spec, sim_cfg=case.cfg)
    return case


def build_suite(full: bool = False, n_cores: int = 16) -> List[SuiteCase]:
    """Instantiate the whole suite (reduced grid by default, paper-scale
    shapes with ``full=True``)."""
    return [_gated(build(full, n_cores)) for build in _REGISTRY.values()]


def suite_case(key: str, full: bool = False,
               n_cores: int = 16, *, gate: bool = True) -> SuiteCase:
    """Build exactly one registered case (lazy: no other spec is
    constructed — the CI smoke path).

    ``gate=False`` skips the error-tier verification gate — for the lint
    CLI, which wants the full diagnostic list rather than the first
    error as an exception.
    """
    build = _REGISTRY.get(key)
    if build is None:
        raise KeyError(f"unknown suite scenario {key!r}; have "
                       f"{list(_REGISTRY)}")
    case = build(full, n_cores)
    return _gated(case) if gate else case
