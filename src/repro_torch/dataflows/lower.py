"""Lowerings from the dataflow IR to the three backends (DESIGN.md §8.2).

All three consumers of dataflow knowledge — the trace-driven simulator,
the cache-integrated analytical model (§V), and the TPU-side orchestrator
— derive their inputs here from one :class:`~repro_torch.dataflows.ir.DataflowSpec`.
Address assignment is shared: every lowering sees the same layout —
explicit per-tensor bases when an :mod:`~repro_torch.dataflows.addr` allocator
already laid the spec out (the pooled replay path), otherwise the default
tile-aligned bump allocation in declaration order — so the simulator's
TMU metadata, the model's line counts, and the orchestrator's plan all
describe the same physical tensors.
"""

from __future__ import annotations

from typing import Dict
from typing import List

from ..core.orchestrator import CacheOrchestrator
from ..core.orchestrator import OrchestrationPlan
from ..core.tmu import TensorMeta
from ..core.traces import DataflowCounts
from ..core.traces import Step
from ..core.traces import Trace
from .addr import BumpAllocator
from .ir import DataflowSpec


def assign_addresses(spec: DataflowSpec) -> Dict[int, TensorMeta]:
    """Lay the spec's tensors out in physical address space.

    Declaration order is allocation order and the tensor id is the
    declaration index — the single source of truth for the layout every
    lowering (and the TMU) observes.  On a multi-tenant composite
    (``spec.tenant_of_tensor``) each tenant's first tensor is aligned to
    ``spec.tenant_region_align``, so tenants occupy disjoint address
    regions and no TMU dead-id tag region straddles two tenants
    (DESIGN.md §8.4).

    Tensors may instead carry *explicit* bases (``TensorSpec.base``, set
    by an emitter that already ran an :class:`~repro_torch.dataflows.addr`
    allocator — the pooled replay path): all-or-nothing per spec, and
    the bases are used verbatim so every lowering reproduces the
    emitter's layout.  Specs without explicit bases go through the
    default :class:`~repro_torch.dataflows.addr.BumpAllocator`, bit-identical
    to the historical in-lowering bump allocator.
    """
    n_explicit = sum(1 for t in spec.tensors if t.base is not None)
    if n_explicit and n_explicit != len(spec.tensors):
        raise ValueError(
            f"{spec.name}: explicit tensor bases are all-or-nothing "
            f"({n_explicit}/{len(spec.tensors)} set)")
    metas: Dict[int, TensorMeta] = {}
    if n_explicit:
        for tid, t in enumerate(spec.tensors):
            metas[tid] = TensorMeta(
                tensor_id=tid, base_addr=t.base, size_bytes=t.size_bytes,
                tile_bytes=t.tile_bytes, n_acc=t.n_acc,
                operand_id=t.operand_id, bypass_all=t.bypass)
        return metas
    alloc = BumpAllocator()
    tenant_of = spec.tenant_of_tensor
    region_align = spec.tenant_region_align
    prev_tenant = None
    for tid, t in enumerate(spec.tensors):
        align = t.tile_bytes
        if tenant_of is not None and region_align:
            tenant = tenant_of[t.name]
            if tenant != prev_tenant:
                align = max(align, region_align)
            prev_tenant = tenant
        region = alloc.alloc(t.size_bytes, t.tile_bytes, align=align)
        metas[tid] = TensorMeta(
            tensor_id=tid, base_addr=region.base, size_bytes=t.size_bytes,
            tile_bytes=t.tile_bytes, n_acc=t.n_acc,
            operand_id=t.operand_id, bypass_all=t.bypass)
    return metas


def tmu_metadata(spec: DataflowSpec) -> List[TensorMeta]:
    """The spec's tensors as TMU registration records (paper §IV-B)."""
    return list(assign_addresses(spec).values())


# ---------------------------------------------------------------------------
def lower_to_trace(spec: DataflowSpec) -> Trace:
    """Expand the spec's round schedule into a simulator :class:`Trace`."""
    metas = assign_addresses(spec)
    tid_of = {t.name: i for i, t in enumerate(spec.tensors)}
    core_steps: List[List[Step]] = []
    for prog in spec.core_programs:
        steps: List[Step] = []
        for s in prog:
            steps.append(Step(
                loads=[(tid_of[n], tile) for n, tile in s.loads],
                stores=[(tid_of[n], tile) for n, tile in s.stores],
                flops=s.flops))
        core_steps.append(steps)
    tenant_of = None
    if spec.tenant_of_tensor is not None:
        tenant_of = {tid_of[n]: ten
                     for n, ten in spec.tenant_of_tensor.items()}
    from .artifacts import artifacts_enabled, try_spec_fingerprint
    return Trace(name=spec.name, tensors=metas, core_steps=core_steps,
                 core_group=list(spec.core_group),
                 core_is_leader=list(spec.core_is_leader),
                 line_bytes=spec.line_bytes, workload=spec.workload,
                 tenant_of_tensor=tenant_of,
                 tenant_names=(list(spec.tenant_names)
                               if spec.tenant_names else None),
                 fingerprint=(try_spec_fingerprint(spec)
                              if artifacts_enabled() else None))


# ---------------------------------------------------------------------------
def lower_to_counts(spec: DataflowSpec,
                    with_profile: bool = True) -> DataflowCounts:
    """Derive the analytical model's request counts (§V, Eq. 1–3) from the
    spec — closed-form per tensor (tile transfer counts × lines per tile,
    placement annotations for sharing), no trace expansion and no
    addresses.

    Class assignment follows §V-B/§V-C: non-bypass tensors are the
    reuse-carrier (K/V) class — their first line touches are cold misses
    and repeat touches split into temporal and inter-core reuse via the
    declared ``sharers`` — while ``bypass`` tensors are the bursty
    always-DRAM (Q/O) class.

    ``with_profile`` (default) also runs the reuse-distance lowering
    (DESIGN.md §5) and attaches the resulting
    :class:`~repro_torch.dataflows.reuse.ReuseProfile` so the analytical
    model's default ``model="profile"`` path has its input; pass
    ``False`` to skip the schedule walk when only the scalar counts are
    needed (e.g. very long-context closed-form sweeps).
    """
    per_tensor = spec.per_tensor_line_accesses()
    n_kv_accesses = 0.0
    n_kv_distinct = 0
    n_bypass = 0
    intercore = 0.0
    for t in spec.tensors:
        reads, writes = per_tensor[t.name]
        acc = reads + writes
        if t.bypass:
            n_bypass += acc
            continue
        n_kv_accesses += acc
        n_kv_distinct += t.size_bytes // spec.line_bytes
        if t.sharers > 1:
            intercore += acc * (t.sharers - 1) / t.sharers

    live_bytes = [0] * spec.n_epochs
    for t in spec.tensors:
        if t.bypass:
            continue
        for e in range(t.epoch0, t.epoch1 + 1):
            live_bytes[e] += t.size_bytes
    s_active = max(live_bytes) if live_bytes else 0
    s_total = live_bytes[0] if live_bytes else 0

    profile = None
    if with_profile:
        from . import artifacts
        from .reuse import lower_to_reuse_profile
        fp = (artifacts.try_spec_fingerprint(spec)
              if artifacts.artifacts_enabled() else None)
        if fp is not None:
            profile = artifacts.load_reuse_profile(fp)
        if profile is None:
            profile = lower_to_reuse_profile(spec)
            if fp is not None:
                artifacts.store_reuse_profile(fp, profile)

    return DataflowCounts(
        name=spec.name, line_bytes=spec.line_bytes,
        n_kv_accesses=int(round(n_kv_accesses)),
        n_kv_distinct=int(n_kv_distinct),
        n_bypass_lines=int(n_bypass),
        n_intercore_reuse=int(round(intercore)),
        s_work_active=int(s_active),
        s_work_total=int(s_total),
        flops_total=float(spec.total_flops()),
        n_batches=spec.n_epochs,
        n_rounds=int(spec.n_rounds),
        reuse_profile=profile,
    )


# ---------------------------------------------------------------------------
def lower_to_plan(spec: DataflowSpec, vmem_budget_bytes: int, *,
                  b_bits: int = 3,
                  reserve_fraction: float = 1.0 / 8.0) -> OrchestrationPlan:
    """Plan VMEM residency for the spec's tensors (DESIGN.md §3).

    Registers the shared address layout with a
    :class:`~repro_torch.core.orchestrator.CacheOrchestrator` and runs the
    S_kept planner — the compile-time transfer of the paper's
    anti-thrashing + bypass gear selection.
    """
    orch = CacheOrchestrator(vmem_budget_bytes, b_bits=b_bits,
                             reserve_fraction=reserve_fraction)
    orch.register_many(tmu_metadata(spec))
    return orch.plan()
