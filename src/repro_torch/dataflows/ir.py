"""Declarative dataflow IR (DESIGN.md §8).

One :class:`DataflowSpec` describes a dataflow at the level the DCO paper
reasons about (§III: "dataflow information available in the software
stack"), and every downstream consumer *derives* its view from that single
description instead of keeping hand-written twins in sync:

* ``lower_to_trace``  → the cycle simulator's :class:`~repro_torch.core.traces.Trace`
* ``lower_to_counts`` → the analytical model's
  :class:`~repro_torch.core.traces.DataflowCounts`
* ``lower_to_plan``   → the TPU orchestrator's
  :class:`~repro_torch.core.orchestrator.OrchestrationPlan` / TMU metadata

The IR has two layers:

**Tensor layer** (fully declarative) — :class:`TensorSpec` records, per
tensor, what the paper's TMU instructions register (size, tile shape,
per-line expected *read* count ``n_acc``, operand id, whole-tensor bypass
hint) plus two placement facts the closed-form counts need and a trace
cannot express directly: the tensor's *liveness epoch range* (which
working-set generation it belongs to — batch index in the multi-batch
§VI-F scenario, retirement wave in decode, expert generation in MoE) and
its *sharer count* (how many cores co-stream it through the LLC —
1 for temporal placement, the group size for spatial placement §VI-C).

**Schedule layer** — per-core lists of :class:`StepSpec` (bulk tile
transfers + flops), one entry per lockstep round of the burst-synchronous
simulation (DESIGN.md §7.2).  Steps reference tensors *by name*; no
addresses exist at this level.  Address assignment happens once, inside
the lowerings, so every backend sees the same layout.

``n_acc`` counts *reads*: the TMU bumps ``accCnt`` on tile-last-line load
accesses only (stores never enter the TLL feed), so a tensor that is
produced and then consumed (e.g. an activation between fused ops) sets
``n_acc`` to its read count and retires when the last consumer has
streamed it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence
from typing import Tuple

from ..core.workloads import AttnWorkload

LINE_BYTES = 128

Access = Tuple[str, int]              # (tensor name, tile index)


@dataclass(frozen=True)
class TensorSpec:
    """One tensor of a dataflow, in TMU-registration form (paper §IV-B)
    plus the placement facts the counts lowering derives reuse from."""

    name: str
    size_bytes: int
    tile_bytes: int
    n_acc: int                  # expected reads of each cache line
    operand_id: int = 0
    bypass: bool = False        # whole-tensor LLC bypass (paper §V-C)
    epoch0: int = 0             # first working-set epoch this tensor is live
    epoch1: int = 0             # last epoch (inclusive)
    sharers: int = 1            # cores co-streaming it through the LLC
    base: Optional[int] = None  # explicit base address (pooled layouts);
    #                             None = the lowering's bump allocator

    def __post_init__(self) -> None:
        if self.size_bytes <= 0 or self.tile_bytes <= 0:
            raise ValueError(f"{self.name}: sizes must be positive")
        if self.size_bytes % self.tile_bytes:
            raise ValueError(
                f"{self.name}: size {self.size_bytes} not a multiple of "
                f"tile {self.tile_bytes}")
        if self.epoch1 < self.epoch0 or self.epoch0 < 0:
            raise ValueError(f"{self.name}: bad epoch range")
        if self.sharers < 1:
            raise ValueError(f"{self.name}: sharers must be >= 1")
        if self.base is not None and (self.base < 0
                                      or self.base % self.tile_bytes):
            raise ValueError(
                f"{self.name}: explicit base 0x{self.base:x} must be "
                f"tile-aligned and non-negative")

    @property
    def num_tiles(self) -> int:
        return self.size_bytes // self.tile_bytes

    @property
    def reuse_carrier(self) -> bool:
        """True for tensors whose lines the LLC can usefully retain (the
        paper's K/V class); bypass tensors are the bursty Q/O class."""
        return not self.bypass


@dataclass(frozen=True)
class StepSpec:
    """One lockstep round on one core: bulk tile transfers + compute."""

    loads: Tuple[Access, ...] = ()
    stores: Tuple[Access, ...] = ()
    flops: float = 0.0


@dataclass
class DataflowSpec:
    """A complete dataflow: tensor layer + per-core round schedule.

    ``tenant_of_tensor`` / ``tenant_names`` / ``tenant_region_align`` are
    set by :func:`~repro_torch.dataflows.compose.compose_time_sliced` on
    multi-tenant composites: every tensor belongs to exactly one tenant,
    tenants occupy disjoint address regions (the shared allocator aligns
    each tenant's first tensor to ``tenant_region_align`` so no TMU
    dead-id tag region straddles two tenants), and all lowerings carry
    the mapping through so simulator counters, profile masses, and plans
    can be attributed per tenant.  ``None`` on ordinary single-tenant
    specs.
    """

    name: str
    tensors: List[TensorSpec]                 # declaration order = layout order
    core_programs: List[List[StepSpec]]
    core_group: List[int]
    core_is_leader: List[bool]
    line_bytes: int = LINE_BYTES
    workload: Optional[AttnWorkload] = None
    tenant_of_tensor: Optional[Dict[str, int]] = None
    tenant_names: Optional[List[str]] = None
    tenant_region_align: int = 0
    #: which address-space policy laid the spec out ("bump" | "pooled");
    #: the verifier conditions its DCO2xx layout rules on this tag
    #: (DESIGN.md §13) — monotone bases are a bump fact, not an IR fact
    allocator: str = "bump"

    @property
    def n_cores(self) -> int:
        return len(self.core_programs)

    @property
    def n_tenants(self) -> int:
        return len(self.tenant_names) if self.tenant_names else 1

    @property
    def n_rounds(self) -> int:
        return max((len(p) for p in self.core_programs), default=0)

    @property
    def n_epochs(self) -> int:
        return 1 + max((t.epoch1 for t in self.tensors), default=0)

    def tensor(self, name: str) -> TensorSpec:
        return self._by_name()[name]

    def _by_name(self) -> Dict[str, TensorSpec]:
        return {t.name: t for t in self.tensors}

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Structural well-formedness: unique names, resolvable references,
        in-range tile indices, consistent core/tenant annotations.

        The checks themselves live in the verifier's rule inventory
        (``repro_torch.dataflows.verify``, codes DCO001–DCO008) so the CLI,
        the gates, and this fail-fast path agree on one rule set; this
        raises on the first structural error, spec name included.
        """
        from .verify import structural_diagnostics
        diags = structural_diagnostics(self)
        if diags:
            d = diags[0]
            more = f" (+{len(diags) - 1} more)" if len(diags) > 1 else ""
            raise ValueError(f"{d.format()}{more}")

    # ------------------------------------------------------------------
    def per_tensor_line_accesses(self) -> Dict[str, Tuple[int, int]]:
        """Closed-form (line_reads, line_writes) per tensor, from tile
        transfer counts × lines-per-tile — no trace expansion, no
        addresses.  The property tests pin these against trace-derived
        totals."""
        reads: Dict[str, int] = {t.name: 0 for t in self.tensors}
        writes: Dict[str, int] = {t.name: 0 for t in self.tensors}
        for prog in self.core_programs:
            for step in prog:
                for tname, _ in step.loads:
                    reads[tname] += 1
                for tname, _ in step.stores:
                    writes[tname] += 1
        out: Dict[str, Tuple[int, int]] = {}
        for t in self.tensors:
            lpt = t.tile_bytes // self.line_bytes
            out[t.name] = (reads[t.name] * lpt, writes[t.name] * lpt)
        return out

    def total_flops(self) -> float:
        return sum(step.flops for prog in self.core_programs
                   for step in prog)


class SpecBuilder:
    """Imperative construction helper for :class:`DataflowSpec`.

    Scenario builders declare tensors (declaration order fixes the address
    layout, like the TMU registration order fixes metadata slots) and emit
    per-core steps; ``build()`` validates and freezes the spec.
    """

    def __init__(self, name: str, n_cores: int,
                 line_bytes: int = LINE_BYTES,
                 workload: Optional[AttnWorkload] = None):
        self.name = name
        self.line_bytes = line_bytes
        self.workload = workload
        self.allocator = "bump"      # layout-policy tag for the built spec
        self._tensors: List[TensorSpec] = []
        self._programs: List[List[StepSpec]] = [[] for _ in range(n_cores)]
        self._core_group = [-1] * n_cores
        self._core_is_leader = [True] * n_cores

    @property
    def n_cores(self) -> int:
        return len(self._programs)

    def tensor(self, name: str, *, size_bytes: int, tile_bytes: int,
               n_acc: int, operand_id: int = 0, bypass: bool = False,
               epoch: int | Tuple[int, int] = 0, sharers: int = 1,
               base: Optional[int] = None) -> str:
        e0, e1 = (epoch, epoch) if isinstance(epoch, int) else epoch
        self._tensors.append(TensorSpec(
            name=name, size_bytes=size_bytes, tile_bytes=tile_bytes,
            n_acc=n_acc, operand_id=operand_id, bypass=bypass,
            epoch0=e0, epoch1=e1, sharers=sharers, base=base))
        return name

    def step(self, core: int, loads: Sequence[Access] = (),
             stores: Sequence[Access] = (), flops: float = 0.0) -> None:
        self._programs[core].append(StepSpec(
            loads=tuple(loads), stores=tuple(stores), flops=flops))

    def pad(self, core: int, n_rounds: int) -> None:
        """Idle rounds keeping ``core`` in lockstep with the others."""
        self._programs[core].extend(StepSpec() for _ in range(n_rounds))

    def pad_to_sync(self) -> None:
        """Barrier: pad every core to the longest program (op boundary)."""
        longest = max((len(p) for p in self._programs), default=0)
        for c in range(self.n_cores):
            self.pad(c, longest - len(self._programs[c]))

    def set_groups(self, core_group: Sequence[int],
                   core_is_leader: Sequence[bool]) -> None:
        self._core_group = list(core_group)
        self._core_is_leader = list(core_is_leader)

    def build(self, verify: bool = True) -> DataflowSpec:
        """Validate, gate, and freeze the spec.

        Beyond the structural ``validate()``, every built spec passes
        the verifier's error tier (annotation-vs-schedule consistency,
        layout invariants — DESIGN.md §12) so no inconsistent spec
        enters a registry or lowering; ``verify=False`` skips the gate
        for callers that deliberately construct defective specs (the
        injection harness goes through ``dataclasses.replace`` instead).
        """
        spec = DataflowSpec(
            name=self.name, tensors=list(self._tensors),
            core_programs=[list(p) for p in self._programs],
            core_group=list(self._core_group),
            core_is_leader=list(self._core_is_leader),
            line_bytes=self.line_bytes, workload=self.workload,
            allocator=self.allocator)
        spec.validate()
        if verify:
            from .verify import assert_clean
            assert_clean(spec)
        return spec
