"""Multi-tenant composition of dataflow specs (DESIGN.md §8.4).

The paper's shared system-level cache is a *multi-core, multi-workload*
resource (§IV-D/E exist because heterogeneous dataflows contend for one
LLC), yet a single :class:`~repro_torch.dataflows.ir.DataflowSpec` describes
one dataflow in isolation.  :func:`compose_time_sliced` builds the
serving-system view: N tenant specs time-sliced onto the same cores in
round-robin quanta, sharing one LLC.

The composite is itself a valid ``DataflowSpec``, so **all four
lowerings work unchanged** — the simulator trace executes the true
interleaving, ``lower_to_reuse_profile`` measures the *interleaved*
stack distances (tenant A's reuse window now contains tenant B's
traffic), the counts see the union working set, and the orchestrator
plans the union tensor set.  What composition adds on top:

* **tensor namespacing** — tenant ``i``'s tensors are renamed
  ``t{i}.<name>`` and declared tenant-major, so each tenant occupies one
  contiguous run of the shared address layout;
* **region alignment** — each tenant's block starts at a multiple of
  ``region_align_bytes`` (default 16 MB).  The TMU's dead-tile
  identifier is a ``tag``-domain slice (``tag[D_MSB:D_LSB]``, §IV-B)
  whose region granularity is ``num_sets · line_bytes · 2^D_LSB``;
  aligning tenant bases beyond that guarantees no dead-id region (and
  no ``tag[B_BITS-1:0]`` priority tier) ever straddles two tenants — a
  retirement in one tenant can never mark another tenant's lines dead;
* **tenant metadata** — ``tenant_of_tensor`` / ``tenant_names`` ride on
  the spec and are threaded through every lowering, so the simulator
  attributes hits/misses/write-backs per tenant region and the
  analytical model exposes per-tenant breakdowns (and can run one gear
  feedback loop per tenant, the per-slice mode).
"""

from __future__ import annotations

from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence

from .ir import DataflowSpec
from .ir import StepSpec
from .ir import TensorSpec

#: default tenant-region alignment: covers the dead-id tag granularity
#: (num_sets · line_bytes · 2^D_LSB) for every geometry the suite sweeps
#: (up to 128 MB LLCs at 128-byte lines, assoc 8, D_LSB 0) and is a
#: multiple of the 2^B_BITS tier period, so each tenant's tier layout
#: starts at tier 0 exactly like its stand-alone spec.
REGION_ALIGN_BYTES = 1 << 24


def compose_time_sliced(tenants: Sequence[DataflowSpec],
                        quantum_rounds: int = 8,
                        name: Optional[str] = None,
                        region_align_bytes: int = REGION_ALIGN_BYTES,
                        ) -> DataflowSpec:
    """Interleave ``tenants`` round-robin onto one set of cores.

    The composite schedule takes ``quantum_rounds`` lockstep rounds from
    tenant 0, then ``quantum_rounds`` from tenant 1, … cycling until
    every tenant's schedule is exhausted (a tenant that finishes early
    simply drops out of the rotation — no idle quanta are inserted).
    Tenants narrower than the widest one leave the extra cores idle
    during their quanta.

    Core sharing-group annotations survive only when every tenant
    declares the identical layout (they are per-core *static* facts and
    the composite runs different tenants on the same core over time);
    otherwise the composite resets to ungrouped all-leader cores —
    compose gqa-dependent tenants only with matching group layouts.
    """
    if not tenants:
        raise ValueError("compose_time_sliced needs at least one tenant")
    if quantum_rounds < 1:
        raise ValueError("quantum_rounds must be >= 1")
    line_bytes = tenants[0].line_bytes
    if any(t.line_bytes != line_bytes for t in tenants):
        raise ValueError("tenants disagree on line_bytes")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        names = [f"{t.name}#{i}" for i, t in enumerate(tenants)]

    n_cores = max(t.n_cores for t in tenants)

    # --- tensor layer: tenant-major, namespaced --------------------------
    tensors: List[TensorSpec] = []
    tenant_of: Dict[str, int] = {}
    rename: List[Dict[str, str]] = []
    for i, sp in enumerate(tenants):
        m: Dict[str, str] = {}
        for t in sp.tensors:
            new = f"t{i}.{t.name}"
            m[t.name] = new
            tenant_of[new] = i
            tensors.append(TensorSpec(
                name=new, size_bytes=t.size_bytes, tile_bytes=t.tile_bytes,
                n_acc=t.n_acc, operand_id=t.operand_id, bypass=t.bypass,
                epoch0=t.epoch0, epoch1=t.epoch1, sharers=t.sharers))
        rename.append(m)

    # --- schedule layer: round-robin quanta ------------------------------
    def renamed(step: StepSpec, m: Dict[str, str]) -> StepSpec:
        return StepSpec(
            loads=tuple((m[n], tile) for n, tile in step.loads),
            stores=tuple((m[n], tile) for n, tile in step.stores),
            flops=step.flops)

    programs: List[List[StepSpec]] = [[] for _ in range(n_cores)]
    cursor = [0] * len(tenants)          # next round to take per tenant
    active = list(range(len(tenants)))
    while active:
        still: List[int] = []
        for i in active:
            sp = tenants[i]
            r0 = cursor[i]
            r1 = min(r0 + quantum_rounds, sp.n_rounds)
            cursor[i] = r1
            for r in range(r0, r1):
                for c in range(n_cores):
                    prog = sp.core_programs[c] if c < sp.n_cores else ()
                    programs[c].append(
                        renamed(prog[r], rename[i]) if r < len(prog)
                        else StepSpec())
            if r1 < sp.n_rounds:
                still.append(i)
        active = still

    # --- core annotations: only a unanimous layout survives ---------------
    def padded_groups(sp: DataflowSpec):
        pad = n_cores - sp.n_cores
        return (list(sp.core_group) + [-1] * pad,
                list(sp.core_is_leader) + [True] * pad)

    g0, l0 = padded_groups(tenants[0])
    if all(padded_groups(sp) == (g0, l0) for sp in tenants[1:]):
        core_group, core_is_leader = g0, l0
    else:
        core_group = [-1] * n_cores
        core_is_leader = [True] * n_cores

    spec = DataflowSpec(
        name=name or ("mt-" + "+".join(names)),
        tensors=tensors,
        core_programs=programs,
        core_group=core_group,
        core_is_leader=core_is_leader,
        line_bytes=line_bytes,
        tenant_of_tensor=tenant_of,
        tenant_names=names,
        tenant_region_align=region_align_bytes,
    )
    spec.validate()
    # composite specs feed registries/replay directly (no SpecBuilder on
    # this path), so run the same error-tier gate build() applies
    from .verify import assert_clean
    assert_clean(spec)
    return spec


def tenant_regions(spec: DataflowSpec) -> List[tuple]:
    """Per-tenant ``(name, base_addr, end_addr)`` of the shared layout —
    the address regions the simulator attributes counters by.  Regions
    are disjoint and each base is ``tenant_region_align``-aligned
    (round-trip pinned by tests)."""
    from .lower import assign_addresses

    if spec.tenant_of_tensor is None or spec.tenant_names is None:
        raise ValueError(f"{spec.name}: not a multi-tenant composite")
    metas = assign_addresses(spec)
    lo = [None] * len(spec.tenant_names)
    hi = [None] * len(spec.tenant_names)
    for tid, t in enumerate(spec.tensors):
        ten = spec.tenant_of_tensor[t.name]
        m = metas[tid]
        lo[ten] = m.base_addr if lo[ten] is None else min(lo[ten],
                                                          m.base_addr)
        hi[ten] = m.end_addr if hi[ten] is None else max(hi[ten],
                                                         m.end_addr)
    return [(n, lo[i], hi[i]) for i, n in enumerate(spec.tenant_names)]
