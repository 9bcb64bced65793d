"""Static verifier over the dataflow IR (DESIGN.md §12).

Every DCO policy decision — dead-block prediction, bypass,
anti-thrashing tiers — trusts the annotations the compiler hands the TMU
(``n_acc``, epoch ranges, sharer counts, bypass hints) and the address
layout the lowerings derive.  Nothing on the simulation path verifies
either: a stale ``n_acc`` silently becomes a premature retirement, and a
bump allocator that mints fresh addresses forever silently aliases
``tag[B_BITS-1:0]`` priority tiers across tensor generations (the
at+dbp decay, 1.25× → 0.67×).

This module is the missing check: :func:`verify_spec` walks a
:class:`~repro_torch.dataflows.ir.DataflowSpec` once and emits structured
:class:`Diagnostic` records — stable ``DCOxxx`` codes, severity
error/warn/info, tensor/core/round location — instead of asserts.  The
rule inventory (:data:`RULES`) is the single place an assumption is
written down next to the lowering or policy that consumes it.

Severity calibration is empirical: a rule is error-tier only if every
registered suite scenario satisfies it exactly (so a violation is a real
defect, not a modeling choice).  The registry's measured behaviour:

* per-tile load counts equal ``n_acc`` exactly on every scenario —
  ``DCO101``/``DCO102`` are errors;
* declared ``sharers`` legitimately *understate* cross-core touches
  (temporal-reuse accounting on matmul/mlp-chain/…) — only the
  over-declared direction (``DCO110``) is an error, the forfeited
  same-round merge is an info lint (``DCO303``);
* tensors with disjoint epoch ranges legitimately overlap in time under
  continuous batching (serve-replay waves) — ``DCO120`` is a warning;
* tier/dead-id aliasing across generations is *present* in the registry
  (spec-decode, mt-spec-ssd, serve-replay — the tier-decay exhibit) —
  ``DCO201``/``DCO202`` are warnings that document it.

Three consumers: ``SpecBuilder.build()`` / ``suite_case()`` gate the
error tier on every spec entering the registry (:func:`assert_clean`),
:class:`StreamVerifier` is the opt-in online mode for the streaming
replay (``run_replay(..., verify=True)``), and ``scripts/spec_lint.py``
sweeps the registry from the command line.  :func:`cross_check_case`
closes the loop against ground truth: the analyzer's predicted TMU
retirement counts must match the simulator's measured ``RETIRE`` events.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from dataclasses import field
from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence
from typing import TYPE_CHECKING
from typing import Tuple

from ..core.tmu import TMUParams
from ..core.tmu import TensorMeta
from .ir import DataflowSpec

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (suite -> verify)
    from .stream import ReplaySegment
    from .suite import SuiteCase

ERROR = "error"
WARN = "warn"
INFO = "info"

_SEV_ORDER = {ERROR: 0, WARN: 1, INFO: 2}

#: runaway guard on per-rule diagnostics per spec — high enough that
#: every per-tensor diagnostic of the registry (and any injected one)
#: survives; rendering layers summarize, the result stays complete
MAX_DIAGS_PER_RULE = 4096


@dataclass(frozen=True)
class Rule:
    """One entry of the rule inventory: the assumption a code checks and
    the lowering/policy that consumes the assumption (DESIGN.md §12)."""

    code: str
    severity: str
    title: str
    assumption: str
    consumer: str
    #: which address-space strategies the rule applies to: "any", or a
    #: specific allocator name ("bump" for the monotone-base invariant —
    #: a recycling allocator legitimately re-issues lower addresses)
    allocator: str = "any"


#: the rule inventory — single source of truth for codes, severities, and
#: the assumption → consumer mapping (rendered by ``spec_lint.py --rules``
#: and documented in DESIGN.md §12)
RULES: Dict[str, Rule] = {r.code: r for r in [
    # -- DCO0xx: structural well-formedness (folded from the historical
    #    DataflowSpec.validate asserts; validate() now raises on these) --
    Rule("DCO001", ERROR, "duplicate tensor names",
         "tensor names are unique (name = identity for schedule refs)",
         "every lowering; TMU metadata slots"),
    Rule("DCO002", ERROR, "core annotation length mismatch",
         "core_group/core_is_leader cover every core program",
         "lower_to_trace; gqa bypass grouping"),
    Rule("DCO003", ERROR, "unknown tensor reference",
         "schedule steps reference declared tensors only",
         "every lowering"),
    Rule("DCO004", ERROR, "tile index out of range",
         "every (tensor, tile) access lies inside the tensor",
         "lower_to_trace; TMU tile table"),
    Rule("DCO005", ERROR, "invalid tenant mapping",
         "tenant map covers every tensor with a valid tenant id",
         "per-tenant attribution (simulator counters, profile masses)"),
    Rule("DCO006", ERROR, "tenant declarations not contiguous",
         "each tenant is one contiguous run of the declaration order",
         "shared allocator region map; tenant_region_starts"),
    Rule("DCO007", ERROR, "non-positive n_acc",
         "n_acc >= 1 (the TMU retires at accCnt >= nAcc; 0 retires on "
         "first touch)",
         "TMU retirement; reuse-profile dead/live split"),
    Rule("DCO008", ERROR, "tile not a multiple of the line size",
         "every cache line belongs to exactly one tile",
         "TLL tile-last-line resolution; dead-id tag math"),
    # -- DCO1xx: annotation consistency vs the schedule ------------------
    Rule("DCO101", ERROR, "n_acc understated",
         "declared n_acc >= actual per-tile read count (else the tile "
         "retires while readers remain: guaranteed dead-block mispredict)",
         "TMU retirement -> DBP dead-FIFO; reuse-profile dead split"),
    Rule("DCO102", ERROR, "n_acc overstated",
         "some loaded tile reaches the declared n_acc (else no tile "
         "ever retires: dead lines are never predicted dead)",
         "TMU retirement -> DBP; analytical dead-mass terms"),
    Rule("DCO104", WARN, "n_acc overstated on boundary tiles",
         "per-tensor n_acc matches the per-tile read count everywhere; "
         "a shortfall on a strict subset (e.g. the causal-mask boundary) "
         "is conservative — those tiles never retire, but nothing "
         "retires early",
         "DBP coverage (unretired boundary tiles stay LRU-managed)"),
    Rule("DCO103", INFO, "store-only tensor",
         "a written-never-read tensor has no TLL feed, so n_acc is "
         "unverifiable and its lines leave the LLC only by eviction",
         "TMU (no retirement); write-back dirty-lifetime model"),
    Rule("DCO110", ERROR, "sharers exceed observed cores",
         "declared sharers <= cores that ever touch the tensor (the "
         "counts lowering credits inter-core reuse that cannot occur)",
         "lower_to_counts inter-core split; profile sharer transform"),
    Rule("DCO120", WARN, "epoch-disjoint tensors concurrently live",
         "tensors with disjoint epoch ranges are not accessed in "
         "overlapping round windows (epoch = the liveness generation "
         "the capacity model stacks)",
         "lower_to_counts s_active; analytical live-stack peak"),
    # -- DCO2xx: layout hazards ------------------------------------------
    Rule("DCO201", WARN, "dead-id region mixes epoch generations",
         "no tag[D_MSB:D_LSB] dead-id region spans tensors of different "
         "epoch ranges (a retirement in one generation marks another "
         "generation's lines dead)",
         "DBP dead-FIFO is_dead match"),
    Rule("DCO202", WARN, "priority-tier aliasing across generations",
         "tag[B_BITS-1:0] tiers keep their liveness correlation: "
         "disjoint-epoch tensors do not reuse the same tier values "
         "(the bump-allocator at+dbp decay)",
         "anti-thrashing tier protection (at)"),
    Rule("DCO210", ERROR, "tensor address regions overlap",
         "assigned [base, end) ranges are disjoint among concurrently-"
         "live tensors (a recycling allocator may reuse a range only "
         "after its previous owner's last access)",
         "every address-level consumer; event attribution"),
    Rule("DCO211", ERROR, "base addresses not monotone",
         "declaration order = ascending base order (bump allocation)",
         "EventSink.register_tensors; StreamEmitter recycling",
         allocator="bump"),
    Rule("DCO212", ERROR, "tenant region misaligned",
         "each tenant's first tensor is aligned to tenant_region_align "
         "so no dead-id tag region straddles two tenants",
         "per-tenant event attribution; dead-id isolation (§8.4)"),
    # -- DCO3xx: policy-contradiction lints ------------------------------
    Rule("DCO301", WARN, "bypass tensor with derived reuse",
         "bypass-hinted tensors are single-touch streams (re-reads or "
         "same-round co-streams through DRAM forfeit LLC reuse)",
         "bypass policy (§V-C); gqa_bypass sharing protection"),
    Rule("DCO302", WARN, "shared tensor declared single-read",
         "n_acc == 1 with sharers > 1 is contradictory: the first "
         "sharer's read retires the tile before the others stream it",
         "TMU retirement vs counts-lowering inter-core reuse"),
    Rule("DCO303", INFO, "same-round co-stream wider than sharers",
         "declared sharers cover the same-round co-stream width (an "
         "understated count forfeits MSHR-merge credit in the model)",
         "lower_to_counts inter-core split; MSHR merge accounting"),
]}

#: codes whose violation invalidates the spec (gate tier for
#: SpecBuilder.build / suite_case / compose)
ERROR_CODES: Tuple[str, ...] = tuple(
    code for code, r in RULES.items() if r.severity == ERROR)


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a severity, a location, a message."""

    code: str
    severity: str
    spec: str
    message: str
    tensor: Optional[str] = None
    core: Optional[int] = None
    round: Optional[int] = None

    def format(self) -> str:
        loc = [self.spec]
        if self.tensor is not None:
            loc.append(self.tensor)
        if self.core is not None:
            loc.append(f"core {self.core}")
        if self.round is not None:
            loc.append(f"round {self.round}")
        return (f"{self.code} [{self.severity}] "
                f"{'/'.join(str(x) for x in loc)}: {self.message}")

    def to_dict(self) -> Dict[str, object]:
        return {"code": self.code, "severity": self.severity,
                "spec": self.spec, "tensor": self.tensor,
                "core": self.core, "round": self.round,
                "message": self.message}


@dataclass
class VerifyResult:
    """All diagnostics of one verification pass, error tier first."""

    spec_name: str
    diagnostics: List[Diagnostic] = field(default_factory=list)
    #: uncapped per-rule fire counts (``diagnostics`` stores at most
    #: MAX_DIAGS_PER_RULE per code; gates that compare counts across
    #: allocators — the replay-scale DCO202 check — need the real total)
    rule_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARN]

    @property
    def has_errors(self) -> bool:
        return any(d.severity == ERROR for d in self.diagnostics)

    def codes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    def count(self, code: str) -> int:
        """Uncapped fire count for ``code`` (falls back to the stored-
        diagnostic tally when the pass predates the counter)."""
        if code in self.rule_counts:
            return self.rule_counts[code]
        return sum(1 for d in self.diagnostics if d.code == code)

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def located(self, code: str, tensor: str) -> bool:
        """True if ``code`` fired at ``tensor`` (the injection-detection
        predicate: a corruption is caught when its expected code appears
        at the corrupted tensor)."""
        return any(d.code == code and d.tensor == tensor
                   for d in self.diagnostics)

    def sort(self) -> None:
        self.diagnostics.sort(
            key=lambda d: (_SEV_ORDER[d.severity], d.code,
                           d.tensor or "", d.round or -1))

    def summary(self) -> str:
        n_e = len(self.errors)
        n_w = len(self.warnings)
        n_i = len(self.diagnostics) - n_e - n_w
        codes = ",".join(f"{c}x{n}" for c, n in sorted(self.codes().items()))
        return (f"{self.spec_name}: {n_e} error(s), {n_w} warning(s), "
                f"{n_i} info ({codes or 'clean'})")

    def to_dict(self) -> Dict[str, object]:
        return {"spec": self.spec_name,
                "counts": {"error": len(self.errors),
                           "warn": len(self.warnings),
                           "info": (len(self.diagnostics)
                                    - len(self.errors)
                                    - len(self.warnings))},
                "codes": self.codes(),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}


class SpecVerifyError(ValueError):
    """Raised by :func:`assert_clean` when error-tier rules fire; carries
    the full :class:`VerifyResult` for callers that want the details."""

    def __init__(self, result: VerifyResult):
        self.result = result
        errs = result.errors
        head = "; ".join(d.format() for d in errs[:3])
        more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
        super().__init__(
            f"spec {result.spec_name!r} failed verification with "
            f"{len(errs)} error(s): {head}{more}")


class _Emitter:
    """Per-rule capped diagnostic collector."""

    def __init__(self, spec_name: str):
        self.spec_name = spec_name
        self.diags: List[Diagnostic] = []
        self._per_rule: Dict[str, int] = defaultdict(int)

    def emit(self, code: str, message: str, *, tensor: Optional[str] = None,
             core: Optional[int] = None,
             round: Optional[int] = None) -> None:
        n = self._per_rule[code]
        self._per_rule[code] = n + 1
        if n >= MAX_DIAGS_PER_RULE:
            return
        if n == MAX_DIAGS_PER_RULE - 1:
            message += f" [further {code} diagnostics suppressed]"
        self.diags.append(Diagnostic(
            code=code, severity=RULES[code].severity, spec=self.spec_name,
            message=message, tensor=tensor, core=core, round=round))


# ---------------------------------------------------------------------------
# schedule-derived facts (one walk, shared by the rule families)
# ---------------------------------------------------------------------------
@dataclass
class _ScheduleFacts:
    loads: Dict[Tuple[str, int], int]           # (tensor, tile) -> reads
    first_round: Dict[str, int]
    last_round: Dict[str, int]
    cores: Dict[str, set]
    co_width: Dict[str, int]        # max cores loading one tile same round
    loaded: set
    stored: set


def _walk_schedule(spec: DataflowSpec) -> _ScheduleFacts:
    loads: Dict[Tuple[str, int], int] = defaultdict(int)
    first: Dict[str, int] = {}
    last: Dict[str, int] = {}
    cores: Dict[str, set] = defaultdict(set)
    co_width: Dict[str, int] = defaultdict(int)
    loaded: set = set()
    stored: set = set()
    round_cores: Dict[Tuple[int, str, int], set] = defaultdict(set)
    for c, prog in enumerate(spec.core_programs):
        for r, step in enumerate(prog):
            for name, tile in step.loads:
                loads[(name, tile)] += 1
                loaded.add(name)
                round_cores[(r, name, tile)].add(c)
                if name not in first:
                    first[name] = r
                first[name] = min(first[name], r)
                last[name] = max(last.get(name, r), r)
                cores[name].add(c)
            for name, tile in step.stores:
                stored.add(name)
                if name not in first:
                    first[name] = r
                first[name] = min(first[name], r)
                last[name] = max(last.get(name, r), r)
                cores[name].add(c)
    for (_, name, _), cs in round_cores.items():
        co_width[name] = max(co_width[name], len(cs))
    return _ScheduleFacts(loads=dict(loads), first_round=first,
                          last_round=last, cores=dict(cores),
                          co_width=dict(co_width), loaded=loaded,
                          stored=stored)


# ---------------------------------------------------------------------------
# rule families
# ---------------------------------------------------------------------------
def structural_diagnostics(spec: DataflowSpec) -> List[Diagnostic]:
    """DCO001–DCO008 — the one rule inventory behind
    ``DataflowSpec.validate()`` (which raises on the first of these)."""
    em = _Emitter(spec.name)
    names = [t.name for t in spec.tensors]
    dup = sorted({n for n in names if names.count(n) > 1})
    if dup:
        em.emit("DCO001", f"duplicate tensor names {dup}")
    if not (len(spec.core_group) == len(spec.core_is_leader)
            == spec.n_cores):
        em.emit("DCO002", "core annotation length mismatch")
    by = {t.name: t for t in spec.tensors}
    for c, prog in enumerate(spec.core_programs):
        for r, step in enumerate(prog):
            for name, tile in (*step.loads, *step.stores):
                t = by.get(name)
                if t is None:
                    em.emit("DCO003",
                            f"references unknown tensor {name!r}",
                            core=c, round=r)
                elif not (0 <= tile < t.num_tiles):
                    em.emit("DCO004",
                            f"tile {tile} out of range for {name!r} "
                            f"({t.num_tiles} tiles)",
                            tensor=name, core=c, round=r)
    if spec.tenant_of_tensor is not None:
        if spec.tenant_names is None:
            em.emit("DCO005", "tenant map without tenant names")
        else:
            n_t = len(spec.tenant_names)
            runs: List[int] = []
            for t in spec.tensors:
                tid = spec.tenant_of_tensor.get(t.name)
                if tid is None or not (0 <= tid < n_t):
                    em.emit("DCO005",
                            "no valid tenant assignment", tensor=t.name)
                    continue
                if not runs or runs[-1] != tid:
                    runs.append(tid)
            if len(runs) != len(set(runs)):
                em.emit("DCO006",
                        f"tenant declarations must be contiguous "
                        f"(tenant-major tensor order), got run "
                        f"sequence {runs}")
    for t in spec.tensors:
        if t.n_acc < 1:
            em.emit("DCO007", f"n_acc={t.n_acc} (must be >= 1)",
                    tensor=t.name)
        if t.tile_bytes % spec.line_bytes:
            em.emit("DCO008",
                    f"tile_bytes={t.tile_bytes} not a multiple of "
                    f"line_bytes={spec.line_bytes}", tensor=t.name)
    return em.diags


def _annotation_rules(spec: DataflowSpec, facts: _ScheduleFacts,
                      em: _Emitter, errors_only: bool) -> None:
    for t in spec.tensors:
        if t.bypass or t.name not in facts.loaded:
            if (not errors_only and not t.bypass
                    and t.name in facts.stored
                    and t.name not in facts.loaded):
                em.emit("DCO103",
                        f"written but never read (n_acc={t.n_acc} "
                        f"unverifiable; lines retire only by eviction)",
                        tensor=t.name)
            continue
        # n_acc vs per-tile read counts (only tiles the schedule reads;
        # a partially-read tensor reports per-tile, capped)
        under = over = exact = 0
        worst: Optional[Tuple[int, int]] = None
        for tile in range(t.num_tiles):
            n = facts.loads.get((t.name, tile), 0)
            if n == 0:
                continue
            if n > t.n_acc:
                under += 1
                if worst is None or n > worst[1]:
                    worst = (tile, n)
            elif n < t.n_acc:
                over += 1
                if worst is None or n < worst[1]:
                    worst = (tile, n)
            else:
                exact += 1
        if under:
            em.emit("DCO101",
                    f"n_acc={t.n_acc} understated: {under} tile(s) read "
                    f"more often (e.g. tile {worst[0]}: {worst[1]} reads) "
                    f"— tiles retire while readers remain",
                    tensor=t.name)
        elif over and not exact:
            # unsatisfiable anywhere: the tensor can never retire
            em.emit("DCO102",
                    f"n_acc={t.n_acc} overstated: {over} tile(s) read "
                    f"fewer times (e.g. tile {worst[0]}: {worst[1]} reads)"
                    f" — tiles never retire, dead lines never predicted",
                    tensor=t.name)
        elif over:
            # conservative boundary shortfall (e.g. a causal mask's last
            # tile): nothing retires early, so not gate-worthy
            em.emit("DCO104",
                    f"n_acc={t.n_acc} reached by {exact} tile(s) but "
                    f"{over} boundary tile(s) fall short (e.g. tile "
                    f"{worst[0]}: {worst[1]} reads): those never retire",
                    tensor=t.name)
    for t in spec.tensors:
        seen = len(facts.cores.get(t.name, ()))
        if seen and t.sharers > seen:
            em.emit("DCO110",
                    f"sharers={t.sharers} but only {seen} core(s) ever "
                    f"touch the tensor", tensor=t.name)
        if errors_only:
            continue
        width = facts.co_width.get(t.name, 0)
        if not t.bypass and width > t.sharers:
            em.emit("DCO303",
                    f"co-streamed by {width} cores in one round but "
                    f"sharers={t.sharers}: inter-core (MSHR-merge) reuse "
                    f"is forfeited in the counts lowering",
                    tensor=t.name)
        if not t.bypass and t.n_acc == 1 and t.sharers > 1:
            em.emit("DCO302",
                    f"n_acc=1 with sharers={t.sharers}: the first "
                    f"sharer's read retires the tile", tensor=t.name)
        if t.bypass:
            n_tiles_multi = sum(
                1 for tile in range(t.num_tiles)
                if facts.loads.get((t.name, tile), 0) > 1)
            if n_tiles_multi:
                em.emit("DCO301",
                        f"bypass-hinted but {n_tiles_multi} tile(s) are "
                        f"read more than once: temporal reuse goes to "
                        f"DRAM", tensor=t.name)
            elif width > 1:
                em.emit("DCO301",
                        f"bypass-hinted but co-streamed by {width} cores "
                        f"in one round: the shared stream pays DRAM per "
                        f"core (the gqa_bypass hazard, §IV-E)",
                        tensor=t.name)


def _epoch_rules(spec: DataflowSpec, facts: _ScheduleFacts,
                 em: _Emitter) -> None:
    """DCO120: pairwise liveness of epoch-disjoint tensors (warn — the
    continuous-batching waves of serve-replay legitimately overlap)."""
    rows = [(t, facts.first_round.get(t.name), facts.last_round.get(t.name))
            for t in spec.tensors]
    rows = [(t, f, last) for t, f, last in rows if f is not None]
    # sweep in first-round order; only tensors whose windows overlap can
    # conflict, so the inner loop stops at the first non-overlapping start
    rows.sort(key=lambda x: x[1])
    per_tensor: Dict[str, Tuple[int, str]] = {}
    for i, (ti, fi, li) in enumerate(rows):
        for tj, fj, lj in rows[i + 1:]:
            if fj > li:
                break
            if ti.epoch1 < tj.epoch0 or tj.epoch1 < ti.epoch0:
                for a, b in ((ti, tj), (tj, ti)):
                    n, ex = per_tensor.get(a.name, (0, b.name))
                    per_tensor[a.name] = (n + 1, ex)
    for t in spec.tensors:
        hit = per_tensor.get(t.name)
        if hit:
            n, ex = hit
            em.emit("DCO120",
                    f"epochs [{t.epoch0},{t.epoch1}] declared disjoint "
                    f"from {n} tensor(s) it is concurrently live with "
                    f"(e.g. {ex!r}): the capacity model retires it early",
                    tensor=t.name,
                    round=facts.last_round.get(t.name))


def _layout_rules(spec: DataflowSpec, metas: Sequence[TensorMeta],
                  em: _Emitter, errors_only: bool, num_sets: int,
                  params: TMUParams,
                  facts: Optional[_ScheduleFacts] = None) -> None:
    if spec.allocator != "bump":
        # recycling allocator: declaration order no longer implies
        # address order and ranges may legitimately recur across
        # generations — the layout tier switches to liveness-window
        # semantics (DCO211 does not apply at all)
        _meta_rules_pooled(spec, metas, em, facts)
        if not errors_only:
            _generation_rules_pooled(spec, metas, em, num_sets, params)
        return
    _meta_rules(spec, metas, em)
    if errors_only:
        return
    # -- generation aliasing (DCO201/DCO202): tag-space collisions
    #    between tensors of different / disjoint epoch generations ------
    line = spec.line_bytes
    infos = []
    for m, t in zip(metas, spec.tensors):
        if t.bypass:
            continue
        tag0 = (m.base_addr // line) // num_sets
        tag1 = ((m.base_addr + m.size_bytes - 1) // line) // num_sets
        infos.append((t, tag0, tag1))
    # dead-id regions: granularity 2**d_lsb tags; region id wraps at the
    # dead-id width, so two generations collide when region ids match
    dead_regions: Dict[int, set] = defaultdict(set)
    region_names: Dict[int, List[str]] = defaultdict(list)
    for t, tag0, tag1 in infos:
        r0 = params.dead_id(tag0)
        span = (tag1 >> params.d_lsb) - (tag0 >> params.d_lsb)
        width = params.d_msb - params.d_lsb + 1
        for k in range(min(span + 1, 1 << width)):
            rid = (r0 + k) & ((1 << width) - 1)
            dead_regions[rid].add((t.epoch0, t.epoch1))
            if len(region_names[rid]) < 4:
                region_names[rid].append(t.name)
    mixed = {rid for rid, gens in dead_regions.items() if len(gens) > 1}
    flagged: set = set()
    for rid in sorted(mixed):
        for name in region_names[rid]:
            if name in flagged:
                continue
            flagged.add(name)
            others = [n for n in region_names[rid] if n != name]
            em.emit("DCO201",
                    f"dead-id region {rid} spans epoch generations "
                    f"{sorted(dead_regions[rid])} (with {others}): a "
                    f"retirement in one generation marks the other's "
                    f"lines dead", tensor=name)
    # priority tiers: tag[B_BITS-1:0]; flag each tensor that shares a
    # tier value with a disjoint-epoch tensor (the tier-decay signature)
    n_tiers = 1 << params.b_bits
    tier_sets = []
    for t, tag0, tag1 in infos:
        if tag1 - tag0 + 1 >= n_tiers:
            tiers = (1 << n_tiers) - 1
        else:
            tiers = 0
            for tag in range(tag0, tag1 + 1):
                tiers |= 1 << (tag & (n_tiers - 1))
        tier_sets.append((t, tiers))
    reported: Dict[str, Tuple[int, str]] = {}
    for i, (ti, si) in enumerate(tier_sets):
        for tj, sj in tier_sets[i + 1:]:
            if not (si & sj):
                continue
            if ti.epoch1 < tj.epoch0 or tj.epoch1 < ti.epoch0:
                for a, b in ((ti, tj), (tj, ti)):
                    n, ex = reported.get(a.name, (0, b.name))
                    reported[a.name] = (n + 1, ex)
    for t in spec.tensors:
        hit = reported.get(t.name)
        if hit:
            n, ex = hit
            em.emit("DCO202",
                    f"tag[{params.b_bits - 1}:0] tier values recur in "
                    f"{n} disjoint-epoch tensor(s) (e.g. {ex!r}): the "
                    f"at tier protection decays across generations "
                    f"(epochs [{t.epoch0},{t.epoch1}])",
                    tensor=t.name)


def _meta_rules(spec: DataflowSpec, metas: Sequence[TensorMeta],
                em: _Emitter) -> None:
    """DCO210/DCO211/DCO212 — pure layout facts, reusable against any
    meta list (the streaming emitters replicate the allocator)."""
    names = [t.name for t in spec.tensors]
    prev_base = None
    prev_name = None
    max_end = None
    max_name = None
    for m, name in zip(metas, names):
        if prev_base is not None:
            if m.base_addr <= prev_base:
                em.emit("DCO211",
                        f"base 0x{m.base_addr:x} not above predecessor "
                        f"{prev_name!r} (0x{prev_base:x}): breaks the "
                        f"bump-allocation invariant EventSink."
                        f"register_tensors and the stream emitters "
                        f"assume", tensor=name)
            if m.base_addr < max_end:
                em.emit("DCO210",
                        f"[0x{m.base_addr:x}, 0x"
                        f"{m.base_addr + m.size_bytes:x}) overlaps "
                        f"{max_name!r} ending at 0x{max_end:x}",
                        tensor=name)
        prev_base, prev_name = m.base_addr, name
        end = m.base_addr + m.size_bytes
        if max_end is None or end > max_end:
            max_end, max_name = end, name
    _tenant_align_rules(spec, metas, em)


def _tenant_align_rules(spec: DataflowSpec, metas: Sequence[TensorMeta],
                        em: _Emitter) -> None:
    """DCO212 — allocator-independent tenant-boundary alignment."""
    if spec.tenant_of_tensor is not None and spec.tenant_region_align:
        align = spec.tenant_region_align
        prev_tenant = None
        for m, t in zip(metas, spec.tensors):
            tenant = spec.tenant_of_tensor.get(t.name)
            if tenant != prev_tenant and m.base_addr % align:
                em.emit("DCO212",
                        f"tenant {tenant} region starts at "
                        f"0x{m.base_addr:x}, not {align}-byte aligned: "
                        f"a dead-id tag region straddles two tenants",
                        tensor=t.name)
            prev_tenant = tenant


def _meta_rules_pooled(spec: DataflowSpec, metas: Sequence[TensorMeta],
                       em: _Emitter,
                       facts: Optional[_ScheduleFacts]) -> None:
    """DCO210/DCO212 under a recycling allocator.

    Two tensors may occupy the same ``[base, end)`` range when the
    region was recycled between generations; the hazard is overlap
    while both are *live*, so the check intersects address ranges with
    schedule round windows.  Tensors the schedule never touches have no
    window and cannot conflict."""
    fr = facts.first_round if facts is not None else {}
    lr = facts.last_round if facts is not None else {}
    rows = []
    for m, t in zip(metas, spec.tensors):
        f = fr.get(t.name)
        if f is None:
            continue
        rows.append((m.base_addr, m.base_addr + m.size_bytes,
                     f, lr[t.name], t.name))
    rows.sort()
    for i, (b0, e0, f0, l0, n0) in enumerate(rows):
        for b1, e1, f1, l1, n1 in rows[i + 1:]:
            if b1 >= e0:
                break              # base-sorted: nothing later overlaps
            if not (l0 < f1 or l1 < f0):
                em.emit("DCO210",
                        f"[0x{b1:x}, 0x{e1:x}) overlaps {n0!r} "
                        f"([0x{b0:x}, 0x{e0:x})) while both are live "
                        f"(rounds [{f1},{l1}] vs [{f0},{l0}]): the "
                        f"allocator recycled a region before its "
                        f"previous owner's last access", tensor=n1,
                        round=max(f0, f1))
    _tenant_align_rules(spec, metas, em)


def _generation_rules_pooled(spec: DataflowSpec,
                             metas: Sequence[TensorMeta], em: _Emitter,
                             num_sets: int, params: TMUParams) -> None:
    """DCO201/DCO202 as *pool-coverage* metrics under recycling.

    With address reuse, a tier (or dead-id) collision is a fresh
    aliasing event only when a tensor claims a previously-unused tag
    block whose tier / dead-id value is already taken — a recycled
    block inherits its own history rather than aliasing someone else's.
    Once the pool's tag blocks are all warmed up no tensor can fire
    again, so both counts are bounded by the pool footprint and stay
    flat in request count.  A bump layout fails this signature: fresh
    addresses forever mean fresh tag blocks forever, and the counts
    grow with every retired generation (the bump-allocator at+dbp decay) — the
    gap is the replay gate's acceptance metric."""
    line = spec.line_bytes
    n_tiers = 1 << params.b_bits
    width = params.d_msb - params.d_lsb + 1
    used_tags: set = set()
    used_tiers: set = set()
    used_rids: set = set()
    for m, t in zip(metas, spec.tensors):
        if t.bypass:
            continue
        tag0 = (m.base_addr // line) // num_sets
        tag1 = ((m.base_addr + m.size_bytes - 1) // line) // num_sets
        new_tags = [tag for tag in range(tag0, tag1 + 1)
                    if tag not in used_tags]
        if not new_tags:
            continue
        new_tiers = {tag & (n_tiers - 1) for tag in new_tags}
        new_rids = {(tag >> params.d_lsb) & ((1 << width) - 1)
                    for tag in new_tags}
        rid_hits = sorted(new_rids & used_rids)
        if rid_hits:
            em.emit("DCO201",
                    f"claims {len(new_tags)} fresh tag block(s) whose "
                    f"dead-id value(s) {rid_hits[:4]} are already in "
                    f"use: a retirement there marks another "
                    f"generation's lines dead", tensor=t.name)
        tier_hits = sorted(new_tiers & used_tiers)
        if tier_hits:
            em.emit("DCO202",
                    f"claims fresh tag block(s) on already-used "
                    f"tag[{params.b_bits - 1}:0] tier value(s) "
                    f"{tier_hits}: at tier protection dilutes as the "
                    f"address footprint grows", tensor=t.name)
        used_tags.update(new_tags)
        used_tiers |= new_tiers
        used_rids |= new_rids


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _num_sets(llc_bytes: int, line_bytes: int, assoc: int) -> int:
    return max(1, (llc_bytes // line_bytes) // assoc)


def verify_spec(spec: DataflowSpec, *, sim_cfg=None,
                params: Optional[TMUParams] = None,
                errors_only: bool = False) -> VerifyResult:
    """Run the rule inventory over one spec.

    ``sim_cfg`` supplies the cache geometry the tag-space rules
    (DCO201/DCO202) are evaluated under — pass the suite case's
    ``SimConfig`` to lint the layout against the geometry it actually
    runs on (defaults to the stock geometry).  ``errors_only`` restricts
    to the gate tier (the cheap path ``SpecBuilder.build`` runs).
    """
    params = params or TMUParams()
    res = VerifyResult(spec.name)
    res.diagnostics.extend(structural_diagnostics(spec))
    if res.has_errors:
        # the schedule walk / layout need a structurally sound spec
        res.sort()
        return res
    from .lower import assign_addresses
    if sim_cfg is None:
        num_sets = _num_sets(4 * 2 ** 20, spec.line_bytes, 8)
    else:
        num_sets = _num_sets(sim_cfg.llc_bytes, sim_cfg.line_bytes,
                             sim_cfg.llc_assoc)
    facts = _walk_schedule(spec)
    em = _Emitter(spec.name)
    _annotation_rules(spec, facts, em, errors_only)
    if not errors_only:
        _epoch_rules(spec, facts, em)
    metas = list(assign_addresses(spec).values())
    _layout_rules(spec, metas, em, errors_only, num_sets, params,
                  facts=facts)
    res.diagnostics.extend(em.diags)
    for code, n in em._per_rule.items():
        res.rule_counts[code] = res.rule_counts.get(code, 0) + n
    res.sort()
    return res


def verify_metas(spec: DataflowSpec, metas: Sequence[TensorMeta],
                 ) -> VerifyResult:
    """Layout-only verification of an explicit meta list (the injection
    harness corrupts base addresses at this level; the spec only carries
    names/tenants for location and alignment context)."""
    em = _Emitter(spec.name)
    _meta_rules(spec, metas, em)
    res = VerifyResult(spec.name, em.diags)
    res.sort()
    return res


def assert_clean(spec: DataflowSpec, *, sim_cfg=None) -> None:
    """Gate: raise :class:`SpecVerifyError` if any error-tier rule fires
    (annotation-vs-schedule consistency plus layout invariants — the
    structural tier is already covered by ``spec.validate()``)."""
    res = verify_spec(spec, sim_cfg=sim_cfg, errors_only=True)
    if res.has_errors:
        raise SpecVerifyError(res)


# ---------------------------------------------------------------------------
# online (streaming) mode
# ---------------------------------------------------------------------------
class StreamVerifier:
    """Opt-in online verification of emitted :class:`ReplaySegment`
    windows (``run_replay(..., verify=True)``).

    The streaming path has no monolithic spec, so the verifier rebuilds
    the analyzer's facts incrementally: bases must ascend and stay
    disjoint (DCO210/DCO211) as tensors are declared, per-tile TLL read
    counts are accumulated from each window's compiled feed, and at
    ``clear`` time the observed counts are checked against the declared
    ``n_acc`` (DCO101/DCO102).  Generation aliasing (DCO202) is tracked
    as tier values of *new* tensors colliding with tiers of already
    *retired* ones — the bump allocator's tier decay, observed live.

    ``allocator="pooled"`` switches the layout tier to the recycling
    semantics of :func:`_meta_rules_pooled` / :func:`
    _generation_rules_pooled`, evaluated incrementally: DCO210 checks
    each declaration against the *live* region set (a region retiring
    in the same window is a legitimate hand-off, mirroring ``EventSink.
    register_tensors``), DCO211 does not apply, and DCO201/DCO202 fire
    only when a declaration claims previously-unused tag blocks on
    already-used dead-id / tier values.  Declaration order equals the
    monolithic spec's, so the streamed counts match ``verify_spec`` on
    the same replay.
    """

    def __init__(self, name: str, *, line_bytes: int = 128, sim_cfg=None,
                 params: Optional[TMUParams] = None,
                 allocator: str = "bump"):
        self.params = params or TMUParams()
        self.line_bytes = line_bytes
        self.allocator = allocator
        if sim_cfg is None:
            self.num_sets = _num_sets(4 * 2 ** 20, line_bytes, 8)
        else:
            self.num_sets = _num_sets(sim_cfg.llc_bytes,
                                      sim_cfg.line_bytes,
                                      sim_cfg.llc_assoc)
        self._em = _Emitter(name)
        self._prev_base: Optional[int] = None
        self._prev_end: Optional[int] = None
        self._prev_tid: Optional[int] = None
        self._meta: Dict[int, TensorMeta] = {}
        self._tier_bits: Dict[int, int] = {}
        self._retired_tiers = 0
        self._counts: Dict[Tuple[int, int], int] = defaultdict(int)
        # pooled-mode state: live [base, end) per tid + pool coverage
        self._live_regions: Dict[int, Tuple[int, int]] = {}
        self._used_tags: set = set()
        self._used_tiers: set = set()
        self._used_rids: set = set()
        self.segments = 0

    def _tag_range(self, meta: TensorMeta) -> Tuple[int, int]:
        tag0 = (meta.base_addr // self.line_bytes) // self.num_sets
        tag1 = ((meta.base_addr + meta.size_bytes - 1)
                // self.line_bytes) // self.num_sets
        return tag0, tag1

    def _tiers_of(self, meta: TensorMeta) -> int:
        n_tiers = 1 << self.params.b_bits
        tag0, tag1 = self._tag_range(meta)
        if tag1 - tag0 + 1 >= n_tiers:
            return (1 << n_tiers) - 1
        bits = 0
        for tag in range(tag0, tag1 + 1):
            bits |= 1 << (tag & (n_tiers - 1))
        return bits

    def _on_declared_bump(self, meta: TensorMeta, name: str) -> None:
        em = self._em
        if self._prev_base is not None:
            if meta.base_addr <= self._prev_base:
                em.emit("DCO211",
                        f"base 0x{meta.base_addr:x} not above "
                        f"predecessor t{self._prev_tid} "
                        f"(0x{self._prev_base:x})", tensor=name)
            if meta.base_addr < self._prev_end:
                em.emit("DCO210",
                        f"[0x{meta.base_addr:x}, ...) overlaps "
                        f"t{self._prev_tid} ending at "
                        f"0x{self._prev_end:x}", tensor=name)
        self._prev_base = meta.base_addr
        self._prev_end = meta.base_addr + meta.size_bytes
        self._prev_tid = meta.tensor_id
        if not meta.bypass_all:
            tiers = self._tiers_of(meta)
            self._tier_bits[meta.tensor_id] = tiers
            if tiers & self._retired_tiers:
                em.emit("DCO202",
                        f"tier values recur from already-retired "
                        f"generations (bump allocation never reuses "
                        f"addresses, so tag[{self.params.b_bits - 1}"
                        f":0] wrapped)", tensor=name)

    def _on_declared_pooled(self, meta: TensorMeta, name: str,
                            retiring: set) -> None:
        em = self._em
        tid = meta.tensor_id
        base, end = meta.base_addr, meta.base_addr + meta.size_bytes
        for lt, (ls, le) in self._live_regions.items():
            if lt == tid or lt in retiring:
                continue
            if base < le and ls < end:
                em.emit("DCO210",
                        f"[0x{base:x}, 0x{end:x}) overlaps the live "
                        f"region [0x{ls:x}, 0x{le:x}) of t{lt}: the "
                        f"allocator recycled a region still in use",
                        tensor=name)
                break
        self._live_regions[tid] = (base, end)
        if meta.bypass_all:
            return
        p = self.params
        n_tiers = 1 << p.b_bits
        width = p.d_msb - p.d_lsb + 1
        tag0, tag1 = self._tag_range(meta)
        new_tags = [tag for tag in range(tag0, tag1 + 1)
                    if tag not in self._used_tags]
        if not new_tags:
            return
        new_tiers = {tag & (n_tiers - 1) for tag in new_tags}
        new_rids = {(tag >> p.d_lsb) & ((1 << width) - 1)
                    for tag in new_tags}
        rid_hits = sorted(new_rids & self._used_rids)
        if rid_hits:
            em.emit("DCO201",
                    f"claims {len(new_tags)} fresh tag block(s) whose "
                    f"dead-id value(s) {rid_hits[:4]} are already in "
                    f"use: a retirement there marks another "
                    f"generation's lines dead", tensor=name)
        tier_hits = sorted(new_tiers & self._used_tiers)
        if tier_hits:
            em.emit("DCO202",
                    f"claims fresh tag block(s) on already-used "
                    f"tag[{p.b_bits - 1}:0] tier value(s) "
                    f"{tier_hits}: at tier protection dilutes as the "
                    f"address footprint grows", tensor=name)
        self._used_tags.update(new_tags)
        self._used_tiers |= new_tiers
        self._used_rids |= new_rids

    def on_segment(self, seg: "ReplaySegment") -> None:
        em = self._em
        pooled = self.allocator != "bump"
        retiring = set(seg.clear_tids) if pooled else ()
        for meta in seg.new_tensors:
            tid = meta.tensor_id
            name = f"t{tid}"
            if pooled:
                self._on_declared_pooled(meta, name, retiring)
            else:
                self._on_declared_bump(meta, name)
            self._meta[tid] = meta
        ct = seg.ct
        for tid, tile in zip(ct.tll_tids.tolist(), ct.tll_tiles.tolist()):
            self._counts[(tid, tile)] += 1
        for tid in seg.clear_tids:
            self._live_regions.pop(tid, None)
            meta = self._meta.pop(tid, None)
            if meta is None or meta.bypass_all:
                continue
            self._retired_tiers |= self._tier_bits.pop(tid, 0)
            n_tiles = meta.size_bytes // meta.tile_bytes
            under = over = exact = 0
            for tile in range(n_tiles):
                n = self._counts.pop((tid, tile), 0)
                if n > meta.n_acc:
                    under += 1
                elif n == meta.n_acc:
                    exact += 1
                elif n > 0:
                    over += 1
            if under:
                em.emit("DCO101",
                        f"n_acc={meta.n_acc} understated: {under} "
                        f"tile(s) read more often before clear",
                        tensor=f"t{tid}")
            if over and not exact:
                em.emit("DCO102",
                        f"n_acc={meta.n_acc} overstated: {over} tile(s) "
                        f"cleared before reaching it (never retired)",
                        tensor=f"t{tid}")
            elif over:
                em.emit("DCO104",
                        f"n_acc={meta.n_acc} reached by {exact} tile(s) "
                        f"but {over} cleared short of it (never retired)",
                        tensor=f"t{tid}")
        self.segments += 1

    def finish(self) -> VerifyResult:
        res = VerifyResult(self._em.spec_name, list(self._em.diags),
                          rule_counts=dict(self._em._per_rule))
        res.sort()
        return res


# ---------------------------------------------------------------------------
# ground-truth cross-check (analyzer verdicts vs simulator-measured TMU)
# ---------------------------------------------------------------------------
def predicted_retirements(spec: DataflowSpec) -> Dict[str, int]:
    """The analyzer's retirement prediction per tensor: the TMU bumps one
    accCnt per TLL feed entry (one per load of a non-bypass tile, not
    MSHR-merged) and retires each time the counter reaches ``n_acc``
    (counter pops and re-accumulates), so a tile retires
    ``floor(reads / n_acc)`` times."""
    facts = _walk_schedule(spec)
    out: Dict[str, int] = {}
    for t in spec.tensors:
        if t.bypass:
            continue
        total = 0
        for tile in range(t.num_tiles):
            total += facts.loads.get((t.name, tile), 0) // t.n_acc
        out[t.name] = total
    return out


def predicted_excess_retirements(spec: DataflowSpec) -> int:
    """Tiles retiring more than once = the measurable premature-
    retirement signal an understated ``n_acc`` produces (a clean spec
    predicts zero: every read tile retires exactly once, at its last
    read)."""
    facts = _walk_schedule(spec)
    total = 0
    for t in spec.tensors:
        if t.bypass:
            continue
        for tile in range(t.num_tiles):
            total += max(0, facts.loads.get((t.name, tile), 0)
                         // t.n_acc - 1)
    return total


def cross_check_case(case: "SuiteCase",
                     policies: Sequence[str] = ("lru", "dbp", "at+dbp"),
                     ) -> Dict[str, object]:
    """Run one suite case with events on and compare measured truth to
    the analyzer's verdicts.

    Checks, per policy: total TMU ``RETIRE`` events == the analyzer's
    predicted retirement count; per-tensor retirement counts match; and
    (spec predicted clean) measured excess retirements (a tile retiring
    more than once) == 0.  Retirements are policy-independent (the TLL
    feed is derived from the trace), so agreement across the policy set
    also pins that invariance.
    """
    import numpy as np

    from ..core.events import EV_RETIRE
    from ..core.events import EventSink
    from ..core.policies import named_policy
    from ..core.simulator import Simulator

    from .lower import lower_to_trace

    spec = case.spec
    predicted = predicted_retirements(spec)
    predicted_total = sum(predicted.values())
    predicted_excess = predicted_excess_retirements(spec)
    verdict = verify_spec(spec, sim_cfg=case.cfg)
    predicted_clean = not any(
        d.code in ("DCO101", "DCO102") for d in verdict.diagnostics)
    trace = lower_to_trace(spec)
    name_of = {i: t.name for i, t in enumerate(spec.tensors)}
    rows: List[Dict[str, object]] = []
    agree = True
    for pol in policies:
        sink = EventSink()
        sim = Simulator(case.cfg, named_policy(pol, gqa=case.gqa))
        sim.run(trace, record_history=False, events=sink)
        mat = sink.matrix()
        ret = mat[mat[:, 6] == EV_RETIRE]
        measured_total = int(ret.shape[0])
        measured: Dict[str, int] = {}
        excess = 0
        if measured_total:
            pair = ret[:, 3] * (2 ** 32) + ret[:, 7]
            _, tile_counts = np.unique(pair, return_counts=True)
            excess = int(np.maximum(tile_counts - 1, 0).sum())
            tids, counts = np.unique(ret[:, 3], return_counts=True)
            measured = {name_of[int(t)]: int(c)
                        for t, c in zip(tids, counts)}
        mismatches = sorted(
            n for n in set(predicted) | set(measured)
            if predicted.get(n, 0) != measured.get(n, 0))
        ok = (measured_total == predicted_total and not mismatches
              and (excess == 0 if predicted_clean
                   else excess == predicted_excess))
        agree &= ok
        rows.append({"policy": pol, "ok": ok,
                     "measured_retirements": measured_total,
                     "measured_excess": excess,
                     "per_tensor_mismatches": mismatches[:8]})
    return {"scenario": case.key, "agree": agree,
            "predicted_retirements": predicted_total,
            "predicted_excess": predicted_excess,
            "predicted_clean": predicted_clean,
            "policies": rows}


def rules_inventory() -> List[Dict[str, str]]:
    """The rule table as plain dicts (CLI/report rendering)."""
    return [{"code": r.code, "severity": r.severity, "title": r.title,
             "assumption": r.assumption, "consumer": r.consumer,
             "allocator": r.allocator}
            for r in RULES.values()]
