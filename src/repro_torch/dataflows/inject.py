"""Corruption injection for the static verifier (DESIGN.md §12).

The ground-truth side of the analyzer's contract: for every corruption
class a stale compiler could hand the TMU — wrong ``n_acc``, shifted
epoch ranges, inflated sharer counts, broken base addresses — this
module produces a corrupted twin of a known-good spec together with the
diagnostic code the analyzer *must* raise against it.  The injection
tests assert 100% detection (the expected code fires, located at the
corrupted tensor) and zero regression (the clean spec carries no such
diagnostic at that tensor), which doubles as the labeled-defect
substrate the ROADMAP's learned-predictor item needs.

Spec-level corruptions go through ``dataclasses.replace`` so every
corrupted spec is still structurally valid — the defect is *semantic*,
exactly the class ``DataflowSpec.validate()`` cannot see.  Base-address
corruptions operate on the assigned :class:`~repro_torch.core.tmu.TensorMeta`
layout (specs carry no addresses) and are checked by
:func:`~repro_torch.dataflows.verify.verify_metas`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import random
from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence
from typing import Tuple

from ..core.tmu import TensorMeta
from .ir import DataflowSpec
from .verify import _walk_schedule

#: corruption classes applied to the spec's annotations
SPEC_KINDS: Tuple[str, ...] = ("nacc_under", "nacc_over", "sharers_over",
                               "epoch_shift")
#: corruption classes applied to the assigned address layout
LAYOUT_KINDS: Tuple[str, ...] = ("base_overlap", "base_nonmonotone")

#: corruption class -> the diagnostic code the analyzer must raise
EXPECTED_CODE: Dict[str, str] = {
    "nacc_under": "DCO101",
    "nacc_over": "DCO102",
    "sharers_over": "DCO110",
    "epoch_shift": "DCO120",
    "base_overlap": "DCO210",
    "base_nonmonotone": "DCO211",
}


@dataclass(frozen=True)
class Injection:
    """One applied corruption: where, what, and the code that must fire."""

    kind: str
    tensor: str
    expected_code: str
    description: str


def _replace_tensor(spec: DataflowSpec, name: str,
                    **changes) -> DataflowSpec:
    tensors = [dataclasses.replace(t, **changes) if t.name == name else t
               for t in spec.tensors]
    return dataclasses.replace(spec, tensors=tensors)


def eligible_tensors(spec: DataflowSpec, kind: str,
                     avoid: Sequence[str] = ()) -> List[str]:
    """Tensors on which ``kind`` produces a *guaranteed-detectable*
    corruption (e.g. halving ``n_acc=1`` changes nothing; a tensor that
    overlaps nobody in time cannot exhibit an epoch conflict)."""
    facts = _walk_schedule(spec)
    avoid_set = set(avoid)
    out: List[str] = []
    if kind in LAYOUT_KINDS:
        # any non-first tensor (base_overlap additionally needs a
        # predecessor wider than one line to slide into while keeping
        # bases ascending)
        return [t.name for i, t in enumerate(spec.tensors)
                if i > 0 and t.name not in avoid_set
                and (kind != "base_overlap"
                     or spec.tensors[i - 1].size_bytes
                     > spec.line_bytes)]
    for t in spec.tensors:
        if t.name in avoid_set:
            continue
        if kind == "nacc_under":
            if t.bypass or t.name not in facts.loaded:
                continue
            m = min(facts.loads.get((t.name, k), 0) or 10 ** 9
                    for k in range(t.num_tiles))
            if m >= 2 and t.n_acc >= 2:
                out.append(t.name)
        elif kind == "nacc_over":
            if not t.bypass and t.name in facts.loaded:
                out.append(t.name)
        elif kind == "sharers_over":
            if t.name in facts.cores:
                out.append(t.name)
        elif kind == "epoch_shift":
            f = facts.first_round.get(t.name)
            if f is None:
                continue
            last = facts.last_round[t.name]
            if any(o.name != t.name
                   and facts.first_round.get(o.name) is not None
                   and facts.first_round[o.name] <= last
                   and facts.last_round[o.name] >= f
                   for o in spec.tensors):
                out.append(t.name)
        else:
            raise KeyError(f"unknown corruption kind {kind!r}")
    return out


def inject_spec(spec: DataflowSpec, kind: str, rng: random.Random,
                avoid: Sequence[str] = (),
                ) -> Optional[Tuple[DataflowSpec, Injection]]:
    """Apply one spec-level corruption of class ``kind`` to a randomly
    chosen eligible tensor (``None`` if the spec offers no eligible
    target).  ``avoid`` excludes tensors already carrying the expected
    code in the clean run, so detection is attributable."""
    if kind not in SPEC_KINDS:
        raise KeyError(f"not a spec-level corruption kind: {kind!r}")
    names = eligible_tensors(spec, kind, avoid)
    if not names:
        return None
    name = rng.choice(names)
    t = spec.tensor(name)
    facts = _walk_schedule(spec)
    if kind == "nacc_under":
        m = min(facts.loads.get((name, k), 0) or 10 ** 9
                for k in range(t.num_tiles))
        new = max(1, m // 2)
        corrupted = _replace_tensor(spec, name, n_acc=new)
        desc = f"n_acc {t.n_acc} -> {new} (tiles read >= {m} times)"
    elif kind == "nacc_over":
        peak = max(facts.loads.get((name, k), 0)
                   for k in range(t.num_tiles))
        new = peak + 3
        corrupted = _replace_tensor(spec, name, n_acc=new)
        desc = f"n_acc {t.n_acc} -> {new} (tiles read <= {peak} times)"
    elif kind == "sharers_over":
        seen = len(facts.cores[name])
        new = seen + 1
        corrupted = _replace_tensor(spec, name, sharers=new)
        desc = f"sharers {t.sharers} -> {new} ({seen} cores observed)"
    else:  # epoch_shift
        horizon = 1 + max(x.epoch1 for x in spec.tensors)
        corrupted = _replace_tensor(spec, name, epoch0=horizon,
                                    epoch1=horizon)
        desc = (f"epochs [{t.epoch0},{t.epoch1}] -> "
                f"[{horizon},{horizon}] (stale generation tag)")
    return corrupted, Injection(kind=kind, tensor=name,
                                expected_code=EXPECTED_CODE[kind],
                                description=desc)


def inject_layout(spec: DataflowSpec, metas: Sequence[TensorMeta],
                  kind: str, rng: random.Random,
                  ) -> Tuple[List[TensorMeta], Injection]:
    """Apply one base-address corruption to an assigned layout.

    ``base_overlap`` slides a tensor's base back inside its
    predecessor's region while keeping bases ascending (isolates
    DCO210); ``base_nonmonotone`` rewinds a base below its predecessor
    (the invariant ``EventSink.register_tensors`` and the stream
    emitters' recycling rest on — DCO211)."""
    if kind not in LAYOUT_KINDS:
        raise KeyError(f"not a layout corruption kind: {kind!r}")
    names = eligible_tensors(spec, kind)
    if not names:
        raise ValueError(f"{spec.name}: no eligible tensor for {kind}")
    name = rng.choice(names)
    idx = [t.name for t in spec.tensors].index(name)
    out = list(metas)
    prev = metas[idx - 1]
    if kind == "base_overlap":
        new_base = max(prev.base_addr + spec.line_bytes,
                       prev.base_addr + prev.size_bytes
                       - spec.line_bytes)
        desc = (f"base 0x{metas[idx].base_addr:x} -> 0x{new_base:x} "
                f"(inside {prev.tensor_id}'s region)")
    else:
        new_base = prev.base_addr
        desc = (f"base 0x{metas[idx].base_addr:x} -> 0x{new_base:x} "
                f"(= predecessor base; monotone bump broken)")
    out[idx] = dataclasses.replace(metas[idx], base_addr=new_base)
    return out, Injection(kind=kind, tensor=name,
                          expected_code=EXPECTED_CODE[kind],
                          description=desc)
