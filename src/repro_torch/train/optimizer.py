"""AdamW written out on trees of tensors (not ``torch.optim``), as the JAX
package's ``train/optimizer.py``.

Moments are fp32 whatever the parameters' type; bf16 parameters are updated
as ``(p.float() - lr * delta).to(p.dtype)`` with no master copy, as the
reference does.  The step count and the learning rate live on the host.

**The update is in place**: ``adamw_update`` writes the new parameters and
moments into the tensors it is given and returns them, where the reference
returns new arrays; at llama3.2-3b's size a second set of fp32 moments would
be another 28.9 GB.  It also walks each leaf in slices of at most
``SLICE_ELEMENTS`` along its leading axis (a stacked leaf's layers), so that
the fp32 temporaries of a stacked MLP leaf (704 M elements, 2.8 GB each)
stay small; the arithmetic is elementwise, so slicing changes no number.

Under a bound mesh the parameters and gradients are this rank's shards
(``train/sharding_rules.py``), the gradients already summed over the
data-parallel ranks, and ``specs`` gives each leaf's parameter and moment
specs.  ZeRO-1: a leaf whose moments ``opt_logical_axes`` shard on the
leading (stacked layer) axis over ``data`` keeps only this data rank's slice
of its moments; the rank updates that slice of the parameter, and the slices
are then all-gathered.  ``global_norm`` counts each model-sharded leaf's
shards once each and each replicated leaf once.
"""

from __future__ import annotations

from dataclasses import dataclass
import math
from typing import Any
from typing import Dict
from typing import Iterator
from typing import NamedTuple
from typing import Tuple

import torch

from ..sharding import comm
from ..sharding.api import spec_axes
from ..sharding.state import axes_leaves
from ..tree import leaves
from ..tree import tree_map

SLICE_ELEMENTS = 1 << 25   # elements of a leaf updated at a time, at most


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Any                 # fp32, the parameters' tree
    v: Any
    step: torch.Tensor     # int32 scalar on the host


def init_opt_state(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio, in fp32 on the host."""
    step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of ``ts`` (tensors of one shape), each at most
    ``SLICE_ELEMENTS`` elements where the leading axis allows."""
    t0 = ts[0]
    if t0.dim() == 0 or t0.numel() <= SLICE_ELEMENTS:
        yield ts
        return
    rows = max(1, SLICE_ELEMENTS // (t0.numel() // t0.shape[0]))
    for i in range(0, t0.shape[0], rows):
        yield tuple(t[i:i + rows] for t in ts)


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.float())) for (s,) in _slices(g))


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.  With
    ``specs`` (the parameters' spec tree, under a bound mesh) the leaves
    sharded over the model axis are summed over its ranks, and the others,
    whole on every rank, counted once."""
    if specs is None:
        return torch.sqrt(torch.sum(torch.stack([_sum_sq(g) for g in leaves(tree)])))
    sums = torch.zeros(2, dtype=torch.float32, device=leaves(tree)[0].device)
    for g, spec in zip(leaves(tree), axes_leaves(specs)):
        sums[0 if any("model" in spec_axes(e) for e in spec) else 1] += _sum_sq(g)
    comm.all_reduce_(sums[:1], "model")      # the sharded leaves' shards
    return torch.sqrt(sums.sum())


def _zero_sliced(pspec, ospec) -> bool:
    """The moments of a leaf are this data rank's slice of its leading axis."""
    return bool(ospec) and "data" in spec_axes(ospec[0]) and \
        "data" not in spec_axes(pspec[0])


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState, specs=None
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping; no decay on leaves of fewer
    than 2 dimensions (norms, biases).  Updates ``params`` and the moments in
    place and returns them with the new step and ``{"lr", "grad_norm"}``.
    ``specs``: (parameter specs, moment specs) under a bound mesh (see the
    module docstring)."""
    p_specs, o_specs = specs if specs is not None else (None, None)
    gnorm = global_norm(grads, p_specs)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = float(lr_schedule(cfg, step))
    stepf = step.float()
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)

    zero = [False] * len(leaves(params)) if specs is None else \
        [_zero_sliced(ps, os) for ps, os in zip(axes_leaves(p_specs), axes_leaves(o_specs))]
    _, n_data, r_data = comm.axis_group("data")
    with torch.no_grad():
        for p_leaf, g_leaf, m_leaf, v_leaf, z in zip(leaves(params), leaves(grads),
                                                     leaves(state.m), leaves(state.v), zero):
            decay = p_leaf.dim() >= 2      # decided on the whole leaf, as the reference
            p_all = p_leaf
            if z:
                rows = p_leaf.shape[0] // n_data
                p_leaf = p_leaf.narrow(0, r_data * rows, rows)
                g_leaf = g_leaf.narrow(0, r_data * rows, rows)
            if m_leaf.shape != p_leaf.shape:
                raise ValueError(f"moments {tuple(m_leaf.shape)} for a parameter part "
                                 f"{tuple(p_leaf.shape)}: place the state by its specs")
            for p, g, m, v in _slices(p_leaf, g_leaf, m_leaf, v_leaf):
                g = g.float() * clip
                m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
                v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
                mhat = m / b1c
                vhat = v / b2c
                delta = mhat / (torch.sqrt(vhat) + cfg.eps)
                if decay:
                    delta = delta + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
            if z:
                p_all.copy_(comm.all_gather_dim(p_leaf, 0, "data"))
    metrics = {"lr": torch.tensor(lr, dtype=torch.float32), "grad_norm": gnorm}
    return params, OptState(state.m, state.v, step), metrics
