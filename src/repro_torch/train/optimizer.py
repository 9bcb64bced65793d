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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    sums = []
    for g in leaves(tree):
        sums.append(sum(torch.sum(torch.square(s.float())) for (s,) in _slices(g)))
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWConfig, params, grads, state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping; no decay on leaves of fewer
    than 2 dimensions (norms, biases).  Updates ``params`` and the moments in
    place and returns them with the new step and ``{"lr", "grad_norm"}``."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = float(lr_schedule(cfg, step))
    stepf = step.float()
    b1c = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    b2c = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)

    with torch.no_grad():
        for p_leaf, g_leaf, m_leaf, v_leaf in zip(leaves(params), leaves(grads),
                                                  leaves(state.m), leaves(state.v)):
            decay = p_leaf.dim() >= 2      # decided on the whole leaf, as the reference
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
    metrics = {"lr": torch.tensor(lr, dtype=torch.float32), "grad_norm": gnorm}
    return params, OptState(state.m, state.v, step), metrics
