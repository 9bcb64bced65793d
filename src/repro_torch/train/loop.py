"""Training loop: train-step factory (gradient accumulation over
microbatches, bf16 parameters with fp32 moments, remat), and the step
watchdog and timer, as the JAX package's ``train/loop.py``.

On the card, attention's gradient comes from the hand-written flash
backward kernel (``kernels/flash_attention``), the SSD scan's from the SSD
backward kernel (``kernels/ssd_scan``); the weight products' and a MoE
layer's routing, experts and combine from PyTorch's own backward.  The step
does not depend on the family.  It updates the state in place
(``adamw_update``) and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
import time
from typing import Any
from typing import Callable
from typing import List
from typing import NamedTuple
from typing import Optional
from typing import Tuple

import torch

from .. import require_device
from ..configs import ArchConfig
from ..models import forward
from ..models import lm_loss
from ..tree import leaves
from ..tree import unflatten
from .optimizer import AdamWConfig
from .optimizer import OptState
from .optimizer import adamw_update
from .optimizer import init_opt_state


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(params))


def loss_and_grads(params, tokens: torch.Tensor,
                   cfg: ArchConfig) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The loss of one (micro)batch and its gradient with respect to each
    leaf of ``params``, in ``leaves`` order: ``lm_loss`` of ``forward`` on
    ``tokens`` (B, S) int64 on the parameters' device, differentiated by
    autograd.  ``train_step`` calls it once a microbatch."""
    # views of the parameters that autograd may differentiate, no copies
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = lm_loss(forward(unflatten(params, flat), tokens, cfg), tokens)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), list(grads)


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, microbatches: int = 1, *,
                    device="cuda") -> Callable:
    """Returns ``train_step(state, tokens) -> (state, metrics)`` on
    ``device`` (the card unless the caller asks for the CPU); the state's
    tensors must lie there, ``tokens`` (B, S) may be numpy.  Each layer is
    recomputed in the backward pass (``forward``'s default ``remat``), as in
    the reference.

    ``microbatches`` > 1 splits the step's batch and sums each microbatch's
    gradients into fp32 zeros, then divides, and averages the losses, as the
    reference's ``lax.scan`` does; the fp32 sum and one microbatch's
    gradients are live at a time."""
    dev = require_device(device)

    def train_step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        for p in leaves(state.params):
            if p.device != tokens.device:
                raise ValueError(f"train_step runs on {dev}; a parameter lies on {p.device}")
        if microbatches == 1:
            loss, grads = loss_and_grads(state.params, tokens, cfg)
        else:
            b = tokens.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
            mb = tokens.reshape(microbatches, b // microbatches, tokens.shape[1])
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves(state.params)]
            loss = 0.0
            for batch in mb:
                loss_i, g_i = loss_and_grads(state.params, batch, cfg)
                for acc, g in zip(grads, g_i):
                    acc.add_(g)
                del g_i
                loss = loss + loss_i
            for g in grads:
                g.div_(microbatches)
            loss = loss / microbatches
        params, opt, om = adamw_update(opt_cfg, state.params,
                                       unflatten(state.params, grads), state.opt)
        return TrainState(params, opt), {"loss": loss, **om}

    return train_step


# ---------------------------------------------------------------------------
# Straggler mitigation: per-step timing watchdog
# ---------------------------------------------------------------------------
@dataclass
class StepWatchdog:
    """Tracks step wall-times and flags stragglers, as the reference's: a
    step longer than ``threshold ×`` the rolling median (of ``window`` steps,
    once 5 are known) is flagged, and after ``evict_after`` flags in a row
    ``on_straggler(step, seconds)`` is called (on a cluster: evict the host
    and restart from the latest checkpoint)."""

    threshold: float = 3.0
    window: int = 32
    evict_after: int = 3
    on_straggler: Optional[Callable[[int, float], None]] = None
    _times: List[float] = field(default_factory=list)
    _consecutive: int = 0
    flagged_steps: List[int] = field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        self._times.append(duration_s)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = sorted(self._times)[len(self._times) // 2]
        is_straggler = (len(self._times) >= 5
                        and duration_s > self.threshold * med)
        if is_straggler:
            self._consecutive += 1
            self.flagged_steps.append(step)
            if self.on_straggler and self._consecutive >= self.evict_after:
                self.on_straggler(step, duration_s)
        else:
            self._consecutive = 0
        return is_straggler


class StepTimer:
    """Host seconds of a ``with`` block (``elapsed``); the block waits for
    the device itself where it needs to."""

    def __init__(self):
        self.t0 = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
