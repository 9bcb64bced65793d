"""Training loop: train-step factory (gradient accumulation over
microbatches, bf16 parameters with fp32 moments, remat), and the step
watchdog and timer, as the JAX package's ``train/loop.py``.

On the card, attention's gradient comes from the hand-written flash
backward kernel (``kernels/flash_attention``), the SSD scan's from the SSD
backward kernel (``kernels/ssd_scan``); the weight products' and a MoE
layer's routing, experts and combine from PyTorch's own backward.  The step
does not depend on the family.  It updates the state in place
(``adamw_update``) and returns it.

Under a bound mesh (``sharding.use_mesh``) the step runs as one rank of it:
the state holds this rank's shards (``shard_train_state``), the step takes
the global batch and keeps its data shard's rows (``batch_logical_axes``),
the loss and the gradients are the global batch's mean (the gradients summed
over the data-parallel ranks), and ``adamw_update`` takes the parameters'
and moments' specs (ZeRO-1).  Microbatches split each rank's rows.
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
from ..models import init_params
from ..models import lm_loss
from ..sharding import comm
from ..sharding.api import current_mesh
from ..sharding.api import dp_axes
from ..sharding.api import logical_spec
from ..sharding.api import spec_axes
from ..sharding.state import gather_tree
from ..sharding.state import map_axes
from ..sharding.state import shard_tree
from ..sharding.state import shardings_for
from ..tree import leaves
from ..tree import unflatten
from .optimizer import AdamWConfig
from .optimizer import OptState
from .optimizer import adamw_update
from .optimizer import init_opt_state
from .sharding_rules import batch_logical_axes
from .sharding_rules import opt_logical_axes
from .sharding_rules import param_logical_axes


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_opt_state(params))


def state_logical_axes(cfg: ArchConfig) -> TrainState:
    """A train state's logical axes: the parameters', and the moments'
    (ZeRO-1) of ``opt_logical_axes``; the step count whole."""
    opt = opt_logical_axes(cfg)
    return TrainState(params=param_logical_axes(cfg), opt=OptState(m=opt, v=opt, step=()))


def _state_shapes(cfg: ArchConfig) -> TrainState:
    """A train state's whole shapes, on the meta device."""
    shapes = init_params(cfg, device="meta")
    return TrainState(params=shapes, opt=OptState(m=shapes, v=shapes,
                                                  step=torch.empty((), device="meta")))


def shard_train_state(state: TrainState, cfg: ArchConfig, mesh=None) -> TrainState:
    """This rank's shards of a whole train state (the same on every rank),
    as the reference's ``jit(in_shardings=...)`` places one
    (``launch/dryrun.py::build_cell``)."""
    return shard_tree(state, state_logical_axes(cfg), mesh)


def init_sharded_train_state(params, cfg: ArchConfig, mesh=None) -> TrainState:
    """``shard_train_state(init_train_state(params), cfg)`` without the whole
    moments: this rank's shards of the whole ``params`` and zero moments of
    its moment shards, each made from one whole leaf at a time (at
    llama3.2-3b's size the whole fp32 moments are 28.9 GB)."""
    axes = state_logical_axes(cfg)

    def zeros(ax, p):
        whole = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return shard_tree(whole, ax, mesh)

    return TrainState(params=shard_tree(params, axes.params, mesh), opt=OptState(
        m=map_axes(zeros, axes.opt.m, params), v=map_axes(zeros, axes.opt.v, params),
        step=torch.zeros((), dtype=torch.int32)))


def gather_train_state(state: TrainState, cfg: ArchConfig, mesh=None) -> TrainState:
    """The whole train state on every rank from each rank's shards: for a
    checkpoint in the reference's format, and for tests."""
    return gather_tree(state, state_logical_axes(cfg), _state_shapes(cfg), mesh)


def train_specs(cfg: ArchConfig, mesh=None):
    """(parameter specs, moment specs) of a train state on ``mesh`` (the
    bound one by default), for ``adamw_update``."""
    shapes = _state_shapes(cfg)
    return (shardings_for(param_logical_axes(cfg), shapes.params, mesh),
            shardings_for(opt_logical_axes(cfg), shapes.params, mesh))


def local_batch(tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """This rank's rows of a global batch (B, S), laid out by
    ``batch_logical_axes``; a batch that the data-parallel ranks do not
    split is refused (the reference would repeat it on every rank)."""
    mesh = mesh or current_mesh()
    spec = logical_spec(batch_logical_axes(), mesh, tuple(tokens.shape))
    if spec_axes(spec[0]) != dp_axes(mesh):
        raise NotImplementedError(
            f"a batch of {tokens.shape[0]} rows does not split over the data-parallel "
            f"axes {dp_axes(mesh)}")
    return shard_tree(tokens, batch_logical_axes(), mesh)


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
    specs = {}

    def train_step(state: TrainState, tokens):
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.long)
        mesh = current_mesh()
        if mesh is not None:
            tokens = local_batch(tokens, mesh)
            if mesh not in specs:
                specs[mesh] = train_specs(cfg, mesh)
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
        if mesh is not None:
            for g in grads:
                for axis in dp_axes(mesh):
                    comm.all_reduce_(g, axis)
        params, opt, om = adamw_update(opt_cfg, state.params, unflatten(state.params, grads),
                                       state.opt, specs.get(mesh))
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
