"""Fine-grained Mixture-of-Experts FFN (DeepSeekMoE-style), in PyTorch.

Shared experts (always active) + routed experts with top-k gating and
first-come-first-served capacity: the JAX package's ``_moe_shard``.  As
there, every routed expert runs its products over all of its ``capacity``
slots, filled or not, so a call reads every expert's weights; the products
are batched ``torch.bmm`` over the expert axis (the reference's ``einsum``,
which no Pallas kernel computes).

Under a bound mesh with a model axis of more than one rank this is the
reference's expert-parallel ``shard_map`` body: every rank of the model axis
routes the same tokens (its data shard's, gathered whole over the model
axis), runs its ``E/model`` experts (ids ``e0`` on) and its slice of the
shared experts' ``d_ff``, and the partial outputs are summed over the model
axis.  The capacity, and the order in which tokens win slots, are then those
of the data shard's tokens, as in the reference.  With one rank on the model
axis the reference takes the global batch's view (GSPMD, no ``shard_map``):
each data shard's tokens then find the slots that the earlier shards'
tokens left, so the capacity and the drop order are the global batch's.
"""

from __future__ import annotations

import math
from typing import Dict
from typing import Optional
from typing import Tuple

import torch

from ..sharding import comm
from ..sharding.api import act_axes
from ..sharding.api import constrain
from ..sharding.api import current_mesh
from ..sharding.api import dp_axes
from ..sharding.api import model_size
from .layers import _gelu_tanh
from .layers import _silu
from .layers import init_stacked
from .layers import resid_norm
from .layers import tp_input


def _router_logits(xt: torch.Tensor, w_gate: torch.Tensor) -> torch.Tensor:
    """The router's logits (T, E): ``xt @ w_gate`` with both widened to fp32,
    as the reference keeps its router."""
    return torch.matmul(xt.float(), w_gate.float())


def _route(xt: torch.Tensor, w_gate: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing with renormalized weights. xt (T, D) → (w, idx), each
    (T, k): fp32 weights and expert ids, by descending router probability."""
    logits = _router_logits(xt, w_gate)
    w, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx


def _slots(w: torch.Tensor, idx: torch.Tensor, n_experts: int, capacity: int,
           e0: int = 0, taken: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Which tokens experts ``e0 .. e0 + n_experts - 1`` take, first come
    first served: earlier tokens win slots.  Returns ``tok_ids`` (E, C) int64,
    ``valid`` (E, C) and each slot's fp32 gate weight ``gw`` (E, C), with
    ``C = min(capacity, T)``; a slot left empty holds token 0 with weight 0,
    as in the reference.  ``taken`` (E,): the slots of each expert that
    tokens before these ones (earlier data shards of the batch) took; these
    tokens compete for the rest."""
    t = idx.shape[0]
    eids = e0 + torch.arange(n_experts, device=idx.device)
    onehot = idx[None, :, :] == eids[:, None, None]                  # (E, T, k)
    w_e = (onehot.to(w.dtype) * w[None]).sum(-1)                     # (E, T)
    chose = w_e > 0
    if taken is not None:
        chose = chose & (taken[:, None] + chose.cumsum(dim=1) <= capacity)
    prio = torch.arange(t, 0, -1, device=w.device, dtype=torch.float32)
    prio = torch.where(chose, prio[None, :], float("-inf"))
    top_prio, tok_ids = torch.topk(prio, min(capacity, t), dim=1)   # (E, C)
    valid = torch.isfinite(top_prio)
    tok_ids = torch.where(valid, tok_ids, 0)
    gw = torch.gather(w_e, 1, tok_ids) * valid
    return tok_ids, valid, gw


def _combine(y: torch.Tensor, tok_ids: torch.Tensor, valid: torch.Tensor,
             idx: torch.Tensor, e0: int = 0) -> torch.Tensor:
    """The weighted scatter-add of the experts' slot outputs ``y`` (E, C, D)
    into a zero (T, D) tensor of ``y``'s type, deterministically and without
    atomics, in the reference's order: it adds slot after slot, expert-major,
    each sum rounded to the type.  A token appears at most once an expert,
    so for each token that is its experts in increasing id.  Each filled
    slot's row goes to row ``rank`` of its token in a (T, k) table, where
    ``rank`` is the place of the slot's expert among the token's k experts
    (empty slots go to rows of their own, dropped ones leave a zero); the
    table's k columns are then added left to right.  Adding the zeros of
    empty slots and dropped experts leaves a sum as it is.  ``y`` holds
    experts ``e0`` on (this rank's, under expert parallelism); the others
    leave zeros."""
    e, c, d = y.shape
    t, k = idx.shape
    eids = e0 + torch.arange(e, device=y.device)
    rank = (idx[tok_ids] < eids[:, None, None]).sum(-1)                 # (E, C)
    spare = t * k + torch.arange(e * c, device=y.device).view(e, c)
    dest = torch.where(valid, tok_ids * k + rank, spare)
    table = y.new_zeros((t * k + e * c, d))
    table.index_copy_(0, dest.reshape(-1), y.reshape(e * c, d))
    table = table[:t * k].view(t, k, d)
    out = table[:, 0]
    for j in range(1, k):
        out = out + table[:, j]
    return out


def _routed_experts(xt, w, idx, w1, w3, w2, capacity: int, act, e0: int = 0,
                    taken: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Outputs of routed experts ``e0 .. e0 + E_loc - 1``. xt (T, D); w/idx
    (T, k); their weights (E_loc, D, F)/(E_loc, F, D).  Returns (T, D) in
    ``xt``'s type, covering those experts only; ``taken`` as ``_slots``'s."""
    tok_ids, valid, gw = _slots(w, idx, w1.shape[0], capacity, e0, taken)
    xg = xt[tok_ids]                                                # (E, C, D)
    h = act(torch.bmm(xg, w1)) * torch.bmm(xg, w3)
    y = torch.bmm(h, w2)                                            # (E, C, D)
    y = y * gw[..., None].to(y.dtype)
    return _combine(y, tok_ids, valid, idx, e0)


def _shared_experts(xt, p, act) -> torch.Tensor:
    h = act(torch.matmul(xt, p["sh_gate"])) * torch.matmul(xt, p["sh_up"])
    return torch.matmul(h, p["sh_down"])


def _moe_shard(x, p, *, spec, act, axis: Optional[str] = None) -> torch.Tensor:
    """The reference's per-shard body: on one device (``axis=None``), or as
    this rank of the model axis ``axis`` (its experts and shared-expert
    slice; the partial output summed over the axis by the caller).  Under a
    mesh without ``axis`` the tokens of the earlier data shards come first
    (``_taken``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w_gate = p["w_gate"]
    e0, t_all = 0, xt.shape[0]
    mesh = current_mesh()
    if axis:
        w_gate = comm.copy_to(w_gate, axis)
        e0 = comm.axis_group(axis)[2] * p["w1"].shape[0]
    elif mesh is not None:
        t_all *= math.prod(comm.axis_group(a)[1] for a in dp_axes(mesh))
    w, idx = _route(xt, w_gate, spec.top_k)
    capacity = min(max(int(spec.capacity_factor * t_all * spec.top_k
                           / spec.n_experts), 4), t_all)
    taken = None
    if mesh is not None and not axis:
        taken = _taken(idx, spec.n_experts, capacity, mesh)
    kw = {} if axis is None and taken is None else dict(e0=e0, taken=taken)
    out = _routed_experts(xt, w, idx, p["w1"], p["w3"], p["w2"], capacity, act, **kw)
    if spec.n_shared:
        out = out + _shared_experts(xt, p, act)
    return out.reshape(b, s, d).to(x.dtype)


def _taken(idx: torch.Tensor, n_experts: int, capacity: int, mesh) -> torch.Tensor:
    """Each expert's slots taken by the data shards before this one, which
    hold the global batch's earlier rows: every shard's count of the tokens
    that chose each expert, gathered over the data-parallel axes, summed over
    the earlier shards and capped at ``capacity``."""
    axes = list(dp_axes(mesh))
    chose = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    chose.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))
    counts = comm.stack_over(chose, axes)                       # (shards, E)
    me = 0
    for a in axes:
        _, n, r = comm.axis_group(a)
        me = me * n + r
    return torch.clamp(counts[:me].sum(0), max=capacity)


def moe_ffn(params, x, cfg, spec) -> torch.Tensor:
    """MoE FFN block (includes its pre-norm).  x (B, S, D).  All B·S tokens
    of the call compete for the experts' slots, earlier ones first; under a
    mesh see the module docstring."""
    act = _gelu_tanh if cfg.act == "gelu" else _silu
    h = resid_norm(x, params["ln"], cfg)
    body = {k: v for k, v in params.items() if k != "ln"}
    m = model_size()
    if m > 1:
        if spec.n_experts % m or (spec.n_shared * spec.d_ff_expert) % m:
            raise NotImplementedError(
                f"{spec.n_experts} experts (shared d_ff {spec.n_shared * spec.d_ff_expert}) "
                f"do not split over a model axis of {m} ranks")
        out = _moe_shard(tp_input(h, cfg, x), body, spec=spec, act=act, axis="model")
        return constrain(comm.reduce_from(out), act_axes())
    return _moe_shard(h, body, spec=spec, act=act)


def init_moe_params(gen: torch.Generator, d_model: int, spec, n_layers: int,
                    dtype) -> Dict[str, torch.Tensor]:
    """``n_layers`` MoE blocks' parameters, stacked on a leading layer axis,
    in the reference's layout; the router ``w_gate`` in fp32.  Every leaf is
    drawn one layer at a time (``init_stacked``): at deepseek-moe-16b's size,
    one layer's ``w1`` in fp32 is 0.74 GB, all 27 of them 19.9 GB."""
    e, f = spec.n_experts, spec.d_ff_expert
    fs = spec.n_shared * spec.d_ff_expert
    s_in = d_model ** -0.5
    L = n_layers
    p = {
        "ln": torch.ones((L, d_model), dtype=dtype, device=gen.device),
        "w_gate": init_stacked(gen, L, (d_model, e), s_in, torch.float32),
        "w1": init_stacked(gen, L, (e, d_model, f), s_in, dtype),
        "w3": init_stacked(gen, L, (e, d_model, f), s_in, dtype),
        "w2": init_stacked(gen, L, (e, f, d_model), f ** -0.5, dtype),
    }
    if spec.n_shared:
        p["sh_gate"] = init_stacked(gen, L, (d_model, fs), s_in, dtype)
        p["sh_up"] = init_stacked(gen, L, (d_model, fs), s_in, dtype)
        p["sh_down"] = init_stacked(gen, L, (fs, d_model), fs ** -0.5, dtype)
    return p
