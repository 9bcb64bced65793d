"""Fine-grained Mixture-of-Experts FFN (DeepSeekMoE-style), in PyTorch.

Shared experts (always active) + routed experts with top-k gating and
first-come-first-served capacity: the JAX package's single-device body
(``_moe_shard`` with ``axis=None``).  As there, every routed expert runs its
products over all of its ``capacity`` slots, filled or not, so a call reads
every expert's weights; the products are batched ``torch.bmm`` over the
expert axis (the reference's ``einsum``, which no Pallas kernel computes).
The expert-parallel ``shard_map`` path of the reference is not ported: the
port has no device mesh yet.
"""

from __future__ import annotations

from typing import Dict
from typing import Tuple

import torch

from .layers import _gelu_tanh
from .layers import _silu
from .layers import init_stacked
from .layers import rms_norm


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


def _slots(w: torch.Tensor, idx: torch.Tensor, n_experts: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Which tokens each expert takes, first come first served: earlier
    tokens win slots.  Returns ``tok_ids`` (E, C) int64, ``valid`` (E, C)
    and each slot's fp32 gate weight ``gw`` (E, C), with ``C = min(capacity,
    T)``; a slot left empty holds token 0 with weight 0, as in the reference."""
    t = idx.shape[0]
    eids = torch.arange(n_experts, device=idx.device)
    onehot = idx[None, :, :] == eids[:, None, None]                  # (E, T, k)
    w_e = (onehot.to(w.dtype) * w[None]).sum(-1)                     # (E, T)
    prio = torch.arange(t, 0, -1, device=w.device, dtype=torch.float32)
    prio = torch.where(w_e > 0, prio[None, :], float("-inf"))
    top_prio, tok_ids = torch.topk(prio, min(capacity, t), dim=1)   # (E, C)
    valid = torch.isfinite(top_prio)
    tok_ids = torch.where(valid, tok_ids, 0)
    gw = torch.gather(w_e, 1, tok_ids) * valid
    return tok_ids, valid, gw


def _combine(y: torch.Tensor, tok_ids: torch.Tensor, valid: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """The weighted scatter-add of the experts' slot outputs ``y`` (E, C, D)
    into a zero (T, D) tensor of ``y``'s type, deterministically and without
    atomics, in the reference's order: it adds slot after slot, expert-major,
    each sum rounded to the type.  A token appears at most once an expert,
    so for each token that is its experts in increasing id.  Each filled
    slot's row goes to row ``rank`` of its token in a (T, k) table, where
    ``rank`` is the place of the slot's expert among the token's k experts
    (empty slots go to rows of their own, dropped ones leave a zero); the
    table's k columns are then added left to right.  Adding the zeros of
    empty slots and dropped experts leaves a sum as it is."""
    e, c, d = y.shape
    t, k = idx.shape
    eids = torch.arange(e, device=y.device)
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


def _routed_experts(xt, w, idx, w1, w3, w2, capacity: int, act) -> torch.Tensor:
    """Outputs of the routed experts. xt (T, D); w/idx (T, k); expert weights
    (E, D, F)/(E, F, D).  Returns (T, D) in ``xt``'s type."""
    tok_ids, valid, gw = _slots(w, idx, w1.shape[0], capacity)
    xg = xt[tok_ids]                                                # (E, C, D)
    h = act(torch.bmm(xg, w1)) * torch.bmm(xg, w3)
    y = torch.bmm(h, w2)                                            # (E, C, D)
    y = y * gw[..., None].to(y.dtype)
    return _combine(y, tok_ids, valid, idx)


def _shared_experts(xt, p, act) -> torch.Tensor:
    h = act(torch.matmul(xt, p["sh_gate"])) * torch.matmul(xt, p["sh_up"])
    return torch.matmul(h, p["sh_down"])


def _moe_shard(x, p, *, spec, act) -> torch.Tensor:
    """The reference's per-shard body on one device (``axis=None``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w, idx = _route(xt, p["w_gate"], spec.top_k)
    capacity = max(int(spec.capacity_factor * xt.shape[0] * spec.top_k
                       / spec.n_experts), 4)
    out = _routed_experts(xt, w, idx, p["w1"], p["w3"], p["w2"], capacity, act)
    if spec.n_shared:
        out = out + _shared_experts(xt, p, act)
    return out.reshape(b, s, d).to(x.dtype)


def moe_ffn(params, x, cfg, spec) -> torch.Tensor:
    """MoE FFN block (includes its pre-norm).  x (B, S, D).  All B·S tokens
    of the call compete for the experts' slots, earlier ones first."""
    act = _gelu_tanh if cfg.act == "gelu" else _silu
    h = rms_norm(x, params["ln"], plus_one=cfg.gemma_norm)
    body = {k: v for k, v in params.items() if k != "ln"}
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
