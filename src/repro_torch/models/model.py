"""Model assembly of the port: init / forward / prefill / decode.

All four families are ported: dense (llama3.2-3b, gemma2-27b with its
sliding window on local layers and its logit softcaps, gemma-7b with its
16 heads of 256, and the other dense configs), MoE (deepseek-moe-16b: ``first_dense``
dense layers, then attention + MoE FFN layers), SSM (mamba2-2.7b) and hybrid
(zamba2-7b: groups of Mamba2 layers, each followed by one weight-shared
attention + MLP block, and a tail of Mamba2 layers).

Design notes
------------
* Parameters are dicts of tensors with the JAX package's keys; per-layer
  leaves are stacked along a leading layer axis, and the layer stack is a
  Python loop over views of that axis (no copies).  ``forward`` takes each
  stacked leaf apart once with ``unbind``, whose backward stacks the layers'
  gradients into one tensor; indexing layer by layer would instead allocate
  a zero gradient of the whole stacked leaf for every layer.
* ``forward(..., remat=True)`` recomputes each layer (each group of a hybrid,
  each Mamba2 tail layer) in the backward pass, as the JAX package's
  ``jax.checkpoint``: it changes memory, not numbers.
* ``tie_embeddings`` is intent only, as in the JAX package: ``lm_head`` is
  always a separate parameter.
* **The cache is updated in place.**  ``prefill`` allocates a
  prompt-sized cache and fills it; ``decode_step`` writes one K/V row
  (dense, MoE) or the new conv history and SSM state (SSM) into the cache it
  is given and returns a ``Cache`` that holds the same tensors.  A hybrid's
  cache holds K/V for each application of the shared block and conv history
  and state for each Mamba2 layer.
* Entry points take an explicit ``device`` (default the card) and raise
  where it is absent; random weights come from an explicit
  ``torch.Generator`` on that device.  ``init_params(cfg, device="meta")``
  gives the shapes alone, the counterpart of ``jax.eval_shape``.
* Under a bound mesh (``sharding.use_mesh``) ``forward`` takes this rank's
  data shard of the batch and its shard of every parameter
  (``train/sharding_rules.py``): ``embed`` sharded over ``d_model`` and
  gathered into the residual stream's layout, ``lm_head`` over the
  vocabulary, whose sharded logits ``lm_loss`` reduces as a vocab-parallel
  cross-entropy to the global batch's mean.  ``prefill`` and
  ``decode_step`` refuse a mesh: serving under one is a later slice.
"""

from __future__ import annotations

from contextlib import nullcontext
from functools import partial
import math
from typing import Any
from typing import Dict
from typing import NamedTuple
from typing import Optional
from typing import Sequence
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import require_device
from ..configs import ArchConfig
from ..configs import DENSE
from ..configs import HYBRID
from ..configs import MOE
from ..configs import SSM
from ..sharding import comm
from ..sharding.api import ACT_SEQ
from ..sharding.api import act_axes
from ..sharding.api import constrain
from ..sharding.api import current_mesh
from ..sharding.api import dp_axes
from ..sharding.api import model_size
from ..sharding.api import use_mesh
from .layers import attention_block
from .layers import block_rope_tables
from .layers import init_normal
from .layers import init_stacked
from .layers import mlp_block
from .layers import resid_norm
from .layers import tp_input
from .moe import init_moe_params
from .moe import moe_ffn
from .ssm import Mamba2Cache
from .ssm import init_mamba2_cache
from .ssm import init_mamba2_params
from .ssm import mamba2_block

DTYPE = torch.bfloat16


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in (DENSE, MOE, SSM, HYBRID):
        raise NotImplementedError(f"unknown family {cfg.family!r}")


def _refuse_mesh(what: str) -> None:
    if current_mesh() is not None:
        raise NotImplementedError(
            f"{what} under a mesh comes with the serving slice of the distribution "
            "layer: it needs the K/V cache sharded on its sequence (cache_logical_axes' "
            "kvseq) and a cross-rank merge of the decode kernel's partials")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
class _ShapesOnly:
    """The stand-in generator of the meta device, which has none: the
    ``init_*`` functions make empty meta tensors from it."""
    device = torch.device("meta")


def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A seeded generator on ``device`` for ``init_params``."""
    dev = require_device(device)
    if dev.type == "meta":
        return _ShapesOnly()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _ln_init(cfg: ArchConfig, shape, device, dtype) -> torch.Tensor:
    make = torch.zeros if cfg.gemma_norm else torch.ones
    return make(shape, dtype=dtype, device=device)


def _init_attn(gen, cfg: ArchConfig, n_layers: int, dtype):
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "ln": _ln_init(cfg, (n_layers, d), gen.device, dtype),
        "wq": init_stacked(gen, n_layers, (d, h, hd), s, dtype),
        "wk": init_stacked(gen, n_layers, (d, g, hd), s, dtype),
        "wv": init_stacked(gen, n_layers, (d, g, hd), s, dtype),
        "wo": init_stacked(gen, n_layers, (h, hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ln_init(cfg, (n_layers, hd), gen.device, dtype)
        p["k_norm"] = _ln_init(cfg, (n_layers, hd), gen.device, dtype)
    return p


def _init_mlp(gen, cfg: ArchConfig, n_layers: int, d_ff: int, dtype):
    d = cfg.d_model
    return {
        "ln": _ln_init(cfg, (n_layers, d), gen.device, dtype),
        "w_gate": init_stacked(gen, n_layers, (d, d_ff), d ** -0.5, dtype),
        "w_up": init_stacked(gen, n_layers, (d, d_ff), d ** -0.5, dtype),
        "w_down": init_stacked(gen, n_layers, (d_ff, d), d_ff ** -0.5, dtype),
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda", dtype=DTYPE) -> Dict[str, Any]:
    """Random parameters in the JAX package's tree layout, made on the device
    of ``generator`` (or of a new generator seeded with ``seed`` on
    ``device``).  SSM layers keep ``a_log`` and ``d_skip`` in fp32, MoE
    layers their router ``w_gate``, as the JAX package does.  A MoE model's
    ``dense_layers`` (``first_dense`` of them, {attn, mlp}) come before its
    ``moe_layers`` ({attn, moe}).  A hybrid's ``mamba_groups`` leaves are
    stacked ``(n_groups, hybrid_period, ...)``, ``mamba_tail`` (present when
    ``hybrid_period`` does not divide ``n_layers``) ``(tail, ...)``, and the
    shared block's leaves have no layer axis."""
    _require_ported(cfg)
    gen = generator if generator is not None else make_generator(seed, device)
    d, v = cfg.d_model, cfg.vocab
    params = {
        "embed": init_normal(gen, (v, d), d ** -0.5, dtype),
        "ln_f": _ln_init(cfg, (d,), gen.device, dtype),
        "lm_head": init_normal(gen, (d, v), d ** -0.5, dtype),
    }
    if cfg.family == SSM:
        params["layers"] = init_mamba2_params(gen, d, cfg.ssm, cfg.n_layers, dtype)
    elif cfg.family == HYBRID:
        period = cfg.hybrid_period
        n_groups = cfg.n_layers // period
        tail = cfg.n_layers - n_groups * period
        stacked = init_mamba2_params(gen, d, cfg.ssm, n_groups * period, dtype)
        params["mamba_groups"] = {k: v.view((n_groups, period) + tuple(v.shape[1:]))
                                  for k, v in stacked.items()}
        if tail:
            params["mamba_tail"] = init_mamba2_params(gen, d, cfg.ssm, tail, dtype)
        params["shared_attn"] = _layer(_init_attn(gen, cfg, 1, dtype), 0)
        params["shared_mlp"] = _layer(_init_mlp(gen, cfg, 1, cfg.d_ff, dtype), 0)
    elif cfg.family == MOE:
        nd = cfg.moe.first_dense
        nm = cfg.n_layers - nd
        if nd:
            params["dense_layers"] = {
                "attn": _init_attn(gen, cfg, nd, dtype),
                "mlp": _init_mlp(gen, cfg, nd, cfg.d_ff, dtype),
            }
        params["moe_layers"] = {
            "attn": _init_attn(gen, cfg, nm, dtype),
            "moe": init_moe_params(gen, d, cfg.moe, nm, dtype),
        }
    else:
        params["layers"] = {
            "attn": _init_attn(gen, cfg, cfg.n_layers, dtype),
            "mlp": _init_mlp(gen, cfg, cfg.n_layers, cfg.d_ff, dtype),
        }
    return params


def local_flags(cfg: ArchConfig, n_layers: Optional[int] = None) -> Tuple[bool, ...]:
    n = n_layers if n_layers is not None else cfg.n_layers
    if cfg.local_global_period is None or cfg.window is None:
        return (False,) * n
    # every `period`-th layer is global; the rest use the sliding window
    return tuple((i % cfg.local_global_period) != (cfg.local_global_period - 1)
                 for i in range(n))


def _layer(tree, i: int):
    return {k: v[i] for k, v in tree.items()}


def _unstack(tree, n: int):
    """The ``n`` layers of a tree of leaves stacked on a leading axis, each a
    dict of views, from one ``unbind`` a leaf."""
    parts = {k: v.unbind(0) for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _attn_layers(params, cfg: ArchConfig):
    """(attention params, FFN, FFN params, local flag) of each layer of a
    dense or MoE model, in the order of the K/V cache's layer axis: a MoE
    model's ``first_dense`` dense layers, then its MoE layers.  Each stacked
    leaf is taken apart once (``_unstack``)."""
    if cfg.family == MOE:
        nd = cfg.moe.first_dense
        stacks = [(params["moe_layers"], "moe", partial(moe_ffn, spec=cfg.moe),
                   (False,) * (cfg.n_layers - nd))]
        if nd:
            stacks.insert(0, (params["dense_layers"], "mlp", mlp_block, local_flags(cfg, nd)))
    else:
        stacks = [(params["layers"], "mlp", mlp_block, local_flags(cfg))]
    for layers, kind, ffn, flags in stacks:
        attn, fp = _unstack(layers["attn"], len(flags)), _unstack(layers[kind], len(flags))
        for i, fl in enumerate(flags):
            yield attn[i], ffn, fp[i], fl


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg: ArchConfig,
                 input_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of ``embed`` (or ``input_embeds``).  ``F.embedding``, whose
    backward sums a repeated token's gradients in a fixed order; indexing's
    backward on the CPU sums them in an order that varies run to run.  Under
    a model axis the rows are this rank's ``d_model`` slice (``embed`` is
    D-sharded), laid out as the residual stream (``act_axes()``)."""
    b, s = (input_embeds if input_embeds is not None else tokens).shape[:2]
    m = model_size()
    if m > 1 and ACT_SEQ[0] and s % m:
        raise NotImplementedError(
            f"a sequence of {s} does not split over a model axis of {m} ranks; the "
            "reference then keeps the residual stream whole, which the port does not")
    if input_embeds is not None:
        x = input_embeds.to(params["embed"].dtype)
        have = None
    else:
        x = torch.nn.functional.embedding(tokens, params["embed"])
        have = ("dp", None, "tp")
    if cfg.gemma_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return constrain(x, act_axes(), have=have, shape=(b, s, cfg.d_model))


def lm_logits(params, x, cfg: ArchConfig) -> torch.Tensor:
    """Logits of the residual stream ``x``; under a model axis this rank's
    vocabulary slice (``lm_head`` vocab-sharded, the reference's
    ``constrain(logits, ("dp", None, "tp"))``), the final softcap applied
    there."""
    m = model_size()
    if m > 1 and cfg.vocab % m:
        raise NotImplementedError(
            f"a vocabulary of {cfg.vocab} does not split over a model axis of {m} ranks")
    h = tp_input(resid_norm(x, params["ln_f"], cfg), cfg, x)
    logits = torch.matmul(h, params["lm_head"])
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


# ---------------------------------------------------------------------------
# Forward (full sequence, no cache)
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> torch.Tensor:
    """Logits (B, S, vocab) of a full sequence.  ``remat``: each layer (each
    group of a hybrid) keeps only its input for the backward pass and runs
    again there (``_maybe_remat``); without grad it changes nothing."""
    _require_ported(cfg)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    if cfg.family == SSM:
        mamba = _maybe_remat(_mamba_layer, remat)
        for i, p in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x = x + mamba(p, x, cfg, None, i)
        return lm_logits(params, x, cfg)
    # the blocks attend over the whole sequence, gathered under ACT_SEQ
    b, s = (input_embeds if input_embeds is not None else tokens).shape[:2]
    rope = block_rope_tables(cfg, b, s, None, x.device)
    if cfg.family == HYBRID:
        return lm_logits(params, _hybrid_stack(params, x, cfg, remat=remat, rope=rope,
                                               positions=positions), cfg)
    block = _maybe_remat(_attn_mlp, remat)
    for attn, ffn, fp, fl in _attn_layers(params, cfg):
        x = block(attn, fp, x, cfg, ffn=ffn, layer_is_local=fl, positions=positions,
                  rope=rope)
    return lm_logits(params, x, cfg)


def _maybe_remat(fn, remat: bool):
    """``fn``, or ``fn`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped after the forward and recomputed in the
    backward, as the JAX package's ``jax.checkpoint``.  The model draws no
    random numbers, so no RNG state is stashed.  The recomputation runs
    under the mesh the forward ran under (``_same_mesh``)."""
    if not remat:
        return fn
    return partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                   context_fn=_same_mesh)


def _same_mesh():
    """(forward context, recompute context) for ``checkpoint``: the mesh bound
    at the forward, bound again for the recomputation.  Autograd runs a
    card's backward on a thread of its own, where the forward thread's mesh
    is not bound."""
    return nullcontext(), use_mesh(current_mesh())


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy in fp32, averaged: ``logsumexp`` of each
    position's logits less the next token's logit, which ``gather`` picks (the
    same value as the JAX package's one-hot einsum).

    Under a bound mesh, ``logits`` and ``tokens`` are this rank's batch rows
    and, on a model axis of more than one rank, its vocabulary slice: the
    maximum, the sum of exponentials and the gold logit are reduced over the
    model axis (a vocab-parallel cross-entropy), and each rank's mean is
    summed over the data-parallel axes, divided by their ranks: every rank
    returns the global batch's mean, and its gradient is its own rows' share
    of that mean's."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    mesh = current_mesh()
    if model_size(mesh) > 1:
        r = comm.axis_group("model")[2]
        v_loc = lg.shape[-1]
        mx = lg.detach().amax(dim=-1, keepdim=True)
        comm.all_reduce_(mx, "model", op=torch.distributed.ReduceOp.MAX)
        logz = torch.log(comm.reduce_from(torch.exp(lg - mx).sum(dim=-1))) + mx[..., 0]
        local = tg - r * v_loc
        mine = (local >= 0) & (local < v_loc)
        gold = lg.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
        gold = comm.reduce_from(torch.where(mine, gold, torch.zeros_like(gold)))
    else:
        logz = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, tg[..., None])[..., 0]
    loss = (logz - gold).mean()
    if mesh is None:
        return loss
    loss = loss / math.prod(comm.axis_group(a)[1] for a in dp_axes(mesh))
    for axis in dp_axes(mesh):
        loss = comm.reduce_from(loss, axis)
    return loss



def _attn_mlp(attn, mlp, x, cfg: ArchConfig, ffn=mlp_block, **attn_kw) -> torch.Tensor:
    """One transformer block: ``x + attention``, then ``+ ffn`` (the MLP, or
    a MoE layer's ``moe_ffn``) with parameters ``mlp``."""
    a, _ = attention_block(attn, x, cfg, **attn_kw)
    x = x + a
    return x + ffn(mlp, x, cfg)


def _mamba_layer(p, x, cfg: ArchConfig, cache: Optional[Cache], i: int,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mamba2 layer ``i``'s output (to add to ``x``).  With a cache, it runs
    from that layer's conv history and state and writes the new ones **into
    the cache's own tensors**, only at batch ``rows`` where given."""
    if cache is None:
        return mamba2_block(p, x, cfg.ssm)[0]
    lc = Mamba2Cache(conv_x=cache.conv_x[i], conv_bc=cache.conv_bc[i], ssm=cache.ssm[i])
    y, new = mamba2_block(p, x, cfg.ssm, cache=lc)
    for dst, src in zip(lc, new):
        if rows is None:
            dst.copy_(src)
        else:
            dst[rows] = src[rows]
    return y


def _hybrid_stack(params, x, cfg: ArchConfig, cache: Optional[Cache] = None,
                  rows: Optional[torch.Tensor] = None, remat: bool = False,
                  **attn_kw) -> torch.Tensor:
    """The reference's ``_hybrid_stack`` / ``_hybrid_prefill`` /
    ``_hybrid_decode`` in one loop: each group's ``hybrid_period`` Mamba2
    layers, then the weight-shared attention + MLP block (application ``a``
    reads and writes K/V slice ``a`` of the cache); the tail's Mamba2 layers
    after the last group.  Mamba2 layer ``i`` of ``n_layers`` uses conv and
    state slice ``i``.  ``attn_kw`` go to every ``attention_block`` call.
    ``remat`` (no cache) recomputes each group and each tail layer in the
    backward pass, as the reference's ``_hybrid_stack``."""
    period = cfg.hybrid_period
    n_groups = cfg.n_layers // period
    n_tail = cfg.n_layers - n_groups * period
    outer = {k: v.unbind(0) for k, v in params["mamba_groups"].items()}
    groups = [_unstack({k: t[a] for k, t in outer.items()}, period) for a in range(n_groups)]
    tail = _unstack(params["mamba_tail"], n_tail) if n_tail else []

    def group(x, a):
        for j in range(period):
            x = x + _mamba_layer(groups[a][j], x, cfg, cache, a * period + j, rows)
        kv = None if cache is None else (cache.k[a], cache.v[a])
        return _attn_mlp(params["shared_attn"], params["shared_mlp"], x, cfg,
                         kv_cache=kv, **attn_kw)

    group = _maybe_remat(group, remat)
    mamba = _maybe_remat(_mamba_layer, remat)
    for a in range(n_groups):
        x = group(x, a)
    for j in range(n_tail):
        x = x + mamba(tail[j], x, cfg, cache, n_groups * period + j, rows)
    return x


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
class Cache(NamedTuple):
    """Attention K/V stacked over layers (a hybrid: over applications of the
    shared block) and/or SSM state stacked over Mamba2 layers, and the next
    position; the fields a family does not use stay ``None``."""
    k: Optional[torch.Tensor] = None          # (L, B, S, G, hd)
    v: Optional[torch.Tensor] = None
    conv_x: Optional[torch.Tensor] = None     # (L, B, K-1, d_inner)
    conv_bc: Optional[torch.Tensor] = None    # (L, B, K-1, 2GN)
    ssm: Optional[torch.Tensor] = None        # (L, B, H, P, N) fp32
    pos: int = 0                              # next position (a Python int)


def _n_attn_apps(cfg: ArchConfig) -> int:
    """Entries of the K/V cache's layer axis: one per attention layer, one
    per application of a hybrid's shared block, none for an SSM."""
    if cfg.family == HYBRID:
        return cfg.n_layers // cfg.hybrid_period
    if cfg.family == SSM:
        return 0
    return cfg.n_layers


def _empty_cache(cfg: ArchConfig, batch: int, kv_rows: int, conv_rows: int, device,
                 dtype) -> Cache:
    """Zero K/V of ``kv_rows`` positions for each attention application and
    zero SSM state for each Mamba2 layer, as the family has them: fp32 state
    and ``conv_rows`` rows of conv history (``d_conv - 1`` except after a
    prefill of fewer tokens)."""
    cache = Cache()
    if cfg.family in (SSM, HYBRID):
        one = init_mamba2_cache(batch, cfg.d_model, cfg.ssm, device=device, dtype=dtype)
        L = cfg.n_layers
        cache = Cache(
            conv_x=torch.zeros((L, batch, conv_rows) + one.conv_x.shape[2:], dtype=dtype,
                               device=device),
            conv_bc=torch.zeros((L, batch, conv_rows) + one.conv_bc.shape[2:], dtype=dtype,
                                device=device),
            ssm=torch.zeros((L,) + tuple(one.ssm.shape), dtype=torch.float32, device=device))
    n_attn = _n_attn_apps(cfg)
    if n_attn:
        shape = (n_attn, batch, kv_rows, cfg.n_kv_heads, cfg.head_dim)
        cache = cache._replace(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda",
               dtype=DTYPE) -> Cache:
    """Dense and MoE: K/V for ``max_seq`` rows, one entry per layer (a MoE
    model's dense layers first).  SSM: conv history and fp32 state, whose
    size does not depend on ``max_seq``.  Hybrid: both, K/V for each
    application of the shared block."""
    _require_ported(cfg)
    return _empty_cache(cfg, batch, max_seq, cfg.ssm.d_conv - 1 if cfg.ssm else 0,
                        require_device(device), dtype)


def cache_logical_axes(cfg: ArchConfig) -> Cache:
    """Logical sharding for the cache, as the reference's (used by its
    dry-run): K/V on the batch and the ``kvseq`` sequence axis, the SSM's
    conv history and state on the batch and ``d_inner`` / heads."""
    has_ssm = cfg.family in (SSM, HYBRID)
    has_attn = bool(_n_attn_apps(cfg))
    return Cache(
        k=(None, "dp", "kvseq", None, None) if has_attn else None,
        v=(None, "dp", "kvseq", None, None) if has_attn else None,
        conv_x=(None, "dp", None, "tp") if has_ssm else None,
        conv_bc=(None, "dp", None, None) if has_ssm else None,
        ssm=(None, "dp", "tp", None, None) if has_ssm else None,
        pos=(),
    )


# ---------------------------------------------------------------------------
# Decode step (one new token against the cache)
# ---------------------------------------------------------------------------
def decode_step(params, tokens, cache: Cache, cfg: ArchConfig, *,
                input_embeds: Optional[torch.Tensor] = None,
                rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) → (logits (B, 1, V), cache advanced by one position).

    Dense and MoE: writes K/V at ``cache.pos`` **into the cache's own
    tensors**.  SSM: writes the new conv history and state into them.
    Hybrid: both.  With ``rows`` (batch indices) only those sequences write
    their cache; the others keep their cache untouched and their logits mean
    nothing.  Dense and hybrid: only the ``rows`` attend (over ``cache.pos +
    1`` rows), the others get ``cache_len`` 0.  MoE: the tokens of one call
    compete for the experts' slots, so every row takes the step as the
    reference's whole-batch step does (K/V written at ``cache.pos``,
    attention over ``cache.pos + 1`` rows), and then the other rows' K/V at
    ``cache.pos`` is put back as it was."""
    _require_ported(cfg)
    _refuse_mesh("decode_step")
    b = tokens.shape[0]
    pos = int(cache.pos)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    cache_rows = cache_len = saved = None
    if rows is not None:
        cache_rows = torch.as_tensor(list(rows), dtype=torch.long, device=x.device)
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            x = x + _mamba_layer(_layer(params["layers"], i), x, cfg, cache, i, cache_rows)
        return lm_logits(params, x, cfg), cache._replace(pos=pos + 1)
    if cfg.family == MOE and rows is not None:
        group = set(rows)
        others = torch.as_tensor([i for i in range(b) if i not in group],
                                 dtype=torch.long, device=x.device)
        saved = others, cache.k[:, others, pos], cache.v[:, others, pos]
        cache_rows = None
    if cache_rows is not None:
        cache_len = torch.zeros((b,), dtype=torch.int32, device=x.device)
        cache_len[cache_rows] = pos + 1
    else:
        cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    attn = dict(cache_pos=pos, cache_rows=cache_rows, cache_len=cache_len,
                rope=block_rope_tables(cfg, b, 1, pos, x.device))
    if cfg.family == HYBRID:
        x = _hybrid_stack(params, x, cfg, cache, cache_rows, **attn)
        return lm_logits(params, x, cfg), cache._replace(pos=pos + 1)
    for i, (la, ffn, fp, fl) in enumerate(_attn_layers(params, cfg)):
        x = _attn_mlp(la, fp, x, cfg, ffn=ffn, layer_is_local=fl,
                      kv_cache=(cache.k[i], cache.v[i]), **attn)
    if saved is not None:
        others, k, v = saved
        cache.k[:, others, pos] = k
        cache.v[:, others, pos] = v
    return lm_logits(params, x, cfg), cache._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------
def prefill(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            pinned_rows: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-token logits (B, V), a new cache sized and filled to S).
    ``pinned_rows`` is handed to the flash kernel of every attention call
    (dense and MoE layers, and each application of a hybrid's shared
    block).

    SSM and hybrid: every Mamba2 layer starts from a zero state, as in the
    reference; its conv history keeps the last ``min(S, d_conv - 1)`` rows of
    the prompt (all ``d_conv - 1`` for a 1-token prompt, which takes the
    decode branch)."""
    _require_ported(cfg)
    _refuse_mesh("prefill")
    if positions is not None:
        raise NotImplementedError(
            "explicit positions (M-RoPE) come with the qwen2-vl slice of the port")
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, input_embeds)
    conv = cfg.ssm.d_conv - 1 if cfg.ssm else 0
    cache = _empty_cache(cfg, b, s, conv if s == 1 else min(s, conv), x.device, x.dtype)
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            x = x + _mamba_layer(_layer(params["layers"], i), x, cfg, cache, i)
        return lm_logits(params, x[:, -1:], cfg)[:, 0], cache._replace(pos=s)
    attn = dict(cache_pos=0, pinned_rows=pinned_rows,
                rope=block_rope_tables(cfg, b, s, 0, x.device))
    if cfg.family == HYBRID:
        x = _hybrid_stack(params, x, cfg, cache, **attn)
    else:
        for i, (la, ffn, fp, fl) in enumerate(_attn_layers(params, cfg)):
            x = _attn_mlp(la, fp, x, cfg, ffn=ffn, layer_is_local=fl,
                          kv_cache=(cache.k[i], cache.v[i]), **attn)
    return lm_logits(params, x[:, -1:], cfg)[:, 0], cache._replace(pos=s)
