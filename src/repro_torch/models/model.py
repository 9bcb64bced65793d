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
  ``decode_step`` take the global batch and this rank's cache shard
  (``init_cache``'s layout): the batch is split over the data axes that
  divide it and repeated on every rank otherwise, as the reference's
  ``logical_spec`` filter places it; they return whole logits on every rank
  (the vocab-parallel logits gathered over the model axis, and over the data
  axes where they split the batch).  Each entry point binds its stream's
  whole shape (``sharding.use_stream``): under ``ACT_SEQ`` a sequence that
  the model axis does not divide, such as a decode call's one token, keeps
  the residual stream whole, as the reference's filter leaves it.
* Under a mesh the K/V cache takes one of the reference's two layouts
  (``kv_layout``, its dry-run's rule): by KV heads over the model axis, or
  ``kvseq``, every KV head over this rank's slice of the rows, the rows
  split over whatever of (data, model) the batch leaves unused.  A
  ``kvseq`` cache's K tensor records the whole rows (``kv_rows``).
"""

from __future__ import annotations

from contextlib import contextmanager
from contextlib import nullcontext
from functools import partial
import math
import os
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
from ..sharding.api import Stream
from ..sharding.api import act_axes
from ..sharding.api import axis_sizes
from ..sharding.api import batch_axes
from ..sharding.api import constrain
from ..sharding.api import current_mesh
from ..sharding.api import current_stream
from ..sharding.api import dp_axes
from ..sharding.api import logical_spec
from ..sharding.api import model_size
from ..sharding.api import seq_sharded
from ..sharding.api import spec_axes
from ..sharding.api import use_mesh
from ..sharding.api import use_stream
from ..sharding.state import rank_part
from ..sharding.state import shard_tree
from .layers import POSITIONS_REFUSED
from .layers import all_kv_heads
from .layers import attention_block
from .layers import block_rope_tables
from .layers import init_normal
from .layers import init_stacked
from .layers import mlp_block
from .layers import resid_norm
from .layers import tp_heads
from .layers import tp_input
from .moe import init_moe_params
from .moe import moe_ffn
from .ssm import Mamba2Cache
from .ssm import init_mamba2_params
from .ssm import mamba2_block

DTYPE = torch.bfloat16


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in (DENSE, MOE, SSM, HYBRID):
        raise NotImplementedError(f"unknown family {cfg.family!r}")


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
    D-sharded), laid out as the residual stream (``act_axes()``; a sequence
    that the axis does not divide stays whole)."""
    b, s = (input_embeds if input_embeds is not None else tokens).shape[:2]
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
    again there (``_maybe_remat``); without grad it changes nothing.
    Explicit ``positions`` are refused (``POSITIONS_REFUSED``)."""
    _require_ported(cfg)
    if positions is not None:
        raise NotImplementedError(POSITIONS_REFUSED)
    b, s = (input_embeds if input_embeds is not None else tokens).shape[:2]
    with use_stream(Stream(_whole_batch(b), s)):
        return _forward(params, tokens, cfg, input_embeds, remat)


def _forward(params, tokens, cfg: ArchConfig, input_embeds, remat: bool):
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
        return lm_logits(params, _hybrid_stack(params, x, cfg, remat=remat, rope=rope), cfg)
    block = _maybe_remat(_attn_mlp, remat)
    for attn, ffn, fp, fl in _attn_layers(params, cfg):
        x = block(attn, fp, x, cfg, ffn=ffn, layer_is_local=fl, rope=rope)
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
    """(forward context, recompute context) for ``checkpoint``: the mesh and
    the stream bound at the forward, bound again for the recomputation.
    Autograd runs a card's backward on a thread of its own, where the
    forward thread's bindings are not."""
    return nullcontext(), _bound(current_mesh(), current_stream())


@contextmanager
def _bound(mesh, stream):
    with use_mesh(mesh), use_stream(stream):
        yield


def _whole_batch(b: int) -> int:
    """The global batch of ``forward``'s ``b`` rows under a mesh: the bound
    stream's, where the caller bound one (the train step, whose batch the
    data axes may not divide: then every rank holds all of it), else ``b``
    rows a data shard."""
    mesh = current_mesh()
    if mesh is None:
        return b
    if current_stream() is not None:
        return current_stream().batch
    sizes = axis_sizes(mesh)
    return b * math.prod(sizes[a] for a in dp_axes(mesh))


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
    summed over the data-parallel axes that split the batch (``batch_axes``
    of the bound stream), divided by their ranks: every rank returns the
    global batch's mean, and its gradient is its own rows' share of that
    mean's."""
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
    axes = batch_axes(mesh)
    loss = loss / math.prod(comm.axis_group(a)[1] for a in axes)
    for axis in axes:
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
    position; the fields a family does not use stay ``None``.  The fields
    are the reference's; a ``kvseq`` cache's whole row count rides on its K
    tensor (``kv_rows``)."""
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


def _local_widths(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(KV heads, conv_x channels, SSM heads) of this rank's cache under the
    bound mesh: the KV heads its query heads read (``tp_heads``), and the
    channels and heads of its Mamba2 shards where the model axis divides the
    heads (the weights' rules), else all of them."""
    g = tp_heads(cfg)[1] if _n_attn_apps(cfg) else 0
    d_inner = h = 0
    if cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        h = d_inner // cfg.ssm.head_dim
        m = model_size()
        if h % m == 0:
            d_inner, h = d_inner // m, h // m
    return g, d_inner, h


def _empty_cache(cfg: ArchConfig, batch: int, kv_rows: int, conv_rows: int, device,
                 dtype, all_kv: bool = False) -> Cache:
    """Zero K/V of ``kv_rows`` positions for each attention application and
    zero SSM state for each Mamba2 layer, as the family has them: fp32 state
    and ``conv_rows`` rows of conv history (``d_conv - 1`` except after a
    prefill of fewer tokens).  ``batch`` rows; under a mesh this rank's
    widths (``_local_widths``), or every KV head with ``all_kv``."""
    g, d_inner, h = _local_widths(cfg)
    g = cfg.n_kv_heads if all_kv else g
    cache = Cache()
    if cfg.family in (SSM, HYBRID):
        spec, L = cfg.ssm, cfg.n_layers
        cache = Cache(
            conv_x=torch.zeros((L, batch, conv_rows, d_inner), dtype=dtype, device=device),
            conv_bc=torch.zeros((L, batch, conv_rows, 2 * spec.n_groups * spec.d_state),
                                dtype=dtype, device=device),
            ssm=torch.zeros((L, batch, h, spec.head_dim, spec.d_state), dtype=torch.float32,
                            device=device))
    n_attn = _n_attn_apps(cfg)
    if n_attn:
        shape = (n_attn, batch, kv_rows, g, cfg.head_dim)
        cache = cache._replace(k=torch.zeros(shape, dtype=dtype, device=device),
                               v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda",
               dtype=DTYPE, layout: Optional[str] = None) -> Cache:
    """Dense and MoE: K/V for ``max_seq`` rows, one entry per layer (a MoE
    model's dense layers first).  SSM: conv history and fp32 state, whose
    size does not depend on ``max_seq``.  Hybrid: both, K/V for each
    application of the shared block.

    Under a bound mesh, this rank's shard of the cache of a global batch of
    ``batch`` rows: its data shard's rows where the data axes divide the
    batch (all rows otherwise), ``conv_x`` on its channels, ``ssm`` on its
    heads, ``conv_bc`` whole, and K/V in ``layout`` (``kv_layout``'s choice
    for ``batch`` by default): ``"heads"``, the KV heads its query heads
    read (``tp_heads``: a KV head that the model axis does not split is
    kept by every rank that reads it), or ``"kvseq"``, every KV head over
    this rank's slice of the rows (``kv_slice``).  ``gather_cache`` and
    ``shard_cache`` move between these layouts and the whole cache."""
    _require_ported(cfg)
    with use_stream(Stream(batch, 1)):
        rows = batch // _data_parts()
    conv = cfg.ssm.d_conv - 1 if cfg.ssm else 0
    if not _sliced(cfg, batch, layout):
        return _empty_cache(cfg, rows, max_seq, conv, require_device(device), dtype)
    _, n, _ = kv_slice(cfg, batch, max_seq)
    return _mark_kvseq(_empty_cache(cfg, rows, n, conv, require_device(device), dtype,
                                    all_kv=True), max_seq)


def kv_rows(cache: Cache) -> int:
    """The whole K/V rows of a ``kvseq`` cache under a mesh, whose tensors
    hold this rank's slice of them (a rank's tensors do not tell the whole
    length), as its K tensor records them; 0 for the heads layout or a
    cache without a mesh.  A new tensor (a copy, a move to another device)
    does not carry the record: such a cache is placed anew with
    ``shard_cache``."""
    return getattr(cache.k, "kv_rows", 0) if cache.k is not None else 0


def _mark_kvseq(cache: Cache, rows: int) -> Cache:
    """``cache``, its K tensor recording ``rows`` whole rows (``kv_rows``)."""
    cache.k.kv_rows = rows
    return cache


def kv_layout(cfg: ArchConfig, batch: int, mesh=None) -> str:
    """The K/V cache's layout for a global batch of ``batch`` rows on
    ``mesh`` (the bound one by default), by the reference's rule
    (``launch/dryrun.py::build_cell``): ``"heads"`` (K/V sharded by KV heads
    over the model axis) where ``REPRO_KV_HEAD_SHARD`` is ``"1"`` (its
    default), the model has K/V, its KV heads divide the model axis and the
    batch is above 1; otherwise ``"kvseq"``, ``cache_logical_axes``' layout.
    A cell then means the same layout in both packages."""
    mesh = mesh or current_mesh()
    mdl = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    if (os.environ.get("REPRO_KV_HEAD_SHARD", "1") == "1"
            and _n_attn_apps(cfg) and cfg.n_kv_heads % mdl == 0 and batch > 1):
        return "heads"
    return "kvseq"


def _sliced(cfg: ArchConfig, batch: int, layout: Optional[str]) -> bool:
    """Whether a cache of ``batch`` rows takes the ``kvseq`` layout under the
    bound mesh (``layout``, or ``kv_layout``'s choice)."""
    if layout not in (None, "heads", "kvseq"):
        raise ValueError(f"layout must be 'heads' or 'kvseq', got {layout!r}")
    if current_mesh() is None or not _n_attn_apps(cfg):
        return False
    return (layout or kv_layout(cfg, batch)) == "kvseq"


def kv_slice(cfg: ArchConfig, batch: int, rows: int) -> Tuple[int, int, Tuple[str, ...]]:
    """(first whole row, rows, mesh axes) of this rank's slice of a
    ``kvseq`` cache of ``rows`` rows and a global batch of ``batch``: the
    K/V spec ``cache_logical_axes`` gives under the bound mesh (the
    sequence split over whatever of (data, model) the batch leaves unused,
    the largest prefix of them that divides ``rows``)."""
    shape = (_n_attn_apps(cfg), batch, rows, cfg.n_kv_heads, cfg.head_dim)
    axes = spec_axes(logical_spec(cache_logical_axes(cfg).k, shape=shape)[2])
    i, n = rank_part(axes)
    return i * (rows // n), rows // n, axes


def cache_logical_axes(cfg: ArchConfig) -> Cache:
    """Logical sharding for the cache, as the reference's (used by its
    dry-run): K/V on the batch and the ``kvseq`` sequence axis, the SSM's
    conv history and state on the batch and ``d_inner`` / heads.

    The port executes both of the reference's K/V layouts, chosen by
    ``kv_layout``: this one (``kvseq``), where each rank holds every KV head
    over its slice of the rows, its attention reads the slice with
    ``decode_attention_lse`` and ``comm.merge_attention`` sums the slices'
    outputs by their log-sum-exp; and K/V by KV heads over the model axis,
    as ``build_cell`` places them where the KV heads divide the model axis
    and the batch is above 1, where each rank's attention reads its own
    heads and needs no merge.  The logits do not depend on the layout."""
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


def _data_parts() -> int:
    """Parts the bound stream's batch is split into (``batch_axes``)."""
    sizes = axis_sizes(current_mesh()) if current_mesh() is not None else {}
    return math.prod(sizes[a] for a in batch_axes())


def _first_row() -> int:
    """The global index of this rank's first batch row."""
    part = 0
    for a in batch_axes():
        _, n, r = comm.axis_group(a)
        part = part * n + r
    return part * (current_stream().batch // _data_parts())


def gather_cache(cache: Cache, cfg: ArchConfig, batch: int) -> Cache:
    """The whole cache of a global batch of ``batch`` rows on every rank,
    from each rank's shard (``init_cache``'s layouts under the bound mesh,
    the K/V one the cache records); the cache itself without a mesh.  For
    tests and checks: it moves every tensor through the collectives."""
    if current_mesh() is None:
        return cache
    g, d_inner, h = _local_widths(cfg)
    with use_stream(Stream(batch, 1)):
        axes = batch_axes()

    def rows(t):
        for a in reversed(axes):
            t = comm.all_gather_dim(t, 1, a)
        return t

    def heads(t, dim, local, whole):
        return t if local == whole else comm.all_gather_dim(t, dim, "model")

    out = {}
    if cache.k is not None and kv_rows(cache):
        seq = kv_slice(cfg, batch, kv_rows(cache))[2]
        for f in ("k", "v"):
            t = rows(getattr(cache, f))
            for a in reversed(seq):
                t = comm.all_gather_dim(t, 2, a)
            out[f] = t
    elif cache.k is not None:
        for f in ("k", "v"):
            out[f] = all_kv_heads(rows(getattr(cache, f)), cfg, 3)
    if cache.ssm is not None:
        whole = cfg.ssm.expand * cfg.d_model
        out.update(conv_x=heads(rows(cache.conv_x), 3, d_inner, whole),
                   conv_bc=rows(cache.conv_bc),
                   ssm=heads(rows(cache.ssm), 2, h, whole // cfg.ssm.head_dim))
    return cache._replace(**out)


def shard_cache(cache: Cache, cfg: ArchConfig, layout: Optional[str] = None) -> Cache:
    """This rank's shard (``init_cache``'s layouts under the bound mesh, K/V
    in ``layout``, ``kv_layout``'s choice by default) of a whole cache, the
    same on every rank: new tensors.  The inverse of ``gather_cache``."""
    if current_mesh() is None:
        return cache
    g, d_inner, h = _local_widths(cfg)
    r = comm.axis_group("model")[2]
    out = {}
    batch = (cache.k if cache.k is not None else cache.ssm).shape[1]
    with use_stream(Stream(batch, 1)):
        n, first = _data_parts(), _first_row()

    def part(t, dim, k):
        t = t.narrow(1, first, t.shape[1] // n)
        return t.narrow(dim, r * k, k) if k != t.shape[dim] else t

    sliced = cache.k is not None and _sliced(cfg, batch, layout)
    if sliced:
        s0, rows, _ = kv_slice(cfg, batch, cache.k.shape[2])
        out.update({f: getattr(cache, f).narrow(1, first, batch // n).narrow(2, s0, rows)
                    .clone() for f in ("k", "v")})
    elif cache.k is not None:
        g0 = tp_heads(cfg)[2]
        out.update({f: getattr(cache, f).narrow(1, first, cache.k.shape[1] // n)
                    .narrow(3, g0, g).clone() for f in ("k", "v")})
    if cache.ssm is not None:
        out.update(conv_x=part(cache.conv_x, 3, d_inner).clone(),
                   conv_bc=part(cache.conv_bc, 3, cache.conv_bc.shape[3]).clone(),
                   ssm=part(cache.ssm, 2, h).clone())
    shard = cache._replace(**out)
    return _mark_kvseq(shard, cache.k.shape[2]) if sliced else shard


def _data_rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """This rank's rows of a global batch under the bound stream: its data
    shard's where the data axes divide the batch, all of them otherwise."""
    if t is None or current_mesh() is None:
        return t
    return shard_tree(t, ("dp",) + (None,) * (t.dim() - 1))


def _whole_logits(logits: torch.Tensor) -> torch.Tensor:
    """This rank's logits (its rows, its vocabulary slice under a model
    axis) gathered whole: over the model axis on the vocabulary, then over
    the data axes that split the batch.  Every rank gets the same bits."""
    if model_size() > 1:
        logits = comm.all_gather_dim(logits, logits.dim() - 1, "model")
    for a in reversed(batch_axes()):
        logits = comm.all_gather_dim(logits, 0, a)
    return logits


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
    ``cache.pos`` is put back as it was.

    Under a bound mesh ``tokens`` and ``rows`` are the global batch's,
    ``cache`` is this rank's shard (``init_cache``) and the logits are whole
    on every rank (see the module docstring).  A cache in the ``kvseq``
    layout (``kv_rows``) is read as ``attention_block`` reads a
    ``kv_slice``: the new row written on the rank whose slice holds
    ``cache.pos``, each slice attended, the slices merged; a MoE step's
    put-back of the other rows' K/V at ``cache.pos`` is that rank's too."""
    _require_ported(cfg)
    batch = tokens.shape[0]
    with use_stream(Stream(batch, 1)):
        tokens, input_embeds = _data_rows(tokens), _data_rows(input_embeds)
        if rows is not None and current_mesh() is not None:
            first = _first_row()
            rows = [i - first for i in rows if first <= i < first + tokens.shape[0]]
        sliced = None
        if kv_rows(cache) and current_mesh() is not None:
            first_row, _, axes = kv_slice(cfg, batch, kv_rows(cache))
            sliced = (first_row, axes)
        logits = _decode(params, tokens, cache, cfg, input_embeds, rows, sliced)
        return _whole_logits(logits), cache._replace(pos=int(cache.pos) + 1)


def _decode(params, tokens, cache: Cache, cfg: ArchConfig, input_embeds, rows, sliced
            ) -> torch.Tensor:
    """``decode_step`` on this rank's rows (``rows`` among them), its cache's
    K/V a ``kvseq`` slice where ``sliced`` (``attention_block``'s
    ``kv_slice``): its logits."""
    b = tokens.shape[0]
    pos = int(cache.pos)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    cache_rows = cache_len = saved = None
    if rows is not None:
        cache_rows = torch.as_tensor(list(rows), dtype=torch.long, device=x.device)
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            x = x + _mamba_layer(_layer(params["layers"], i), x, cfg, cache, i, cache_rows)
        return lm_logits(params, x, cfg)
    # the cache row of position pos on this rank (None: another rank's)
    at = pos if sliced is None else pos - sliced[0]
    at = at if 0 <= at < (cache.k.shape[2] if cache.k is not None else 0) else None
    if cfg.family == MOE and rows is not None:
        group = set(rows)
        others = torch.as_tensor([i for i in range(b) if i not in group],
                                 dtype=torch.long, device=x.device)
        if at is not None:
            saved = others, cache.k[:, others, at], cache.v[:, others, at]
        cache_rows = None
    if cache_rows is not None:
        cache_len = torch.zeros((b,), dtype=torch.int32, device=x.device)
        cache_len[cache_rows] = pos + 1
    else:
        cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    attn = dict(cache_pos=pos, cache_rows=cache_rows, cache_len=cache_len,
                rope=block_rope_tables(cfg, b, 1, pos, x.device))
    if sliced is not None:
        attn["kv_slice"] = sliced
    if cfg.family == HYBRID:
        x = _hybrid_stack(params, x, cfg, cache, cache_rows, **attn)
        return lm_logits(params, x, cfg)
    for i, (la, ffn, fp, fl) in enumerate(_attn_layers(params, cfg)):
        x = _attn_mlp(la, fp, x, cfg, ffn=ffn, layer_is_local=fl,
                      kv_cache=(cache.k[i], cache.v[i]), **attn)
    if saved is not None:
        others, k, v = saved
        cache.k[:, others, at] = k
        cache.v[:, others, at] = v
    return lm_logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------
def prefill(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            pinned_rows: int = 0, layout: Optional[str] = None) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-token logits (B, V), a new cache sized and filled to S).
    ``pinned_rows`` is handed to the flash kernel of every attention call
    (dense and MoE layers, and each application of a hybrid's shared
    block).

    SSM and hybrid: every Mamba2 layer starts from a zero state, as in the
    reference; its conv history keeps the last ``min(S, d_conv - 1)`` rows of
    the prompt (all ``d_conv - 1`` for a 1-token prompt, which takes the
    decode branch).

    Under a bound mesh ``tokens`` are the global batch, the logits are
    whole on every rank and the cache is this rank's shard (``init_cache``'s
    layouts, K/V in ``layout``, ``kv_layout``'s choice for the batch by
    default).  In the ``kvseq`` layout the layers write K/V by heads, as in
    the other, and the prefill then gathers them over the model axis and
    keeps this rank's slice of the rows: for that moment a rank holds every
    KV head of every prompt row, the model axis' times its heads' share."""
    _require_ported(cfg)
    if positions is not None:
        raise NotImplementedError(POSITIONS_REFUSED)
    b, s = tokens.shape
    with use_stream(Stream(b, s)):
        tokens, input_embeds = _data_rows(tokens), _data_rows(input_embeds)
        x, cache = _prefill(params, tokens, cfg, input_embeds, pinned_rows)
        if cache.k is not None and _sliced(cfg, b, layout):
            s0, rows, _ = kv_slice(cfg, b, s)
            cache = _mark_kvseq(cache._replace(**{
                f: all_kv_heads(getattr(cache, f), cfg, 3).narrow(2, s0, rows).clone()
                for f in ("k", "v")}), s)
        last = x[:, -1:]
        if seq_sharded():
            # the last model rank holds the sequence's last row
            last = comm.all_gather_dim(last, 1, "model")[:, -1:]
        with use_stream(Stream(b, 1)):
            logits = _whole_logits(lm_logits(params, last, cfg))[:, 0]
    return logits, cache._replace(pos=s)


def _prefill(params, tokens, cfg: ArchConfig, input_embeds, pinned_rows: int
             ) -> Tuple[torch.Tensor, Cache]:
    """``prefill`` of this rank's rows: the residual stream after the last
    layer, and the cache it filled."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, input_embeds)
    conv = cfg.ssm.d_conv - 1 if cfg.ssm else 0
    cache = _empty_cache(cfg, b, s, conv if s == 1 else min(s, conv), x.device, x.dtype)
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            x = x + _mamba_layer(_layer(params["layers"], i), x, cfg, cache, i)
        return x, cache
    attn = dict(cache_pos=0, pinned_rows=pinned_rows,
                rope=block_rope_tables(cfg, b, s, 0, x.device))
    if cfg.family == HYBRID:
        return _hybrid_stack(params, x, cfg, cache, **attn), cache
    for i, (la, ffn, fp, fl) in enumerate(_attn_layers(params, cfg)):
        x = _attn_mlp(la, fp, x, cfg, ffn=ffn, layer_is_local=fl,
                      kv_cache=(cache.k[i], cache.v[i]), **attn)
    return x, cache
