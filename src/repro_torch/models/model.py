"""Model assembly of the port: init / forward / prefill / decode.

All four families are ported: dense (llama3.2-3b, gemma2-27b with its
sliding window on local layers and its logit softcaps, and the other dense
configs), MoE (deepseek-moe-16b: ``first_dense``
dense layers, then attention + MoE FFN layers), SSM (mamba2-2.7b) and hybrid
(zamba2-7b: groups of Mamba2 layers, each followed by one weight-shared
attention + MLP block, and a tail of Mamba2 layers).

Design notes
------------
* Parameters are dicts of tensors with the JAX package's keys; per-layer
  leaves are stacked along a leading layer axis, and the layer stack is a
  Python loop that indexes that axis (views, no copies).
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
  ``torch.Generator`` on that device.
"""

from __future__ import annotations

from functools import partial
import math
from typing import Any
from typing import Dict
from typing import NamedTuple
from typing import Optional
from typing import Sequence
from typing import Tuple

import torch

from .. import require_device
from ..configs import ArchConfig
from ..configs import DENSE
from ..configs import HYBRID
from ..configs import MOE
from ..configs import SSM
from .layers import attention_block
from .layers import block_rope_tables
from .layers import init_normal
from .layers import init_stacked
from .layers import mlp_block
from .layers import rms_norm
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


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A seeded generator on ``device`` for ``init_params``."""
    gen = torch.Generator(device=require_device(device))
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


def _attn_layers(params, cfg: ArchConfig):
    """(attention params, FFN, FFN params, local flag) of each layer of a
    dense or MoE model, in the order of the K/V cache's layer axis: a MoE
    model's ``first_dense`` dense layers, then its MoE layers."""
    if cfg.family == MOE:
        nd = cfg.moe.first_dense
        stacks = [(params["moe_layers"], "moe", partial(moe_ffn, spec=cfg.moe),
                   (False,) * (cfg.n_layers - nd))]
        if nd:
            stacks.insert(0, (params["dense_layers"], "mlp", mlp_block, local_flags(cfg, nd)))
    else:
        stacks = [(params["layers"], "mlp", mlp_block, local_flags(cfg))]
    for layers, kind, ffn, flags in stacks:
        for i, fl in enumerate(flags):
            yield _layer(layers["attn"], i), ffn, _layer(layers[kind], i), fl


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_tokens(params, tokens, cfg: ArchConfig,
                 input_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    if input_embeds is not None:
        x = input_embeds.to(params["embed"].dtype)
    else:
        x = params["embed"][tokens]
    if cfg.gemma_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def lm_logits(params, x, cfg: ArchConfig) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], plus_one=cfg.gemma_norm)
    logits = torch.matmul(x, params["lm_head"])
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


# ---------------------------------------------------------------------------
# Forward (full sequence, no cache)
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    _require_ported(cfg)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    if cfg.family == SSM:
        for i in range(cfg.n_layers):
            x = x + _mamba_layer(_layer(params["layers"], i), x, cfg, None, i)
        return lm_logits(params, x, cfg)
    rope = block_rope_tables(cfg, x.shape[0], x.shape[1], None, x.device)
    if cfg.family == HYBRID:
        return lm_logits(params, _hybrid_stack(params, x, cfg, rope=rope,
                                               positions=positions), cfg)
    for attn, ffn, fp, fl in _attn_layers(params, cfg):
        x = _attn_mlp(attn, fp, x, cfg, ffn=ffn, layer_is_local=fl, positions=positions,
                      rope=rope)
    return lm_logits(params, x, cfg)


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
                  rows: Optional[torch.Tensor] = None, **attn_kw) -> torch.Tensor:
    """The reference's ``_hybrid_stack`` / ``_hybrid_prefill`` /
    ``_hybrid_decode`` in one loop: each group's ``hybrid_period`` Mamba2
    layers, then the weight-shared attention + MLP block (application ``a``
    reads and writes K/V slice ``a`` of the cache); the tail's Mamba2 layers
    after the last group.  Mamba2 layer ``i`` of ``n_layers`` uses conv and
    state slice ``i``.  ``attn_kw`` go to every ``attention_block`` call."""
    period = cfg.hybrid_period
    n_groups = cfg.n_layers // period
    groups = params["mamba_groups"]
    tail = params.get("mamba_tail", {})
    for a in range(n_groups):
        for j in range(period):
            p = {k: v[a, j] for k, v in groups.items()}
            x = x + _mamba_layer(p, x, cfg, cache, a * period + j, rows)
        kv = None if cache is None else (cache.k[a], cache.v[a])
        x = _attn_mlp(params["shared_attn"], params["shared_mlp"], x, cfg,
                      kv_cache=kv, **attn_kw)
    for j in range(cfg.n_layers - n_groups * period):
        x = x + _mamba_layer(_layer(tail, j), x, cfg, cache, n_groups * period + j, rows)
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
