"""Model assembly of the port: init / forward / prefill / decode.

The dense family is ported (llama3.2-3b and the other dense configs
without a sliding window); MoE, SSM and hybrid families raise
``NotImplementedError`` naming the slice that brings them.

Design notes
------------
* Parameters are dicts of tensors with the JAX package's keys; per-layer
  leaves are stacked along a leading layer axis, and the layer stack is a
  Python loop that indexes that axis (views, no copies).
* ``tie_embeddings`` is intent only, as in the JAX package: ``lm_head`` is
  always a separate parameter.
* **The KV cache is updated in place.**  ``prefill`` allocates a
  prompt-sized cache and fills it; ``decode_step`` writes one row into the
  cache it is given and returns a ``Cache`` that holds the same tensors.
* Entry points take an explicit ``device`` (default the card) and raise
  where it is absent; random weights come from an explicit
  ``torch.Generator`` on that device.
"""

from __future__ import annotations

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
from .layers import mlp_block
from .layers import rms_norm

DTYPE = torch.bfloat16

_LATER = {
    MOE: "the MoE family (moe_ffn, expert routing) is a later slice of the port",
    SSM: "the SSM family (mamba2_block, the SSD scan kernel) is a later slice of the port",
    HYBRID: "the hybrid family (mamba2 groups + shared attention) is a later slice of the port",
}


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(_LATER.get(cfg.family, f"unknown family {cfg.family!r}"))


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def make_generator(seed: int, device="cuda") -> torch.Generator:
    """A seeded generator on ``device`` for ``init_params``."""
    gen = torch.Generator(device=require_device(device))
    gen.manual_seed(seed)
    return gen


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def _ln_init(cfg: ArchConfig, shape, device, dtype) -> torch.Tensor:
    make = torch.zeros if cfg.gemma_norm else torch.ones
    return make(shape, dtype=dtype, device=device)


def _init_attn(gen, cfg: ArchConfig, n_layers: int, dtype):
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = d ** -0.5
    p = {
        "ln": _ln_init(cfg, (n_layers, d), gen.device, dtype),
        "wq": _normal(gen, (n_layers, d, h, hd), s, dtype),
        "wk": _normal(gen, (n_layers, d, g, hd), s, dtype),
        "wv": _normal(gen, (n_layers, d, g, hd), s, dtype),
        "wo": _normal(gen, (n_layers, h, hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = _ln_init(cfg, (n_layers, hd), gen.device, dtype)
        p["k_norm"] = _ln_init(cfg, (n_layers, hd), gen.device, dtype)
    return p


def _init_mlp(gen, cfg: ArchConfig, n_layers: int, d_ff: int, dtype):
    d = cfg.d_model
    return {
        "ln": _ln_init(cfg, (n_layers, d), gen.device, dtype),
        "w_gate": _normal(gen, (n_layers, d, d_ff), d ** -0.5, dtype),
        "w_up": _normal(gen, (n_layers, d, d_ff), d ** -0.5, dtype),
        "w_down": _normal(gen, (n_layers, d_ff, d), d_ff ** -0.5, dtype),
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda", dtype=DTYPE) -> Dict[str, Any]:
    """Random parameters in the JAX package's tree layout, made on the device
    of ``generator`` (or of a new generator seeded with ``seed`` on
    ``device``)."""
    _require_dense(cfg)
    gen = generator if generator is not None else make_generator(seed, device)
    d, v = cfg.d_model, cfg.vocab
    return {
        "embed": _normal(gen, (v, d), d ** -0.5, dtype),
        "ln_f": _ln_init(cfg, (d,), gen.device, dtype),
        "lm_head": _normal(gen, (d, v), d ** -0.5, dtype),
        "layers": {
            "attn": _init_attn(gen, cfg, cfg.n_layers, dtype),
            "mlp": _init_mlp(gen, cfg, cfg.n_layers, cfg.d_ff, dtype),
        },
    }


def local_flags(cfg: ArchConfig, n_layers: Optional[int] = None) -> Tuple[bool, ...]:
    n = n_layers if n_layers is not None else cfg.n_layers
    if cfg.local_global_period is None or cfg.window is None:
        return (False,) * n
    # every `period`-th layer is global; the rest use the sliding window
    return tuple((i % cfg.local_global_period) != (cfg.local_global_period - 1)
                 for i in range(n))


def _layer(tree, i: int):
    return {k: v[i] for k, v in tree.items()}


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
    _require_dense(cfg)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    rope = block_rope_tables(cfg, x.shape[0], x.shape[1], None, x.device)
    layers = params["layers"]
    for i, fl in enumerate(local_flags(cfg)):
        a, _ = attention_block(_layer(layers["attn"], i), x, cfg, layer_is_local=fl,
                               positions=positions, rope=rope)
        x = x + a
        x = x + mlp_block(_layer(layers["mlp"], i), x, cfg)
    return lm_logits(params, x, cfg)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
class Cache(NamedTuple):
    """Attention K/V stacked over layers, and the next position.  The SSM
    fields keep the JAX package's names and stay ``None`` for the dense family."""
    k: Optional[torch.Tensor] = None          # (L, B, S, G, hd)
    v: Optional[torch.Tensor] = None
    conv_x: Optional[torch.Tensor] = None
    conv_bc: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    pos: int = 0                              # next position (a Python int)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device="cuda",
               dtype=DTYPE) -> Cache:
    _require_dense(cfg)
    dev = require_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return Cache(k=torch.zeros(shape, dtype=dtype, device=dev),
                 v=torch.zeros(shape, dtype=dtype, device=dev), pos=0)


# ---------------------------------------------------------------------------
# Decode step (one new token against the cache)
# ---------------------------------------------------------------------------
def decode_step(params, tokens, cache: Cache, cfg: ArchConfig, *,
                input_embeds: Optional[torch.Tensor] = None,
                rows: Optional[Sequence[int]] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, 1) → (logits (B, 1, V), cache advanced by one position).

    Writes K/V at ``cache.pos`` **into the cache's own tensors**.  With
    ``rows`` (batch indices) only those sequences write their K/V and attend
    (over ``cache.pos + 1`` rows); the others keep their cache untouched,
    attend over nothing, and their logits mean nothing."""
    _require_dense(cfg)
    b = tokens.shape[0]
    pos = int(cache.pos)
    x = embed_tokens(params, tokens, cfg, input_embeds)
    cache_rows = cache_len = None
    if rows is not None:
        cache_rows = torch.as_tensor(list(rows), dtype=torch.long, device=x.device)
        cache_len = torch.zeros((b,), dtype=torch.int32, device=x.device)
        cache_len[cache_rows] = pos + 1
    else:
        cache_len = torch.full((b,), pos + 1, dtype=torch.int32, device=x.device)
    rope = block_rope_tables(cfg, b, 1, pos, x.device)
    layers = params["layers"]
    for i, fl in enumerate(local_flags(cfg)):
        a, _ = attention_block(_layer(layers["attn"], i), x, cfg, layer_is_local=fl,
                               kv_cache=(cache.k[i], cache.v[i]), cache_pos=pos,
                               cache_rows=cache_rows, cache_len=cache_len, rope=rope)
        x = x + a
        x = x + mlp_block(_layer(layers["mlp"], i), x, cfg)
    return lm_logits(params, x, cfg), cache._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# Prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------
def prefill(params, tokens, cfg: ArchConfig, *,
            positions: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            pinned_rows: int = 0) -> Tuple[torch.Tensor, Cache]:
    """Returns (last-token logits (B, V), a new cache sized and filled to S).
    ``pinned_rows`` is handed to the flash kernel of every layer."""
    _require_dense(cfg)
    if positions is not None:
        raise NotImplementedError(
            "explicit positions (M-RoPE) come with the qwen2-vl slice of the port")
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg, input_embeds)
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    rope = block_rope_tables(cfg, b, s, 0, x.device)
    layers = params["layers"]
    for i, fl in enumerate(local_flags(cfg)):
        a, _ = attention_block(_layer(layers["attn"], i), x, cfg, layer_is_local=fl,
                               kv_cache=(ck[i], cv[i]), cache_pos=0,
                               pinned_rows=pinned_rows, rope=rope)
        x = x + a
        x = x + mlp_block(_layer(layers["mlp"], i), x, cfg)
    logits = lm_logits(params, x[:, -1:], cfg)[:, 0]
    return logits, Cache(k=ck, v=cv, pos=s)
