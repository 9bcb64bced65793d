"""Transformer building blocks of the dense family, in PyTorch.

Plain functions on tensors; params are dicts of tensors with the JAX
package's keys and layouts (``wq (d, h, e)``, ``wk/wv (d, g, e)``,
``wo (h, e, d)``).  The large projections are ``torch.matmul`` on 2-D views
of those weights.  The attention core of ``attention_block`` is the two
hand-written kernels (flash attention for full sequences, decode attention
for one token against the cache); ``gqa_attention`` stays as the plain
oracle the tests hold them against.  The single-device serving path needs
no sharding hints, so the JAX package's ``constrain`` calls have no
counterpart here.
"""

from __future__ import annotations

import math
from typing import Optional
from typing import Tuple

import torch

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention


def init_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std²) weights drawn in fp32 from ``gen`` on its device, cast to
    ``dtype``, as the JAX package's ``(normal(key, shape) * std).astype(dtype)``."""
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def init_stacked(gen: torch.Generator, n_layers: int, shape, std: float,
                 dtype) -> torch.Tensor:
    """``init_normal`` of a leaf stacked on a leading layer axis, drawn one
    layer at a time into the ``dtype`` leaf, so that the fp32 draw never holds
    more than one layer (gemma2-27b's ``w_down`` in fp32 is 31.3 GB whole, 0.68
    GB a layer)."""
    out = torch.empty((n_layers,) + tuple(shape), dtype=dtype, device=gen.device)
    for i in range(n_layers):
        out[i] = init_normal(gen, shape, std, dtype)
    return out


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm in fp32, cast back; ``plus_one`` selects the Gemma convention
    ((1+w)·x̂, the sum taken in the weight's own type)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale) if plus_one else scale
    return (x * w.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + multimodal M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, ...]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(cos, sin)`` of the rotation angles, each (B, S, 1, D/2).

    ``positions``: (B, S) for standard RoPE, or (3, B, S) for Qwen2-VL
    M-RoPE, where the three planes carry temporal/height/width positions
    and ``mrope_sections`` gives the per-plane frequency-section sizes
    (in half-dims, summing to D/2).  The tables depend on the positions
    only, so a model call makes them once for all its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)      # (D/2,)
    if mrope_sections is None:
        angles = positions[..., None].float() * freqs          # (B,S,D/2)
    else:
        if positions.dim() == 2:                               # text-only fallback
            positions = positions[None].expand((3,) + tuple(positions.shape))
        parts = []
        start = 0
        for plane, sec in enumerate(mrope_sections):
            f = freqs[start:start + sec]
            parts.append(positions[plane][..., None].float() * f)
            start += sec
        angles = torch.cat(parts, dim=-1)                      # (B,S,D/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None, *,
               tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """Rotate ``x`` (..., S, H, D) by position-dependent angles (split-halves
    form, fp32 angles, result in ``x``'s type).  ``tables`` are
    ``rope_tables(positions, D, theta, mrope_sections)`` made ahead."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta, mrope_sections)
    cos, sin = tables
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; optional logit softcap and sliding window): plain oracle
# ---------------------------------------------------------------------------
def _soft_cap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  kv_positions: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention, plain PyTorch, fp32 scores and probabilities.

    q: (B, Sq, H, D); k/v: (B, Sk, G, D) with H % G == 0.
    ``q_positions``/``kv_positions``: (B, Sq)/(B, Sk) absolute positions for
    masking (required when Sq != Sk, i.e. decode); default = aranges.
    """
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    group = h // g
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, g, group, d)
    scores = torch.einsum("bsgqd,btgd->bgqst", qg.float(), k.float()) * scale
    scores = _soft_cap(scores, softcap)

    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, device=q.device).expand(b, sk)
    pos_q = q_positions[:, None, None, :, None]        # (b,1,1,sq,1)
    pos_k = kv_positions[:, None, None, None, :]       # (b,1,1,1,sk)
    mask = torch.ones((b, 1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (pos_k <= pos_q)
    if window is not None:
        mask = mask & (pos_k > pos_q - window)
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqst,btgd->bsgqd", probs, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention sub-block, with the kernels as its core
# ---------------------------------------------------------------------------
def attention_block(params, x, cfg, *, layer_is_local=None, positions=None,
                    kv_cache=None, cache_pos: Optional[int] = None,
                    cache_rows: Optional[torch.Tensor] = None,
                    cache_len: Optional[torch.Tensor] = None,
                    pinned_rows: int = 0,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full attention sub-block: norm → qkv → rope → attn → out-proj.

    Three modes, each ending in one kernel call:

    * no ``kv_cache``: causal flash attention over the sequence;
    * ``kv_cache=(k, v)`` (B, S_max, G, D), ``cache_pos == 0`` and more than
      one token (prefill): K/V are written to rows ``[0, s)`` of the cache
      and flash attention runs over those rows;
    * ``kv_cache`` and one token (decode): K/V are written at ``cache_pos``
      and decode attention runs over the cache with ``cache_len`` valid
      rows per sequence (default ``cache_pos + 1`` for every row).

    **The cache is updated in place**; the returned pair is the same two
    tensors.  ``cache_rows`` (a LongTensor of batch rows) limits the decode
    write to those rows, so a step for one group of slots leaves the K/V
    of the other slots untouched; the caller then passes ``cache_len`` 0
    for the rows it leaves out.  ``pinned_rows`` is the flash kernel's
    schedule parameter (see ``CacheOrchestrator.plan_kv_split``).  ``rope`` are
    the ``rope_tables`` of this call's positions, which a model makes once
    for all its layers; without them the block makes its own.

    A local layer (``layer_is_local`` with ``cfg.window``, gemma2's
    alternation) attends over the last ``cfg.window`` positions only, in both
    kernels; ``cfg.attn_softcap`` caps the scores in both.  What the two
    kernels do not compute raises ``NotImplementedError``: explicit
    ``positions`` (M-RoPE) and chunked prefill.  They belong to later slices
    of the port.
    """
    b, s, dm = x.shape
    if positions is not None:
        raise NotImplementedError(
            "explicit positions (M-RoPE) reach neither attention kernel yet; "
            "they come with the qwen2-vl slice of the port")
    window = cfg.window if layer_is_local and cfg.window is not None else None
    n_h, n_g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, params["ln"], plus_one=cfg.gemma_norm)
    q = torch.matmul(h, params["wq"].reshape(dm, n_h * hd)).view(b, s, n_h, hd)
    k = torch.matmul(h, params["wk"].reshape(dm, n_g * hd)).view(b, s, n_g, hd)
    v = torch.matmul(h, params["wv"].reshape(dm, n_g * hd)).view(b, s, n_g, hd)

    if rope is None:
        rope = block_rope_tables(cfg, b, s, cache_pos, x.device)
    q = apply_rope(q, None, cfg.rope_theta, tables=rope)
    k = apply_rope(k, None, cfg.rope_theta, tables=rope)

    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], plus_one=cfg.gemma_norm)
        k = rms_norm(k, params["k_norm"], plus_one=cfg.gemma_norm)
    scale = cfg.attn_scale or (1.0 / math.sqrt(cfg.head_dim))

    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True, scale=scale,
                              softcap=cfg.attn_softcap, window=window,
                              pinned_rows=pinned_rows)
        new_cache = None
    else:
        ck, cv = kv_cache
        if cache_pos is None:
            raise ValueError("kv_cache needs cache_pos")
        if s == 1:
            if cache_rows is None:
                ck[:, cache_pos] = k[:, 0].to(ck.dtype)
                cv[:, cache_pos] = v[:, 0].to(cv.dtype)
            else:
                ck[cache_rows, cache_pos] = k[cache_rows, 0].to(ck.dtype)
                cv[cache_rows, cache_pos] = v[cache_rows, 0].to(cv.dtype)
            if cache_len is None:
                cache_len = torch.full((b,), cache_pos + 1, dtype=torch.int32,
                                       device=x.device)
            out = decode_attention(q[:, 0], _as(ck, q.dtype), _as(cv, q.dtype),
                                   cache_len, scale=scale, window=window,
                                   softcap=cfg.attn_softcap)[:, None]
        else:
            if cache_pos != 0:
                raise NotImplementedError(
                    "chunked prefill (several tokens at cache_pos > 0) is not "
                    "ported: the flash kernel's causal mask needs Sq == Sk")
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
            out = flash_attention(q, _as(ck[:, :s], q.dtype), _as(cv[:, :s], q.dtype),
                                  causal=True, scale=scale, softcap=cfg.attn_softcap,
                                  window=window, pinned_rows=pinned_rows)
        new_cache = (ck, cv)

    out = torch.matmul(out.reshape(b, s, n_h * hd), params["wo"].reshape(n_h * hd, dm))
    return out, new_cache


def block_rope_tables(cfg, b: int, s: int, cache_pos: Optional[int], device):
    """``rope_tables`` for ``s`` tokens a sequence starting at ``cache_pos``
    (0 without a cache), as ``attention_block`` positions them."""
    pos = (torch.arange(s, device=device) + (cache_pos or 0)).expand(b, s)
    return rope_tables(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def _silu(x: torch.Tensor) -> torch.Tensor:
    """x · sigmoid(x) with the sigmoid written out as 1 / (1 + exp(-x)) in
    ``x``'s own type, each step rounded there, which is how the JAX package's
    ``jax.nn.silu`` comes out in bf16; a fused fp32 silu differs from it in
    the last bf16 bit of about a third of the activations."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu as ``jax.nn.gelu(approximate=True)``
    comes out in ``x``'s type: its constants rounded to that type first
    (0.044715 is 0.0446777 in bf16, sqrt(2/pi) 0.796875), x**3 as two
    products, each step rounded there.  ``F.gelu(approximate="tanh")``, which
    rounds once, differs from it in the last bf16 bit of about 40% of the
    activations."""
    k = x.new_tensor(0.044715)
    c = x.new_tensor(math.sqrt(2.0 / math.pi))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def mlp_block(params, x, cfg):
    h = rms_norm(x, params["ln"], plus_one=cfg.gemma_norm)
    gate = torch.matmul(h, params["w_gate"])
    up = torch.matmul(h, params["w_up"])
    act = _gelu_tanh(gate) if cfg.act == "gelu" else _silu(gate)
    return torch.matmul(act * up, params["w_down"])
