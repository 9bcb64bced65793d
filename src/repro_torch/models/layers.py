"""Transformer building blocks of the dense family, in PyTorch.

Plain functions on tensors; params are dicts of tensors with the JAX
package's keys and layouts (``wq (d, h, e)``, ``wk/wv (d, g, e)``,
``wo (h, e, d)``).  The large projections are ``torch.matmul`` on 2-D views
of those weights.  The attention core of ``attention_block`` is the two
hand-written kernels (flash attention for full sequences, decode attention
for one token against the cache); ``gqa_attention`` stays as the plain
oracle the tests hold them against.

Under a bound mesh with a model axis of more than one rank (tensor
parallelism, Megatron's split) each rank holds its shard of every weight, as
``train/sharding_rules.py`` lays them out: q/k/v and gate/up are
column-parallel over the heads and ``d_ff``, ``wo`` and ``w_down``
row-parallel, their partial products all-reduced.  The residual stream
between blocks is laid out by ``act_axes()``: ``d_model`` sharded over the
model axis, or with ``ACT_SEQ`` the sequence, where ``row_parallel_out``
reduce-scatters it.  Each ``constrain`` of the reference has its
counterpart at the same place, a move of local shards; the kernels always
receive plain local tensors: this rank's query heads and the KV heads they
read, or, decoding against a sequence-sharded cache (the ``kvseq`` layout,
``models.model.kv_layout``), every head over this rank's slice of rows,
whose partial outputs ``comm.merge_attention`` sums across the ranks.
"""

from __future__ import annotations

import math
from typing import Optional
from typing import Tuple

import torch

from ..kernels.decode_attention import decode_attention
from ..kernels.decode_attention import decode_attention_lse
from ..kernels.flash_attention import flash_attention
from ..sharding import comm
from ..sharding.api import ACT_SEQ
from ..sharding.api import act_axes
from ..sharding.api import constrain
from ..sharding.api import current_mesh
from ..sharding.api import model_size
from ..sharding.api import seq_sharded

# why ``attention_block``, ``forward`` and ``prefill`` refuse explicit
# positions: text-only positions (the default) are the rows' own indices
POSITIONS_REFUSED = (
    "explicit positions are refused: both attention kernels mask by row index "
    "(causal over the sequence's rows, a decode step's keys below cache_len), not "
    "by position ids, and the JAX package's forward and prefill fail on M-RoPE's "
    "3-plane (3, B, S) positions, so no reference holds such a run")


def init_normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """N(0, std²) weights drawn in fp32 from ``gen`` on its device, cast to
    ``dtype``, as the JAX package's ``(normal(key, shape) * std).astype(dtype)``.
    On the meta device (``make_generator(seed, "meta")``) the shape only."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def init_stacked(gen: torch.Generator, n_layers: int, shape, std: float,
                 dtype) -> torch.Tensor:
    """``init_normal`` of a leaf stacked on a leading layer axis, drawn one
    layer at a time into the ``dtype`` leaf, so that the fp32 draw never holds
    more than one layer (gemma2-27b's ``w_down`` in fp32 is 31.3 GB whole, 0.68
    GB a layer)."""
    out = torch.empty((n_layers,) + tuple(shape), dtype=dtype, device=gen.device)
    for i in range(n_layers if gen.device.type != "meta" else 0):
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
# Tensor parallelism: the residual stream's layout and the block's edges
# ---------------------------------------------------------------------------
def resid_shape(x: torch.Tensor, cfg) -> Tuple[int, int, int]:
    """The whole shape over the model axis of ``x``, this rank's part of the
    residual stream (its batch rows are its data shard's): the sequence is
    sharded where ``seq_sharded()`` says (``ACT_SEQ`` and a whole sequence
    that the model axis divides; a decode call's one token stays whole), and
    ``d_model`` is ``cfg.d_model``."""
    b, s, _ = x.shape
    return b, (s * model_size() if seq_sharded() else s), cfg.d_model


def resid_norm(x: torch.Tensor, scale: torch.Tensor, cfg) -> torch.Tensor:
    """``rms_norm(x, scale)`` of the residual stream's local part ``x``.
    ``d_model`` sharded (``act_axes()``'s ``tp_act``): the sum of squares is
    all-reduced and each rank scales by its slice of ``scale``.  The sequence
    sharded (``ACT_SEQ``): each rank's rows alone, and the gradient of the
    whole ``scale`` summed over the ranks (``comm.copy_to``)."""
    if model_size() == 1:
        return rms_norm(x, scale, plus_one=cfg.gemma_norm)
    whole = resid_shape(x, cfg)
    if x.shape[2] != whole[2]:
        dtype = x.dtype
        xf = x.float()
        var = comm.all_sum(xf.square().sum(dim=-1, keepdim=True)) / whole[2]
        xf = xf * torch.rsqrt(var + 1e-6)
        w = constrain(scale, ("tp_act",))
        w = (1.0 + w) if cfg.gemma_norm else w
        return (xf * w.float()).to(dtype)
    if x.shape[1] != whole[1]:
        scale = comm.copy_to(scale)
    return rms_norm(x, scale, plus_one=cfg.gemma_norm)


def tp_input(h: torch.Tensor, cfg, like: torch.Tensor) -> torch.Tensor:
    """The reference's ``constrain(h, ("dp", None, None))`` before the
    column-parallel products: the normed residual ``h`` (laid out as the
    stream ``like`` is) gathered whole on every rank of the model axis,
    whose gradient then sums every rank's partial one (``comm.copy_to``)."""
    if model_size() == 1:
        return h
    h = constrain(h, ("dp", None, None), have=act_axes(), shape=resid_shape(like, cfg))
    return comm.copy_to(h)


def tp_output(part: torch.Tensor, cfg) -> torch.Tensor:
    """The row-parallel product's partial sums ``part`` (B, S, d_model), one
    per rank of the model axis, all-reduced and laid out as the residual
    stream: the reference's ``einsum`` and ``constrain(out, act_axes())``."""
    if model_size() == 1:
        return part
    return constrain(comm.reduce_from(part), act_axes())


def tp_heads(cfg) -> Tuple[int, int, int]:
    """(query heads a rank, KV heads a rank, first KV head of this rank) under
    the bound mesh's model axis.  ``wq`` is sharded by heads; ``wk``/``wv``
    are sharded where the model axis divides the KV heads, and otherwise
    (``logical_spec``'s divisibility filter) stay whole and each rank uses the
    one KV head its query heads read."""
    m = model_size()
    h, g = cfg.n_heads, cfg.n_kv_heads
    if m == 1:
        return h, g, 0
    r = comm.axis_group("model")[2]
    if h % m:
        raise NotImplementedError(
            f"{h} query heads do not split over a model axis of {m} ranks: tensor "
            "parallelism shards attention by heads")
    if g % m == 0:
        return h // m, g // m, r * (g // m)
    group = h // g
    if group % (h // m):
        raise NotImplementedError(
            f"{h // m} query heads a rank straddle the KV groups of {group}")
    return h // m, 1, r * (h // m) // group


def kv_holders(cfg):
    """The first model rank that holds each KV head, for a model axis that
    does not divide the KV heads (each rank holds one, ``tp_heads``)."""
    m, h, g = model_size(), cfg.n_heads, cfg.n_kv_heads
    held = [r * (h // m) // (h // g) for r in range(m)]
    return [held.index(j) for j in range(g)]


def all_kv_heads(t: torch.Tensor, cfg, dim: int) -> torch.Tensor:
    """Every KV head of ``t``, this rank's KV heads (``tp_heads``) on
    ``dim``: gathered over the model axis, and where the axis does not
    divide the KV heads, the first copy of each kept."""
    if model_size() == 1:
        return t
    t = comm.all_gather_dim(t, dim, "model")
    if t.shape[dim] == cfg.n_kv_heads:
        return t
    return t.index_select(dim, torch.tensor(kv_holders(cfg), device=t.device))


def row_parallel_out(y: torch.Tensor, w: torch.Tensor) -> Optional[torch.Tensor]:
    """Megatron-SP row-parallel output projection, as the reference's.

    y (B, S, F/model) is this rank's shard of F; w (F/model, D) its rows.
    Computes the partial product and **reduce-scatters over the sequence**,
    so that the residual stream leaves the block sequence-sharded
    (``ACT_SEQ``).  Returns ``None`` where the reference's does: without
    ``ACT_SEQ`` or a mesh, with one rank on the model axis, or where the
    model axis does not divide the sequence (the caller then all-reduces
    and lays the sum out as ``act_axes()`` says)."""
    mesh = current_mesh()
    if not ACT_SEQ[0] or mesh is None:
        return None
    mdl = model_size(mesh)
    if mdl <= 1 or y.shape[1] % mdl:
        return None
    return comm.reduce_scatter(torch.matmul(y, w), 1)


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
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_slice: Optional[Tuple[int, Tuple[str, ...]]] = None):
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

    ``kv_slice = (first row, mesh axes)`` (decode only): the cache is this
    rank's slice of a sequence-sharded one (``kvseq``), every KV head over
    whole rows [first, first + S_max) of a sequence split over the mesh
    axes; ``cache_pos`` and ``cache_len`` count whole rows.  The new row's
    K/V heads are gathered over the model axis and written on the rank
    whose slice holds ``cache_pos``; the query heads are gathered, attend
    the slice (``decode_attention_lse``), and the slices' outputs are merged
    across the axes (``comm.merge_attention``); this rank keeps its own
    query heads for the row-parallel ``wo``.

    A local layer (``layer_is_local`` with ``cfg.window``, gemma2's
    alternation) attends over the last ``cfg.window`` positions only, in both
    kernels; ``cfg.attn_softcap`` caps the scores in both.  What the two
    kernels do not compute raises ``NotImplementedError``: explicit
    ``positions`` (``POSITIONS_REFUSED`` says why) and chunked prefill.
    """
    if positions is not None:
        raise NotImplementedError(POSITIONS_REFUSED)
    window = cfg.window if layer_is_local and cfg.window is not None else None
    n_h, n_g, g0 = tp_heads(cfg)
    hd = cfg.head_dim
    wk, wv = params["wk"], params["wv"]
    if wk.shape[-2] != n_g:
        # whole K/V weights: this rank's KV head, the gradient summed over ranks
        wk, wv = (comm.copy_to(w)[:, g0:g0 + n_g] for w in (wk, wv))
    h = resid_norm(x, params["ln"], cfg)
    h = tp_input(h, cfg, x)
    b, s, dm = h.shape
    q = torch.matmul(h, params["wq"].reshape(dm, n_h * hd)).view(b, s, n_h, hd)
    k = torch.matmul(h, wk.reshape(dm, n_g * hd)).view(b, s, n_g, hd)
    v = torch.matmul(h, wv.reshape(dm, n_g * hd)).view(b, s, n_g, hd)
    # the reference's constrain(q/k/v, ("dp", None, "tp", None)): this rank's
    # heads are what the column-parallel products made

    if rope is None:
        rope = block_rope_tables(cfg, b, s, cache_pos, x.device)
    q = apply_rope(q, None, cfg.rope_theta, tables=rope)
    k = apply_rope(k, None, cfg.rope_theta, tables=rope)

    if cfg.qk_norm:
        q = rms_norm(q, comm.copy_to(params["q_norm"]), plus_one=cfg.gemma_norm)
        k = rms_norm(k, comm.copy_to(params["k_norm"]), plus_one=cfg.gemma_norm)
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
        if s == 1 and kv_slice is not None:
            out = _decode_slice(q, k, v, ck, cv, cfg, kv_slice, cache_pos, cache_rows,
                                cache_len, scale=scale, window=window)
        elif s == 1:
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

    wo = params["wo"].reshape(n_h * hd, dm)
    rp = row_parallel_out(out.reshape(b, s, n_h * hd), wo)
    if rp is not None:
        return rp, new_cache
    out = torch.matmul(out.reshape(b, s, n_h * hd), wo)
    return tp_output(out, cfg), new_cache


def _decode_slice(q, k, v, ck, cv, cfg, kv_slice, cache_pos: int, cache_rows, cache_len,
                  *, scale: float, window: Optional[int]) -> torch.Tensor:
    """``attention_block``'s decode against a ``kvseq`` cache slice ``ck`` /
    ``cv`` (B, S_max, G, D): this rank's query heads' output (B, 1, n_h, D)."""
    first, axes = kv_slice
    n_h = q.shape[2]
    q_all = comm.all_gather_dim(q[:, 0], 1, "model") if model_size() > 1 else q[:, 0]
    k_all, v_all = all_kv_heads(k[:, 0], cfg, 1), all_kv_heads(v[:, 0], cfg, 1)
    p = cache_pos - first
    if 0 <= p < ck.shape[1]:   # this rank's slice holds the new row
        if cache_rows is None:
            ck[:, p] = k_all.to(ck.dtype)
            cv[:, p] = v_all.to(cv.dtype)
        else:
            ck[cache_rows, p] = k_all[cache_rows].to(ck.dtype)
            cv[cache_rows, p] = v_all[cache_rows].to(cv.dtype)
    if cache_len is None:
        cache_len = torch.full((q.shape[0],), cache_pos + 1, dtype=torch.int32,
                               device=q.device)
    o, lse = decode_attention_lse(q_all, _as(ck, q.dtype), _as(cv, q.dtype), cache_len,
                                  row_offset=first, scale=scale, window=window,
                                  softcap=cfg.attn_softcap)
    o = comm.merge_attention(o, lse, axes, q.dtype)
    r = comm.axis_group("model")[2]
    return o[:, r * n_h:(r + 1) * n_h][:, None]


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
    """Norm, gate/up (column-parallel under a model axis: this rank's
    ``d_ff`` columns, the reference's ``constrain(gate, ("dp", None,
    "tp"))``), then ``w_down`` (row-parallel)."""
    m = model_size()
    if m > 1 and params["w_down"].shape[0] * m != cfg.d_ff:
        raise NotImplementedError(
            f"d_ff {cfg.d_ff} does not split over a model axis of {m} ranks")
    h = tp_input(resid_norm(x, params["ln"], cfg), cfg, x)
    gate = torch.matmul(h, params["w_gate"])
    up = torch.matmul(h, params["w_up"])
    act = _gelu_tanh(gate) if cfg.act == "gelu" else _silu(gate)
    rp = row_parallel_out(act * up, params["w_down"])
    if rp is not None:
        return rp
    return tp_output(torch.matmul(act * up, params["w_down"]), cfg)
