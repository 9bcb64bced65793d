"""Plain PyTorch versions of the flash-attention kernels (no tiling, fp32):
the forward, with the per-row log-sum-exp it can also give, and the
FlashAttention-2 backward written out."""

from __future__ import annotations

import math
from typing import Optional
from typing import Tuple

import torch


def _mask(sq: int, sk: int, causal: bool, window: Optional[int], device) -> torch.Tensor:
    """(Sq, Sk) True where query i (at position i + Sk - Sq) sees key j."""
    pos_q = torch.arange(sq, device=device)[:, None] + (sk - sq)
    pos_k = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None,
                  return_lse: bool = False):
    """q (B, Sq, H, D); k/v (B, Sk, G, D); returns (B, Sq, H, D).  Scores and
    probabilities are fp32; the causal mask puts the last query on the last
    key (``tril`` shifted by ``Sk - Sq``).  With a ``window``, query i (at
    position i + Sk - Sq) sees only keys at positions above its own less the
    window, as the JAX package's ``pos_k > pos_q - window``; the softcap
    comes before the masks.

    ``return_lse``: also the natural log-sum-exp of each row's scaled,
    capped and masked scores, (B, H, Sq) fp32, as the forward kernel writes
    it for the backward."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, g, h // g, d).float()
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal or window is not None:
        s = s.masked_fill(~_mask(sq, sk, causal, window, q.device), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqst,btgd->bsgqd", p, v.float())
    o = o.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True, scale: Optional[float] = None,
                      softcap: Optional[float] = None, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FlashAttention-2 backward of ``attention_ref``, in fp32 from the
    forward's output ``o`` and log-sum-exp ``lse`` (B, H, Sq), the natural
    log-sum-exp of the scaled, capped and masked scores: with S the unscaled
    scores, s = S·scale and s_c = softcap·tanh(s / softcap) (s_c = s
    without a softcap),

        Δ = rowsum(dO ∘ O),  P = exp(s_c − lse),  dV = Pᵀ dO,
        dP = dO Vᵀ,  dS = P ∘ (dP − Δ) ∘ (1 − (s_c / softcap)²),
        dQ = dS K·scale,  dK = dSᵀ Q·scale,

    P 0 where the causal mask or the ``window`` (as ``_mask``) hides the
    pair, and the softcap's factor 1 without one; dK and dV summed over the
    query heads of each KV head's group.  Returns (dq, dk, dv) in the
    inputs' types.  It is the oracle the backward kernel is held against."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    grp = h // g
    qg = q.reshape(b, sq, g, grp, d).float()
    dog = do.reshape(b, sq, g, grp, d).float()
    og = o.reshape(b, sq, g, grp, d).float()
    kf, vf = k.float(), v.float()
    delta = (dog * og).sum(-1)                                    # (b, sq, g, grp)
    s = torch.einsum("bsgqd,btgd->bgqst", qg, kf) * scale
    cap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, cap = t * softcap, 1.0 - t * t
    p = torch.exp(s - lse.float().reshape(b, g, grp, sq, 1))
    if causal or window is not None:
        p = p.masked_fill(~_mask(sq, sk, causal, window, q.device), 0.0)
    dv = torch.einsum("bgqst,bsgqd->btgd", p, dog)
    dp = torch.einsum("bsgqd,btgd->bgqst", dog, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    if cap is not None:
        ds = ds * cap
    dq = torch.einsum("bgqst,btgd->bsgqd", ds, kf) * scale
    dk = torch.einsum("bgqst,bsgqd->btgd", ds, qg) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
