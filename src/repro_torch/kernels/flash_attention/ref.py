"""Plain PyTorch version of the flash-attention kernel (no tiling, fp32)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, G, D); returns (B, Sq, H, D).  Scores and
    probabilities are fp32; the causal mask puts the last query on the last
    key (``tril`` shifted by ``Sk - Sq``).  With a ``window``, query i (at
    position i + Sk - Sq) sees only keys at positions above its own less the
    window, as the JAX package's ``pos_k > pos_q - window``; the softcap
    comes before the masks."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, g, h // g, d).float()
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    pos_q = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    pos_k = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    if causal or window is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqst,btgd->bsgqd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
