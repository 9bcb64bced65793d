"""Plain PyTorch version of the flash-attention kernel (no tiling, fp32)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, G, D); returns (B, Sq, H, D).  Scores and
    probabilities are fp32; the causal mask puts the last query on the last
    key (``tril`` shifted by ``Sk - Sq``)."""
    b, sq, h, d = q.shape
    _, sk, g, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, g, h // g, d).float()
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqst,btgd->bsgqd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
