"""Plain PyTorch version of decode attention (one token vs a KV cache)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         cache_len: torch.Tensor, *,
                         scale: Optional[float] = None,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, H, D); k/v (B, S, G, D); cache_len (B,) valid prefix lengths.
    Returns (B, H, D).  Scores and probabilities are fp32.  Row t of a
    sequence of length n is live iff ``t < n`` and, with a ``window``,
    ``t >= n - window`` (the JAX package's ``pos_k > pos_q - window`` for the
    query at position n - 1); dead rows carry no weight, and a sequence with
    ``cache_len == 0`` gives zeros, as the kernel does (``acc / max(l, 1e-30)``
    with nothing accumulated).  The softcap, ``tanh(s / cap) * cap``, is
    applied to the scaled scores before the mask."""
    b, h, d = q.shape
    _, s, g, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, g, h // g, d).float()
    sc = torch.einsum("bgqd,btgd->bgqt", qg, k.float()) * scale
    if softcap is not None:
        sc = torch.tanh(sc / softcap) * softcap
    t = torch.arange(s, device=q.device)[None, None, None, :]
    n = cache_len.to(q.device).clamp(0, s)[:, None, None, None]   # as the kernel reads it
    valid = t < n
    if window is not None:
        valid = valid & (t >= n - window)
    sc = torch.where(valid, sc, torch.full_like(sc, -1e30))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(sc - m), torch.zeros_like(sc))
    # dead rows may hold anything (inf, nan): keep them out of the product
    vz = torch.where(valid[:, 0, 0, :, None, None], v.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bgqt,btgd->bgqd", p, vz)
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, d).to(q.dtype)
