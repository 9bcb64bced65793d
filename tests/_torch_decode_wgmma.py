"""The bf16 decode kernel's arithmetic in plain torch (csrc/decode_attention.cu,
``decode_wgmma_kernel``), for the CPU tests: its work map (``WgmmaPlan``: the
blocks of a (batch row, KV head) and their 64-row tiles from the first live
row, cut per call from all the lengths), the scores of each tile in fp32,
scaled into log2 units (or capped), one max and one rescale a tile, P
rounded to the value type before P V and l summed from the unrounded P, and
the partials of the blocks with rows merged in block order with the weights
2^(m_u - M) / sum_u l_u 2^(m_u - M).  Run on fp32 inputs it is the same map
and merge with P unrounded."""

from __future__ import annotations

import math

from repro_torch.kernels.decode_attention import ops as decode_ops
import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def emulate_wgmma(q, k, v, cache_len, *, rows_per_split=None, sm_count=132, window=None,
                  softcap=None, scale=None, row_offset=None):
    """(B, H, D) in q's type; with ``row_offset`` (the slice kernel) the fp32
    output and each row's natural-log log-sum-exp (-inf and zeros where the
    slice holds no live row)."""
    b, h, d = q.shape
    _, s, g, _ = k.shape
    plan = decode_ops.wgmma_plan(b, s, h, g, d, rows_per_split, sm_count, window, row_offset)
    group = plan.group
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.zeros((b, h, d), dtype=torch.float32)
    lse = torch.full((b, h), float("-inf"))
    lens = [int(n) for n in cache_len]
    for bi in range(b):
        n = int(cache_len[bi])
        for gi in range(g):
            heads = slice(gi * group, (gi + 1) * group)
            qg = q[bi, heads].float()
            parts = []
            for rank in range(plan.active(n, lens)):
                m = torch.full((group,), -1e30)
                den = torch.zeros(group)
                acc = torch.zeros((group, d))
                for t in plan.block_tiles(rank, n, lens):
                    rows = torch.tensor(list(plan.tile_rows(t, n)), dtype=torch.long)
                    sc = qg @ k[bi, rows, gi].float().T
                    if softcap:
                        x = torch.tanh(sc * (scale / softcap)) * (softcap * LOG2E)
                    else:
                        x = sc * (scale * LOG2E)
                    m_new = torch.maximum(m, x.amax(1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    den = den * alpha + p.sum(1)
                    pv = p.to(v.dtype).float() @ v[bi, rows, gi].float()
                    acc = acc * alpha[:, None] + pv
                    m = m_new
                parts.append((m, den, acc))
            if not parts:
                continue                                  # zeros (and -inf)
            if len(parts) == 1:
                m, den, acc = parts[0]
                out[bi, heads] = acc * (1.0 / den.clamp_min(1e-30))[:, None]
                lse[bi, heads] = (m + torch.log2(den)) * LN2
                continue
            ms = torch.stack([p[0] for p in parts])
            mx = ms.amax(0)
            w = torch.exp2(ms - mx)
            den = (torch.stack([p[1] for p in parts]) * w).sum(0)
            acc = (torch.stack([p[2] for p in parts]) * w[..., None]).sum(0)
            out[bi, heads] = acc * (1.0 / den.clamp_min(1e-30))[:, None]
            lse[bi, heads] = (mx + torch.log2(den)) * LN2
    if row_offset is not None:
        return out, lse
    return out.to(q.dtype)
