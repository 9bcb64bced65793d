"""Plain PyTorch version of the SSD scan kernel: the chunked SSD algorithm
(the model path's oracle, re-exported by ``models/ssm.py``).

The chunked algorithm lives here, beside its kernel, rather than in
``models/ssm.py`` as in the JAX package, because ``models/ssm.py`` imports
the kernel wrapper and the wrapper needs the oracle for CPU tensors.
"""

from __future__ import annotations

from typing import Optional
from typing import Tuple

import torch
import torch.nn.functional as F


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sum: out[..., i, j] = sum(x[..., j+1:i+1]) for i >= j, -inf
    above the diagonal (as differences of one cumsum, like the reference)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B,S,H,P); dt (B,S,H); A (H,); B/C (B,S,G,N).
    Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError("sequence must be chunk-aligned")
    nc = s // chunk
    rep = h // g

    xd = (x * dt[..., None]).reshape(b, nc, chunk, h, p)
    Bc = B.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    Cc = C.reshape(b, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    dA = (dt * A).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)    # (b,h,c,l)
    dA_cs = torch.cumsum(dA, dim=-1)

    # 1. intra-chunk (quadratic within chunk)
    L = torch.exp(segsum(dA))                                    # (b,h,c,l,l)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cc, Bc, L, xd)

    # 2. per-chunk final states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)            # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bc, decay_states, xd)

    # 3. inter-chunk recurrence
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=states.dtype, device=x.device)
    states = torch.cat([initial_state[:, None].to(states.dtype), states], dim=1)
    chunk_decay = dA_cs[..., -1]                                 # (b,h,c)
    dc = torch.exp(segsum(F.pad(chunk_decay, (1, 0))))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. inter-chunk contribution to outputs
    state_decay = torch.exp(dA_cs)                               # (b,h,c,l)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int,
            initial_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: :func:`ssd_chunked` in fp32.  Returns
    (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32)."""
    init = initial_state.float() if initial_state is not None else None
    return ssd_chunked(x.float(), dt.float(), A.float(), B.float(), C.float(), chunk,
                       initial_state=init)
