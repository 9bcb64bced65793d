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


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                dfinal: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None, *,
                return_da: bool = False):
    """The backward kernel's plain version: the gradients of
    :func:`ssd_ref`'s ``y`` (incoming ``dy``, B,S,H,P) and final state
    (``dfinal``, B,H,P,N, or None for zero) with respect to x, dt, A, B, C
    and the initial state, in fp32, written out as closed forms walked one
    row at a time (nothing is chunked, and no decay is formed across more
    than one row).  With a = dt·A, xd = x·dt, state_t the running state
    (from ``initial_state`` or zeros) and, per head h of group g:

    * dC^h_t = dy_t · state_t (the forward walk);
    * G_t = dy_t ⊗ C_t + exp(a_{t+1}) G_{t+1}, from G_{S-1} = dy ⊗ C + dfinal
      (the reverse walk); dxd_t = G_t B_t, dx = dxd·dt, dB^h_t = xd_tᵀ G_t,
      dinit = exp(a_0) G_0;
    * dcum_t = C_t·dC^h_t − B_t·dB^h_t (+ ⟨dfinal, final state⟩ at S−1);
      da_t = Σ_{t' ≥ t} dcum_t', ddt = dxd·x + da·A, dA = Σ_{b,t} da·dt;
    * dB, dC of group g: the sums of dB^h, dC^h over its heads.

    Returns (dx, ddt, dA, dB, dC, dinit), and da (B,S,H) after them with
    ``return_da``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    x, dt, A, dy = x.float(), dt.float(), A.float(), dy.float()
    Bh = B.float().repeat_interleave(rep, dim=2)                 # (b,s,h,n)
    Ch = C.float().repeat_interleave(rep, dim=2)
    decay = torch.exp(dt * A)                                    # (b,s,h)
    xd = x * dt[..., None]
    state = (initial_state.float().clone() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    dCh = torch.empty((b, s, h, n), dtype=torch.float32, device=x.device)
    for t in range(s):
        state = state * decay[:, t, :, None, None] + xd[:, t, :, :, None] * Bh[:, t, :, None, :]
        dCh[:, t] = torch.einsum("bhp,bhpn->bhn", dy[:, t], state)
    dcum = (Ch * dCh).sum(-1)                                    # (b,s,h)
    G = torch.zeros_like(state)
    if dfinal is not None:
        dcum[:, -1] += (dfinal.float() * state).sum((-2, -1))
        G = dfinal.float().clone()
    dxd = torch.empty_like(x)
    dBh = torch.empty_like(dCh)
    for t in reversed(range(s)):
        G = G + dy[:, t, :, :, None] * Ch[:, t, :, None, :]
        dxd[:, t] = torch.einsum("bhpn,bhn->bhp", G, Bh[:, t])
        dBh[:, t] = torch.einsum("bhp,bhpn->bhn", xd[:, t], G)
        G = G * decay[:, t, :, None, None]
    dcum = dcum - (Bh * dBh).sum(-1)
    da = dcum.flip(1).cumsum(1).flip(1)
    grads = (dxd * dt[..., None], (dxd * x).sum(-1) + da * A, (da * dt).sum((0, 1)),
             dBh.reshape(b, s, g, rep, n).sum(3), dCh.reshape(b, s, g, rep, n).sum(3), G)
    return grads + (da,) if return_da else grads
