"""Mamba2 (SSD — state-space duality) blocks in PyTorch.

The counterpart of the JAX package's ``models/ssm.py``.  The prefill /
forward branch of :func:`mamba2_block` runs the chunked SSD scan through the
``ssd_scan`` wrapper, so on the card it is the hand-written kernel; the
plain chunked algorithm (:func:`ssd_chunked`, :func:`segsum`) stays the
oracle and lives beside the kernel in ``kernels/ssd_scan/ref.py``.  The
one-token decode branch is the recurrence in plain torch ops (the JAX
package has no kernel for it).  ``constrain`` and ``row_parallel_out`` have
no counterpart on one device.

Shapes: x (B, S, H, P); dt (B, S, H) [post-softplus]; A (H,) negative;
B/C (B, S, G, N) with H % G == 0.

bf16 rounding follows the JAX package evaluated op by op: softplus is
``max(x, 0) + log1p(exp(-|x|))`` (its gradient ``g exp(x - softplus(x))``,
JAX's rule for logaddexp) and silu ``x / (1 + exp(-x))``, each step rounded
in the activations' type, and the depthwise convolutions sum their taps in
fp32 and round once.
"""

from __future__ import annotations

from typing import NamedTuple
from typing import Optional
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..kernels.ssd_scan.ref import segsum
from ..kernels.ssd_scan.ref import ssd_chunked
from .layers import _silu
from .layers import init_stacked
from .layers import rms_norm

__all__ = ["Mamba2Cache", "init_mamba2_cache", "init_mamba2_params", "mamba2_block",
           "segsum", "ssd_chunked", "ssd_decode_step"]


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state (B,H,P,N); x (B,H,P); dt (B,H);
    B/C (B,G,N).  Returns (y (B,H,P), new_state)."""
    rep = x.shape[1] // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)                  # (b,h,n)
    Ch = C.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A)                                # (b,h)
    upd = torch.einsum("bhp,bhn->bhpn", x * dt[..., None], Bh)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y, new_state


class Mamba2Cache(NamedTuple):
    conv_x: torch.Tensor   # (B, d_conv-1, d_inner)
    conv_bc: torch.Tensor  # (B, d_conv-1, 2·G·N)
    ssm: torch.Tensor      # (B, H, P, N) fp32


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` as XLA evaluates it, forward and gradient:
    logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), and the gradient of
    logaddexp's own derivative rule, g exp(x - softplus(x)), each step
    rounded in ``x``'s type.  (Autograd of the forward's steps would give g
    exp(-|x|) / (1 + exp(-|x|)) for x < 0, whose 1 + exp(-|x|) rounds to 1
    in bf16, and the reduced mamba2's dt_bias gradient would leave JAX's.)"""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as XLA evaluates it (``_Softplus``)."""
    return _Softplus.apply(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d, then silu.  x (B,S,C); w (K,C); b (C).  The
    K taps are summed in fp32 (plain multiply-adds: no cuDNN, no TF32) and
    rounded once to ``x``'s type."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = pad[:, 0:s] * wf[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * wf[i]
    return _silu(out.to(x.dtype) + b)


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The decode branch's ``einsum("bkc,kc->bc")`` over the K-row history,
    summed in fp32 and rounded once, then bias and silu."""
    out = (hist.float() * w.float()).sum(dim=1)
    return _silu(out.to(hist.dtype) + b)


def mamba2_block(params, x: torch.Tensor, spec, cache: Optional[Mamba2Cache] = None
                 ) -> Tuple[torch.Tensor, Optional[Mamba2Cache]]:
    """One Mamba2 block: projections → conv → SSD → gated norm → out-proj.

    Prefill / forward mode (no cache, or a cache and more than one token)
    runs the SSD scan kernel with ``chunk = min(spec.chunk, S)``, starting
    from ``cache.ssm`` where a cache is given; S must then be a multiple of
    that chunk, as in the reference.  Decode mode (a cache and one token)
    runs the one-token recurrence.  The returned cache is new tensors; the
    caller decides where they go."""
    b, s, d = x.shape
    d_inner = spec.expand * d
    h = d_inner // spec.head_dim
    p, n, g = spec.head_dim, spec.d_state, spec.n_groups

    res = rms_norm(x, params["ln"])
    z = torch.matmul(res, params["w_z"])
    xr = torch.matmul(res, params["w_x"])
    bc = torch.matmul(res, params["w_bc"])
    dt = _softplus(torch.matmul(res, params["w_dt"]) + params["dt_bias"])
    A = -torch.exp(params["a_log"].float())

    if cache is not None and s == 1:
        hist_x = torch.cat([cache.conv_x, xr], dim=1)          # (b,K,d_in)
        hist_bc = torch.cat([cache.conv_bc, bc], dim=1)
        cx = _conv_step(hist_x, params["conv_x_w"], params["conv_x_b"])
        cbc = _conv_step(hist_bc, params["conv_bc_w"], params["conv_bc_b"])
        xs = cx.reshape(b, h, p)
        Bv = cbc[..., :g * n].reshape(b, g, n)
        Cv = cbc[..., g * n:].reshape(b, g, n)
        y, new_ssm = ssd_decode_step(cache.ssm, xs.float(), dt[:, 0].float(), A,
                                     Bv.float(), Cv.float())
        y = y[:, None]                                           # (b,1,h,p)
        xs = xs[:, None]
        new_cache = Mamba2Cache(conv_x=hist_x[:, 1:], conv_bc=hist_bc[:, 1:],
                                ssm=new_ssm)
    else:
        cx = _causal_conv(xr, params["conv_x_w"], params["conv_x_b"])
        cbc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"]).float()
        xs = cx.reshape(b, s, h, p)
        # B and C stay strided views of one fp32 tensor: the kernel reads them
        # through their strides
        Bv = cbc[..., :g * n].view(b, s, g, n)
        Cv = cbc[..., g * n:].view(b, s, g, n)
        init = cache.ssm if cache is not None else None
        y, final_state = ssd_scan(xs.float(), dt.float(), A, Bv, Cv,
                                  chunk=min(spec.chunk, s), initial_state=init)
        new_cache = None
        if cache is not None:
            new_cache = Mamba2Cache(conv_x=xr[:, -(spec.d_conv - 1):],
                                    conv_bc=bc[:, -(spec.d_conv - 1):],
                                    ssm=final_state)

    y = y + xs.to(y.dtype) * params["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * _silu(z), params["out_ln"])
    return torch.matmul(y, params["w_out"]), new_cache


def init_mamba2_params(gen: torch.Generator, d_model: int, spec, n_layers: int,
                       dtype=torch.bfloat16):
    """Random parameters of ``n_layers`` Mamba2 blocks, stacked on a leading
    layer axis, with the JAX package's keys, scales and types (``a_log`` and
    ``d_skip`` fp32), drawn from ``gen`` on its device."""
    d_inner = spec.expand * d_model
    h = d_inner // spec.head_dim
    bc_dim = 2 * spec.n_groups * spec.d_state
    scale = d_model ** -0.5
    dev = gen.device
    L = n_layers

    def per_layer(v: torch.Tensor) -> torch.Tensor:
        return v.to(dev).expand((L,) + tuple(v.shape)).contiguous()

    return {
        "ln": torch.ones((L, d_model), dtype=dtype, device=dev),
        "w_z": init_stacked(gen, L, (d_model, d_inner), scale, dtype),
        "w_x": init_stacked(gen, L, (d_model, d_inner), scale, dtype),
        "w_bc": init_stacked(gen, L, (d_model, bc_dim), scale, dtype),
        "w_dt": init_stacked(gen, L, (d_model, h), scale, dtype),
        "conv_x_w": init_stacked(gen, L, (spec.d_conv, d_inner), 0.1, dtype),
        "conv_x_b": torch.zeros((L, d_inner), dtype=dtype, device=dev),
        "conv_bc_w": init_stacked(gen, L, (spec.d_conv, bc_dim), 0.1, dtype),
        "conv_bc_b": torch.zeros((L, bc_dim), dtype=dtype, device=dev),
        "dt_bias": per_layer(torch.log(torch.expm1(
            torch.linspace(0.001, 0.1, h, dtype=torch.float32))).to(dtype)),
        "a_log": per_layer(torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))),
        "d_skip": torch.ones((L, h), dtype=torch.float32, device=dev),
        "out_ln": torch.ones((L, d_inner), dtype=dtype, device=dev),
        "w_out": init_stacked(gen, L, (d_inner, d_model), d_inner ** -0.5, dtype),
    }


def init_mamba2_cache(batch: int, d_model: int, spec, *, device, dtype=torch.bfloat16
                      ) -> Mamba2Cache:
    d_inner = spec.expand * d_model
    h = d_inner // spec.head_dim
    bc_dim = 2 * spec.n_groups * spec.d_state
    return Mamba2Cache(
        conv_x=torch.zeros((batch, spec.d_conv - 1, d_inner), dtype=dtype, device=device),
        conv_bc=torch.zeros((batch, spec.d_conv - 1, bc_dim), dtype=dtype, device=device),
        ssm=torch.zeros((batch, h, spec.head_dim, spec.d_state), dtype=torch.float32,
                        device=device),
    )
