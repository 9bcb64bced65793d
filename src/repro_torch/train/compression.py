"""int8 gradient compression with error feedback for cross-pod sync, as the
JAX package's ``train/compression.py``.

The inter-pod gradient all-reduce is the slowest collective of a multi-pod
mesh, so the payload is quantized to int8 with a shared per-tensor scale and
the quantization error is carried into the next step (error feedback keeps
convergence unbiased in expectation).

Wire protocol per tensor, over the process group of one mesh axis:
  1. ``scale = all_reduce_max(|g+e|) / 127``  (scalar, fp32)
  2. ``q = round((g+e)/scale)``, clipped to ±127 (the int8 payload)
  3. ``sum = all_reduce_sum(q.int32)``        (int32 on the wire, as the
     reference's ``psum``)
  4. ``g' = sum · scale / n``; ``e' = (g+e) - dequant(own share)``
"""

from __future__ import annotations

from typing import Any
from typing import Tuple

import torch
import torch.distributed as dist

from ..sharding import comm
from ..tree import leaves
from ..tree import tree_map
from ..tree import unflatten


def _compress_one(g: torch.Tensor, e: torch.Tensor, axis: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + e
    amax = gf.abs().max()
    comm.all_reduce_(amax, axis, op=dist.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    new_e = gf - q * scale
    n = comm.axis_group(axis)[1]
    summed = comm.all_reduce_(q.to(torch.int32), axis).float()
    return (summed * scale / n).to(g.dtype), new_e


def compressed_psum_mean(grads: Any, err: Any, axis: str) -> Tuple[Any, Any]:
    """Mean-reduce a gradient tree across mesh ``axis`` of the bound mesh
    with int8 quantization and error feedback; every rank of the axis calls
    it with its own ``grads`` and ``err``.  Returns (mean, new error)."""
    out = [_compress_one(g, e, axis) for g, e in zip(leaves(grads), leaves(err))]
    return unflatten(grads, [m for m, _ in out]), unflatten(grads, [e for _, e in out])


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
