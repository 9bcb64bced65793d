"""Collectives of the executed mesh, as autograd functions.

Each move is a pair (what the forward does, what the backward does to the
gradient) over one named axis of the bound ``DeviceMesh``:

* ``gather`` / ``split``: all-gather a dim / keep this rank's part of it, the
  gradient the other way round (``api.constrain``'s layout moves);
* ``copy_to`` (identity, then all-reduce of the gradient) and
  ``reduce_from`` (all-reduce, identity on the gradient): Megatron's f and g.
  A whole tensor that each rank consumes with its own shard of a weight gets
  a partial gradient on each rank; ``copy_to`` sums them.  A product summed
  over a sharded dim is partial on each rank; ``reduce_from`` sums it;
* ``reduce_scatter``: the sum of partial products, each rank keeping its part
  of a dim (the reference's ``psum_scatter``), the gradient all-gathered;
* ``all_sum``: the sum, and the sum of the gradients (a norm's sum of squares
  over a dim sharded across ranks, whose every rank's result feeds that rank's
  part of the output).

The process group of an axis is the mesh's own (``DeviceMesh.get_group``);
an axis of one rank moves nothing.  Every rank must make the same moves in
the same order, as every rank runs the same model code.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .api import axis_sizes
from .api import current_mesh


def axis_group(axis: str, mesh=None):
    """(process group, size, this rank's index) of ``axis`` of the bound (or
    given) mesh; ``(None, 1, 0)`` where the mesh lacks the axis."""
    mesh = mesh or current_mesh()
    n = axis_sizes(mesh).get(axis, 1) if mesh is not None else 1
    if n == 1:
        return None, 1, 0
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"{mesh!r} holds no processes: a ShapeMesh resolves specs only")
    return mesh.get_group(axis), n, mesh.get_local_rank(axis)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _part(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int, r: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[r])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _move(kind: str, x: torch.Tensor, dim: int, group, n: int, r: int) -> torch.Tensor:
    if kind == "id":
        return x
    if kind == "sum":
        return _all_reduce(x, group)
    if kind == "gather":
        return _all_gather(x, dim, group, n)
    if kind == "split":
        return _part(x, dim, n, r)
    if kind == "scatter_sum":
        return _reduce_scatter(x, dim, group, n, r)
    raise ValueError(kind)


class _Move(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd, dim, group, n, r):
        ctx.args = (bwd, dim, group, n, r)
        return _move(fwd, x, dim, group, n, r)

    @staticmethod
    def backward(ctx, g):
        bwd, dim, group, n, r = ctx.args
        return _move(bwd, g, dim, group, n, r), None, None, None, None, None, None


def _apply(x, fwd, bwd, dim=0, axis="model"):
    group, n, r = axis_group(axis)
    if n == 1:
        return x
    return _Move.apply(x, fwd, bwd, dim, group, n, r)


def gather(x, dim: int, axis: str = "model"):
    return _apply(x, "gather", "split", dim, axis)


def split(x, dim: int, axis: str = "model"):
    return _apply(x, "split", "gather", dim, axis)


def copy_to(x, axis: str = "model"):
    return _apply(x, "id", "sum", 0, axis)


def reduce_from(x, axis: str = "model"):
    return _apply(x, "sum", "id", 0, axis)


def reduce_scatter(x, dim: int, axis: str = "model"):
    return _apply(x, "scatter_sum", "gather", dim, axis)


def all_sum(x, axis: str = "model"):
    return _apply(x, "sum", "sum", 0, axis)


# ---------------------------------------------------------------------------
# Plain collectives (no autograd), for the train step and the optimizer
# ---------------------------------------------------------------------------
def all_reduce_(x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``x`` in place over ``axis``; ``x`` unchanged on one rank."""
    group, n, _ = axis_group(axis)
    if n > 1:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim``."""
    group, n, _ = axis_group(axis)
    return x if n == 1 else _all_gather(x, dim, group, n)


def stack_over(x: torch.Tensor, axes: List[str]) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` (mesh order, outer first), stacked on
    a new leading dim in the order of those ranks' indices."""
    out = x[None]
    for axis in reversed(axes):
        out = all_gather_dim(out[None], 0, axis).flatten(0, 1)
    return out
