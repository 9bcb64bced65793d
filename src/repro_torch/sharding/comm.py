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

``merge_attention`` sums the partial attention of each rank's slice of a
sequence-sharded K/V cache (``kernels.decode_attention_lse``), the
counterpart of what GSPMD inserts around the reference's ``gqa_attention``.

Every collective this module issues adds the bytes of this rank's operand to
``BYTES`` by kind (``collective_bytes()`` / ``reset_collective_bytes()``), as
the kernel wrappers count their launches: the shard an all-gather sends, the
whole tensor an all-reduce or a reduce-scatter takes.
"""

from __future__ import annotations

from typing import Dict
from typing import List
from typing import Optional
from typing import Sequence

import torch
import torch.distributed as dist

from .api import axis_sizes
from .api import current_mesh

# operand bytes of this rank's collectives since the last reset, by kind
BYTES: Dict[str, int] = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}


def collective_bytes() -> Dict[str, int]:
    """This rank's collectives' operand bytes by kind since the last reset."""
    return dict(BYTES)


def reset_collective_bytes() -> None:
    for kind in BYTES:
        BYTES[kind] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    BYTES[kind] += x.numel() * x.element_size()


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
    _count("all-reduce", y)
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    _count("all-gather", x)
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
    _count("reduce-scatter", x)
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
        _count("all-reduce", x)
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


def merge_attention(o: torch.Tensor, lse: torch.Tensor, axes: Sequence[str],
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The attention over a whole sequence from each rank's partial one over
    its slice: ``o`` (B, H, D) fp32 and ``lse`` (B, H), the log-sum-exp of
    the slice's scores (``-inf`` where the slice holds no live key), over
    the mesh ``axes`` that split the sequence: every rank's pair gathered
    (in the order of ``stack_over``) and summed by ``merge_parts``, so that
    every rank gets the same bits; cast to ``dtype`` (``o``'s by default)."""
    axes = [a for a in axes if axis_group(a)[1] > 1]
    parts_o = stack_over(o.float(), axes) if axes else o.float()[None]
    parts_l = stack_over(lse.float(), axes) if axes else lse.float()[None]
    return merge_parts(parts_o, parts_l).to(dtype or o.dtype)


def merge_parts(parts_o: torch.Tensor, parts_l: torch.Tensor) -> torch.Tensor:
    """``sum_r exp(lse_r - m) o_r / sum_r exp(lse_r - m)`` with ``m = max_r
    lse_r``, over the leading dim of ``parts_o`` (n, B, H, D) and
    ``parts_l`` (n, B, H), in fp32, the parts summed one after another in
    their order; zeros where every part's ``lse`` is ``-inf`` (no live key
    anywhere), with no NaN from ``-inf - -inf``."""
    parts_o, parts_l = parts_o.float(), parts_l.float()
    m = parts_l.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = torch.zeros_like(parts_o[0])
    den = torch.zeros_like(m)
    for part_o, part_l in zip(parts_o, parts_l):
        w = torch.exp(part_l - m)
        num = num + w[..., None] * part_o
        den = den + w
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None],
                       torch.zeros_like(num))
