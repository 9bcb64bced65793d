"""Placing a tree of whole tensors on a mesh, and gathering it back.

``shardings_for`` is the JAX package's ``launch/dryrun.py::shardings_for``:
a logical-axes tree and a tree of whole tensors (or of tensors on the meta
device, the counterpart of ``jax.eval_shape``) give a tree of specs, an
indivisible dim replicated.  ``shard_tree`` gives this rank its part of each
leaf by those specs, as the reference's ``jit(in_shardings=...)`` places a
state; ``gather_tree`` puts the parts back together on every rank, for
checkpoints (the on-disk format stays the reference's) and for tests.

An axes tree is built of dicts and NamedTuples; its leaves are plain tuples
of logical axes, or ``None`` for a leaf the value tree does not have.
"""

from __future__ import annotations

from typing import Any
from typing import Callable

from .api import current_mesh
from .api import logical_spec
from .api import spec_axes
from .comm import all_gather_dim
from .comm import axis_group


def _is_axes(x) -> bool:
    # plain tuples are axis specs; NamedTuples (Cache, TrainState) are containers
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields"))


def map_axes(fn: Callable, axes, *trees) -> Any:
    """``fn(axes, *leaves)`` over the leaves of an axes tree and the matching
    nodes of ``trees``; the result is shaped as ``axes``."""
    if _is_axes(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_axes(fn, axes[k], *(t[k] for t in trees)) for k in axes}
    return type(axes)(*[map_axes(fn, a, *(getattr(t, f) for t in trees))
                        for f, a in zip(axes._fields, axes)])


def axes_leaves(axes) -> list:
    """The leaves of an axes (or spec) tree, in the order of
    ``repro_torch.tree.leaves`` of the matching value tree (dict keys
    sorted, NamedTuple fields in order)."""
    if _is_axes(axes):
        return [axes]
    if isinstance(axes, dict):
        return [leaf for k in sorted(axes) for leaf in axes_leaves(axes[k])]
    return [leaf for a in axes for leaf in axes_leaves(a)]


def shardings_for(axes_tree, struct_tree, mesh=None):
    """Logical-axes tree + tree of whole tensors → tree of specs (shape-aware:
    an indivisible dim falls back to replication; a leaf without axes, or
    missing, is replicated)."""
    mesh = mesh or current_mesh()

    def one(axes, struct):
        if axes is None or struct is None:
            return ()
        # a Python scalar (the cache's position) has no dims
        return logical_spec(tuple(axes), mesh, shape=tuple(getattr(struct, "shape", ())))

    return map_axes(one, axes_tree, struct_tree)


def rank_part(axes, mesh=None):
    """(this rank's part, number of parts) of a dim split over mesh ``axes``
    (of the bound mesh by default), the first axis outermost."""
    mesh = mesh or current_mesh()
    idx, n = 0, 1
    for a in axes:
        _, size, r = axis_group(a, mesh)
        idx, n = idx * size + r, n * size
    return idx, n


def shard_tree(tree, axes_tree, mesh=None):
    """This rank's part of every leaf of a tree of whole tensors, by
    ``shardings_for(axes_tree, tree)``: new contiguous tensors, so that the
    whole ones can be freed."""
    mesh = mesh or current_mesh()

    def one(axes, t):
        if t is None:
            return None
        spec = () if axes is None else logical_spec(tuple(axes), mesh, tuple(t.shape))
        for d, entry in enumerate(spec):
            i, n = rank_part(spec_axes(entry), mesh)
            if n > 1:
                k = t.shape[d] // n
                t = t.narrow(d, i * k, k)
        return t.contiguous().clone()

    return map_axes(one, axes_tree, tree)


def gather_tree(tree, axes_tree, struct_tree, mesh=None):
    """The whole of every leaf of a tree of this rank's parts, on every rank:
    the inverse of ``shard_tree``, the specs taken from ``struct_tree``'s
    whole shapes."""
    mesh = mesh or current_mesh()

    def one(axes, t, struct):
        if t is None:
            return None
        spec = () if axes is None else logical_spec(tuple(axes), mesh, tuple(struct.shape))
        for d, entry in enumerate(spec):
            for a in reversed(spec_axes(entry)):
                t = all_gather_dim(t, d, a)
        if tuple(t.shape) != tuple(struct.shape):
            raise ValueError(f"gathered {tuple(t.shape)}, expected {tuple(struct.shape)}")
        return t

    return map_axes(one, axes_tree, tree, struct_tree)
