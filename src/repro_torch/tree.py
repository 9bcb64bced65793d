"""Trees of tensors as the JAX package's pytrees: nested dicts (keys in
sorted order, as JAX flattens them), NamedTuples (fields in order) and
lists or tuples (by index).

``flatten_with_keys`` names each leaf by its path the way the JAX package's
checkpoint manager does (``repro/checkpoint/manager.py``): a dict key as
itself, a NamedTuple field with a leading dot (JAX's ``GetAttrKey`` prints
so), an index as its number, joined by ``/``; a ``TrainState``'s leaves are
``.params/embed``, ``.opt/.m/layers/attn/wq``, ``.opt/.step`` and so on.
"""

from __future__ import annotations

from typing import Any
from typing import Callable
from typing import List
from typing import Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(key, child) pairs of an inner node, in JAX's order; [] for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_leaf(node) -> bool:
    return not isinstance(node, (dict, list, tuple))


def flatten_with_keys(tree) -> List[Tuple[str, Any]]:
    """(path key, leaf) of every leaf, in JAX's order."""
    if _is_leaf(tree):
        return [("", tree)]
    out = []
    for key, child in _children(tree):
        for sub, leaf in flatten_with_keys(child):
            out.append((key + "/" + sub if sub else key, leaf))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped as ``like`` with ``new_leaves`` in its leaves' order."""
    it = iter(new_leaves)

    def build(node):
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(c) for c in node])
        return type(node)(build(c) for c in node)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same shape)."""
    groups = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(g) != len(groups[0]) for g in groups):
        raise ValueError("trees of different shapes")
    return unflatten(tree, [fn(*xs) for xs in zip(*groups)])
