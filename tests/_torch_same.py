"""Exact, package-blind comparison of simulator-stack objects.

The JAX package and the port define classes of the same names (``Trace``,
``DataflowSpec``, ``SimResult``, ...), and a dataclass never compares equal
to one of another class.  :func:`plain` turns either package's object into
nested builtins: the class's name, its fields or public attributes, numpy
arrays as dtype, shape and raw bytes, floats as their IEEE bits.  Two
objects are the same when their plain forms are equal: every integer, every
float bit and every array element.  Names that start with ``_`` are caches
(memoized fingerprints, compiled traces) and are left out.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


def _float(x) -> tuple:
    return ("f", struct.pack("<d", float(x)))


def plain(obj, _depth: int = 0):
    if _depth > 40:
        raise RecursionError("object nests deeper than 40 levels")
    d = _depth + 1
    if obj is None or isinstance(obj, (bool, str, bytes)):
        return obj
    if isinstance(obj, (int, np.integer)):
        return int(obj)
    if isinstance(obj, (float, np.floating)):
        return _float(obj)
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return ("array", str(a.dtype), a.shape, a.tobytes())
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [plain(x, d) for x in obj])
    if isinstance(obj, dict):
        return ("dict", [(plain(k, d), plain(v, d)) for k, v in obj.items()])
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                [(f.name, plain(getattr(obj, f.name), d))
                 for f in dataclasses.fields(obj) if not f.name.startswith("_")])
    if hasattr(obj, "__dict__"):
        return (type(obj).__name__,
                [(k, plain(v, d)) for k, v in sorted(vars(obj).items())
                 if not k.startswith("_")])
    raise TypeError(f"no plain form for {type(obj).__name__}")


def assert_same(ref, port, what: str = "") -> None:
    """Raise naming the first path at which the two plain forms differ."""
    a, b = plain(ref), plain(port)
    if a == b:
        return
    path = _first_difference(a, b, what or type(ref).__name__)
    raise AssertionError(f"port differs from the reference at {path}")


def _first_difference(a, b, path: str) -> str:
    if type(a) is not type(b):
        return f"{path}: {_short(a)} != {_short(b)}"
    if isinstance(a, tuple) and a and a[0] == "array":
        if a[1:3] != b[1:3]:
            return f"{path}: dtype/shape {a[1:3]} != {b[1:3]}"
        return f"{path}: array contents"
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                label = x[0] if (isinstance(x, tuple) and len(x) == 2
                                 and isinstance(x[0], str)) else i
                return _first_difference(x, y, f"{path}.{label}")
    return f"{path}: {_short(a)} != {_short(b)}"


def _short(x) -> str:
    r = repr(x)
    return r if len(r) < 120 else r[:117] + "..."
