"""Logical-axis sharding rules of the port, and the layout moves that execute
them over a ``torch.distributed`` device mesh.

``LOGICAL_RULES``, ``ACT_SEQ``, ``act_axes`` and ``logical_spec`` are the JAX
package's (``repro/sharding/api.py``), rule for rule: a logical axis resolves
to the mesh axes the mesh has, each mesh axis is used once, and with a shape
given the largest prefix of mesh axes whose extent divides the dim is kept.
A spec is a tuple with one entry per tensor dim: ``None``, one mesh-axis name
or a tuple of them, the content of JAX's ``PartitionSpec``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are named
(``launch/mesh.py``), or a ``ShapeMesh``: axis names and sizes only, for specs
without processes (the counterpart of ``compat.abstract_mesh``).

The reference hands its hints to GSPMD, which inserts the collectives.  The
port computes on plain local shards and moves them itself: ``constrain``
changes a local tensor from one logical layout to another over the model axis
(an all-gather where a dim stops being sharded, a slice where one starts), and
the autograd functions of ``comm.py`` place the Megatron split's sums.  A
tensor's gradient has the tensor's own layout: a whole tensor's gradient is
whole on every rank.
"""

from __future__ import annotations

from contextlib import contextmanager
import threading
from typing import Any
from typing import Dict
from typing import NamedTuple
from typing import Optional
from typing import Sequence
from typing import Tuple
from typing import Union

# logical axis → tuple of mesh axes (filtered by what the mesh provides)
LOGICAL_RULES = {
    "dp": ("pod", "data"),        # batch / data parallel
    "sp": ("data",),              # sequence parallel (long-context)
    "tp": ("model",),             # tensor parallel (heads / ffn / vocab)
    "tp_act": ("model",),         # activation d_model sharding (Megatron SP)
    "ep": ("model",),             # expert parallel
    "zero": ("data",),            # optimizer-state sharding (ZeRO-1)
    # KV-cache sequence axis: takes whatever of (data, model) the batch
    # axis left unused
    "kvseq": ("data", "model"),
    # Megatron-SP residual stream: sequence sharded over model between
    # blocks (enabled by ACT_SEQ)
    "act_seq": ("model",),
    None: (),
}

# Runtime switch: residual-stream layout (sequence-sharded when set).
ACT_SEQ = [False]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def act_axes():
    """Logical axes for the residual stream between blocks."""
    if ACT_SEQ[0]:
        return ("dp", "act_seq", None)
    return ("dp", None, "tp_act")


class ShapeMesh:
    """A mesh of axis names and sizes and nothing else: specs can be
    resolved on it, nothing can run on it."""

    def __init__(self, shape: Sequence[int], names: Sequence[str]):
        if len(shape) != len(names):
            raise ValueError("shape and names must have the same length")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self):
        return f"ShapeMesh({self.shape})"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``ShapeMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, ShapeMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve logical axes")
    return dict(zip(names, mesh.shape))


_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextmanager
def use_mesh(mesh):
    """Bind a mesh (or ``None``) for the model code and ``constrain`` of this
    thread, and restore the one bound before on exit."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


class Stream(NamedTuple):
    """The whole batch and sequence of the residual stream of the model call
    running on this thread.  A rank's part of the stream does not tell them:
    under ``ACT_SEQ`` a local sequence of one row is a whole one-token
    sequence or a two-token one split over two ranks."""
    batch: int
    seq: int


def current_stream() -> Optional[Stream]:
    return getattr(_state, "stream", None)


@contextmanager
def use_stream(stream: Optional[Stream]):
    """Bind the residual stream's whole shape (or ``None``) for this thread,
    as ``use_mesh`` binds the mesh."""
    prev = current_stream()
    _state.stream = stream
    try:
        yield stream
    finally:
        _state.stream = prev


def _resolve(axis, sizes: Dict[str, int]) -> Optional[Tuple[str, ...]]:
    phys = tuple(a for a in LOGICAL_RULES.get(axis, ()) if a in sizes)
    return phys or None


def logical_spec(axes: Sequence[Union[str, None]], mesh=None,
                 shape: Optional[Sequence[int]] = None) -> Spec:
    """Translate logical axes to a spec for ``mesh`` (the bound one by
    default; ``()`` without a mesh).

    With ``shape`` given, axes whose mesh extent does not divide the dim
    size are dropped (replicated) — e.g. batch=1 decode cells drop "dp".
    """
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    parts = []
    used: set = set()
    for i, ax in enumerate(axes):
        phys = _resolve(ax, sizes)
        if phys is None:
            parts.append(None)
            continue
        phys = tuple(p for p in phys if p not in used)
        if shape is not None and phys:
            # keep the largest prefix of mesh axes that divides the dim
            keep = []
            extent = 1
            for p in phys:
                if shape[i] % (extent * sizes[p]) == 0:
                    keep.append(p)
                    extent *= sizes[p]
                else:
                    break
            phys = tuple(keep)
        used.update(phys)
        if not phys:
            parts.append(None)
        else:
            parts.append(phys if len(phys) != 1 else phys[0])
    return tuple(parts)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on a named ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim it shards, else ``Replicate()``.  A dim
    sharded over two mesh axes takes them in the spec's order, which must be
    the mesh's (DTensor splits a dim over its mesh dims left to right)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: dim {d} takes mesh axes {axes} out of the "
                             f"mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


class NamedSharding(NamedTuple):
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec


def named_sharding(axes: Sequence[Union[str, None]], mesh=None,
                   shape: Optional[Sequence[int]] = None) -> Optional[NamedSharding]:
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_spec(axes, mesh, shape))


# ---------------------------------------------------------------------------
# Layout moves over the model axis
# ---------------------------------------------------------------------------
def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes that shard the batch (``"dp"``'s), outer first."""
    return tuple(a for a in LOGICAL_RULES["dp"] if a in axis_sizes(mesh))


def model_size(mesh=None) -> int:
    """Ranks on the bound (or given) mesh's model axis; 1 without one."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return axis_sizes(mesh).get("model", 1)


def seq_sharded() -> bool:
    """Whether the residual stream is sharded on its sequence over the model
    axis: ``ACT_SEQ``, a model axis of more than one rank and a whole
    sequence (the bound ``Stream``'s) that the axis divides.  Otherwise
    ``logical_spec``'s filter keeps the sequence whole, as the reference's
    does for a decode call's one token."""
    m = model_size()
    if not ACT_SEQ[0] or m == 1:
        return False
    stream = current_stream()
    return stream is None or stream.seq % m == 0


def batch_axes(mesh=None) -> Tuple[str, ...]:
    """The data-parallel axes that split the bound stream's batch: those of
    ``logical_spec``'s filter on its whole batch (all of ``dp_axes`` where
    no stream is bound).  A batch they do not split is whole on every rank,
    as the reference replicates it."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    stream = current_stream()
    if stream is None:
        return dp_axes(mesh)
    return spec_axes(logical_spec(("dp",), mesh, (stream.batch,))[0])


def _model_dims(axes, mesh, shape) -> Tuple[int, ...]:
    """The tensor dims that ``axes`` shard over the model axis, for a tensor
    of (whole) ``shape``."""
    spec = logical_spec(axes, mesh, shape)
    return tuple(d for d, e in enumerate(spec) if "model" in spec_axes(e))


def constrain(x, axes: Sequence[Union[str, None]],
              have: Optional[Sequence[Union[str, None]]] = None,
              shape: Optional[Sequence[int]] = None):
    """Lay the local tensor ``x`` out over the model axis as logical ``axes``
    say, from the layout logical ``have`` say (whole over the model axis
    when ``None``); ``shape`` is the tensor's whole shape (``x.shape`` by
    default), which decides, as in ``logical_spec``, which dims the axes
    shard.  A dim that ``have`` shards and ``axes`` does not is all-gathered
    (its gradient sliced back); a dim that ``axes`` shards and ``have`` does
    not is sliced to this rank's part (its gradient all-gathered).
    Data-parallel axes are left as they are: the model's tensors hold their
    data shard's rows throughout.  Without a bound mesh, or with a model
    axis of one rank, ``x`` itself, as the reference's hint is a no-op
    without a mesh."""
    mesh = current_mesh()
    if model_size(mesh) == 1:
        return x
    from . import comm
    whole = tuple(shape) if shape is not None else tuple(x.shape)
    have_dims = _model_dims(have, mesh, whole) if have is not None else ()
    want_dims = _model_dims(axes, mesh, whole)
    for d in have_dims:
        if d not in want_dims:
            x = comm.gather(x, d)
    for d in want_dims:
        if d not in have_dims:
            x = comm.split(x, d)
    return x
