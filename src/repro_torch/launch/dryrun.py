"""Dry run of every (arch × shape × mesh) cell: what each rank holds, and the
cell's roofline terms on an H100, without a device or a process group.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both --out DIR
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k --mesh 2x4

The port's counterpart of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles each cell on 512 fake TPU devices; PyTorch has
no compiler to ask, so a cell here is built on a ``ShapeMesh`` (axis names
and sizes, no ranks) from ``init_params(cfg, device="meta")`` and the
sharding rules, and the reference's argument trees and specs are rebuilt
leaf for leaf (``build_cell``): the train state with ZeRO-1 moments and the
token batch, the parameters and the prompt, or the parameters, one token a
sequence and the cache placed by ``models.model.kv_layout`` (K/V by heads,
or ``kvseq``).  ``run_cell`` writes one JSON record a cell: ``ok`` or
``skipped`` (``cell_applicable``'s reason), the K/V layout, each rank's
argument bytes from its shards' shapes (the counterpart of
``memory_analysis().argument_size_in_bytes``) and the roofline entry with
the H100's constants (``launch/roofline.py``), whose per-chip FLOPs and
bytes are the model's own counts over the ranks: no compiler count stands
behind them.  The cell is not run, so it has no collective bytes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any
from typing import Dict
from typing import NamedTuple
from typing import Optional
from typing import Tuple

import torch

from ..configs import ARCH_NAMES
from ..configs import SHAPES
from ..configs import cell_applicable
from ..configs import get_arch
from ..models import cache_logical_axes
from ..models import init_cache
from ..models import init_params
from ..models.model import kv_layout
from ..sharding.api import ShapeMesh
from ..sharding.api import axis_sizes
from ..sharding.api import logical_spec
from ..sharding.api import spec_axes
from ..sharding.api import use_mesh
from ..sharding.state import shardings_for
from ..train.loop import TrainState
from ..train.loop import state_logical_axes
from ..train.optimizer import OptState
from ..train.sharding_rules import param_logical_axes
from ..tree import tree_map
from . import roofline as rl

# the reference's production meshes (launch/mesh.py::make_production_mesh)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NO_COMPILER = ("flops_per_chip and bytes_per_chip are model_flops and model_bytes over the "
               "ranks: PyTorch has no compiler whose count would stand behind them")
NOT_RUN = ("null: a dry run issues no collective; sharding.comm's tally gives a cell's "
           "collective bytes when the cell is run")
HEADS_AXES = (None, "dp", None, "tp", None)   # build_cell's K/V by heads


class Cell(NamedTuple):
    """One cell's arguments (trees of meta tensors), their specs (trees of
    the same shape) and the K/V layout of a decode cell (None otherwise)."""
    args: Tuple[Any, ...]
    specs: Tuple[Any, ...]
    layout: Optional[str]


def shape_mesh(name: str) -> ShapeMesh:
    """A production mesh by name, or ``DxM``: a (data, model) mesh."""
    if name in MESHES:
        return ShapeMesh(*MESHES[name])
    data, model = (int(x) for x in name.split("x"))
    return ShapeMesh((data, model), ("data", "model"))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(cfg, shape, mesh: ShapeMesh) -> Cell:
    """The reference's ``build_cell`` arguments and specs on ``mesh``."""
    with use_mesh(None):   # whole shapes: no rank's widths
        params = init_params(cfg, device="meta")
    p_spec = shardings_for(param_logical_axes(cfg), params, mesh)
    if shape.kind == "train":
        tokens = _meta((shape.global_batch, shape.seq_len), torch.int32)

        def moment(p):
            return _meta(p.shape, torch.float32)

        state = TrainState(params=params, opt=OptState(
            m=tree_map(moment, params), v=tree_map(moment, params), step=_meta((), torch.int32)))
        specs = shardings_for(state_logical_axes(cfg), state, mesh)
        return Cell((state, tokens), (specs, _token_spec(tokens, mesh)), None)
    if shape.kind == "prefill":
        tokens = _meta((shape.global_batch, shape.seq_len), torch.int32)
        return Cell((params, tokens), (p_spec, _token_spec(tokens, mesh)), None)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    with use_mesh(None):
        cache = init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    axes = cache_logical_axes(cfg)
    layout = kv_layout(cfg, shape.global_batch, mesh)
    if layout == "heads":
        axes = axes._replace(k=HEADS_AXES, v=HEADS_AXES)
    c_spec = shardings_for(axes, cache, mesh)
    return Cell((params, tokens, cache), (p_spec, _token_spec(tokens, mesh), c_spec),
                layout if axes.k is not None else None)


def _token_spec(tokens, mesh):
    return logical_spec(("dp", None), mesh, tuple(tokens.shape))


def _leaves(spec, arg, key=""):
    """(path, spec, tensor) of every leaf of an argument and its spec tree
    (a spec is a plain tuple; dicts and NamedTuples are inner nodes), paths
    as ``repro_torch.tree.flatten_with_keys`` names them."""
    if spec is None or (isinstance(spec, tuple) and not hasattr(spec, "_fields")):
        if isinstance(arg, torch.Tensor):   # not the cache's position, a Python int
            yield key, spec or (), arg
        return
    children = ([(k, spec[k], arg[k]) for k in sorted(spec)] if isinstance(spec, dict) else
                [("." + f, getattr(spec, f), getattr(arg, f)) for f in spec._fields])
    for k, sub_spec, sub_arg in children:
        yield from _leaves(sub_spec, sub_arg, f"{key}/{k}" if key else k)


def shard_shapes(cell: Cell, mesh: ShapeMesh) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{path: (one rank's shard shape, dtype)} of every tensor argument of a
    cell, paths under the argument's index (``0/embed``, ``2/.k``,
    ``0/.opt/.m/layers/attn/wq``)."""
    sizes = axis_sizes(mesh)
    out = {}
    for i, (arg, spec) in enumerate(zip(cell.args, cell.specs)):
        for key, sp, leaf in _leaves(spec, arg, str(i)):
            sp = tuple(sp) + (None,) * (leaf.dim() - len(sp))
            out[key] = (tuple(n // math.prod(sizes[a] for a in spec_axes(e))
                              for n, e in zip(leaf.shape, sp)), leaf.dtype)
    return out


def argument_bytes(cell: Cell, mesh: ShapeMesh) -> int:
    """One rank's bytes of the cell's arguments, from its shards' shapes."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for shape, dtype in shard_shapes(cell, mesh).values())


def run_cell(arch_name: str, shape_name: str, mesh_name: str,
             out_dir: Optional[str] = None) -> dict:
    """One cell's record, written to ``out_dir/<cell>.json`` where given."""
    shape = SHAPES[shape_name]
    cfg = get_arch(arch_name)
    record: Dict[str, Any] = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
    else:
        mesh = shape_mesh(mesh_name)
        cell = build_cell(cfg, shape, mesh)
        chips = math.prod(axis_sizes(mesh).values())
        entry = rl.RooflineEntry(
            arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
            flops_per_chip=rl.model_flops(cfg, shape) / chips,
            bytes_per_chip=rl.model_bytes(cfg, shape) / chips,
            coll_bytes_per_chip=None, coll_breakdown=None, peak_memory_bytes=None,
            model_flops_global=rl.model_flops(cfg, shape),
            model_bytes_global=rl.model_bytes(cfg, shape))
        record.update(status="ok", kv_layout=cell.layout,
                      argument_size_in_bytes=argument_bytes(cell, mesh),
                      roofline=entry.to_dict(), counts=NO_COMPILER, collective_bytes=NOT_RUN)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch_name}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def line(rec: dict) -> str:
    """One row of the printed table."""
    head = f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} {rec['status']:8s}"
    if rec["status"] != "ok":
        return f"{head} {rec['reason']}"
    rf = rec["roofline"]
    return (f"{head} kv={str(rec['kv_layout']):6s} args/rank={rec['argument_size_in_bytes']:.3e} B"
            f" t_compute={rf['t_compute']:.3e} s t_memory={rf['t_memory']:.3e} s"
            f" bottleneck={rf['bottleneck']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run of the (arch x shape x mesh) cells")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16), both, or DxM: a (data, model) mesh")
    ap.add_argument("--out", default=None, help="a directory for one JSON record a cell")
    args = ap.parse_args(argv)
    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}.get(args.mesh, [args.mesh])
    records = [run_cell(a, s, m, args.out) for a in archs for s in shapes for m in meshes]
    for rec in records:
        print(line(rec), flush=True)
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"\ncells: {len(records)}  ok: {n_ok}  skipped(documented): {len(records) - n_ok}")


if __name__ == "__main__":
    main()
