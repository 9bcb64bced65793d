"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's ``launch/dryrun.py`` on the same meshes, without devices: the
reference's own ``build_cell`` runs on ``repro.compat.abstract_mesh`` (no
fake devices are needed to build a cell), and each of its ``in_shardings``
gives the shard shape of its argument (``.shard_shape``).

For every cell of ``ARCH_NAMES`` x ``SHAPES`` x {16x16, 2x16x16}: skipped
cells give ``cell_applicable``'s reason; every argument leaf of an
applicable cell (the train state with its ZeRO-1 moments and the tokens;
the parameters and the prompt; the parameters, one token a sequence and the
cache) has the reference's shard shape, and its argument bytes are those
shapes' bytes; the decode cells' K/V layout (``kv_layout``) is the
reference's rule, with ``REPRO_KV_HEAD_SHARD`` on and off.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices in
``os.environ``; ``jax_dryrun`` imports it in this file alone and restores
the variable right after, so that later files on the same worker, and the
JAX processes the mesh tests start, do not inherit it."""

import os

import jax
import pytest

from repro.compat import abstract_mesh
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cell_applicable as jax_applicable
from repro.configs import get_arch as jax_arch
# the port
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import SHAPES
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.models.model import kv_layout


MESH_NAMES = ("16x16", "2x16x16")
CELLS = [(a, s, m) for a in ARCH_NAMES for s in SHAPES for m in MESH_NAMES]
DECODE = [(a, s, m) for a, s, m in CELLS if SHAPES[s].kind == "decode"]
SKIP = (".pos",)   # the cache's position: a Python int in the port


def _key(path) -> str:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(str(k.key))
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append("." + k.name)
        else:
            parts.append(str(k.idx))
    return "/".join(parts)


def jax_dryrun():
    """The reference's ``launch/dryrun.py``, ``XLA_FLAGS`` as it was before
    the import (which sets it to 512 host devices)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def reference_shard_shapes(arch, shape, mesh_name):
    """{path: shard shape} of the reference's cell on an abstract mesh."""
    shape_t, names = dryrun.MESHES[mesh_name]
    mesh = abstract_mesh(shape_t, names)
    _, structs, shardings, _ = jax_dryrun().build_cell(jax_arch(arch), JAX_SHAPES[shape], mesh)
    by_path = {_key(p): s for p, s in jax.tree_util.tree_flatten_with_path(shardings)[0]}
    return {_key(p): tuple(by_path[_key(p)].shard_shape(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(structs)[0]
            if not _key(p).endswith(SKIP)}


def _port(arch, shape, mesh_name):
    mesh = dryrun.shape_mesh(mesh_name)
    cell = dryrun.build_cell(get_arch(arch), SHAPES[shape], mesh)
    return cell, mesh, dryrun.shard_shapes(cell, mesh)


@pytest.mark.parametrize("arch,shape,mesh", CELLS, ids=["-".join(c) for c in CELLS])
def test_every_leaf_has_the_reference_shard_shape(arch, shape, mesh):
    ok, why = jax_applicable(jax_arch(arch), JAX_SHAPES[shape])
    rec = dryrun.run_cell(arch, shape, mesh)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == why
        return
    assert rec["status"] == "ok"
    cell, mesh_obj, got = _port(arch, shape, mesh)
    want = reference_shard_shapes(arch, shape, mesh)
    assert sorted(got) == sorted(want)
    assert {k: s for k, (s, _) in got.items()} == want
    assert rec["argument_size_in_bytes"] == dryrun.argument_bytes(cell, mesh_obj)
    assert rec["kv_layout"] == cell.layout


@pytest.mark.parametrize("switch", ["1", "0"])
@pytest.mark.parametrize("arch,shape,mesh", DECODE, ids=["-".join(c) for c in DECODE])
def test_kv_layout_is_the_reference_rule(arch, shape, mesh, switch, monkeypatch):
    """``kv_layout`` is ``build_cell``'s rule, and with the switch off every
    decode cell's K/V shard shapes are the reference's ``kvseq`` ones."""
    monkeypatch.setenv("REPRO_KV_HEAD_SHARD", switch)
    cfg, sh = get_arch(arch), SHAPES[shape]
    m = dict(zip(dryrun.MESHES[mesh][1], dryrun.MESHES[mesh][0]))["model"]
    heads = (switch == "1" and cfg.n_kv_heads > 0 and cfg.n_kv_heads % m == 0
             and sh.global_batch > 1)
    assert kv_layout(cfg, sh.global_batch, dryrun.shape_mesh(mesh)) == ("heads" if heads
                                                                         else "kvseq")
    if switch == "0" and jax_applicable(jax_arch(arch), JAX_SHAPES[shape])[0]:
        got = {k: s for k, (s, _) in _port(arch, shape, mesh)[2].items()}
        assert got == reference_shard_shapes(arch, shape, mesh)


def test_the_production_decode_cells_that_need_kvseq():
    """llama3.2-3b's decode_32k shards K/V on the batch over data and the
    sequence over model (8 KV heads on a model axis of 16); zamba2-7b's
    long_500k (batch 1) the sequence over both; gemma-7b's (16 KV heads) the
    heads over model."""
    for arch, shape, layout, k in (
            ("llama3.2-3b", "decode_32k", "kvseq", (28, 8, 2048, 8, 128)),
            ("zamba2-7b", "long_500k", "kvseq", (13, 1, 2048, 32, 112)),
            ("gemma-7b", "decode_32k", "heads", (28, 8, 32768, 1, 256))):
        cell, _, shapes = _port(arch, shape, "16x16")
        assert cell.layout == layout and shapes["2/.k"][0] == k


def test_the_command_line_writes_a_record_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "all", "--mesh", "4x16",
                 "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 4 and all(f.startswith("llama3.2-3b__") for f in files)
    out = capsys.readouterr().out
    assert "cells: 4  ok: 3  skipped(documented): 1" in out
    assert "kv=kvseq" in out


def test_the_reference_import_leaves_xla_flags_as_they_were():
    before = os.environ.get("XLA_FLAGS")
    jax_dryrun()
    assert os.environ.get("XLA_FLAGS") == before
