"""The port's logical-axis sharding rules against the JAX package's.

The seven cases of tests/test_sharding.py carried over to the port's
shape-only mesh (``ShapeMesh``, the counterpart of ``compat.abstract_mesh``);
the rules trees (``param_logical_axes``, ``opt_logical_axes``,
``cache_logical_axes``) equal the reference's; and for the four families at
their published and reduced shapes, on meshes (1, 1), (2, 2), (1, 4),
(16, 16) and (2, 16, 16), every leaf's spec of the three trees equals JAX's
``logical_spec`` on an abstract mesh of the same shape.  Shapes: the
parameters' from ``jax.eval_shape`` and the port's meta device, the caches'
at a batch of 16 x 512 positions and of 1 x 4096 (where ``kvseq`` takes the
axes the batch leaves)."""

import jax
import pytest

from repro import models as jm
from repro import train as jt
from repro.compat import abstract_mesh
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.sharding import logical_spec as jax_logical_spec
# the port
from repro_torch import models as tm
from repro_torch import train as tt
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.sharding import ShapeMesh
from repro_torch.sharding import act_axes
from repro_torch.sharding import constrain
from repro_torch.sharding import current_mesh
from repro_torch.sharding import logical_spec
from repro_torch.sharding import placements
from repro_torch.sharding import shardings_for
from repro_torch.sharding import use_mesh
from repro_torch.sharding.api import ACT_SEQ
from repro_torch.sharding.state import axes_leaves
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import leaves

ARCHS = ("llama3.2-3b", "deepseek-moe-16b", "mamba2-2.7b", "zamba2-7b")
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHES = ((16, 512), (1, 4096))


@pytest.fixture
def mesh():
    # real axis sizes without needing 256 processes
    return ShapeMesh((16, 16), ("data", "model"))


# ---------------------------------------------------------------------------
# tests/test_sharding.py, against the port
# ---------------------------------------------------------------------------
def test_no_mesh_is_noop():
    import torch
    x = torch.ones((4, 4))
    assert constrain(x, ("dp", "tp")) is x


def test_logical_spec_basic(mesh):
    assert logical_spec(("dp", None, "tp"), mesh) == ("data", None, "model")


def test_divisibility_filter(mesh):
    # dim size 3 cannot shard over data(16) → dropped; 64 can shard 16-way
    assert logical_spec(("dp", "tp"), mesh, shape=(3, 64)) == (None, "model")


def test_axis_used_once(mesh):
    # "dp" consumes data; "sp" (data) must then resolve to nothing
    assert logical_spec(("dp", "sp"), mesh) == ("data", None)


def test_kvseq_takes_leftover_axes(mesh):
    # batch=1: dp dropped by divisibility → kvseq gets data AND model
    assert logical_spec(("dp", "kvseq"), mesh, shape=(1, 512)) == (None, ("data", "model"))
    # batch shardable: data consumed by dp → kvseq falls back to model
    assert logical_spec(("dp", "kvseq"), mesh, shape=(32, 512)) == ("data", "model")


def test_act_axes_flag():
    try:
        ACT_SEQ[0] = False
        assert act_axes() == ("dp", None, "tp_act")
        ACT_SEQ[0] = True
        assert act_axes() == ("dp", "act_seq", None)
    finally:
        ACT_SEQ[0] = False


def test_multipod_spec():
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert logical_spec(("dp", None, "tp"), mesh) == (("pod", "data"), None, "model")


def test_use_mesh_binds_and_restores():
    mesh = ShapeMesh((1, 1), ("data", "model"))
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is mesh
    assert current_mesh() is None


def test_no_mesh_gives_the_empty_spec():
    assert logical_spec(("dp", "tp")) == () == tuple(jax_logical_spec(("dp", "tp")))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor import Shard
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None, "data"), mesh) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# The rules trees, and every leaf's spec against JAX's
# ---------------------------------------------------------------------------
def configs(arch, reduced):
    if reduced:
        return reduce_for_smoke(get_arch(arch)), jax_reduce(jax_get_arch(arch))
    return get_arch(arch), jax_get_arch(arch)


def jax_specs(axes_tree, shapes, mesh):
    def one(axes, struct):
        if axes is None or struct is None:
            return ()
        return tuple(jax_logical_spec(tuple(axes), mesh, shape=struct.shape))
    return jax.tree.map(one, axes_tree, shapes,
                        is_leaf=lambda x: x is None or (isinstance(x, tuple)
                                                        and not hasattr(x, "_fields")))


def jax_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                           and not hasattr(x, "_fields"))


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_trees_equal_the_reference(arch):
    cfg, jcfg = configs(arch, reduced=False)
    assert tt.param_logical_axes(cfg) == jt.param_logical_axes(jcfg)
    assert tt.opt_logical_axes(cfg) == jt.opt_logical_axes(jcfg)
    assert tt.batch_logical_axes() == jt.batch_logical_axes()
    assert tuple(tm.cache_logical_axes(cfg)) == tuple(jm.cache_logical_axes(jcfg))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("reduced", [False, True], ids=["published", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tree", ["params", "opt", "cache"])
def test_every_leaf_spec_equals_jax(arch, reduced, mesh_name, tree):
    shape, names = MESHES[mesh_name]
    cfg, jcfg = configs(arch, reduced)
    mesh, jmesh = ShapeMesh(shape, names), abstract_mesh(shape, names)
    if tree == "cache":
        geometries = CACHES
    else:
        geometries = [None]
    for geo in geometries:
        if tree == "cache":
            shapes = tm.init_cache(cfg, *geo, device="meta")
            jshapes = jax.eval_shape(lambda: jm.init_cache(jcfg, *geo))
            axes, jaxes = tm.cache_logical_axes(cfg), jm.cache_logical_axes(jcfg)
        else:
            shapes = tm.init_params(cfg, device="meta")
            jshapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
            rules = tt.param_logical_axes if tree == "params" else tt.opt_logical_axes
            jrules = jt.param_logical_axes if tree == "params" else jt.opt_logical_axes
            axes, jaxes = rules(cfg), jrules(jcfg)
        got = axes_leaves(shardings_for(axes, shapes, mesh))
        want = jax_leaves(jax_specs(jaxes, jshapes, jmesh))
        assert len(got) == len(want) > 0
        assert got == want, (geo, [(g, w) for g, w in zip(got, want) if g != w][:4])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_structure_matches_params(arch):
    """tests/test_substrate.py's case against the port's trees: the axes tree
    has the parameters' keys, every axes tuple the rank of its parameter, and
    the ZeRO axes the same length."""
    cfg = reduce_for_smoke(get_arch(arch))
    params = tm.init_params(cfg, seed=0, device="cpu")
    axes = tt.param_logical_axes(cfg)

    def keys(tree, prefix=""):
        if isinstance(tree, dict):
            return [k for n in sorted(tree) for k in keys(tree[n], f"{prefix}{n}/")]
        return [prefix[:-1]]

    assert keys(axes) == [k for k, _ in flatten_with_keys(params)]
    flat_a = axes_leaves(axes)
    for p, a in zip(leaves(params), flat_a):
        assert p.dim() == len(a), f"{arch}: rank mismatch {tuple(p.shape)} {a}"
    for a, z in zip(flat_a, axes_leaves(tt.opt_logical_axes(cfg))):
        assert len(a) == len(z)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_gives_the_reference_shapes(arch):
    """``init_params(cfg, device="meta")``, the port's ``jax.eval_shape``,
    gives every leaf the reference's whole shape, at the published size."""
    cfg, jcfg = configs(arch, reduced=False)
    shapes = tm.init_params(cfg, device="meta")
    jshapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
    assert [tuple(t.shape) for t in leaves(shapes)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jshapes)]
    assert all(t.device.type == "meta" for t in leaves(shapes))


def test_a_mesh_needs_the_callers_process_group():
    """The port picks no backend: without ``init_process_group`` there is no
    mesh to build."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.mesh import make_test_mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_test_mesh(1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh(multi_pod=True, device_type="cpu")
