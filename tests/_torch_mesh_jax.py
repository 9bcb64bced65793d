"""The JAX package's side of the mesh tests, run as its own process:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_mesh_jax.py JOB.pkl OUT.pkl

``JOB.pkl`` (written by the test that starts this process) holds the
weights of each architecture as numpy trees, the tokens, and the cases: an
architecture, its config changes, a (data, model) mesh or none, ``ACT_SEQ``,
the dtype and what to compute (cases that only the port runs, such as
``refusals``, get an empty result).  The mesh is a ``jax.sharding.Mesh`` over the
first data x model CPU devices, whose axes are Auto: under JAX 0.9
``launch/mesh.py::make_test_mesh`` builds one with Explicit axes
(``jax.make_mesh``), on which the reference's ``constrain`` raises.  Every
function is jitted with ``in_shardings`` from the sharding rules, as
``launch/dryrun.py::build_cell`` does, and traced under ``use_mesh``.
``OUT.pkl`` gets one dict of numpy results a case.
"""

from __future__ import annotations

from dataclasses import replace
import pickle
import sys

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
import numpy as np

from repro import models as jm
from repro import train as jt
from repro.configs import get_arch
from repro.configs import reduce_for_smoke
from repro.sharding import logical_spec
from repro.sharding import use_mesh
from repro.sharding.api import ACT_SEQ


def config(arch, changes):
    cfg = reduce_for_smoke(get_arch(arch))
    moe = changes.get("capacity_factor")
    if moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=moe))
    return cfg


def shardings_for(axes_tree, struct_tree, mesh):
    """``launch/dryrun.py::shardings_for`` (importing that module would set
    the device count to 512)."""
    def one(axes, struct):
        if axes is None or struct is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, logical_spec(tuple(axes), mesh, shape=struct.shape))

    def is_axes_leaf(x):
        return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields"))

    return jax.tree.map(one, axes_tree, struct_tree, is_leaf=is_axes_leaf)


def params_in(arrays, cfg, dtype):
    """fp32 leaves, or bf16 with the reference's own leaf types."""
    if dtype == "fp32":
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), arrays)
    shapes = jax.eval_shape(lambda: jm.init_params(cfg, jax.random.key(0)))
    return jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)


def flat(tree):
    out, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path):
            np.asarray(leaf, np.float32) for path, leaf in out}


def run_case(case, arrays, tokens):
    cfg = config(case["arch"], case.get("changes", {}))
    params = params_in(arrays[case["arch"]], cfg, case["dtype"])
    tok = jnp.asarray(tokens)
    ACT_SEQ[0] = bool(case.get("act_seq"))
    shape = case.get("mesh")
    mesh = None
    if shape is not None:
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = jax.sharding.Mesh(devs, ("data", "model"))
    out = {}
    try:
        with use_mesh(mesh):
            kw = {}
            if mesh is not None:
                p_shard = shardings_for(jt.param_logical_axes(cfg), params, mesh)
                t_shard = NamedSharding(mesh, logical_spec(("dp", None), mesh, tok.shape))
                kw = dict(in_shardings=(p_shard, t_shard))

            def loss(p, t):
                logits = jm.forward(p, t, cfg)
                return jm.lm_loss(logits, t), logits

            if "step" in case["what"]:
                # one program: the train step, and the gradients and logits of
                # its batch (XLA computes the shared forward and backward once)
                opt = jt.AdamWConfig(**case["opt"])
                step = jt.make_train_step(cfg, opt, case.get("microbatches", 1))
                state = jt.init_train_state(params)
                skw = {}
                if mesh is not None:
                    o_ax = jt.opt_logical_axes(cfg)
                    s_shard = type(state)(params=p_shard, opt=type(state.opt)(
                        m=shardings_for(o_ax, state.opt.m, mesh),
                        v=shardings_for(o_ax, state.opt.v, mesh),
                        step=NamedSharding(mesh, P())))
                    skw = dict(in_shardings=(s_shard, t_shard))

                def both(st, t):
                    return step(st, t), jax.value_and_grad(loss, has_aux=True)(st.params, t)

                (new, metrics), ((value, logits), grads) = jax.jit(both, **skw)(state, tok)
                out.update(loss=float(value), logits=np.asarray(logits, np.float32),
                           grads=flat(grads), grad_norm=float(jt.global_norm(grads)),
                           step_loss=float(metrics["loss"]),
                           step_grad_norm=float(metrics["grad_norm"]),
                           step_lr=float(metrics["lr"]), step_params=flat(new.params))
            elif "logits" in case["what"]:
                out["logits"] = np.asarray(jax.jit(
                    lambda p, t: jm.forward(p, t, cfg), **kw)(params, tok), np.float32)
    finally:
        ACT_SEQ[0] = False
    return out


def run_compression(grads):
    """Two ``compressed_psum_mean`` calls inside ``shard_map`` over the data
    axis of a (2, 1) mesh, shard r holding ``grads[k][r]``: each call's mean
    (shard 0's) and every shard's error."""
    from repro.compat import shard_map
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    f = jax.jit(shard_map(lambda g, e: jt.compressed_psum_mean(g, e, "data"), mesh=mesh,
                          in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                          check_vma=False))
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    err = jt.init_error_feedback(g)
    out = {}
    for i in range(2):
        mean, err = f(g, err)
        out[f"mean{i}"] = {k: np.asarray(v)[0] for k, v in mean.items()}
        out[f"err{i}"] = {k: np.asarray(v) for k, v in err.items()}
    return out


def main(job_path, out_path):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    results = [run_compression(job["compression"]) if c["what"] == ("compression",)
               else run_case(c, job["arrays"], job["tokens"]) for c in job["cases"]]
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
