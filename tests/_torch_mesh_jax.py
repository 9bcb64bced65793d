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

A ``serve`` case (``run_serve``) prefills the first S tokens of its batch
rows (``prompt`` of them where the case says) and takes STEPS decode steps
from that cache, grown by STEPS rows (to ``cache_rows`` where the case says;
K/V in the weights' type), each jitted as ``build_cell`` compiles them: the
cache placed by ``cache_logical_axes``, K/V by heads where the KV heads
divide the model axis, the batch is larger than 1 and the case leaves the
head sharding on (``kv_head_shard``, ``REPRO_KV_HEAD_SHARD`` in
``build_cell``), else by ``kvseq``.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial
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
    if "window" in changes:
        cfg = replace(cfg, window=changes["window"])
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
    tok = jnp.asarray(tokens[:case.get("batch", len(tokens))])
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


CACHE_FIELDS = ("k", "v", "conv_x", "conv_bc", "ssm")


def cache_out(cache):
    """{field: fp32 numpy array} of a cache's tensors, and {field: dtype name}."""
    arrays = {f: np.asarray(getattr(cache, f), np.float32) for f in CACHE_FIELDS
              if getattr(cache, f) is not None}
    dtypes = {f: str(getattr(cache, f).dtype) for f in arrays}
    return arrays, dtypes


def run_serve(case, arrays, tokens):
    """Prefill of ``case["batch"]`` rows of ``tokens[:, :S]`` (S = its width
    less ``case["steps"]``), then that many decode steps from the cache
    grown to the whole width, under the case's mesh: every logit and cache,
    and the grown cache the decode started from (in its own types)."""
    from jax.sharding import NamedSharding as NS
    cfg = config(case["arch"], case.get("changes", {}))
    params = params_in(arrays[case["arch"]], cfg, case["dtype"])
    steps = case["steps"]
    width = case["prompt"] + steps if "prompt" in case else tokens.shape[1]
    tok = jnp.asarray(tokens[:case["batch"], :width])
    s = tok.shape[1] - steps
    ACT_SEQ[0] = bool(case.get("act_seq"))
    shape = case["mesh"]
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    out = {}
    try:
        with use_mesh(mesh):
            p_shard = shardings_for(jt.param_logical_axes(cfg), params, mesh)
            prompt = tok[:, :s]
            t_shard = NS(mesh, logical_spec(("dp", None), mesh, prompt.shape))
            logits, cache = jax.jit(partial(jm.prefill, cfg=cfg),
                                    in_shardings=(p_shard, t_shard))(params, prompt)
            out["prefill_logits"] = np.asarray(logits, np.float32)
            out["prefill_cache"], _ = cache_out(cache)
            # the forward's logits at the prompt's last position: the
            # prefill's, without the bf16 K/V buffers it attends over
            out["forward_last"] = np.asarray(jax.jit(
                lambda p, t: jm.forward(p, t, cfg)[:, -1],
                in_shardings=(p_shard, t_shard))(params, prompt), np.float32)
            if cache.k is not None:
                # grown by the decode steps' rows; an fp32 model's K/V widened
                # to fp32 (exactly): the steps then write fp32 rows, which a
                # rounding of the two sides' fp32 values to bf16 would not
                # leave within 1e-5 (see tests/test_torch_mesh_serve.py)
                pad = [(0, 0), (0, 0), (0, case.get("cache_rows", s + steps) - s), (0, 0),
                       (0, 0)]
                kv = params["embed"].dtype
                cache = cache._replace(k=jnp.pad(cache.k, pad).astype(kv),
                                       v=jnp.pad(cache.v, pad).astype(kv))
            out["decode_from"], out["decode_from_dtypes"] = cache_out(cache)
            out["decode_from_pos"] = int(cache.pos)
            axes = jm.cache_logical_axes(cfg)
            if (case.get("kv_head_shard", True) and axes.k is not None
                    and cfg.n_kv_heads % shape[1] == 0 and tok.shape[0] > 1):
                axes = axes._replace(k=(None, "dp", None, "tp", None),
                                     v=(None, "dp", None, "tp", None))
            one = tok[:, s:s + 1]
            o_shard = NS(mesh, logical_spec(("dp", None), mesh, one.shape))
            c_shard = shardings_for(axes, cache, mesh)
            step = jax.jit(partial(jm.decode_step, cfg=cfg),
                           in_shardings=(p_shard, o_shard, c_shard))
            out["decode_logits"] = []
            for t in range(s, s + steps):
                # each call takes its cache placed as build_cell places it
                logits, cache = step(params, tok[:, t:t + 1], jax.device_put(cache, c_shard))
                out["decode_logits"].append(np.asarray(logits, np.float32))
            out["decode_cache"], _ = cache_out(cache)
    finally:
        ACT_SEQ[0] = False
    return out


def main(job_path, out_path):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    results = []
    for c in job["cases"]:
        if c["what"] == ("compression",):
            results.append(run_compression(job["compression"]))
        elif c["what"] == ("serve",):
            results.append(run_serve(c, job["arrays"], job["serve_tokens"]))
        else:
            results.append(run_case(c, job["arrays"], job["tokens"]))
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
