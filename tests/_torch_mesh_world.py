"""The port's side of the mesh tests: a world of gloo ranks on the CPU.

``run_world(shape, cases, job, tmp)`` starts data x model processes (spawn),
each pinned to one torch thread and joined to a process group through a
``FileStore`` in ``tmp`` (no fixed port, so parallel test workers do not
collide).  Each builds ``make_test_mesh(data, model, device_type="cpu")``
and runs every case on it: the weights of ``job["arrays"]`` placed by the
sharding rules, the global batch ``job["tokens"]``, and what the case asks
for, gathered whole (loss, gradient norm and gradients; logits; one train
step's loss, gradient norm and parameters).  Rank 0 writes the results;
a rank that fails fails the world.
"""

from __future__ import annotations

from dataclasses import replace
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300


def _config(arch, changes):
    from repro_torch.configs import get_arch
    from repro_torch.configs import reduce_for_smoke
    cfg = reduce_for_smoke(get_arch(arch))
    cf = changes.get("capacity_factor")
    if cf is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    return cfg


def _np(tree):
    from repro_torch.tree import flatten_with_keys
    return {k: v.detach().float().numpy() for k, v in flatten_with_keys(tree)
            if isinstance(v, torch.Tensor)}


def run_case(case, job, mesh):
    from repro_torch import convert
    from repro_torch import models as tm
    from repro_torch import train as tt
    from repro_torch.sharding.api import dp_axes
    from repro_torch.sharding import ACT_SEQ
    from repro_torch.sharding import comm
    from repro_torch.sharding import gather_tree
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding import use_mesh
    from repro_torch.train.loop import local_batch
    from repro_torch.tree import leaves
    from repro_torch.tree import unflatten
    if case["what"] == ("compression",):
        with use_mesh(mesh):
            return _compression(job["compression"])
    cfg = _config(case["arch"], case.get("changes", {}))
    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    whole = convert.params_from_numpy(job["arrays"][case["arch"]], "cpu", dtype=dtype)
    tokens = torch.from_numpy(np.asarray(job["tokens"])).long()
    axes = tt.param_logical_axes(cfg)
    shapes = tm.init_params(cfg, device="meta")
    out = {}
    ACT_SEQ[0] = bool(case.get("act_seq"))
    try:
        with use_mesh(mesh):
            params = shard_tree(whole, axes)
            local = local_batch(tokens)
            if "step" in case["what"]:
                loss, grads = grads_on_another_thread(params, local, cfg)
                for g in grads:
                    for a in dp_axes(mesh):
                        comm.all_reduce_(g, a)
                grads = unflatten(params, grads)
                out.update(loss=float(loss), grads=_np(gather_tree(grads, axes, shapes)),
                           grad_norm=float(tt.global_norm(grads, tt.loop.train_specs(cfg)[0])))
            if "logits" in case["what"] or "step" in case["what"]:
                with torch.no_grad():
                    logits = tm.forward(params, local, cfg, remat=False)
                out["logits"] = gather_tree(
                    logits, ("dp", None, "tp"),
                    torch.empty(tokens.shape + (cfg.vocab,), device="meta")).float().numpy()
            if "step" in case["what"]:
                step = tt.make_train_step(cfg, tt.AdamWConfig(**case["opt"]),
                                          case.get("microbatches", 1), device="cpu")
                state = tt.init_sharded_train_state(whole, cfg)
                sliced = tt.shard_train_state(tt.init_train_state(whole), cfg)
                out["init_matches"] = [(tuple(a.shape), tuple(b.shape), bool(torch.equal(a, b)))
                                       for a, b in zip(leaves(state), leaves(sliced))]
                state, metrics = step(state, tokens)
                state = tt.gather_train_state(state, cfg)
                out.update(step_loss=float(metrics["loss"]),
                           step_grad_norm=float(metrics["grad_norm"]),
                           step_lr=float(metrics["lr"]), step_params=_np(state.params))
            if "refusals" in case["what"]:
                out["refusals"] = _refusals(cfg, params, local)
    finally:
        ACT_SEQ[0] = False
    return out


def grads_on_another_thread(params, tokens, cfg):
    """``loss_and_grads`` with the backward on a thread where no mesh is
    bound, as autograd runs a card's backward: each layer's recomputation
    must bind the forward's mesh itself."""
    import threading
    from repro_torch import models as tm
    from repro_torch.tree import leaves
    from repro_torch.tree import unflatten
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = tm.lm_loss(tm.forward(unflatten(params, flat), tokens, cfg), tokens)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, flat)
        except BaseException as exc:
            out["error"] = exc

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return loss.detach(), list(out["grads"])


def _compression(grads):
    """Two ``compressed_psum_mean`` calls over the data axis, this rank's
    gradients ``grads[rank]``, from zero error: each call's mean (the same on
    every rank) and every rank's error after it, stacked."""
    from repro_torch import train as tt
    from repro_torch.sharding import comm
    r = comm.axis_group("data")[2]
    g = {k: torch.from_numpy(v[r]) for k, v in grads.items()}
    err = tt.init_error_feedback(g)
    out = {}
    for i in range(2):
        mean, err = tt.compressed_psum_mean(g, err, "data")
        out[f"mean{i}"] = {k: v.numpy() for k, v in mean.items()}
        out[f"err{i}"] = {k: comm.stack_over(v, ["data"]).numpy() for k, v in err.items()}
    return out


def _refusals(cfg, params, tokens):
    """{entry point: the message of the NotImplementedError it raised under
    the bound mesh, or None where it raised none}: ``forward``, and
    ``prefill`` and ``decode_step``, which no mesh runs yet."""
    from repro_torch import models as tm
    out = {}
    cache = tm.init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    calls = {"forward": lambda: tm.forward(params, tokens, cfg),
             "prefill": lambda: tm.prefill(params, tokens, cfg),
             "decode_step": lambda: tm.decode_step(params, tokens[:, :1], cache, cfg)}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


def _rank(rank, shape, cases, job_path, tmp):
    torch.set_num_threads(1)
    err_path = os.path.join(tmp, f"error{rank}.txt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=rank, world_size=shape[0] * shape[1])
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh(*shape, device_type="cpu")
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        results = [run_case(c, job, mesh) for c in cases]
        if rank == 0:
            with open(os.path.join(tmp, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(shape, cases, job_path, tmp):
    """Every case on a (data, model) mesh of gloo ranks; one result each."""
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_rank, args=(tuple(shape), cases, job_path, tmp),
                             nprocs=shape[0] * shape[1], start_method="spawn", join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh {shape} did not finish in {TIMEOUT_S} s")
    except Exception as exc:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        errors = [open(os.path.join(tmp, n)).read() for n in sorted(os.listdir(tmp))
                  if n.startswith("error")]
        raise RuntimeError(f"mesh {shape} failed:\n" + "\n".join(errors)) from exc
    with open(os.path.join(tmp, "results.pkl"), "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# Both packages on the same cases, and the comparisons
# ---------------------------------------------------------------------------
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 32            # the global batch: 4 sequences of 32 tokens
JAX_TIMEOUT_S = 600
# fp32: every compared value within this of its leaf's (or tensor's) scale
TOL = 1e-5
# the optimizer of the step cases: Adam's first step moves a parameter by
# lr * g / (|g| + eps); with eps 1 that is a smooth function of the gradient
# (about lr * g), so the moved parameters can be held elementwise, where at
# eps 1e-8 a gradient within its tolerance of 0 could move either way by lr
STEP_OPT = dict(lr=0.1, eps=1.0, warmup_steps=0, total_steps=10)


def case(arch, mesh, act_seq=False, dtype="fp32", **extra):
    # fp32: the step, with its batch's gradients and logits; bf16: the logits
    what = ("step",) if dtype == "fp32" else ("logits",)
    return dict(arch=arch, mesh=tuple(mesh), act_seq=act_seq, dtype=dtype, what=what,
                opt=STEP_OPT, **extra)


def case_id(c) -> str:
    parts = [c["arch"].split("-")[0].split(".")[0], "x".join(map(str, c["mesh"]))]
    if c["act_seq"]:
        parts.append("actseq")
    if c.get("changes", {}).get("capacity_factor") is not None:
        parts.append(f"cf{c['changes']['capacity_factor']}")
    if c.get("microbatches", 1) > 1:
        parts.append(f"mb{c['microbatches']}")
    parts.append(c["dtype"])
    return "-".join(parts)


def make_job(cases, path):
    """The weights of each architecture (the port's ``init_params``, seed 0,
    bf16, as numpy) and a global batch, written to ``path``."""
    from repro_torch import convert
    from repro_torch import models as tm
    arrays = {}
    for c in cases:
        if "arch" in c and c["arch"] not in arrays:
            cfg = _config(c["arch"], {})
            arrays[c["arch"]] = convert.params_to_numpy(tm.init_params(cfg, seed=0,
                                                                       device="cpu"))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (B, S))
    # two ranks' gradients for the compression cases: unequal scales, values
    # on both sides of a quantization step
    compression = {"w": (rng.standard_normal((2, 8, 8)) * [[[1.0]], [[0.3]]]).astype(np.float32),
                   "b": rng.uniform(-0.01, 0.01, (2, 5)).astype(np.float32)}
    job = dict(arrays=arrays, tokens=tokens, compression=compression, cases=cases)
    with open(path, "wb") as f:
        pickle.dump(job, f)
    return job


def run_both(cases, tmp):
    """[(port result, JAX result)] of every case: the JAX process runs while
    the port's worlds (one a mesh shape) do."""
    import subprocess
    import sys
    os.makedirs(tmp, exist_ok=True)
    job_path = os.path.join(tmp, "job.pkl")
    make_job(cases, job_path)
    # 4 host devices; one thread each, beside the worlds' single-thread ranks
    flags = ("--xla_force_host_platform_device_count=4 --xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out_path = os.path.join(tmp, "jax.pkl")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_mesh_jax.py"),
                             job_path, out_path], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = [None] * len(cases)
        for shape in sorted({c["mesh"] for c in cases}):
            idx = [i for i, c in enumerate(cases) if c["mesh"] == shape]
            res = run_world(shape, [cases[i] for i in idx], job_path,
                            os.path.join(tmp, "x".join(map(str, shape))))
            for i, r in zip(idx, res):
                port[i] = r
        log, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        raise RuntimeError(f"the JAX side failed:\n{log[-4000:]}")
    with open(out_path, "rb") as f:
        ref = pickle.load(f)
    return list(zip(port, ref))


def held(got, want, what, tol=TOL):
    """|got - want| <= tol * max |want|, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}"
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} beyond {tol} x {scale:.3e}"


def held_by_share(got, want, what, tol=3e-2):
    """bf16: the share of |got - want| / max |want| within ``tol`` (at least
    0.99), its RMS (at most tol / 2) and its largest value (at most 0.5)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rel = np.abs(got - want) / float(np.abs(want).max())
    share, rms = float((rel <= tol).mean()), float(np.sqrt(np.mean(rel ** 2)))
    assert share >= 0.99 and rms <= tol / 2 and rel.max() <= 0.5, \
        f"{what}: share {share:.4f}, RMS {rms:.4f}, cap {rel.max():.4f}"


def check_loss(port, ref):
    for k in ("loss", "step_loss"):
        assert abs(port[k] - ref[k]) <= TOL * max(1.0, abs(ref[k])), (k, port[k], ref[k])
    for k in ("grad_norm", "step_grad_norm"):
        assert abs(port[k] - ref[k]) <= TOL * ref[k], (k, port[k], ref[k])
    assert port["step_lr"] == pytest.approx(ref["step_lr"], rel=1e-6)


def check_leaves(got, want, what):
    assert sorted(got) == sorted(want), f"{what}: keys differ"
    for k in want:
        held(got[k], want[k], f"{what} {k}")


def single_device(c):
    """(loss, {key: gradient}) of case ``c``'s batch on one process, no mesh."""
    from repro_torch import convert
    from repro_torch import models as tm
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.tree import flatten_with_keys
    cfg = _config(c["arch"], c.get("changes", {}))
    arrays = convert.params_to_numpy(tm.init_params(_config(c["arch"], {}), seed=0,
                                                    device="cpu"))
    params = convert.params_from_numpy(arrays, "cpu", dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (B, S)))
    loss, grads = loss_and_grads(params, tokens, cfg)
    keys = [k for k, _ in flatten_with_keys(params)]
    return float(loss), {k: g.numpy() for k, g in zip(keys, grads)}
