"""The port's side of the mesh tests: a world of gloo ranks on the CPU.

``run_world(shape, cases, job, tmp)`` starts data x model processes (spawn),
each pinned to one torch thread and joined to a process group through a
``FileStore`` in ``tmp`` (no fixed port, so parallel test workers do not
collide).  Each builds ``make_test_mesh(data, model, device_type="cpu")``
and runs every case on it: the weights of ``job["arrays"]`` placed by the
sharding rules, the global batch ``job["tokens"]``, and what the case asks
for, gathered whole (loss, gradient norm and gradients; logits; one train
step's loss, gradient norm and parameters; a prefill and decode steps from
the JAX package's prefilled cache, the caches gathered whole; a serving
engine's tokens).  Rank 0 writes the results; a rank that fails fails the
world.
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
    if "vocab" in changes:
        cfg = replace(cfg, vocab=changes["vocab"])
    if "window" in changes:
        cfg = replace(cfg, window=changes["window"])
    return cfg


def _np(tree):
    from repro_torch.tree import flatten_with_keys
    return {k: v.detach().float().numpy() for k, v in flatten_with_keys(tree)
            if isinstance(v, torch.Tensor)}


def run_case(case, job, mesh):
    from repro_torch import convert
    from repro_torch import models as tm
    from repro_torch import train as tt
    from repro_torch.sharding import ACT_SEQ
    from repro_torch.sharding import comm
    from repro_torch.sharding import gather_tree
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.api import Stream
    from repro_torch.sharding.api import batch_axes
    from repro_torch.sharding.api import use_stream
    from repro_torch.train.loop import local_batch
    from repro_torch.tree import leaves
    from repro_torch.tree import unflatten
    if case["what"] == ("compression",):
        with use_mesh(mesh):
            return _compression(job["compression"])
    cfg = _config(case["arch"], case.get("changes", {}))
    dtype = torch.float32 if case["dtype"] == "fp32" else torch.bfloat16
    whole = convert.params_from_numpy(job["arrays"][weights_key(case)], "cpu", dtype=dtype)
    tokens = torch.from_numpy(np.asarray(job["tokens"])[:case.get("batch", B)]).long()
    axes = tt.param_logical_axes(cfg)
    shapes = tm.init_params(cfg, device="meta")
    out = {}
    ACT_SEQ[0] = bool(case.get("act_seq"))
    head_shard = os.environ.get("REPRO_KV_HEAD_SHARD")
    if not case.get("kv_head_shard", True):
        os.environ["REPRO_KV_HEAD_SHARD"] = "0"
    try:
        with use_mesh(mesh):
            params = shard_tree(whole, axes)
            if "serve" in case["what"]:
                return _serve(case, job, cfg, params, whole)
            if "engine" in case["what"]:
                return _engine(case, cfg, params, whole)
            if "own" in case["what"]:
                return _own_serve(case, job, cfg, params, whole)
            if "positions" in case["what"]:
                return _positions_prefill(case, job, cfg, params, whole)
            local = local_batch(tokens)
            if "step" in case["what"]:
                # as the train step: the batch's whole shape bound, the
                # gradients summed over the data axes that split it
                with use_stream(Stream(*tokens.shape)):
                    loss, grads = grads_on_another_thread(params, local, cfg)
                    for g in grads:
                        for a in batch_axes():
                            comm.all_reduce_(g, a)
                grads = unflatten(params, grads)
                out.update(loss=float(loss), grads=_np(gather_tree(grads, axes, shapes)),
                           grad_norm=float(tt.global_norm(grads, tt.loop.train_specs(cfg)[0])))
            if "logits" in case["what"] or "step" in case["what"]:
                with torch.no_grad(), use_stream(Stream(*tokens.shape)):
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
            if "runs" in case["what"]:
                out["runs"] = _entry_points(cfg, params, tokens)
    finally:
        ACT_SEQ[0] = False
        if head_shard is None:
            os.environ.pop("REPRO_KV_HEAD_SHARD", None)
        else:
            os.environ["REPRO_KV_HEAD_SHARD"] = head_shard
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


def _entry_points(cfg, params, tokens):
    """{entry point: the message of the NotImplementedError it raised under
    the bound mesh, or None where it ran and gave finite logits}:
    ``forward``, ``prefill`` and ``decode_step`` on the global batch."""
    from repro_torch import models as tm
    from repro_torch.train.loop import local_batch
    out = {}
    cache = tm.init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    calls = {"forward": lambda: tm.forward(params, local_batch(tokens), cfg),
             "prefill": lambda: tm.prefill(params, tokens, cfg)[0],
             "decode_step": lambda: tm.decode_step(params, tokens[:, :1], cache, cfg)[0]}
    for name, call in calls.items():
        try:
            with torch.no_grad():
                out[name] = None if bool(torch.isfinite(call()).all()) else "not finite"
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


def _cache_np(cache):
    return {f: getattr(cache, f).float().numpy() for f in CACHE_FIELDS
            if getattr(cache, f) is not None}


def _same_on_every_rank(t):
    """Whether every rank of the mesh holds the same bits as this one."""
    from repro_torch.sharding import comm
    from repro_torch.sharding import current_mesh
    every = comm.stack_over(t.contiguous(), list(current_mesh().mesh_dim_names))
    return all(torch.equal(every[0], x) for x in every)


def _serve(case, job, cfg, params, whole):
    """The port's side of ``_torch_mesh_jax.run_serve`` under the bound mesh:
    the prefill's logits and its cache gathered whole; the decode steps from
    the JAX package's grown cache (``case["decode_from"]``, in its own
    types) sharded onto the ranks, each step's logits and the last cache
    gathered whole; the K/V layout ``kv_layout`` chose; whether every rank
    got the same logits; and, on rank 0 without the mesh, the same prefill
    in one process.  A ``kvseq`` case (``layouts``) also takes the decode
    steps from the same cache in the heads layout under the mesh and, on
    rank 0, in one process."""
    from repro_torch import models as tm
    from repro_torch.models.model import gather_cache
    from repro_torch.models.model import kv_rows
    from repro_torch.models.model import shard_cache
    from repro_torch.sharding import use_mesh
    steps = case["steps"]
    tok = np.asarray(job["serve_tokens"])[:case["batch"], :case.get("prompt", S) + steps]
    tok = torch.from_numpy(tok).long()
    b, s = tok.shape[0], tok.shape[1] - steps
    out = {}
    same = []
    with torch.no_grad():
        logits, cache = tm.prefill(params, tok[:, :s], cfg)
        same.append(_same_on_every_rank(logits))
        out["prefill_logits"] = logits.float().numpy()
        out["prefill_cache"] = _cache_np(gather_cache(cache, cfg, b))
        arrays, dtypes = case["decode_from"]
        whole_cache = tm.Cache(pos=case["decode_from_pos"], **{
            f: torch.from_numpy(a).to(getattr(torch, dtypes[f])) for f, a in arrays.items()})
        cache = shard_cache(whole_cache, cfg)
        out["layout"] = "kvseq" if kv_rows(cache) else "heads"
        out["decode_logits"] = []
        for t in range(s, s + steps):
            logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, cfg)
            same.append(_same_on_every_rank(logits))
            out["decode_logits"].append(logits.float().numpy())
        out["decode_cache"] = _cache_np(gather_cache(cache, cfg, b))
        out["same_on_every_rank"] = same

        def steps_from(p, c):
            got = []
            for t in range(s, s + steps):
                logits, c = tm.decode_step(p, tok[:, t:t + 1], c, cfg)
                got.append(logits.float().numpy())
            return got

        if case.get("layouts"):
            out["heads_decode_logits"] = steps_from(
                params, shard_cache(whole_cache, cfg, layout="heads"))
        if dist.get_rank() == 0:
            with use_mesh(None):
                logits, cache = tm.prefill(whole, tok[:, :s], cfg)
                out["one_logits"], out["one_cache"] = logits.float().numpy(), _cache_np(cache)
                if case.get("layouts"):
                    out["one_decode_logits"] = steps_from(whole, whole_cache._replace(**{
                        f: getattr(whole_cache, f).clone() for f in arrays}))
    return out


def _own_serve(case, job, cfg, params, whole):
    """The port alone: a prefill of S tokens and SERVE_STEPS decode steps
    from its own cache, grown, under the bound mesh (logits, and the cache
    after each call gathered whole) and in one process on rank 0."""
    from repro_torch import models as tm
    from repro_torch.models.model import gather_cache
    from repro_torch.sharding import use_mesh
    tok = torch.from_numpy(np.asarray(job["serve_tokens"])).long() % cfg.vocab
    b, s = tok.shape[0], tok.shape[1] - SERVE_STEPS

    def run(p, gather):
        with torch.no_grad():
            logits, cache = tm.prefill(p, tok[:, :s], cfg)
            out = [(logits.numpy(), _cache_np(gather(cache)))]
            if cache.k is not None:
                pad = torch.zeros_like(cache.k[:, :, :SERVE_STEPS])
                cache = cache._replace(k=torch.cat([cache.k, pad], 2),
                                       v=torch.cat([cache.v, pad], 2))
            for t in range(s, s + SERVE_STEPS):
                logits, cache = tm.decode_step(p, tok[:, t:t + 1], cache, cfg)
                out.append((logits.numpy(), _cache_np(gather(cache))))
        return out

    out = dict(mesh=run(params, lambda c: gather_cache(c, cfg, b)))
    if dist.get_rank() == 0:
        with use_mesh(None):
            out["one"] = run(whole, lambda c: c)
    return out


def _positions_prefill(case, job, cfg, params, whole):
    """A prefill of the case's rows of S tokens with explicit (B, S)
    positions (even rows shifted by 5, odd rows starting at -4, whose first
    four rows see no key) under the bound mesh, which splits them with the
    batch: the logits and the cache gathered whole, whether every rank got
    the same logits, and (rank 0) the same prefill in one process."""
    from repro_torch import models as tm
    from repro_torch.models.model import gather_cache
    from repro_torch.sharding import use_mesh
    tok = torch.from_numpy(np.asarray(job["serve_tokens"])[:case["batch"], :S]).long()
    b = tok.shape[0]
    row = torch.arange(S)
    pos = torch.stack([row + 5 if i % 2 == 0 else row - 4 for i in range(b)])
    with torch.no_grad():
        logits, cache = tm.prefill(params, tok, cfg, positions=pos)
        out = dict(logits=logits.float().numpy(), cache=_cache_np(gather_cache(cache, cfg, b)),
                   same_on_every_rank=[_same_on_every_rank(logits)])
        if dist.get_rank() == 0:
            with use_mesh(None):
                logits, cache = tm.prefill(whole, tok, cfg, positions=pos)
                out["one_logits"], out["one_cache"] = logits.float().numpy(), _cache_np(cache)
    return out


ENGINE_PROMPTS = (5, 17, 32, 9, 24, 12)      # 6 requests; the last two reuse slots
ENGINE_NEW = (6, 3, 8, 4, 5, 7)              # ragged, so slots retire at other steps
ENGINE_SLOTS = 4


def _engine(case, cfg, params, whole):
    """Every request's tokens from a ``ServeEngine`` made under the bound
    mesh, every rank's, and (rank 0) the one-process engine's on the whole
    weights."""
    from repro_torch.models.model import kv_rows
    from repro_torch.serve.engine import Request
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import use_mesh
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in ENGINE_PROMPTS]

    layouts = []

    def serve(p):
        eng = ServeEngine(cfg, p, max_batch=ENGINE_SLOTS, max_seq=64, device="cpu")
        layouts.append("kvseq" if kv_rows(eng.cache) else "heads")
        reqs = [Request(uid=i, prompt=q, max_new_tokens=n)
                for i, (q, n) in enumerate(zip(prompts, ENGINE_NEW))]
        for r in reqs:
            eng.add_request(r)
        with torch.no_grad():
            eng.run_to_completion()
        return [r.tokens_out for r in reqs], eng.decode_calls

    mine = serve(params)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out = dict(ranks=every, layout=layouts[0])
    if dist.get_rank() == 0:
        with use_mesh(None):
            out["one"] = serve(whole)
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
CACHE_FIELDS = ("k", "v", "conv_x", "conv_bc", "ssm")
PORT_ONLY = {("engine",), ("own",), ("positions",)}     # cases the JAX package does not run
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 32            # the global batch: 4 sequences of 32 tokens
# serving: a prompt of S tokens (a multiple of the reduced SSM chunk of 32),
# then this many decode steps
SERVE_STEPS = 3
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


def serve_case(arch, mesh, act_seq=False, dtype="fp32", batch=B, **extra):
    """A prefill of ``batch`` rows of S tokens and SERVE_STEPS decode steps
    from the JAX package's prefilled cache, on both sides."""
    return dict(arch=arch, mesh=tuple(mesh), act_seq=act_seq, dtype=dtype, what=("serve",),
                batch=batch, steps=SERVE_STEPS, **extra)


def positions_case(arch, mesh, batch=B):
    """A prefill with explicit (B, S) positions under the mesh against one
    process (``_positions_prefill``), fp32: the port alone (one process holds
    positions against the JAX package: tests/test_torch_positions.py)."""
    return dict(arch=arch, mesh=tuple(mesh), act_seq=False, dtype="fp32",
                what=("positions",), batch=batch)


# kvseq cases: a prompt of KV_PROMPT tokens (within the reduced SSM chunk)
# into a cache of KV_ROWS rows, so that on 2 or 4 ranks the decode steps
# write rows 30, 31 and 32: the last row of one slice, then the first of the
# next; gemma2's window cut to KV_WINDOW rows, so that it binds and a slice
# boundary falls inside it
KV_PROMPT, KV_ROWS, KV_WINDOW = 30, 64, 8
KV_MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))


def kvseq_case(arch, mesh, batch=1, **extra):
    """A serve case whose cache ``kv_layout`` puts in the ``kvseq`` layout
    (a batch of 1, or KV heads the model axis does not divide, or the head
    sharding switched off), with the other layout's and one process's decode
    steps beside it (``layouts``)."""
    if arch == "gemma2-27b":
        extra["changes"] = dict(extra.get("changes", {}), window=KV_WINDOW)
    return serve_case(arch, mesh, batch=batch, prompt=KV_PROMPT, cache_rows=KV_ROWS,
                      layouts=True, **extra)


def case_id(c) -> str:
    parts = [c["arch"].split("-")[0].split(".")[0], "x".join(map(str, c["mesh"]))]
    if c.get("batch", B) != B:
        parts.append(f"b{c['batch']}")
    if c["act_seq"]:
        parts.append("actseq")
    if c.get("changes", {}).get("capacity_factor") is not None:
        parts.append(f"cf{c['changes']['capacity_factor']}")
    if c.get("microbatches", 1) > 1:
        parts.append(f"mb{c['microbatches']}")
    if c.get("layouts"):
        parts.append("kvseq")
    if c["what"] == ("positions",):
        parts.append("positions")
    if not c.get("kv_head_shard", True):
        parts.append("noheadshard")
    parts.append(c["dtype"])
    return "-".join(parts)


def weights_key(c) -> str:
    """The key of a case's weights in a job: its architecture, and the
    vocabulary where the case changes it."""
    vocab = c.get("changes", {}).get("vocab")
    return c["arch"] if vocab is None else f"{c['arch']}@{vocab}"


def make_job(cases, path):
    """The weights of each architecture (the port's ``init_params``, seed 0,
    bf16, as numpy) and a global batch, written to ``path``."""
    from repro_torch import convert
    from repro_torch import models as tm
    arrays = {}
    for c in cases:
        if "arch" in c and weights_key(c) not in arrays:
            vocab = {k: v for k, v in c.get("changes", {}).items() if k == "vocab"}
            cfg = _config(c["arch"], vocab)
            arrays[weights_key(c)] = convert.params_to_numpy(tm.init_params(cfg, seed=0,
                                                                            device="cpu"))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (B, S))
    # two ranks' gradients for the compression cases: unequal scales, values
    # on both sides of a quantization step
    compression = {"w": (rng.standard_normal((2, 8, 8)) * [[[1.0]], [[0.3]]]).astype(np.float32),
                   "b": rng.uniform(-0.01, 0.01, (2, 5)).astype(np.float32)}
    serve_tokens = rng.integers(0, 512, (B, S + SERVE_STEPS))
    job = dict(arrays=arrays, tokens=tokens, compression=compression, cases=cases,
               serve_tokens=serve_tokens)
    with open(path, "wb") as f:
        pickle.dump(job, f)
    return job


def run_both(cases, tmp):
    """[(port result, JAX result)] of every case: the JAX process runs while
    the port's worlds (one a mesh shape) do; with ``serve`` cases it runs
    first, and each serve case takes its prefilled cache to the port's
    decode steps."""
    import subprocess
    import sys
    if all(c["what"] in PORT_ONLY for c in cases):
        return [(r, None) for r in run_port(cases, tmp)]
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
        if any(c["what"] == ("serve",) for c in cases):
            ref = _jax_result(proc, out_path)
            cases = [dict(c, decode_from=(r["decode_from"], r["decode_from_dtypes"]),
                          decode_from_pos=r["decode_from_pos"]) if c["what"] == ("serve",)
                     else c for c, r in zip(cases, ref)]
        port = _worlds(cases, job_path, tmp)
        ref = _jax_result(proc, out_path)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return list(zip(port, ref))


def _worlds(cases, job_path, tmp):
    """The port's result of every case, one world a mesh shape."""
    port = [None] * len(cases)
    for shape in sorted({c["mesh"] for c in cases}):
        idx = [i for i, c in enumerate(cases) if c["mesh"] == shape]
        res = run_world(shape, [cases[i] for i in idx], job_path,
                        os.path.join(tmp, "x".join(map(str, shape))))
        for i, r in zip(idx, res):
            port[i] = r
    return port


def run_port(cases, tmp):
    """The port's result of every case, for cases that only the port runs."""
    os.makedirs(tmp, exist_ok=True)
    job_path = os.path.join(tmp, "job.pkl")
    make_job(cases, job_path)
    return _worlds(cases, job_path, tmp)


def _jax_result(proc, out_path):
    """The JAX process's results, once it has ended."""
    if proc.returncode is None:
        log, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
        proc.log = log
    if proc.returncode:
        raise RuntimeError(f"the JAX side failed:\n{proc.log[-4000:]}")
    with open(out_path, "rb") as f:
        return pickle.load(f)


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


def check_leaves(got, want, what, skip=(), tols=None):
    """Every leaf but ``skip`` within its tolerance (``tols`` by the key's
    last part, TOL otherwise) of its scale."""
    assert sorted(got) == sorted(want), f"{what}: keys differ"
    for k in want:
        if k not in skip:
            held(got[k], want[k], f"{what} {k}", (tols or {}).get(k.split("/")[-1], TOL))


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


# ---------------------------------------------------------------------------
# Serving cases
# ---------------------------------------------------------------------------
def check_cache(got, want, what, hold=held):
    """Every field of two caches (gathered whole), each held by ``hold``."""
    assert sorted(got) == sorted(want), f"{what}: fields {sorted(got)} vs {sorted(want)}"
    for f in want:
        hold(got[f], want[f], f"{what} {f}")


def check_decode(port, ref, hold=held):
    """Each decode step's logits and the cache after the last step."""
    assert len(port["decode_logits"]) == len(ref["decode_logits"]) == SERVE_STEPS
    for i, (got, want) in enumerate(zip(port["decode_logits"], ref["decode_logits"])):
        hold(got, want, f"decode step {i} logits")
    check_cache(port["decode_cache"], ref["decode_cache"], "cache after decoding", hold)


def check_prefill_logits(port, ref):
    """The fp32 prefill's logits against the JAX package's forward at the
    prompt's last position under the same mesh, within TOL of their scale."""
    held(port["prefill_logits"], ref["forward_last"], "prefill logits")


def check_kvseq_layouts(port):
    """A kvseq case: the cache took the kvseq layout, and its decode steps'
    logits equal, within TOL of their scale, those of the same steps from
    the same cache in the heads layout under the mesh and in one process."""
    assert port["layout"] == "kvseq"
    for what in ("heads", "one"):
        for i, (got, want) in enumerate(zip(port["decode_logits"],
                                            port[f"{what}_decode_logits"])):
            held(got, want, f"decode step {i} logits, kvseq vs {what}")


def check_positions_one_process(port):
    """A positions case: logits and every gathered cache tensor within TOL
    of their scale of the one-process prefill's."""
    held(port["logits"], port["one_logits"], "prefill logits with positions")
    check_cache(port["cache"], port["one_cache"], "prefill cache with positions")


def check_prefill_one_process(port):
    """The fp32 prefill under the mesh against the port's own one-process
    call: logits and every gathered cache tensor within TOL of its scale."""
    held(port["prefill_logits"], port["one_logits"], "prefill logits")
    check_cache(port["prefill_cache"], port["one_cache"], "prefill cache")
