#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                      # every phase, as a release check
    python3 chip_smoke.py --phases build,kernels --build-log nvcc.log

Phases, each printing one JSON line; any exception or failed check ends the
run with a non-zero exit code:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit as nvidia-smi gives them.
2. build    compiles ``src/repro_torch/csrc/*.cu`` into ``build/``.
3. kernels  each hand-written kernel against its plain PyTorch version on the
            card, over dtypes, head sizes, ragged lengths, the poisoned dead
            region (decode) and the pinned/streamed splits (flash); times each
            kernel at the serving path's shapes beside its plain version, one
            library call (``scaled_dot_product_attention``, a yardstick only:
            the port never calls it) and the card's bound for the same work.
4. serve    llama3.2-3b at full width and depth (28 layers, bf16, random
            weights from a seeded generator on the card) behind
            ``ServeEngine(max_batch=8, max_seq=2048)``: 16 requests with
            prompts of 64 to 1024 tokens, 32 new tokens each.  The kernels'
            launch counts are set to 0 just before and read just after.
5. parity   the same weights, 2 layers: prefill + 4 decode steps on the card
            (kernels) against the same calls on the CPU (plain versions).

The last lines are the ``{"kernels": [...]}`` record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
from dataclasses import replace
import json
from pathlib import Path
import statistics
import subprocess
import sys
import time

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks of one H100 SXM (dense): bytes/s of device memory and FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # attention: rtol = atol
LOGIT_TOL = 3e-2                                     # bf16 model logits: rtol = atol
PHASES = ("device", "build", "kernels", "serve", "parity")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def close(out, ref, tol, what):
    """max |out - ref|, after asserting |out - ref| <= tol + tol * |ref|."""
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = (out - ref).abs()
    check(bool((err <= tol + tol * ref.abs()).all()),
          f"{what}: max abs err {float(err.max()):.3e} beyond tol {tol}")
    return float(err.max())


def time_ms(fn, flush, reps=10, iters=20):
    """Device milliseconds of one ``fn()``.

    A kernel of a few microseconds cannot be timed launch by launch: the host
    needs longer to issue it than the card to run it, and two events around
    one call measure the host.  So ``reps`` calls are captured into a CUDA
    graph, each after a rewrite of a 64 MB buffer (the 50 MB L2 starts cold, as
    a serving step that streams the weights between attention calls leaves
    it); the graph is replayed ``iters`` times between CUDA events, and the
    median time of a graph that holds only the rewrites is taken off."""
    fn()
    torch.cuda.synchronize()

    def median_replay(body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                flush.zero_()
                body()
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return (median_replay(fn) - median_replay(lambda: None)) / reps


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs one CUDA device", file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build(build_log):
    from repro_torch.kernels import build
    from repro_torch.kernels import kernels_built
    t0 = time.time()
    build.build(verbose=bool(build_log))
    build.load()
    check(kernels_built(), "kernel library did not load")
    if build_log:
        Path(build_log).parent.mkdir(parents=True, exist_ok=True)
        Path(build_log).write_text(str(build.build_info.get("log", "")))
    emit("build", seconds=round(time.time() - t0, 2),
         sources=[p.name for p in build.sources()],
         library=Path(str(build.build_info["path"])).name)


# ---------------------------------------------------------------------------
def decode_cases():
    bf, f32 = torch.bfloat16, torch.float32
    main_lens = [1, 2048, 777, 64, 1500, 300, 2047, 1024]
    # (B, S, H, G, D, dtype, lens)
    return [
        (8, 2048, 24, 8, 128, bf, main_lens),
        (8, 2048, 24, 8, 128, f32, main_lens),
        (2, 512, 4, 1, 64, f32, [512, 37]),
        (2, 1000, 8, 2, 64, bf, [999, 1]),
        (1, 333, 16, 2, 128, f32, [333]),          # group 8: two head blocks
        (3, 129, 10, 2, 128, bf, [129, 5, 64]),    # group 5: one head a block
    ]


def check_decode(gen):
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    worst = {}
    for b, s, h, g, d, dtype, lens in decode_cases():
        q = randn(gen, (b, h, d), dtype)
        k = randn(gen, (b, s, g, d), dtype)
        v = randn(gen, (b, s, g, d), dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = decode_attention(q, k, v, cl)
        torch.cuda.synchronize()
        err = close(out, decode_attention_ref(q, k, v, cl), TOL[dtype],
                    f"decode {(b, s, h, g, d, dtype)}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # a strided view of a larger pool, and one split against many
    pool_k = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    pool_v = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    q = randn(gen, (4, 6, 128), torch.bfloat16)
    cl = torch.tensor([700, 0, 123, 17], dtype=torch.int32, device="cuda")
    ref = decode_attention_ref(q, pool_k[1], pool_v[1], cl)
    for n_splits in (1, 7):
        out = decode_attention(q, pool_k[1], pool_v[1], cl, n_splits=n_splits)
        close(out, ref, TOL[torch.bfloat16], f"decode pool view, {n_splits} split(s)")
    check(bool((out[1] == 0).all()), "decode: cache_len 0 must give zeros")
    # rows at or past cache_len are dead: poisoning them changes nothing
    q = randn(gen, (1, 4, 64), torch.float32)
    k = randn(gen, (1, 512, 2, 64), torch.float32)
    v = randn(gen, (1, 512, 2, 64), torch.float32)
    cl = torch.tensor([300], dtype=torch.int32, device="cuda")
    out1 = decode_attention(q, k, v, cl)
    k2, v2 = k.clone(), v.clone()
    k2[:, 300:] = 1e4
    v2[:, 300:] = -1e4
    out2 = decode_attention(q, k2, v2, cl)
    check(bool((out1 - out2).abs().max() <= 1e-6), "decode: poisoned dead rows leaked")
    close(out2, decode_attention_ref(q, k2, v2, cl), 2e-5, "decode poison vs plain")
    return worst


def flash_cases():
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    # (B, Sq, Sk, H, G, D, causal, softcap, pinned, dtype)
    for s in (17, 128, 1000, 1024):
        for dtype in (bf, f32):
            fit = 256 if dtype == bf else 64
            for pinned in sorted({0, 64 if s >= 64 else s, s if s <= fit else fit}):
                cases.append((1, s, s, 24, 8, 128, True, None, pinned, dtype))
    cases += [
        (2, 128, 512, 4, 1, 128, False, None, 0, f32),
        (1, 100, 333, 8, 2, 128, False, None, 128, bf),
        (1, 100, 200, 8, 2, 64, False, None, 200, f32),
        (1, 256, 256, 4, 2, 128, True, 50.0, 0, f32),
        (1, 300, 300, 4, 2, 128, True, 50.0, 64, bf),
        (2, 256, 256, 4, 2, 64, True, None, 128, f32),
        (2, 257, 257, 8, 2, 64, True, None, 257, bf),
        (1, 384, 384, 2, 2, 128, True, None, 256, bf),
    ]
    return cases


def check_flash(gen):
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    worst = {}
    for b, sq, sk, h, g, d, causal, softcap, pinned, dtype in flash_cases():
        q = randn(gen, (b, sq, h, d), dtype)
        k = randn(gen, (b, sk, g, d), dtype)
        v = randn(gen, (b, sk, g, d), dtype)
        out = flash_attention(q, k, v, causal=causal, softcap=softcap,
                              pinned_rows=pinned)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, softcap=softcap)
        err = close(out, ref, TOL[dtype],
                    f"flash {(b, sq, sk, h, g, d, causal, softcap, pinned, dtype)}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # pinned_rows is a pure schedule parameter: fp32 outputs agree to 1e-5,
    # also when a block walks several Q tiles with the prefix resident
    q = randn(gen, (1, 320, 6, 128), torch.float32)
    k = randn(gen, (1, 320, 2, 128), torch.float32)
    v = randn(gen, (1, 320, 2, 128), torch.float32)
    base = flash_attention(q, k, v, causal=True, pinned_rows=0)
    for pinned, tiles in ((64, None), (64, 5), (0, 2), (64, 1)):
        other = flash_attention(q, k, v, causal=True, pinned_rows=pinned,
                                tiles_per_chunk=tiles)
        close(other, base, 1e-5, f"flash pinned equivalence {pinned}/{tiles}")
    # a cache slice longer than the prompt, read through its strides
    pool_k = randn(gen, (1, 512, 8, 128), torch.bfloat16)
    pool_v = randn(gen, (1, 512, 8, 128), torch.bfloat16)
    q = randn(gen, (1, 200, 24, 128), torch.bfloat16)
    out = flash_attention(q, pool_k[:, :200], pool_v[:, :200], pinned_rows=200)
    close(out, attention_ref(q, pool_k[:, :200], pool_v[:, :200]), TOL[torch.bfloat16],
          "flash on a strided cache slice")
    return worst


def time_kernels(gen, flush):
    """Times at the serving path's shapes.  Returns the two records of the
    ``kernels`` line, without their launch counts."""
    from repro_torch.core.orchestrator import CacheOrchestrator
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels import flash_attention
    bf = torch.bfloat16
    records = []

    # decode: the engine's pool (8 slots x 2048 rows), slots at mixed positions
    b, s, h, g, d = 8, 2048, 24, 8, 128
    lens = [97, 1056, 540, 801, 333, 1000, 650, 128]
    q = randn(gen, (b, h, d), bf)
    k = randn(gen, (b, s, g, d), bf)
    v = randn(gen, (b, s, g, d), bf)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < cl[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)

    def lib_decode():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True)

    ref = decode_attention_ref(q, k, v, cl)
    err = close(decode_attention(q, k, v, cl), ref, TOL[bf], "decode at the serving shape")
    close(lib_decode()[:, :, 0], ref, TOL[bf], "library decode vs plain")
    n_bytes = (2 * g * d * 2 * sum(lens)) + 2 * q.numel() * 2 + cl.numel() * 4
    n_flops = 4 * h * d * sum(lens)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    records.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "shape": {"B": b, "S": s, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "cache_len": lens},
        "max_abs_err": err, "tol": TOL[bf],
        "ms": time_ms(lambda: decode_attention(q, k, v, cl), flush),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, cl), flush),
        "library_ms": time_ms(lib_decode, flush),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    })

    # flash: one request's prefill, split as the engine's orchestrator plans it
    orch = CacheOrchestrator(vmem_budget_bytes=hopper_pin_budget_bytes(d, 2))
    extra = []
    for sq in (1024, 256):
        pinned, _ = orch.plan_kv_split(sq, FLASH_TILE_ROWS, 2 * d * 2)
        q = randn(gen, (1, sq, h, d), bf)
        k = randn(gen, (1, sq, g, d), bf)
        v = randn(gen, (1, sq, g, d), bf)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def lib_flash():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        ref = attention_ref(q, k, v)
        err = close(flash_attention(q, k, v, pinned_rows=pinned), ref, TOL[bf],
                    "flash at the serving shape")
        close(lib_flash().transpose(1, 2), ref, TOL[bf], "library flash vs plain")
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
        n_flops = 4 * sq * sq * d * h // 2
        t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
        rec = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
            "shape": {"B": 1, "Sq": sq, "Sk": sq, "H": h, "G": g, "D": d,
                      "dtype": "bfloat16", "causal": True, "pinned_rows": pinned},
            "max_abs_err": err, "tol": TOL[bf],
            "ms": time_ms(lambda: flash_attention(q, k, v, pinned_rows=pinned), flush),
            "ms_unpinned": time_ms(lambda: flash_attention(q, k, v, pinned_rows=0), flush),
            "plain_ms": time_ms(lambda: attention_ref(q, k, v), flush),
            "library_ms": time_ms(lib_flash, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        (records if sq == 1024 else extra).append(rec)
    return records, extra


def phase_kernels():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    worst_decode = check_decode(gen)
    worst_flash = check_flash(gen)
    records, extra = time_kernels(gen, flush)
    emit("kernels", decode_cases_max_abs_err=worst_decode,
         flash_cases_max_abs_err=worst_flash, tol={str(k): v for k, v in TOL.items()},
         timed=records + extra)
    return records


# ---------------------------------------------------------------------------
def phase_serve(n_requests, max_new):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serve import Request
    from repro_torch.serve import ServeEngine
    cfg = get_arch("llama3.2-3b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
           cfg.d_ff, cfg.vocab) == (28, 3072, 24, 8, 128, 8192, 128256),
          "llama3.2-3b is not at its published size")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    engine = ServeEngine(cfg, params, max_batch=8, max_seq=2048, device="cuda")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(64, 1025))
        prompt = rng.integers(2, cfg.vocab, size=plen).astype(np.int32)
        reqs.append(Request(uid=i, prompt=prompt, max_new_tokens=max_new))
        engine.add_request(reqs[-1])

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    steps = engine.run_to_completion(max_steps=100000)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = launch_counts()

    tokens = sum(len(r.tokens_out) for r in reqs)
    for r in reqs:
        check(r.done and len(r.tokens_out) == max_new,
              f"request {r.uid} ended with {len(r.tokens_out)} tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens_out),
              f"request {r.uid} has a token outside the vocabulary")
    check(engine._tmu.live_tiles == 0, "TMU still tracks live slots")
    check(engine.prefill_calls == n_requests, "prefill calls != requests")
    check(counts["flash_attention"] == n_requests * cfg.n_layers,
          f"flash launches {counts['flash_attention']} != requests x layers")
    check(engine.decode_calls > 0
          and counts["decode_attention"] == cfg.n_layers * engine.decode_calls,
          f"decode launches {counts['decode_attention']} != layers x "
          f"{engine.decode_calls} decode_step calls")
    check(bool(torch.isfinite(engine.last_logits.float()).all()), "non-finite logits")
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         requests=n_requests, prompt_tokens=int(sum(len(r.prompt) for r in reqs)),
         new_tokens=tokens, seconds=seconds, tokens_per_s=tokens / seconds,
         engine_steps=steps, decode_step_calls=engine.decode_calls,
         launches=counts, init_params_seconds=init_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return cfg, params, counts


def phase_parity(cfg, params):
    """Prefill + 4 decode steps of a 2-layer cut of the served weights, on the
    card (kernels) and on the CPU (plain versions).

    In fp32 (the same weights, widened) every logit must agree within
    rtol = atol = 3e-2: that holds the kernels to the plain path inside the
    model, free of rounding noise.  In bf16, the serving type, the two devices
    round activations at other places (another summation order in every
    product flips last bits, and the flips travel through the layers), so
    over 1.3 million logits the largest difference is a tail event, not a
    fault: there the check is the share of logits within the same tolerance,
    the RMS error, and the greedy token wherever the CPU's top-2 margin is
    clear of the tolerance."""
    from repro_torch.models import decode_step
    from repro_torch.models import prefill
    cfg2 = replace(cfg, n_layers=2)

    def cut_params(dev, dtype):
        out = {k: v.to(device=dev, dtype=dtype) for k, v in params.items()
               if not isinstance(v, dict)}
        out["layers"] = {
            name: {k: v[:2].to(device=dev, dtype=dtype) for k, v in sub.items()}
            for name, sub in params["layers"].items()}
        return out

    rng = np.random.default_rng(1)
    prompt = rng.integers(2, cfg.vocab, size=(2, 48))
    steps = rng.integers(2, cfg.vocab, size=(4, 2, 1))

    def run(dev, dtype):
        p = cut_params(dev, dtype)
        got, cache = prefill(p, torch.as_tensor(prompt, device=dev), cfg2,
                             pinned_rows=48)
        pad = torch.zeros_like(cache.k[:, :, :4])
        cache = cache._replace(k=torch.cat([cache.k, pad], dim=2),
                               v=torch.cat([cache.v, pad], dim=2))
        outs = [got]
        for tok in steps:
            got, cache = decode_step(p, torch.as_tensor(tok, device=dev), cache, cfg2)
            outs.append(got[:, 0])
        return torch.stack(outs).float().cpu()

    card, cpu = run("cuda", torch.float32), run("cpu", torch.float32)
    check(card.shape == (5, 2, cfg.vocab), "parity: wrong logits shape")
    err32 = close(card, cpu, LOGIT_TOL, "parity fp32: card vs CPU logits")

    card, cpu = run("cuda", torch.bfloat16), run("cpu", torch.bfloat16)
    check(bool(torch.isfinite(card).all()), "parity bf16: non-finite logits")
    err = (card - cpu).abs()
    share = float((err <= LOGIT_TOL + LOGIT_TOL * cpu.abs()).float().mean())
    rms = float(err.square().mean().sqrt())
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * (LOGIT_TOL + LOGIT_TOL * top2[..., 0].abs())
    same = card.argmax(-1) == cpu.argmax(-1)
    check(share >= 0.999, f"parity bf16: only {share:.5f} of the logits within {LOGIT_TOL}")
    check(rms <= LOGIT_TOL / 2, f"parity bf16: RMS logit error {rms:.4f}")
    check(bool(same[clear].all()), "parity bf16: greedy token differs at a clear margin")
    emit("parity", n_layers=2, calls="prefill(2x48) + 4 decode steps", tol=LOGIT_TOL,
         fp32_max_abs_err=err32, bf16_max_abs_err=float(err.max()),
         bf16_share_within_tol=share, bf16_rms_err=rms,
         bf16_clear_margin_tokens=int(clear.sum()), bf16_tokens_equal=int(same.sum()))


# ---------------------------------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--build-log", metavar="PATH",
                    help="pass -Xptxas -v to nvcc and write its output to PATH")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")

    smi = phase_device()
    phase_build(args.build_log)
    records = phase_kernels() if "kernels" in phases else []
    if "serve" in phases:
        cfg, params, counts = phase_serve(args.requests, args.max_new)
        for rec in records:
            rec["launches"] = counts[rec["name"]]
            check(rec["launches"] > 0, f"{rec['name']} was not launched by the serve run")
        if "parity" in phases:
            phase_parity(cfg, params)
    complete = set(phases) == set(PHASES)
    if complete:
        print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if not complete:
        raise SystemExit(4)


if __name__ == "__main__":
    main()
