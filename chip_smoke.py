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
            card, over dtypes, head sizes, ragged and mostly-zero lengths,
            lengths at the edges of a work unit, the poisoned dead region and
            one work unit against many (decode, whose merge counters must be
            back at 0), the pinned/streamed splits, GQA groups, softcap and
            chunkings (flash, whose bf16 outputs must be bit-identical across
            splits and chunkings), and group counts, initial states and
            strided views (SSD scan); times each kernel at the serving path's shapes
            (decode also at a serving call's one live position group) beside
            its plain version, one library call where one computes the same
            function (``scaled_dot_product_attention`` for attention, a
            yardstick only: the port never calls it; none exists for the SSD
            scan) and the card's bound for the same work.  The flash backward
            (training) against its plain version over both types, head sizes
            64, 112, 128 and 256, GQA groups 1–8, lengths 17–1024, sliding
            windows of 1, 63, 64 and 100 rows and softcaps 2, 30 and 50; the forward's
            per-row LSE against the plain one, O unchanged by it and the LSE
            bit-identical across splits; calls without a backward kernel
            refused under grad; the backward timed at the training shapes of
            llama3.2-3b, zamba2-7b (head_dim 112), deepseek-moe-16b,
            gemma2-27b (window and softcap) and gemma-7b (head_dim 256), and
            at gemma2's 5120-token row, where its window binds.
            The backward is held elementwise on each gradient row's and
            64-row tile's scale (``grad_err``), which planted faults must
            fail.  The SSD backward (training) against its plain version
            ``ssd_bwd_ref`` and against autograd of ``ssd_ref`` over the
            SSD cases' fp32 shapes, with and without an initial state and a
            final-state gradient, and on strided views through
            ``SSDScanFn``, by the same rule at 1e-4 (``ssd_grad_err``),
            which planted faults must fail; timed at the training shapes of
            mamba2-2.7b and zamba2-7b.
4. serve    llama3.2-3b at full width and depth (28 layers, bf16, random
            weights from a seeded generator on the card) behind
            ``ServeEngine(max_batch=8, max_seq=2048)``: 16 requests with
            prompts of 64 to 1024 tokens, 32 new tokens each.  The kernels'
            launch counts are set to 0 just before and read just after.
5. parity   the same weights, 2 layers: prefill + 4 decode steps on the card
            (kernels) against the same calls on the CPU (plain versions).
6. serve_ssm   mamba2-2.7b at full width and depth (64 layers, bf16, seeded
            random weights) behind ``ServeEngine(max_batch=8, max_seq=2048)``:
            8 requests, prompts of 3 to 256 tokens or 512, 768 or 1024 (lengths
            the reference's chunk rule accepts), 32 new tokens each; counts as
            in 4.
7. parity_ssm  its 2-layer cut: prefill of 2 x 64 tokens + 4 decode steps,
            card against CPU.
8. serve_hybrid   zamba2-7b at full width and depth (81 Mamba2 layers in 13
            groups of 6 + a tail of 3, one weight-shared attention + MLP block
            after each group; head_dim 112; bf16, seeded random weights) behind
            ``ServeEngine(max_batch=8, max_seq=2048)``: 8 requests drawn as in
            6, 32 new tokens each; all three kernels, counts as in 4.
9. parity_hybrid  its cut to one group and one tail layer (7 layers):
            prefill of 2 x 64 tokens + 4 decode steps, card against CPU.
10. serve_moe   deepseek-moe-16b at full width and depth (28 layers: one dense,
            27 with 64 routed experts, top-6, and 2 shared experts; MHA,
            head_dim 128; bf16, seeded random weights) behind
            ``ServeEngine(max_batch=8, max_seq=2048)``: 8 requests drawn as in
            4, 32 new tokens each; counts as in 4.
11. parity_moe  its cut to the dense layer and one MoE layer: prefill of
            2 x 64 tokens + 4 decode steps, card against CPU; the card's
            router logits against the CPU's fp32 product on the same tokens,
            which a router planted in bf16 must fail.
12. serve_gemma2   gemma2-27b at full width and depth (46 layers alternating a
            local layer, window 4096, with a global one; attention softcap
            50, final softcap 30, score scale 144^-0.5; bf16, seeded random
            weights, 56.8 GB) behind ``ServeEngine(max_batch=4,
            max_seq=6144)``: 8 requests, six drawn as in 4 and two of 4160 and
            5120 tokens, past the window, the second in a reused slot; 32 new
            tokens each; counts as in 4.
13. parity_gemma2  its cut to one local and one global layer, with the window
            set to 64 so that a prefill of 2 x 96 tokens + 4 decode steps
            overruns it: card against CPU.
14. serve_gemma7b   gemma-7b at full width and depth (28 layers, d_model 3072,
            16 heads MHA at head_dim 256, GeGLU d_ff 24576, vocab 256000; bf16,
            seeded random weights, 18.6 GB) behind ``ServeEngine(max_batch=8,
            max_seq=2048)``: 8 requests drawn as in 4, 32 new tokens each;
            counts as in 4.
15. parity_gemma7b  its 2-layer cut: prefill of 2 x 64 tokens + 4 decode
            steps, card against CPU.
16. train   llama3.2-3b trained at full width and depth (bf16, seeded random
            weights, 8 x 512 tokens a step, remat, AdamW as launch/train.py
            builds it): 6 steps, the last 2 in 2 microbatches; losses finite
            and falling, launch counts (set to 0 just before, read just
            after) exactly those of the forward, its recomputation and the
            backward of every layer and microbatch.
17. parity_train  one train step of its 2-layer cut at full width on the
            card against the CPU (fp32 gradients elementwise, bf16 by share),
            then the card's state, each leaf cut to its first 1024 rows and
            columns, checkpointed and restored on the CPU, bit-equal.
18. train_ssm   mamba2-2.7b trained at full width and depth (64 layers,
            d_model 2560, 2.83 B parameters), as in 16: the SSD forward twice
            and its backward's three kernels once a layer and microbatch,
            nothing else launched.
19. parity_train_ssm  one train step of its 2-layer cut at full width, 2 x
            256 tokens (two SSD chunks), card against CPU as in 17 (the
            CPU's fp32 scan in float64), without the checkpoint; every
            gradient leaf nonzero on the card (so in 17, 21 and 23 too).
20. train_hybrid   zamba2-7b trained at full width and a cut depth (45
            layers: 7 groups of 6 Mamba2 layers, each followed by the shared
            attention block at head_dim 112, and a tail of 3; 81 do not fit
            one card with Adam's state), as in 16 at a peak learning rate
            of 1e-4 (``TRAIN_PATHS``): the flash forward twice
            and its backward once an application of the shared block, the
            SSD forward twice and its backward once a Mamba2 layer, each a
            microbatch.
21. parity_train_hybrid  one train step of its cut to one group of 2 Mamba2
            layers, the shared block and a tail of 1, 2 x 256 tokens, card
            against CPU as in 19.
22. train_moe   deepseek-moe-16b trained at full width and a cut depth (7
            layers: the dense layer and 6 MoE layers; 28 do not fit), as in
            20, tokens dropped at the published capacity factor 1.25.
23. parity_train_moe  one train step of its cut to the dense layer and one
            MoE layer, 2 x 64 tokens, which drop at the capacity: card against
            CPU as in 17 without the checkpoint, the CPU following the card's
            expert choices, the tokens each side dropped counted and the
            router logits held as in 11.
24. train_gemma2   gemma2-27b trained at full width and a cut depth (2 layers:
            one local, window 4096, and one global; attention softcap 50,
            final softcap 30, score scale 144^-0.5; 46 do not fit), as in 20:
            the flash forward twice and its backward, with the window and the
            softcap, once a layer and microbatch.
25. parity_train_gemma2  one train step of its 2 layers with the window cut
            to 64, 2 x 128 tokens, so that the window binds: card against CPU
            as in 17 without the checkpoint.
26. train_gemma7b   gemma-7b trained at full width and a cut depth (8
            layers, head_dim 256; 28 do not fit), as in 20.
27. parity_train_gemma7b  one train step of its 2-layer cut, 2 x 128
            tokens: card against CPU as in 25.

The kernels phase holds the attention kernels at head_dim 64, 112, 128 and
256, with and without a sliding window (both) and a softcap (decode too), and
the SSD scan at d_state 16 to 128, and times each kernel at the shapes of
every path that runs it (llama3.2-3b, zamba2-7b, deepseek-moe-16b, gemma2-27b
and gemma-7b for attention, mamba2-2.7b and zamba2-7b for the SSD scan);
each record of the ``kernels`` line names its path and carries the launches
of that path's serve phase (the backwards': of their train phases).  The
whole run takes about 8 to 9 minutes of command time on an H100, the
build's 30 to 45 seconds included; the ``timing`` line gives each phase's
host seconds.

fp32 products run in full fp32 on the card: TF32 is switched off for
matmuls and cuDNN.  The last lines are the ``timing`` line, the
``{"kernels": [...]}`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
from contextlib import ExitStack
from contextlib import contextmanager
from contextlib import nullcontext
from dataclasses import replace
import gc
import json
from pathlib import Path
import re
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
# the fastest product rate that keeps fp32 accuracy: 3xTF32, three TF32
# tensor-core products (495 TFLOP/s dense) for each fp32 one
PEAK_FP32_ACCURATE_MMA = 495e12 / 3
SSD_COUNT_Q = 64   # counting convention for the SSD scan's operations (see ssd_record)
# the decode kernel's timed calls: slots at mixed positions, and a serving
# call's one live position group (most of the serve phase's launches)
DECODE_RAGGED = [97, 1056, 540, 801, 333, 1000, 650, 128]
DECODE_ONE_GROUP = [0, 0, 801, 0, 0, 0, 0, 0]
# gemma2-27b: its local layers' window and its score scale, and the decode
# kernel's timed calls on its pool (8 slots x 6144 rows): two slots past the
# window, and a serving call's one live group
GEMMA2_WINDOW = 4096
GEMMA2_SCALE = 144.0 ** -0.5
GEMMA2_POOL = 6144
GEMMA2_DECODE_RAGGED = [97, 1056, 540, 801, 4160, 5120, 650, 128]
GEMMA2_DECODE_ONE_GROUP = [0, 0, 0, 0, 0, 5120, 0, 0]
SSD_PROMPTS = (1024, 256)   # prompt lengths the SSD scan is timed at
# the timed shapes of each path: attention (H, G, D), SSD scan (H, P, N)
ATTN_SHAPES = {"llama3.2-3b": (24, 8, 128), "zamba2-7b": (32, 32, 112),
               "deepseek-moe-16b": (16, 16, 128), "gemma2-27b": (32, 16, 128),
               "gemma-7b": (16, 16, 256)}
SSD_SHAPES = {"mamba2-2.7b": (80, 64, 128), "zamba2-7b": (112, 64, 64)}
# each path's attention timings: its attention's options (a local layer's
# window, softcap, score scale), the decode pool's rows, and the cases in
# order, (kernel, decode lengths or flash tokens, on a local layer); the first
# case of each kernel is its record in the kernels line.  Decode: slots at
# mixed positions, and a serving call's one position group; flash: one
# request's prefill, split as the engine's orchestrator plans it.
ATTN_TIMED_DEFAULT = dict(cases=(("decode", DECODE_RAGGED, False), ("flash", 1024, False),
                                 ("decode", DECODE_ONE_GROUP, False), ("flash", 256, False)))
ATTN_TIMED = {
    # gemma2-27b: its pool with two slots past the window, as a local and a
    # global layer, and its one live group; flash at 5120 tokens as a local
    # and a global layer, and at 1024, where the window does not bind
    "gemma2-27b": dict(
        window=GEMMA2_WINDOW, softcap=50.0, scale=GEMMA2_SCALE, pool=GEMMA2_POOL,
        cases=(("decode", GEMMA2_DECODE_RAGGED, True), ("flash", 5120, True),
               ("decode", GEMMA2_DECODE_RAGGED, False),
               ("decode", GEMMA2_DECODE_ONE_GROUP, True), ("flash", 5120, False),
               ("flash", 1024, True)))}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # attention: rtol = atol
SSD_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}  # SSD scan: rtol = atol, the reference's
LOGIT_TOL = 3e-2                                     # bf16 model logits: rtol = atol
# a MoE parity run on the CPU follows the card's expert choices; the tokens it
# would route otherwise must be near-ties, and few (phase_parity)
ROUTER_NEAR_TIE = 2e-3
ROUTER_MAX_FLIPS = 0.1
# the card's router logits against the CPU's fp32 product on the same tokens
# and weights: times their largest magnitude (router_log)
ROUTER_LOGIT_TOL = 1e-4
PHASES = ("device", "build", "kernels", "serve", "parity", "serve_ssm", "parity_ssm",
          "serve_hybrid", "parity_hybrid", "serve_moe", "parity_moe", "serve_gemma2",
          "parity_gemma2", "serve_gemma7b", "parity_gemma7b", "train", "parity_train",
          "train_ssm", "parity_train_ssm", "train_hybrid", "parity_train_hybrid", "train_moe",
          "parity_train_moe", "train_gemma2", "parity_train_gemma2", "train_gemma7b",
          "parity_train_gemma7b")
PATH_REQUESTS = 8   # requests of every serve phase but llama3.2-3b's


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def refused(fn, what):
    """Check that ``fn()`` raises ValueError before any launch."""
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{what} was not refused")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return smi


def kernel_name(mangled):
    """``flash_mma_kernel<Li128>`` from ``_ZN<n><namespace><m><kernel>I<args>EE...``,
    the mangled name of a kernel template in an anonymous namespace."""
    if not mangled.startswith("_ZN"):
        return mangled
    pos = 3
    for _ in range(2):  # past the namespace's name, then over the kernel's
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            return mangled
        start, pos = pos + m.end(), pos + m.end() + int(m.group())
    targs = re.match(r"I(\w*?)EE", mangled[pos:])
    return mangled[start:pos] + (f"<{targs.group(1)}>" if targs else "")


def ptxas_usage(log):
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def phase_build(build_log):
    from repro_torch.kernels import build
    from repro_torch.kernels import kernels_built
    t0 = time.time()
    build.build(verbose=bool(build_log))
    build.load()
    check(kernels_built(), "kernel library did not load")
    extra = {}
    if build_log:
        log = str(build.build_info.get("log", ""))
        Path(build_log).parent.mkdir(parents=True, exist_ok=True)
        Path(build_log).write_text(log)
        extra["ptxas"] = ptxas_usage(log)
    emit("build", seconds=round(time.time() - t0, 2),
         sources=[p.name for p in build.sources()],
         library=Path(str(build.build_info["path"])).name, **extra)
    return extra.get("ptxas")


# ---------------------------------------------------------------------------
UNIT_ROWS = 128   # a unit length the edge cases straddle, also run fixed at it


def decode_cases():
    r = UNIT_ROWS
    bf, f32 = torch.bfloat16, torch.float32
    main_lens = [1, 2048, 777, 64, 1500, 300, 2047, 1024]
    # (B, S, H, G, D, dtype, lens[, window, softcap])
    return [
        (8, 2048, 24, 8, 128, bf, main_lens),
        (8, 2048, 24, 8, 128, f32, main_lens),
        (2, 512, 4, 1, 64, f32, [512, 37]),
        (2, 1000, 8, 2, 64, bf, [999, 1]),
        (1, 333, 16, 2, 128, f32, [333]),          # group 8: two head blocks
        (3, 129, 10, 2, 128, bf, [129, 5, 64]),    # group 5: one head a block
        # the serving path's calls: one position group live, the other rows 0
        (8, 2048, 24, 8, 128, bf, [0, 0, 801, 0, 0, 0, 0, 0]),
        (8, 2048, 24, 8, 128, f32, [0, 0, 0, 0, 0, 0, 0, 33]),
        # lengths at the edges of a work unit of r rows, and the capacity S
        # (each case also runs with the unit fixed at r rows)
        (5, 2048, 24, 8, 128, bf, [r - 1, r, r + 1, 2048, 0]),
        (4, 2 * r + 1, 8, 2, 64, f32, [0, r + 1, 2 * r + 1, r]),
        (3, 3 * r, 12, 4, 128, f32, [3 * r, r - 1, 2 * r + 1]),
        (2, r - 1, 8, 1, 64, bf, [r - 1, 0]),      # group 8, S below one unit
        # head_dim 112 (zamba2-7b, MHA: one head a block; 8 lanes share a row's
        # 14 or 28 chunks unevenly); GQA groups 2 and 4 at 112
        (8, 2048, 32, 32, 112, bf, main_lens),
        (8, 2048, 32, 32, 112, f32, main_lens),
        (8, 2048, 32, 32, 112, bf, [0, 0, 801, 0, 0, 0, 0, 0]),
        (5, 2048, 32, 32, 112, bf, [r - 1, r, r + 1, 2048, 0]),
        (3, 2 * r + 1, 8, 2, 112, f32, [2 * r + 1, 0, 1]),
        (2, 700, 8, 4, 112, bf, [700, 129]),
        # deepseek-moe-16b: MHA, 16 heads of 128
        (8, 2048, 16, 16, 128, bf, main_lens),
        (8, 2048, 16, 16, 128, f32, main_lens),
        (8, 2048, 16, 16, 128, bf, [0, 0, 801, 0, 0, 0, 0, 0]),
        # qwen2-vl-7b (28 / 4 heads of 128: GQA group 7) and musicgen-large
        # (MHA, 32 heads of 64)
        (8, 2048, 28, 4, 128, bf, main_lens),
        (8, 2048, 28, 4, 128, f32, main_lens),
        (8, 2048, 32, 32, 64, bf, main_lens),
        (8, 2048, 32, 32, 64, f32, main_lens),
    ] + gemma2_decode_cases() + gemma7b_decode_cases()


def gemma2_decode_cases():
    """gemma2-27b's local and global layers (H 32, G 16, D 128, softcap 50):
    its serving pool with prompts past the 4096-row window, one live group,
    and windows of 1, 63, 64 and 65 rows with lengths just inside and just
    past them; a window alone and a softcap alone at other shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    lens = GEMMA2_DECODE_RAGGED
    edges = [63, 64, 65, 66, 129, 300, 1, 0]
    cases = [(8, 6144, 32, 16, 128, dtype, lens, window, 50.0)
             for dtype in (bf, f32) for window in (GEMMA2_WINDOW, None)]
    cases += [(8, 6144, 32, 16, 128, bf, GEMMA2_DECODE_ONE_GROUP, GEMMA2_WINDOW, 50.0)]
    cases += [(8, 300, 32, 16, 128, dtype, edges, window, 50.0)
              for window in (1, 63, 64, 65) for dtype in (bf, f32)]
    cases += [(3, 1000, 8, 2, 64, f32, [999, 1, 500], 100, None),
              (4, 700, 8, 4, 112, bf, [700, 129, 0, 64], None, 30.0)]
    return cases


def gemma7b_decode_cases():
    """head_dim 256 (gemma-7b: MHA, 16 heads; a lane owns 4 chunks of a bf16
    row, 8 of fp32, whose ring grows to two 64 KB steps): its serving pool at
    mixed positions and at one live group, lengths at the edges of a work
    unit, GQA groups 2 and 4 (two heads a block at most), and windows of 63
    and 64 rows with a softcap."""
    r = UNIT_ROWS
    bf, f32 = torch.bfloat16, torch.float32
    main_lens = [1, 2048, 777, 64, 1500, 300, 2047, 1024]
    edges = [63, 64, 65, 66, 129, 300, 1, 0]
    cases = [(8, 2048, 16, 16, 256, dtype, main_lens) for dtype in (bf, f32)]
    cases += [
        (8, 2048, 16, 16, 256, bf, DECODE_ONE_GROUP),
        (8, 2048, 16, 16, 256, f32, [0, 0, 0, 0, 0, 0, 0, 33]),
        (5, 2048, 16, 16, 256, bf, [r - 1, r, r + 1, 2048, 0]),
        (4, 2 * r + 1, 8, 8, 256, f32, [0, r + 1, 2 * r + 1, r]),
        (2, 700, 8, 2, 256, bf, [700, 129]),
        (3, 300, 4, 2, 256, f32, [300, 1, 0]),
    ]
    cases += [(8, 300, 16, 16, 256, dtype, edges, window, 50.0)
              for window in (63, 64) for dtype in (bf, f32)]
    cases += [(3, 1000, 8, 4, 256, bf, [999, 1, 500], 100, 30.0)]
    return cases


def check_decode(gen):
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels.decode_attention import ops as decode_ops
    worst = {}
    for case in decode_cases():
        b, s, h, g, d, dtype, lens, window, softcap = (case + (None, None))[:9]
        kw = dict(window=window, softcap=softcap)
        q = randn(gen, (b, h, d), dtype)
        k = randn(gen, (b, s, g, d), dtype)
        v = randn(gen, (b, s, g, d), dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ref = decode_attention_ref(q, k, v, cl, **kw)
        for rows in (None, UNIT_ROWS):   # R chosen per call, and fixed
            out = decode_attention(q, k, v, cl, rows_per_split=rows, **kw)
            torch.cuda.synchronize()
            err = close(out, ref, TOL[dtype], f"decode {(b, s, h, g, d, dtype, lens, rows)} "
                        f"window {window} softcap {softcap}")
            for i, n in enumerate(lens):
                check(n > 0 or bool((out[i] == 0).all()),
                      "decode: cache_len 0 must give zeros")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # a strided view of a larger pool, one work unit against many
    pool_k = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    pool_v = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    q = randn(gen, (4, 6, 128), torch.bfloat16)
    cl = torch.tensor([700, 0, 123, 17], dtype=torch.int32, device="cuda")
    ref = decode_attention_ref(q, pool_k[1], pool_v[1], cl)
    step = decode_ops.STEP_ROWS
    for rows in (-(-700 // step) * step, step, 3 * step):
        out = decode_attention(q, pool_k[1], pool_v[1], cl, rows_per_split=rows)
        close(out, ref, TOL[torch.bfloat16], f"decode pool view, {rows} rows a unit")
        check(bool((out[1] == 0).all()), "decode: cache_len 0 must give zeros")
    # rows at or past cache_len are dead: poisoning them changes nothing
    for h, g, d in ((4, 2, 64), (16, 16, 256)):
        q = randn(gen, (1, h, d), torch.float32)
        k = randn(gen, (1, 512, g, d), torch.float32)
        v = randn(gen, (1, 512, g, d), torch.float32)
        cl = torch.tensor([300], dtype=torch.int32, device="cuda")
        out1 = decode_attention(q, k, v, cl)
        k2, v2 = k.clone(), v.clone()
        k2[:, 300:] = 1e4
        v2[:, 300:] = -1e4
        out2 = decode_attention(q, k2, v2, cl)
        check(bool((out1 - out2).abs().max() <= 1e-6), f"decode D {d}: poisoned dead rows leaked")
        close(out2, decode_attention_ref(q, k2, v2, cl), 2e-5, f"decode D {d} poison vs plain")
        v2[:, 300:] = float("nan")
        check(bool(torch.isfinite(decode_attention(q, k2, v2, cl)).all()),
              f"decode D {d}: a NaN in a dead row leaked")
    # with a window and a softcap, rows below the window are dead too: they
    # are never read, so poison there leaves every bit as it was
    for h, g, d in ((32, 16, 128), (16, 16, 256)):
        q = randn(gen, (4, h, d), torch.bfloat16)
        k = randn(gen, (4, 700, g, d), torch.bfloat16)
        v = randn(gen, (4, 700, g, d), torch.bfloat16)
        cl = torch.tensor([700, 65, 64, 300], dtype=torch.int32, device="cuda")
        kw = dict(window=64, softcap=50.0, scale=GEMMA2_SCALE)
        clean = decode_attention(q, k, v, cl, **kw)
        k2, v2 = k.clone(), v.clone()
        for i, n in enumerate(cl.tolist()):
            k2[i, :max(0, n - 64)], v2[i, :max(0, n - 64)] = 1e4, float("nan")
            k2[i, n:], v2[i, n:] = -1e4, float("inf")
        for rows in (None, decode_ops.STEP_ROWS):
            out = decode_attention(q, k2, v2, cl, rows_per_split=rows, **kw)
            check(torch.equal(out, clean) if rows is None else bool(torch.isfinite(out).all()),
                  f"decode D {d}: a poisoned row outside the window leaked "
                  f"({rows} rows a unit)")
            close(out, decode_attention_ref(q, k2, v2, cl, **kw), TOL[torch.bfloat16],
                  f"decode D {d} window + softcap over poisoned rows vs plain")
    # a head size the kernel is not built for is refused on the card
    q, k = randn(gen, (2, 4, 96), torch.bfloat16), randn(gen, (2, 64, 2, 96), torch.bfloat16)
    refused(lambda: decode_attention(q, k, k, torch.tensor([64, 3], dtype=torch.int32,
                                                           device="cuda")),
            "decode at head_dim 96")
    # the units that merged set their counters back to 0 for the next call
    torch.cuda.synchronize()
    check(all(int(c.abs().sum()) == 0 for c in decode_ops._counters.values()),
          "decode: merge counters not back at 0")
    return worst


def pin_fit(d, dtype):
    """The longest pinned prefix, in whole KV tiles, that the planner's pin
    budget holds for K and V rows of this head size and type."""
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import flash_smem_row_words
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    isz = torch.empty((), dtype=dtype).element_size()
    rows = hopper_pin_budget_bytes(d, isz) // (2 * 4 * flash_smem_row_words(d, isz))
    return rows // FLASH_TILE_ROWS * FLASH_TILE_ROWS


def flash_cases():
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    # (B, Sq, Sk, H, G, D, causal, softcap, pinned, dtype, tiles_per_chunk)
    for s in (17, 128, 1000, 1024):
        for dtype in (bf, f32):
            fit = pin_fit(128, dtype)
            for pinned in sorted({0, 64 if s >= 64 else s, s if s <= fit else fit}):
                cases.append((1, s, s, 24, 8, 128, True, None, pinned, dtype, None))
    cases += [
        (2, 128, 512, 4, 1, 128, False, None, 0, f32, None),
        (1, 100, 333, 8, 2, 128, False, None, 128, bf, None),
        (1, 100, 200, 8, 2, 64, False, None, 200, f32, None),
        (1, 256, 256, 4, 2, 128, True, 50.0, 0, f32, None),
        (1, 300, 300, 4, 2, 128, True, 50.0, 64, bf, None),
        (2, 256, 256, 4, 2, 64, True, None, 128, f32, None),
        (2, 257, 257, 8, 2, 64, True, None, 257, bf, None),
        (1, 384, 384, 2, 2, 128, True, None, 256, bf, None),
        # the bf16 path's block shapes: groups 1 (64-row Q tiles), 3 and 4
        # (32), 8 (16) and 12 (two passes of heads); D 64; ragged lengths;
        # softcap; several Q tiles a chunk
        (1, 17, 17, 4, 4, 128, True, None, 17, bf, None),
        (1, 1000, 1000, 4, 4, 128, True, 50.0, 0, bf, 4),
        (1, 257, 257, 12, 4, 128, True, 50.0, 256, bf, 2),
        (2, 1000, 1000, 12, 3, 64, True, None, 640, bf, 3),
        (1, 257, 257, 16, 4, 64, True, None, 257, bf, 5),
        (2, 100, 1000, 16, 4, 128, False, None, 320, bf, 2),
        (1, 1024, 1024, 32, 8, 128, True, 50.0, 256, bf, 2),
        (1, 300, 300, 16, 2, 64, True, None, 64, bf, 1),
        (1, 200, 200, 24, 2, 128, True, None, 0, bf, None),
    ]
    # head_dim 112 (zamba2-7b: MHA, 32 heads; bf16 rows staged at a 256-byte
    # pitch): causal prompts with the planner's pins, both types; softcap,
    # groups 4 and 8, non-causal, several Q tiles a chunk
    for s in (17, 1000, 1024):
        for dtype in (bf, f32):
            fit = pin_fit(112, dtype)
            for pinned in sorted({0, 64 if s >= 64 else s, s if s <= fit else fit}):
                cases.append((1, s, s, 32, 32, 112, True, None, pinned, dtype, None))
    # deepseek-moe-16b (MHA, 16 heads of 128), qwen2-vl-7b (28 / 4 heads of 128:
    # GQA group 7, seven warps of 16 rows a block) and musicgen-large (MHA, 32
    # heads of 64): causal prompts with the planner's pins
    for h, g, d in ((16, 16, 128), (28, 4, 128), (32, 32, 64)):
        for s in (17, 1000, 1024):
            for dtype in (bf, f32):
                fit = pin_fit(d, dtype)
                for pinned in sorted({0, s if s <= fit else fit}):
                    cases.append((1, s, s, h, g, d, True, None, pinned, dtype, None))
    cases += [
        (1, 300, 300, 8, 2, 112, True, 50.0, 300, bf, 2),
        (2, 257, 257, 16, 4, 112, True, None, 256, bf, 3),
        (1, 100, 333, 8, 1, 112, False, None, 128, bf, None),
        (1, 256, 256, 4, 2, 112, True, 50.0, 64, f32, 2),
    ]
    return [c + (None,) for c in cases] + gemma2_flash_cases() + gemma7b_flash_cases()


def gemma2_flash_cases():
    """gemma2-27b's prefill shape (H 32, G 16, D 128, softcap 50; the window
    last): windows of 1, 63, 64 and 65 rows with prompts just inside and just
    past them, pinned and streamed, both types; the published 4096 at 4096
    (inside), 4097, 4160 and 5120 tokens (past by one row, one tile and
    sixteen), and a window at other groups and head sizes."""
    bf, f32 = torch.bfloat16, torch.float32
    w = GEMMA2_WINDOW
    cases = []
    for window in (1, 63, 64, 65):
        for s in (window, window + 1, 300):
            for dtype in (bf, f32):
                cases.append((1, s, s, 32, 16, 128, True, 50.0, 0 if s < 64 else 64, dtype,
                              None, window))
    for s in (w, w + 1, w + 64, 5120):
        cases.append((1, s, s, 32, 16, 128, True, 50.0, 0, bf, None, w))
    cases += [
        (1, w + 64, w + 64, 32, 16, 128, True, 50.0, 256, bf, 3, w),
        (1, w + 64, w + 64, 32, 16, 128, True, 50.0, 0, f32, None, w),
        (2, 700, 700, 16, 4, 64, True, None, 640, bf, 3, 100),
        (1, 300, 300, 8, 8, 112, True, 50.0, 256, bf, 2, 63),
        (2, 257, 257, 12, 4, 128, True, None, 64, f32, 2, 65),
    ]
    return cases


def gemma7b_flash_cases():
    """head_dim 256 (gemma-7b: MHA, 16 heads; bf16 Q re-read from a buffer
    of its own, four warps a block; the planner's pin budget holds one 64-row
    tile in bf16, none in fp32): causal prompts pinned 0, 64 and whole where
    that fits (fp32 at most 8 rows), GQA groups 3, 4 and 8 (passes of four
    heads), non-causal, a softcap and windows, several Q tiles a chunk."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for s in (17, 64, 1000, 1024):
        for pinned in sorted({0, min(s, 64)}):
            cases.append((1, s, s, 16, 16, 256, True, None, pinned, bf, None, None))
    cases += [
        (1, 17, 17, 16, 16, 256, True, None, 0, f32, None, None),
        (1, 8, 8, 16, 16, 256, True, None, 8, f32, None, None),
        (1, 1000, 1000, 16, 16, 256, True, None, 0, f32, None, None),
        (1, 257, 257, 8, 2, 256, True, None, 64, bf, 2, None),
        (2, 300, 300, 12, 4, 256, True, 50.0, 0, bf, None, None),
        (1, 200, 200, 16, 2, 256, True, None, 0, bf, None, None),
        (1, 100, 333, 8, 1, 256, False, None, 64, bf, None, None),
        (1, 128, 300, 4, 2, 256, False, None, 0, f32, None, None),
        (1, 300, 300, 16, 16, 256, True, 50.0, 64, bf, 2, 63),
        (1, 300, 300, 16, 16, 256, True, 50.0, 0, f32, None, 64),
        (1, 1000, 1000, 16, 16, 256, True, None, 64, bf, 3, 100),
    ]
    return cases


def check_flash(gen):
    from repro_torch.core.orchestrator import CacheOrchestrator
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import flash_kv_row_bytes
    from repro_torch.core.orchestrator import flash_smem_bytes
    from repro_torch.core.orchestrator import H100_SMEM_PER_BLOCK
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    worst = {}
    for case in flash_cases():
        b, sq, sk, h, g, d, causal, softcap, pinned, dtype, tiles, window = case
        scale = GEMMA2_SCALE if window else None
        q = randn(gen, (b, sq, h, d), dtype)
        k = randn(gen, (b, sk, g, d), dtype)
        v = randn(gen, (b, sk, g, d), dtype)
        out = flash_attention(q, k, v, causal=causal, softcap=softcap, window=window,
                              scale=scale, pinned_rows=pinned, tiles_per_chunk=tiles)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, softcap=softcap, window=window,
                            scale=scale)
        err = close(out, ref, TOL[dtype], f"flash {case}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    q, k = randn(gen, (1, 64, 4, 96), torch.bfloat16), randn(gen, (1, 64, 2, 96), torch.bfloat16)
    refused(lambda: flash_attention(q, k, k), "flash at head_dim 96")
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
    # bf16 walks the same tiles in the same order with the same arithmetic
    # wherever a tile lives: bit-identical across pinned_rows (none, one tile,
    # the planner's split, all of Sk) and across chunkings, with a window too
    # (a pinned tile older than the window is skipped as a streamed one is)
    for s, h, g, d, window in ((300, 6, 2, 128, None), (700, 16, 4, 64, None),
                               (300, 8, 8, 112, None), (300, 8, 2, 112, None),
                               (300, 16, 16, 128, None), (300, 32, 16, 128, 64),
                               (700, 16, 4, 64, 65), (300, 8, 8, 112, 63),
                               (GEMMA2_WINDOW + 64, 32, 16, 128, GEMMA2_WINDOW)):
        kw = dict(window=window, softcap=50.0, scale=GEMMA2_SCALE) if window else {}
        q = randn(gen, (1, s, h, d), torch.bfloat16)
        k = randn(gen, (1, s, g, d), torch.bfloat16)
        v = randn(gen, (1, s, g, d), torch.bfloat16)
        planned, _ = CacheOrchestrator(
            vmem_budget_bytes=hopper_pin_budget_bytes(d, 2)).plan_kv_split(
                s, FLASH_TILE_ROWS, flash_kv_row_bytes(d, 2))
        pins = {0, 64, planned}
        if flash_smem_bytes(s, d, 2) <= H100_SMEM_PER_BLOCK:
            pins.add(s)
        else:   # a long prompt, which the planner streams whole: pin what fits
            pins |= {128, 256}
        check(len(pins) == 4, f"bf16 equivalence at S {s}: pins {sorted(pins)}")
        base = flash_attention(q, k, v, causal=True, pinned_rows=0, tiles_per_chunk=1, **kw)
        close(base, attention_ref(q, k, v, **kw), TOL[torch.bfloat16],
              f"flash bf16 S {s} window {window}")
        for pinned in sorted(pins):
            for tiles in (None, 1, 2, 3, 7):
                other = flash_attention(q, k, v, causal=True, pinned_rows=pinned,
                                        tiles_per_chunk=tiles, **kw)
                check(torch.equal(other, base), f"flash bf16 S {s} window {window}: "
                      f"pinned {pinned}, tiles {tiles} differs from pinned 0 by "
                      f"{float((other.float() - base.float()).abs().max()):.3e}")
    # the same at head_dim 256, where the pin budget holds one 64-row tile:
    # pinned 0 and 64 (or the whole of a short prompt), with a window and a
    # softcap too, GQA in passes of four heads
    for s, h, g, window in ((300, 16, 16, None), (1024, 16, 16, None), (40, 16, 16, None),
                            (300, 16, 16, 64), (300, 8, 2, None)):
        kw = dict(window=window, softcap=50.0, scale=GEMMA2_SCALE) if window else {}
        q = randn(gen, (1, s, h, 256), torch.bfloat16)
        k = randn(gen, (1, s, g, 256), torch.bfloat16)
        v = randn(gen, (1, s, g, 256), torch.bfloat16)
        base = flash_attention(q, k, v, causal=True, pinned_rows=0, tiles_per_chunk=1, **kw)
        close(base, attention_ref(q, k, v, **kw), TOL[torch.bfloat16],
              f"flash bf16 D 256 S {s} window {window}")
        for pinned in (0, min(s, 64)):
            for tiles in (None, 1, 2, 3, 7):
                other = flash_attention(q, k, v, causal=True, pinned_rows=pinned,
                                        tiles_per_chunk=tiles, **kw)
                check(torch.equal(other, base), f"flash bf16 D 256 S {s} window {window}: "
                      f"pinned {pinned}, tiles {tiles} differs from pinned 0 by "
                      f"{float((other.float() - base.float()).abs().max()):.3e}")
    # a cache slice longer than the prompt, read through its strides
    for h, g, d in ((24, 8, 128), (32, 32, 112), (16, 16, 256)):
        pool_k = randn(gen, (1, 512, g, d), torch.bfloat16)
        pool_v = randn(gen, (1, 512, g, d), torch.bfloat16)
        q = randn(gen, (1, 200, h, d), torch.bfloat16)
        out = flash_attention(q, pool_k[:, :200], pool_v[:, :200],
                              pinned_rows=min(200, pin_fit(d, torch.bfloat16)))
        close(out, attention_ref(q, pool_k[:, :200], pool_v[:, :200]), TOL[torch.bfloat16],
              f"flash on a strided cache slice, D {d}")
    return worst


def decode_inputs(gen, lens, h, g, d, s=2048):
    """q, k, v and cache_len on the engine's pool (8 slots x ``s`` rows, a
    path's heads, bf16) with the slots at ``lens``."""
    bf = torch.bfloat16
    b = 8
    return (randn(gen, (b, h, d), bf), randn(gen, (b, s, g, d), bf),
            randn(gen, (b, s, g, d), bf), torch.tensor(lens, dtype=torch.int32, device="cuda"))


def decode_record(q, k, v, cl, flush, window=None, softcap=None, scale=None):
    """The decode kernel's record on these inputs: its time beside the plain
    version's and the library call's, and the bound, which counts only live
    rows (below ``cache_len`` and, with a window, among its last ``window``).
    No library call computes softcapped scores: with a softcap,
    ``library_ms`` is None and ``library_ms_no_softcap`` times the library
    call on the same live rows without it, a different function."""
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels.decode_attention import ops as decode_ops
    bf = torch.bfloat16
    (b, h, d), (_, s, g, _) = q.shape, k.shape
    lens = cl.tolist()
    kw = dict(window=window, softcap=softcap, scale=scale)
    plan = decode_ops.decode_plan(b, s, h, g, d, window=window,
                                  sm_count=torch.cuda.get_device_properties(0).multi_processor_count)
    t = torch.arange(s, device="cuda")[None, :]
    live_rows = (t < cl[:, None]) & ((t >= cl[:, None] - window) if window else True)
    mask = live_rows[:, None, None, :]
    q4 = q[:, :, None, :]
    k4, v4 = k.transpose(1, 2), v.transpose(1, 2)

    def lib_decode():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True,
                                              scale=scale)

    ref = decode_attention_ref(q, k, v, cl, **kw)
    err = close(decode_attention(q, k, v, cl, **kw), ref, TOL[bf],
                f"decode at {lens}, window {window}, softcap {softcap}")
    # the library call gives NaN for a row with no valid key: compare the rest
    live = cl > 0
    lib_ref = ref if softcap is None else decode_attention_ref(q, k, v, cl, window=window,
                                                               scale=scale)
    close(lib_decode()[:, :, 0][live], lib_ref[live], TOL[bf], "library decode vs plain")
    n_live = int(live_rows.sum())
    n_bytes = (2 * g * d * 2 * n_live) + 2 * q.numel() * 2 + cl.numel() * 4
    n_flops = 4 * h * d * n_live
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    lib_ms = time_ms(lib_decode, flush)
    return {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "shape": {"B": b, "S": s, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "cache_len": lens, "window": window, "softcap": softcap, "scale": scale,
                  "live_rows": n_live, "rows_chosen": plan.rows_for(lens)},
        "max_abs_err": err, "tol": TOL[bf],
        "ms": time_ms(lambda: decode_attention(q, k, v, cl, **kw), flush),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, cl, **kw), flush),
        "library_ms": lib_ms if softcap is None else None,
        **({} if softcap is None else {"library_ms_no_softcap": lib_ms}),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def flash_record(gen, flush, sq, h, g, d, pinned, window=None, softcap=None, scale=None):
    """The flash kernel's record for one causal prefill of ``sq`` tokens
    (bf16, ``pinned`` rows as the planner splits them): its time beside the
    plain version's and the library call's, pinned and unpinned, and the
    bound, whose operations count only the (row, column) pairs the causal
    mask and the window leave.  With a softcap, ``library_ms`` is None (no
    library call computes it) and ``library_ms_no_softcap`` times the library
    call with the same mask and no softcap, a different function."""
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    bf = torch.bfloat16
    kw = dict(window=window, softcap=softcap, scale=scale)
    q = randn(gen, (1, sq, h, d), bf)
    k = randn(gen, (1, sq, g, d), bf)
    v = randn(gen, (1, sq, g, d), bf)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows = torch.arange(sq, device="cuda")
    seen = rows[None, :] <= rows[:, None]
    if window:
        seen &= rows[None, :] > rows[:, None] - window

    def lib_flash():
        if window:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=seen,
                                                  enable_gqa=True, scale=scale)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True, scale=scale)

    ref = attention_ref(q, k, v, **kw)
    err = close(flash_attention(q, k, v, pinned_rows=pinned, **kw), ref, TOL[bf],
                f"flash at the serving shape, S {sq}, window {window}")
    lib_ref = ref if softcap is None else attention_ref(q, k, v, window=window, scale=scale)
    close(lib_flash().transpose(1, 2), lib_ref, TOL[bf], "library flash vs plain")
    n_seen = int(seen.sum())
    del ref, lib_ref
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel())
    n_flops = 4 * n_seen * d * h
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    ms = time_ms(lambda: flash_attention(q, k, v, pinned_rows=pinned, **kw), flush)
    lib_ms = time_ms(lib_flash, flush)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
        "shape": {"B": 1, "Sq": sq, "Sk": sq, "H": h, "G": g, "D": d,
                  "dtype": "bfloat16", "causal": True, "pinned_rows": pinned,
                  "window": window, "softcap": softcap, "scale": scale,
                  "visible_pairs": n_seen},
        "max_abs_err": err, "tol": TOL[bf],
        "ms": ms, "tflops": n_flops / ms * 1e-9,
        "ms_unpinned": time_ms(lambda: flash_attention(q, k, v, pinned_rows=0, **kw), flush),
        # the same call also writing the per-row log-sum-exp, as training's forward
        "ms_with_lse": time_ms(lambda: flash_lse(q, k, v, pinned_rows=pinned, **kw), flush),
        # no heavy/light pairing: one Q tile a block
        "ms_one_tile_a_chunk": time_ms(lambda: flash_attention(
            q, k, v, pinned_rows=pinned, tiles_per_chunk=1, **kw), flush),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, **kw), flush),
        "library_ms": lib_ms if softcap is None else None,
        **({} if softcap is None else {"library_ms_no_softcap": lib_ms}),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def time_attention(gen, flush, path):
    """Times of the attention kernels at one path's serving shapes.  Returns
    the records of the ``kernels`` line, without their launch counts, and the
    extra records, the cases of ``ATTN_TIMED``; each names its path."""
    from repro_torch.core.orchestrator import CacheOrchestrator
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import flash_kv_row_bytes
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    h, g, d = ATTN_SHAPES[path]
    orch = CacheOrchestrator(vmem_budget_bytes=hopper_pin_budget_bytes(d, 2))

    def pins(sq):
        return orch.plan_kv_split(sq, FLASH_TILE_ROWS, flash_kv_row_bytes(d, 2))[0]

    timed = ATTN_TIMED.get(path, ATTN_TIMED_DEFAULT)
    attn = {k: timed[k] for k in ("softcap", "scale") if k in timed}
    pool = {"s": timed["pool"]} if "pool" in timed else {}
    records, extra = [], []
    for kernel, size, local in timed["cases"]:
        kw = dict(attn, window=timed["window"]) if local else attn
        if kernel == "decode":
            rec = decode_record(*decode_inputs(gen, size, h, g, d, **pool), flush, **kw)
        else:
            rec = flash_record(gen, flush, size, h, g, d, pins(size), **kw)
        rec["path"] = path
        first = all(r["name"] != rec["name"] for r in records)
        (records if first else extra).append(rec)
    return records, extra


# ---------------------------------------------------------------------------
def ssd_inputs(gen, b, s, h, g, p, n, dtype):
    """The reference's SSD test inputs (tests/test_kernels.py::_ssd_inputs):
    dt = softplus(N(0,1)) * 0.1, A = -exp(U(-1, 1))."""
    x = randn(gen, (b, s, h, p), dtype)
    dt = F.softplus(randn(gen, (b, s, h), torch.float32)) * 0.1
    A = -torch.exp(torch.rand((h,), generator=gen, device="cuda") * 2 - 1)
    B = randn(gen, (b, s, g, n), dtype)
    C = randn(gen, (b, s, g, n), dtype)
    return x, dt, A, B, C


def ssd_cases():
    bf, f32 = torch.bfloat16, torch.float32
    # (B, S, H, G, P, N, chunk, dtype, initial_state)
    return [
        # the reference's SSD_CASES
        (1, 128, 2, 1, 64, 32, 32, f32, False),
        (2, 256, 4, 1, 32, 64, 64, f32, False),
        (1, 256, 4, 2, 64, 32, 64, bf, False),
        (1, 512, 2, 1, 64, 128, 128, f32, False),
        # mamba2-2.7b's prefill of 1024 tokens, and a short prompt (S = chunk)
        (1, 1024, 80, 1, 64, 128, 256, f32, False),
        (1, 100, 80, 1, 64, 128, 100, f32, False),
        (1, 100, 8, 1, 64, 128, 100, bf, False),
        # groups, batch and a carried state; the reduced model's N 16
        (2, 256, 8, 2, 64, 64, 64, f32, True),
        (2, 192, 6, 2, 32, 128, 64, bf, True),
        (2, 40, 16, 1, 32, 16, 40, f32, True),
        # zamba2-7b's prefill of 1024 tokens (H 112, N 64), a short prompt, and
        # bf16 with a carried state
        (1, 1024, 112, 1, 64, 64, 256, f32, False),
        (1, 100, 112, 1, 64, 64, 100, f32, False),
        (1, 256, 112, 1, 64, 64, 256, bf, True),
    ]


def check_ssd(gen):
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan
    worst = {}

    def held(y, st, y_ref, st_ref, dtype, what):
        e = close(y, y_ref, SSD_TOL[dtype], f"ssd y {what}")
        e = max(e, close(st, st_ref, SSD_TOL[torch.float32], f"ssd state {what}"))
        check(y.dtype == dtype and st.dtype == torch.float32, f"ssd types {what}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), e)

    for b, s, h, g, p, n, chunk, dtype, with_init in ssd_cases():
        x, dt, A, B, C = ssd_inputs(gen, b, s, h, g, p, n, dtype)
        init = randn(gen, (b, h, p, n), torch.float32) if with_init else None
        y, st = ssd_scan(x, dt, A, B, C, chunk=chunk, initial_state=init)
        torch.cuda.synchronize()
        y_ref, st_ref = ssd_ref(x, dt, A, B, C, chunk, initial_state=init)
        held(y, st, y_ref, st_ref, dtype, (b, s, h, g, p, n, chunk, dtype, with_init))
    # strided views, as the model hands them over: x a slice of a wider
    # projection, B and C two column ranges of one (B, S, 2GN) tensor
    b, s, h, g, p, n = 2, 128, 8, 2, 64, 64
    wide = randn(gen, (b, s, h, 2 * p), torch.float32)
    bc = randn(gen, (b, s, 2 * g * n), torch.float32)
    _, dt, A, _, _ = ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
    x, B, C = wide[..., p:], bc[..., :g * n].view(b, s, g, n), bc[..., g * n:].view(b, s, g, n)
    y, st = ssd_scan(x, dt, A, B, C, chunk=64)
    y_ref, st_ref = ssd_ref(x.contiguous(), dt, A, B.contiguous(), C.contiguous(), 64)
    held(y, st, y_ref, st_ref, torch.float32, "on strided views")
    return worst


def ssd_record(x, dt, A, B, C, chunk, flush):
    """The SSD scan's record on these inputs (fp32 at mamba2-2.7b's prefill
    shapes, as ``mamba2_block`` hands them over).  The operations are counted
    by a fixed convention, whatever sub-chunk the kernel walks: the chunked
    algorithm at SSD_COUNT_Q rows, per (batch, head, sub-chunk) Q^2 (N + P)
    FLOP for the two causal Q x Q products and 4 Q N P for the two state
    products.  They are held against the card's fastest product rate that
    keeps fp32 accuracy (3xTF32, ``bound_ms``) and, beside it, the fp32 FMA
    peak (``bound_fma_ms``)."""
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan
    q = SSD_COUNT_Q
    f32 = torch.float32
    (b, s, h, p), (g, n) = x.shape, B.shape[2:]
    y_ref, st_ref = ssd_ref(x, dt, A, B, C, chunk)
    y, st = ssd_scan(x, dt, A, B, C, chunk=chunk)
    err = max(close(y, y_ref, SSD_TOL[f32], "ssd at the serving shape"),
              close(st, st_ref, SSD_TOL[f32], "ssd state at the serving shape"))
    n_flops = b * h * (s // q) * (q * q * (n + p) + 4 * q * n * p)
    n_bytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel() + C.numel()
                   + st.numel())
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FP32_ACCURATE_MMA * 1e3
    ms = time_ms(lambda: ssd_scan(x, dt, A, B, C, chunk=chunk), flush)
    return {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:28",
        "shape": {"B": b, "S": s, "H": h, "G": g, "P": p, "N": n, "chunk": chunk,
                  "count_q": q, "dtype": "float32"},
        "flop": n_flops, "bytes": n_bytes,
        "max_abs_err": err, "tol": SSD_TOL[f32],
        "ms": ms, "tflops": n_flops / ms * 1e-9,
        "plain_ms": time_ms(lambda: ssd_ref(x, dt, A, B, C, chunk), flush),
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_fma_ms": max(t_bytes, n_flops / PEAK_FLOPS[f32] * 1e3),
    }


def time_ssd(gen, flush, path):
    """The SSD records at one path's shape, prompts of 1024 and 256 tokens."""
    h, p, n = SSD_SHAPES[path]
    out = [ssd_record(*ssd_inputs(gen, 1, s, h, 1, p, n, torch.float32),
                      min(256, s), flush) for s in SSD_PROMPTS]
    for rec in out:
        rec["path"] = path
    return out[:1], out[1:]


# ---------------------------------------------------------------------------
# the flash-attention backward kernel (training) and the forward's LSE
TRAIN_SHAPE = dict(b=8, s=512, h=24, g=8, d=128)   # llama3.2-3b's train phase, one microbatch
# the attention of each train phase's microbatch, as the backward sees it:
# llama3.2-3b, zamba2-7b's shared block at head_dim 112, deepseek-moe-16b,
# gemma2-27b's local layer (softcap 50, its 4096-row window inert at 512
# tokens) and gemma-7b (head_dim 256); and gemma2's window where it binds,
# at the forward's serving row of 5120 tokens (a record of the train_gemma2
# path: the same kernel)
BWD_SHAPES = {"train": TRAIN_SHAPE,
              "train_hybrid": dict(b=8, s=512, h=32, g=32, d=112),
              "train_moe": dict(b=8, s=512, h=16, g=16, d=128),
              "train_gemma2": dict(b=8, s=512, h=32, g=16, d=128, softcap=50.0,
                                   window=GEMMA2_WINDOW, scale=GEMMA2_SCALE),
              "train_gemma7b": dict(b=8, s=512, h=16, g=16, d=256),
              "train_gemma2_window": dict(b=1, s=5120, h=32, g=16, d=128, softcap=50.0,
                                          window=GEMMA2_WINDOW, scale=GEMMA2_SCALE,
                                          path="train_gemma2")}


def close_scaled(out, ref, tol, what):
    """max |out - ref|, after asserting it is within ``tol`` times the larger
    of 1 and ref's largest magnitude (the LSE's own scale)."""
    out, ref = out.float(), ref.float()
    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    check(err <= tol * scale, f"{what}: max abs err {err:.3e} beyond {tol} x {scale:.3g}")
    return err


BWD_TILE = 64   # rows of the backward kernel's Q and KV tiles
BWD_GROUPS = ((4, 4), (4, 2), (6, 2), (8, 2), (16, 2))   # (H, G) of the backward's cases


def grad_scale(ref):
    """Each element's scale in a gradient ``ref`` (B, S, heads, D): the
    larger of the RMS of its row (the D values of one position and head)
    and the RMS of its BWD_TILE-row tile of that head (the rows one block of
    the backward kernel writes; the last tile may be ragged).  Causal
    gradients shrink with position (dK and dV of KV row j by about
    sqrt(1/j - 1/S)), so a tensor-wide scale would hold late tiles loosely.
    The row's own RMS where it is the larger: the first rows of a tile can
    stand several times above its RMS, and their bf16 rounding with them.
    The tile's where it is: a row whose true gradient is zero (dQ of the
    first query, which sees one key: dS = P (dP - rowsum(dO o)) = 0) comes
    out of both sides as fp32 rounding noise of two sums of D products,
    which a row's own scale would hold against itself."""
    ref = ref.float()
    b, s, h, _ = ref.shape
    sq = ref.square().mean(-1)                                      # (B, S, H)
    n = -(-s // BWD_TILE)
    padded = torch.zeros((b, n * BWD_TILE, h), device=ref.device)
    padded[:, :s] = sq
    rows = torch.full((n, 1), float(BWD_TILE), device=ref.device)
    rows[-1] = s - BWD_TILE * (n - 1)
    tile = padded.reshape(b, n, BWD_TILE, h).sum(2) / rows           # (B, n, H)
    tile = tile.repeat_interleave(BWD_TILE, dim=1)[:, :s]
    return torch.maximum(sq, tile).sqrt()[..., None]


def grad_err(out, ref, tol, floor=0.0):
    """A gradient against its oracle, elementwise as the forward's outputs
    are held (rtol = atol = ``tol``), with the atol on the scale of each
    element's row and tile: |out - ref| <= tol (|ref| + grad_scale(ref)),
    the scale at least ``floor`` (``vanishing_floor``).  Returns (ok, the
    worst |out - ref| / (tol (|ref| + scale)), max |out - ref|, the scale at
    that element)."""
    out, ref = out.float(), ref.float()
    scale = grad_scale(ref).clamp(min=floor).expand_as(ref)
    err = (out - ref).abs()
    ratio = float((err / (tol * (ref.abs() + scale))).max())
    at = int(err.argmax())
    return (bool(torch.isfinite(out).all()) and ratio <= 1.0, ratio, float(err.max()),
            float(scale.flatten()[at]))


def vanishing_floor(want, kw):
    """{gradient: the floor of ``grad_err``'s scale} of a backward's oracle
    gradients ``want`` (dq, dk, dv) under options ``kw``.  Under a window of
    1 each row sees only its own key: P = 1 and dS = dP - delta = 0, so dQ
    and dK vanish in exact arithmetic and both sides return the rounding of
    two sums of D products that cancel; those are held on the RMS of dV (the
    scale of dO V, whose difference from delta they are).  Elsewhere none."""
    if kw.get("window") != 1:
        return {}
    rms = float(want[2].float().square().mean().sqrt())
    return {"dq": rms, "dk": rms}


def close_grad(out, ref, tol, what, floor=0.0):
    """``grad_err``'s (worst ratio, max abs err, scale there), after
    asserting that ``out`` passes."""
    ok, ratio, err, at = grad_err(out, ref, tol, floor)
    check(ok, f"{what}: |err| / (tol (|ref| + scale)) reaches {ratio:.3g} (tol {tol}; "
              f"max abs err {err:.3e} where the scale is {at:.3g})")
    return ratio, err, at


def uncapped_bwd(q, k, v, lse, do, delta, *, softcap, scale=None, window=None):
    """dQ and dK of a backward that leaves the softcap's derivative out of
    dS (``attention_bwd_ref``'s formulas otherwise), fp32."""
    from repro_torch.kernels.flash_attention.ref import _mask
    b, s, h, d = q.shape
    g = k.shape[2]
    scale = scale or d ** -0.5
    qg, dog = (t.reshape(b, s, g, h // g, d).float() for t in (q, do))
    sc = torch.tanh(torch.einsum("bsgqd,btgd->bgqst", qg, k.float()) * scale / softcap)
    p = torch.exp(sc * softcap - lse.float().reshape(b, g, h // g, s, 1))
    p = p.masked_fill(~_mask(s, s, True, window, q.device), 0.0)
    ds = p * (torch.einsum("bsgqd,btgd->bgqst", dog, v.float()) - delta[..., None])
    return (torch.einsum("bgqst,btgd->bsgqd", ds, k.float()).reshape(b, s, h, d) * scale,
            torch.einsum("bgqst,bsgqd->btgd", ds, qg) * scale)


def bwd_faults(q, k, v, o, lse, do, got, kw):
    """Faults planted in a backward's gradients ``got`` (dq, dk, dv), each
    of which ``grad_err`` must reject in every gradient it touches:
    {name: {gradient: planted}}.  Always: "tail", the last KV tile (the
    ragged one where S is no multiple of BWD_TILE) of dK and dV left at zero;
    "head", the last query head of every group missing from dK and dV of the
    tile before it (its contribution, ``attention_bwd_ref`` with dO kept on
    that head only, taken away).  With a softcap: "uncapped", the cap's
    derivative left out of dS (dQ, dK); in bf16 only at CAP_BENDS, where it
    moves dS by more than bf16's tolerance.  With a window: "window_off_by_one",
    each row seeing one more key (kv >= q - W; dQ, dK, dV); "last_q_tile",
    the last Q tile that the window of each KV tile reaches (``bwd_q_tiles``)
    skipped in the dK/dV walk.  At head_dim 256: "dk_half", the second half
    of dK's columns left at zero.  Each fault is planted as the kernel's
    output plus the change the fault makes to the plain version's.  Where
    dQ and dK vanish (``vanishing_floor``: a window of 1), a fault that
    takes part of them away changes nothing, so only "window_off_by_one"
    touches them."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops
    b, s, h, d = q.shape
    g = k.shape[2]
    dq, dk, dv = got
    ref = [t.float() for t in attention_bwd_ref(q, k, v, o, lse, do, **kw)]

    def plus(t, change):
        return (t.float() + change).to(t.dtype)

    def contribution(rows, heads=slice(None)):
        """dK and dV of the dO of Q rows ``rows`` and heads ``heads`` only."""
        only = torch.zeros_like(do)
        only[:, rows, heads] = do[:, rows, heads]
        return [t.float() for t in attention_bwd_ref(q, k, v, o, lse, only, **kw)[1:]]

    last = (s - 1) // BWD_TILE * BWD_TILE
    late = slice(max(0, last - BWD_TILE), last)
    tail_k, tail_v = dk.clone(), dv.clone()
    tail_k[:, last:] = 0
    tail_v[:, last:] = 0
    dk_h, dv_h = contribution(slice(None), torch.arange(h // g - 1, h, h // g))
    head_k, head_v = dk.clone(), dv.clone()
    head_k[:, late] = plus(dk[:, late], -dk_h[:, late])
    head_v[:, late] = plus(dv[:, late], -dv_h[:, late])
    faults = {"tail": {"dk": tail_k, "dv": tail_v}, "head": {"dk": head_k, "dv": head_v}}
    if kw.get("softcap") and (q.dtype == torch.float32 or kw["softcap"] <= CAP_BENDS):
        delta = (do.float() * o.float()).sum(-1).reshape(b, s, g, h // g).permute(0, 2, 3, 1)
        uq, uk = uncapped_bwd(q, k, v, lse, do, delta, **kw)
        faults["uncapped"] = {"dq": plus(dq, uq - ref[0]), "dk": plus(dk, uk - ref[1])}
    if kw.get("window"):
        wide = [t.float() for t in attention_bwd_ref(
            q, k, v, o, lse, do, **{**kw, "window": kw["window"] + 1})]
        faults["window_off_by_one"] = {n: plus(t, w - r) for n, t, w, r in
                                       zip(("dq", "dk", "dv"), got, wide, ref)}
        tile = ops.bwd_tile_rows(d, q.element_size())
        skip_k, skip_v = dk.clone(), dv.clone()
        for kt in range(-(-s // tile)):
            qt = ops.bwd_q_tiles(kt, s, window=kw["window"], tile=tile)[-1]
            ck, cv = contribution(slice(qt * tile, (qt + 1) * tile))
            kv = slice(kt * tile, (kt + 1) * tile)
            skip_k[:, kv] = plus(dk[:, kv], -ck[:, kv])
            skip_v[:, kv] = plus(dv[:, kv], -cv[:, kv])
        faults["last_q_tile"] = {"dk": skip_k, "dv": skip_v}
    if d == 256:
        half = dk.clone()
        half[..., d // 2:] = 0
        faults["dk_half"] = {"dk": half}
    vanish = vanishing_floor(ref, kw)
    faults = {name: {n: t for n, t in planted.items()
                     if n not in vanish or name == "window_off_by_one"}
              for name, planted in faults.items()}
    return {name: planted for name, planted in faults.items() if planted}


def check_faults_rejected(q, k, v, o, lse, do, got, want, tol, what, kw=None):
    """Every fault of ``bwd_faults`` planted in ``got`` fails ``grad_err``
    (with ``vanishing_floor``) against ``want`` in every gradient it
    touches; returns {fault: its smallest worst ratio}."""
    least = {}
    floor = vanishing_floor(want, kw or {})
    for name, planted in bwd_faults(q, k, v, o, lse, do, got, kw or {}).items():
        for grad, a in planted.items():
            ok, ratio, _, _ = grad_err(a, want[("dq", "dk", "dv").index(grad)], tol,
                                       floor.get(grad, 0.0))
            check(not ok, f"{what}: the planted fault {name!r} in {grad} passes "
                  f"(worst ratio {ratio:.3g})")
            least[name] = min(least.get(name, float("inf")), ratio)
    return least


BWD_WINDOWS = (1, 64, 100)   # windows of the backward's cases: the diagonal, a tile, neither
# a softcap that bends the cases' scores (of unit scale; gemma2's 50 moves
# them by about 4e-4, below bf16's tolerance), and which keeps the softmax
# spread (a larger q would make it peak on one key, where dS = P (dP - delta)
# cancels and the sums' rounding, not the gradient, sets the error)
CAP_BENDS = 2.0


def flash_bwd_cases():
    """(B, S, H, G, D, dtype, options): both types; D 64 and 128 at GQA
    groups 1, 2, 3, 4 and 8, and D 112 (zamba2-7b's shared block) at groups
    1 and 2, at lengths 17, 64, 100, 1000 and 1024 (ragged, one tile, many);
    qwen2-vl-7b's heads (28 / 4 of 128: group 7) and musicgen-large's (MHA,
    32 of 64) at 100 and 1000.  gemma2-27b's heads (32 / 16 of 128, score
    scale 144^-0.5) with softcap 50 alone, with windows of BWD_WINDOWS rows
    alone and with both, and with CAP_BENDS alone and with window 64, at 17,
    100, 1000 and 1024; softcap 30 at group 1; gemma-7b's head_dim 256 at
    MHA (16 / 16) and group 2 (8 / 4), and with window 63 and softcap 50, at
    the same lengths.  Options are the keywords of ``flash_attention_bwd``
    (scale, softcap, window)."""
    cases = []
    lens = (17, 100, 1000, 1024)
    g2 = dict(scale=GEMMA2_SCALE)
    for dtype in (torch.bfloat16, torch.float32):
        for d, groups in ((64, BWD_GROUPS), (128, BWD_GROUPS), (112, ((4, 4), (4, 2)))):
            for h, g in groups:
                for i, s in enumerate((17, 64, 100, 1000, 1024)):
                    cases.append((1 + i % 2, s, h, g, d, dtype, {}))
        for h, g, d in ((28, 4, 128), (32, 32, 64)):
            for i, s in enumerate((100, 1000)):
                cases.append((1 + i % 2, s, h, g, d, dtype, {}))
        gemma = [(32, 16, 128, {**g2, "softcap": 50.0})]
        for w in BWD_WINDOWS:
            gemma += [(32, 16, 128, {**g2, "window": w}),
                      (32, 16, 128, {**g2, "window": w, "softcap": 50.0})]
        gemma += [(32, 16, 128, {**g2, "softcap": CAP_BENDS}),
                  (32, 16, 128, {**g2, "window": 64, "softcap": CAP_BENDS}),
                  (4, 4, 128, {"softcap": 30.0}), (16, 16, 256, {}), (8, 4, 256, {}),
                  (8, 4, 256, {"window": 63, "softcap": 50.0})]
        for h, g, d, kw in gemma:
            for i, s in enumerate(lens):
                cases.append((1 + i % 2, s, h, g, d, dtype, kw))
    return cases


def flash_lse(q, k, v, *, scale=None, softcap=None, window=None, pinned_rows=0,
              tiles_per_chunk=None):
    """(O, LSE) of one causal forward launch through the entry that
    ``FlashAttentionFn`` calls (the public wrapper returns O only)."""
    from repro_torch.kernels.flash_attention import ops
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = ops._forward(q, k, v, lse, causal=True, scale=scale or d ** -0.5,
                       softcap=softcap, window=window, pinned_rows=pinned_rows,
                       tiles_per_chunk=tiles_per_chunk)
    return out, lse


def check_flash_bwd(gen):
    """The backward kernel against ``attention_bwd_ref`` on the same inputs
    (the forward kernel's own O and LSE, with the case's scale, softcap and
    window), each gradient by ``grad_err`` at
    ``TOL`` of the dtype (dQ and dK under a window of 1, which vanish, on
    ``vanishing_floor``); at S 1000, at GQA groups of 3, 7 and 8, at head_dim
    112 and 256 and with a window or a softcap, the faults of ``bwd_faults``
    planted in the kernel's gradients must fail the same rule.  Returns, for
    each dtype, the worst ratio (<= 1), the largest absolute error and the
    smallest ratio of each planted fault (> 1)."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import flash_attention_bwd
    worst = {}
    for case in flash_bwd_cases():
        b, s, h, g, d, dtype, kw = case
        q = randn(gen, (b, s, h, d), dtype)
        k = randn(gen, (b, s, g, d), dtype)
        v = randn(gen, (b, s, g, d), dtype)
        do = randn(gen, (b, s, h, d), dtype)
        o, lse = flash_lse(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
        w = worst.setdefault(str(dtype), {"ratio": 0.0, "max_abs_err": 0.0,
                                          "fault_min_ratio": {}})
        floor = vanishing_floor(want, kw)
        for name, a, r in zip(("dq", "dk", "dv"), got, want):
            check(a.dtype == dtype and a.shape == r.shape, f"flash bwd {case}: {name} type")
            ratio, err, _ = close_grad(a, r, TOL[dtype], f"flash bwd {case} {name}",
                                       floor.get(name, 0.0))
            w["ratio"], w["max_abs_err"] = max(w["ratio"], ratio), max(w["max_abs_err"], err)
        if s == 1000 and (h // g in (3, 7, 8) or d in (112, 256) or kw.get("window")
                          or kw.get("softcap")):
            least = check_faults_rejected(q, k, v, o, lse, do, got, want, TOL[dtype],
                                          f"flash bwd {case}", kw)
            for name, ratio in least.items():
                w["fault_min_ratio"][name] = min(w["fault_min_ratio"].get(name, ratio), ratio)
    return worst


def check_flash_lse(gen):
    """The forward's LSE: against ``attention_ref(return_lse=True)`` over
    types, head sizes, groups, windows and softcaps; O bit-identical with and
    without it; bf16 LSE bit-identical across ``pinned_rows`` and
    ``tiles_per_chunk``, as O is."""
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    worst = {}
    # (B, S, H, G, D, dtype, pinned, window, softcap)
    for case in [(2, 512, 24, 8, 128, torch.bfloat16, 0, None, None),
                 (1, 1000, 24, 8, 128, torch.float32, 64, None, None),
                 (1, 300, 4, 2, 64, torch.bfloat16, 64, None, None),
                 (1, 100, 8, 8, 112, torch.bfloat16, 100, None, None),
                 (1, 300, 16, 16, 256, torch.bfloat16, 64, 63, 50.0),
                 (1, 300, 32, 16, 128, torch.float32, 0, 64, 50.0),
                 (1, 17, 4, 1, 64, torch.float32, 17, None, None),
                 # zamba2-7b's shared block in fp32 (D 112), qwen2-vl-7b's
                 # group 7 and musicgen-large's MHA at D 64, both types
                 (1, 300, 32, 32, 112, torch.float32, 0, None, None),
                 (1, 1000, 28, 4, 128, torch.bfloat16, 64, None, None),
                 (1, 300, 28, 4, 128, torch.float32, 0, None, None),
                 (1, 1000, 32, 32, 64, torch.bfloat16, 64, None, None),
                 (1, 300, 32, 32, 64, torch.float32, 64, None, None)]:
        b, s, h, g, d, dtype, pinned, window, softcap = case
        kw = dict(window=window, softcap=softcap, scale=GEMMA2_SCALE if window else None)
        q = randn(gen, (b, s, h, d), dtype)
        k = randn(gen, (b, s, g, d), dtype)
        v = randn(gen, (b, s, g, d), dtype)
        out, lse = flash_lse(q, k, v, pinned_rows=pinned, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, flash_attention(q, k, v, pinned_rows=pinned, **kw)),
              f"flash {case}: O differs with the LSE written")
        _, ref = attention_ref(q, k, v, return_lse=True, **kw)
        err = close_scaled(lse, ref, 2e-5 if dtype == torch.float32 else 1e-3,
                           f"flash LSE {case}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    for s, h, g, d in ((300, 6, 2, 128), (700, 16, 4, 64), (300, 24, 8, 128)):
        q = randn(gen, (1, s, h, d), torch.bfloat16)
        k = randn(gen, (1, s, g, d), torch.bfloat16)
        v = randn(gen, (1, s, g, d), torch.bfloat16)
        base = flash_lse(q, k, v, pinned_rows=0, tiles_per_chunk=1)[1]
        for pinned in (0, 64, 256):
            for tiles in (None, 2, 3):
                other = flash_lse(q, k, v, pinned_rows=pinned, tiles_per_chunk=tiles)[1]
                check(torch.equal(other, base), f"flash LSE S {s} G {g} D {d}: pinned "
                      f"{pinned}, tiles {tiles} differs from pinned 0")
    return worst


def not_implemented(fn, what):
    """Check that ``fn()`` raises NotImplementedError before any launch."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    try:
        fn()
    except NotImplementedError:
        check(launch_counts() == before, f"{what}: launched before refusing")
        return
    raise AssertionError(f"{what} was not refused")


def check_refused_under_grad(gen):
    """A CUDA tensor that autograd would differentiate is refused where no
    backward kernel exists: decode attention, the SSD scan in bf16 and
    non-causal flash attention; without grad the same calls run.  An fp32
    SSD scan under grad goes through ``SSDScanFn``; flash attention at
    head_dim 112 and 256, with a window (at 128 and 112), a softcap or both
    through ``FlashAttentionFn``; a head size the kernels are not compiled
    for (96) is refused with ValueError."""
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import ssd_scan
    bf = torch.bfloat16
    q = randn(gen, (2, 8, 128), bf).requires_grad_()
    k = randn(gen, (2, 64, 2, 128), bf)
    cl = torch.tensor([64, 3], dtype=torch.int32, device="cuda")
    not_implemented(lambda: decode_attention(q, k, k, cl), "decode_attention under grad")
    x, dt, A, B, C = ssd_inputs(gen, 1, 128, 8, 1, 64, 64, bf)
    x.requires_grad_()
    not_implemented(lambda: ssd_scan(x, dt, A, B, C, chunk=64), "bf16 ssd_scan under grad")
    x32 = x.detach().float().requires_grad_()
    y, _ = ssd_scan(x32, dt, A, B.float(), C.float(), chunk=64)
    check(type(y.grad_fn).__name__ == "SSDScanFnBackward",
          f"fp32 ssd_scan under grad: grad_fn {type(y.grad_fn).__name__}")
    qf = randn(gen, (1, 128, 4, 128), bf).requires_grad_()
    kf = randn(gen, (1, 128, 2, 128), bf)
    not_implemented(lambda: flash_attention(qf, kf, kf, causal=False),
                    "non-causal flash_attention under grad")
    q96 = randn(gen, (1, 128, 4, 96), bf).requires_grad_()
    refused(lambda: flash_attention(q96, q96[:, :, :2], q96[:, :, :2]),
            "flash_attention at D 96 under grad")
    with torch.no_grad():
        decode_attention(q, k, k, cl)
        ssd_scan(x, dt, A, B, C, chunk=64)
        flash_attention(qf, kf, kf, causal=False)
    for d, kw in ((112, {}), (256, {}), (128, dict(window=64)), (128, dict(softcap=50.0)),
                  (112, dict(window=64)), (256, dict(window=64, softcap=50.0))):
        qg = randn(gen, (1, 128, 4, d), bf).requires_grad_()
        kg = randn(gen, (1, 128, 2, d), bf)
        o = flash_attention(qg, kg, kg, **kw)
        check(type(o.grad_fn).__name__ == "FlashAttentionFnBackward",
              f"flash_attention at D {d} {kw} under grad: grad_fn {type(o.grad_fn).__name__}")
    torch.cuda.synchronize()


def time_ms_events(fn, flush, iters=10):
    """Device milliseconds of one ``fn()`` of a few milliseconds or more,
    autograd calls included (which ``time_ms``'s CUDA graphs do not take):
    ``iters`` calls, each after a rewrite of the 64 MB buffer, between two
    CUDA events, less the same loop of rewrites alone; median of 3."""
    fn()
    torch.cuda.synchronize()

    def loop(body):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            flush.zero_()
            body()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    runs = [loop(fn) - loop(lambda: None) for _ in range(3)]
    return statistics.median(runs) / iters


def visible_pairs(s, window=None):
    """(row, column) pairs that causal attention over ``s`` rows sees, each
    row at most ``window`` of them."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bwd_record(gen, flush, key, ptxas=None):
    """The backward kernel's record at the training shape ``BWD_SHAPES[key]``
    of a train phase (one microbatch, bf16, causal; its scale, softcap and
    window where it has them): its time (the three launches of one call)
    beside the plain version's and one library call's, ``torch.autograd.grad``
    through ``scaled_dot_product_attention`` (a yardstick only: the port never
    calls it; it has no softcap, so with one it computes another function,
    and a window that binds is its boolean mask), and the bound: the larger
    of the bytes moved once (q, k, v, o, dO and lse read, dq, dk, dv written)
    over the card's memory rate and the operations over its bf16 peak, five
    products (S again, dP, dV, dK, dQ) of 2 * D FLOP for each visible (row,
    column) pair of each query head.  Also the forward's time with and
    without the LSE at this shape, beside its plain version (with the LSE),
    the library's call and its bound (two products a visible pair; q, k, v
    read, o and the LSE written).  With the build's ``ptxas`` map
    (``--build-log``), the registers and spills of the bf16 kernels at this
    head_dim (the ``_ext_`` ones where the shape has a window or a
    softcap)."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import _mask
    bf = torch.bfloat16
    shape = BWD_SHAPES[key]
    b, s, h, g, d = (shape[k] for k in ("b", "s", "h", "g", "d"))
    kw = {k: shape[k] for k in ("scale", "softcap", "window") if k in shape}
    window = kw.get("window")
    q = randn(gen, (b, s, h, d), bf)
    k = randn(gen, (b, s, g, d), bf)
    v = randn(gen, (b, s, g, d), bf)
    do = randn(gen, (b, s, h, d), bf)
    o, lse = flash_lse(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    # (worst ratio, max abs err, the row scale where it is) of dq, dk, dv
    held = {n: close_grad(a, r, TOL[bf], f"flash bwd at the training shape {key}, {n}")
            for n, a, r in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    binds = bool(window) and window < s
    lib_kw = dict(scale=kw.get("scale"), enable_gqa=True)
    if binds:
        lib_kw["attn_mask"] = _mask(s, s, True, window, q.device)
    else:
        lib_kw["is_causal"] = True

    def lib_fwd(a, bb, c):
        return F.scaled_dot_product_attention(a, bb, c, **lib_kw)

    lib_out = lib_fwd(ql, kl, vl)
    dol = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), dol, retain_graph=True)

    lib = lib_bwd()
    if not kw.get("softcap"):
        close_grad(lib[0].transpose(1, 2), attention_bwd_ref(q, k, v, o, lse, do, **kw)[0],
                   TOL[bf], "library bwd dq vs plain")
    del lib
    n_seen = visible_pairs(s, window)
    n_flops = 10 * d * n_seen * h * b
    n_bytes = 2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel() + 2 * (q.numel()
                                                                         + 2 * k.numel())
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    fwd_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * lse.numel()   # q, k, v, o; lse
    ms = time_ms_events(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), flush)
    ext = "_ext" if kw.get("window") or kw.get("softcap") else ""
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # no Pallas backward exists: the JAX package differentiates the
        # attention that flash_kernel computes through gqa_attention
        "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
        "replaces_note": "gradient of flash_kernel's attention; the JAX package takes it "
                         "by autodiff of src/repro/models/layers.py:124 gqa_attention",
        "path": shape.get("path", key),
        "shape": {"B": b, "S": s, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "causal": True, "visible_pairs": n_seen, **kw},
        **kernel_usage(ptxas, (f"delta_kernel<13__nv_bfloat16Li{d}>",
                               f"dkdv_mma{ext}_kernel<Li{d}>", f"dq_mma{ext}_kernel<Li{d}>")),
        "max_abs_err": max(e for _, e, _ in held.values()), "tol": TOL[bf],
        "tol_rule": f"|err| <= tol (|ref| + scale), scale: the larger RMS of the "
                    f"element's row and of its {BWD_TILE}-row tile of its head (grad_err)",
        "held": {n: {"worst_ratio": r, "max_abs_err": e, "scale_at_max_abs_err": a}
                 for n, (r, e, a) in held.items()},
        "ms": ms, "tflops": n_flops / ms * 1e-9,
        "plain_ms": time_ms_events(lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw),
                                   flush),
        "library_ms": time_ms_events(lib_bwd, flush),
        **({"library_note": "scaled_dot_product_attention without the softcap"
                            + (", the window as a boolean mask" if binds else "")}
           if kw.get("softcap") else {}),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "forward_ms": time_ms(lambda: flash_attention(q, k, v, **kw), flush),
        "forward_ms_with_lse": time_ms(lambda: flash_lse(q, k, v, **kw), flush),
        "forward_plain_ms_with_lse": time_ms(
            lambda: attention_ref(q, k, v, return_lse=True, **kw), flush),
        "forward_library_ms": time_ms(lambda: lib_fwd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)), flush),
        "forward_bound_ms": max(fwd_bytes / PEAK_BYTES * 1e3,
                                4 * d * n_seen * h * b / PEAK_FLOPS[bf] * 1e3),
    }


def kernel_usage(ptxas, names):
    """{"ptxas": {kernel: registers and spills}} of the kernels named in
    ``names`` (as ``kernel_name`` prints them), from the build's map; {}
    without one."""
    if not ptxas:
        return {}
    return {"ptxas": {k: v for k, v in ptxas.items() if k in names}}


# ---------------------------------------------------------------------------
# the SSD scan's backward kernel (training)
# the SSD scans of each train phase's microbatch: mamba2-2.7b, zamba2-7b
SSD_TRAIN_SHAPE = dict(b=8, s=512, h=80, g=1, p=64, n=128, chunk=256)
SSD_BWD_SHAPES = {"train_ssm": SSD_TRAIN_SHAPE,
                  "train_hybrid": dict(b=8, s=512, h=112, g=1, p=64, n=64, chunk=256)}
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def ssd_grad_err(name, out, ref, tol):
    """``grad_err`` for one gradient of the SSD scan, each laid out as
    (B, rows, heads, D) so that a row is one position's (or one state row's)
    values and a tile its ``BWD_TILE`` rows of one head: dx (B,S,H,P), dB
    and dC (B,S,G,N) as they are; ddt (B,S,H) with D 1; dinit (B,H,P,N) with
    P as the rows.  dA (H,) against the RMS of dA: |err| <= tol (|ref| +
    rms(ref))."""
    if name == "dA":
        out, ref = out.float(), ref.float()
        scale = float(ref.square().mean().sqrt())
        err = (out - ref).abs()
        ratio = float((err / (tol * (ref.abs() + scale))).max())
        return (bool(torch.isfinite(out).all()) and ratio <= 1.0, ratio, float(err.max()),
                scale)
    if name == "ddt":
        out, ref = out[..., None], ref[..., None]
    elif name == "dinit":
        out, ref = out.transpose(1, 2), ref.transpose(1, 2)
    return grad_err(out, ref, tol)


def check_ssd_grads(got, want, tol, what):
    """Every gradient of ``got`` passes ``ssd_grad_err`` against ``want`` (a
    None on both sides is skipped); returns {name: (ratio, max abs err)}."""
    held = {}
    for name, a, r in zip(SSD_GRADS, got, want):
        if a is None and r is None:
            continue
        check(a is not None and r is not None and a.shape == r.shape
              and a.dtype == torch.float32, f"{what}: {name} missing or misshapen")
        ok, ratio, err, at = ssd_grad_err(name, a, r, tol)
        check(ok, f"{what} {name}: |err| / (tol (|ref| + scale)) reaches {ratio:.3g} (tol "
                  f"{tol}; max abs err {err:.3e} where the scale is {at:.3g})")
        held[name] = (ratio, err)
    return held


def ssd_bwd_faults(x, dt, A, B, C, dy, dfinal, init, got):
    """Faults planted in a backward's gradients, each of which
    ``ssd_grad_err`` must reject: {name: (gradient name, tensor)}.  "tail":
    dB of the last ``BWD_TILE``-row sub-chunk left at zero.  "head": the last
    head of every group missing from dB and dC in the sub-chunk before the
    last (its contribution, ``ssd_bwd_ref`` with dy and dfinal kept on that
    head only, taken away).  "cut": ddt with the reverse running sum of dcum
    cut at the last sub-chunk's boundary (the rows before it lose A times the
    sum of dcum from the boundary on).  Needs S > 2 ``BWD_TILE``."""
    from repro_torch.kernels import ssd_bwd_ref
    s, h, g = x.shape[1], x.shape[2], B.shape[2]
    last = (s - 1) // BWD_TILE * BWD_TILE
    late = slice(last - BWD_TILE, last)
    keep = torch.zeros(h, device=x.device)
    keep[h // g - 1::h // g] = 1.0
    only = ssd_bwd_ref(x, dt, A, B, C, dy * keep[:, None],
                       None if dfinal is None else dfinal * keep[:, None, None], init)
    da = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init, return_da=True)[-1]
    tail, head_b, head_c, cut = got[3].clone(), got[3].clone(), got[4].clone(), got[1].clone()
    tail[:, last:] = 0
    head_b[:, late] -= only[3][:, late]
    head_c[:, late] -= only[4][:, late]
    cut[:, :last] -= A * da[:, last:last + 1]
    return {"tail": ("dB", tail), "head": ("dB", head_b), "head_c": ("dC", head_c),
            "cut": ("ddt", cut)}


def ssd_faults_rejected(x, dt, A, B, C, dy, dfinal, init, got, want, tol, what):
    """Every fault of ``ssd_bwd_faults`` fails ``ssd_grad_err`` against
    ``want``; returns the smallest worst ratio."""
    least = float("inf")
    for name, (grad, planted) in ssd_bwd_faults(x, dt, A, B, C, dy, dfinal, init,
                                                got).items():
        ok, ratio, _, _ = ssd_grad_err(grad, planted, want[SSD_GRADS.index(grad)], tol)
        check(not ok, f"{what}: the planted fault {name!r} in {grad} passes "
              f"(worst ratio {ratio:.3g})")
        least = min(least, ratio)
    return least


def ssd_autograd_ref(x, dt, A, B, C, chunk, init, dy, dfinal):
    """The six gradients by autograd through ``ssd_ref`` (dinit None without
    an initial state)."""
    from repro_torch.kernels import ssd_ref
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    if init is not None:
        leaves.append(init.detach().clone().requires_grad_())
    y, st = ssd_ref(*leaves[:5], chunk, initial_state=leaves[5] if init is not None else None)
    outs, grads = [y], [dy]
    if dfinal is not None:
        outs.append(st)
        grads.append(dfinal)
    got = torch.autograd.grad(outs, leaves, grads)
    return tuple(got) + ((None,) if init is None else ())


def check_ssd_bwd(gen):
    """The backward kernel against ``ssd_bwd_ref`` and against autograd of
    ``ssd_ref`` on the same inputs, every gradient by ``ssd_grad_err`` at the
    fp32 ``SSD_TOL``, over ``ssd_cases()``'s fp32 shapes, with and without an
    initial state and a final-state gradient, and on strided views through
    ``ssd_scan`` under autograd (``SSDScanFn``).  At S of two sub-chunks or
    more the faults of ``ssd_bwd_faults`` planted in the kernel's gradients
    must fail the same rule.  Returns the worst ratios (<= 1), the largest
    absolute errors and the smallest ratio of a planted fault (> 1)."""
    from repro_torch.kernels import ssd_bwd_ref
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels import ssd_scan_bwd
    tol = SSD_TOL[torch.float32]
    worst = {"ratio_vs_closed_form": 0.0, "ratio_vs_autograd": 0.0, "max_abs_err": 0.0,
             "fault_min_ratio": float("inf"), "cases": 0}

    def note(held, key):
        for ratio, err in held.values():
            worst[key] = max(worst[key], ratio)
            worst["max_abs_err"] = max(worst["max_abs_err"], err)

    cases = [c for c in ssd_cases() if c[7] == torch.float32]
    for i, (b, s, h, g, p, n, chunk, _, with_init) in enumerate(cases):
        case = (b, s, h, g, p, n, chunk, with_init, i % 2 == 0)
        x, dt, A, B, C = ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
        init = randn(gen, (b, h, p, n), torch.float32) if with_init else None
        dy = randn(gen, (b, s, h, p), torch.float32)
        dfinal = randn(gen, (b, h, p, n), torch.float32) if i % 2 == 0 else None
        got = ssd_scan_bwd(x, dt, A, B, C, dy, dfinal, initial_state=init)
        torch.cuda.synchronize()
        if init is None:
            got = got[:5] + (None,)
        want = ssd_bwd_ref(x, dt, A, B, C, dy, dfinal, init)
        if init is None:
            want = want[:5] + (None,)
        note(check_ssd_grads(got, want, tol, f"ssd bwd {case} vs ssd_bwd_ref"),
             "ratio_vs_closed_form")
        note(check_ssd_grads(got, ssd_autograd_ref(x, dt, A, B, C, chunk, init, dy, dfinal),
                             tol, f"ssd bwd {case} vs autograd of ssd_ref"),
             "ratio_vs_autograd")
        if s > 2 * BWD_TILE:
            worst["fault_min_ratio"] = min(worst["fault_min_ratio"], ssd_faults_rejected(
                x, dt, A, B, C, dy, dfinal, init, got, want, tol, f"ssd bwd {case}"))
        worst["cases"] += 1
    # strided views through ssd_scan under autograd, as mamba2_block hands them
    # over: x a slice of a wider projection, B and C two column ranges of one
    # (B, S, 2GN) tensor; dB and dC come back into that tensor's gradient
    b, s, h, g, p, n = 2, 512, 8, 2, 64, 128
    wide = randn(gen, (b, s, h, 2 * p), torch.float32).requires_grad_()
    bc = randn(gen, (b, s, 2 * g * n), torch.float32).requires_grad_()
    _, dt, A, _, _ = ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
    dt, A = dt.requires_grad_(), A.requires_grad_()
    dy = randn(gen, (b, s, h, p), torch.float32)
    dfinal = randn(gen, (b, h, p, n), torch.float32)

    def grads(fn):
        x = wide[..., p:]
        B, C = bc[..., :g * n].view(b, s, g, n), bc[..., g * n:].view(b, s, g, n)
        y, st = fn(x, dt, A, B, C)
        gw, gdt, gA, gbc = torch.autograd.grad((y, st), (wide, dt, A, bc), (dy, dfinal))
        return (gw[..., p:], gdt, gA, gbc[..., :g * n].reshape(b, s, g, n),
                gbc[..., g * n:].reshape(b, s, g, n), None)

    got = grads(lambda *a: ssd_scan(*a, chunk=256))
    want = grads(lambda *a: ssd_ref(*a, 256))
    note(check_ssd_grads(got, want, tol, "ssd bwd on strided views through SSDScanFn"),
         "ratio_vs_autograd")
    check(bool((got[0] != 0).any()) and float(got[0].abs().max()) > 0,
          "ssd bwd on strided views: a zero gradient")
    worst["cases"] += 1
    return worst


def ssd_bwd_record(gen, flush, path, ptxas=None):
    """The backward kernel's record at the training shape of the train phase
    ``path`` (one microbatch, ``SSD_BWD_SHAPES``, fp32 as ``mamba2_block``
    passes it), with its kernels' registers where ``ptxas`` is given:
    its time (the three launches of one call) beside the plain version's,
    ``torch.autograd.grad`` through ``ssd_ref``; no library call computes an
    SSD gradient.  The bound: the larger of the bytes moved once (x, dt, A,
    B, C and dy read; dx, ddt, dA, dB and dC written) over the card's memory
    rate and the operations over 3xTF32's rate, counted by ``SSD_COUNT_Q``'s
    convention extended to the products the gradient needs (not the
    kernel's, which forms dY X^T once in each walk): per (batch, head,
    sub-chunk of Q rows) two causal Q x Q products over P (dY X^T,
    (C B^T o L)^T dY) and three over N (C B^T, (dY X^T o L) B,
    (dY X^T o L)^T C), at Q^2 K FLOP each (half the square), and five of
    2 Q P N FLOP (dY ST and X^T B of the recomputed state; B R^T, X R and
    dY^T C of the reverse one): Q^2 (2 P + 3 N) + 10 Q P N."""
    from repro_torch.kernels import ssd_bwd_ref
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan_bwd
    f32 = torch.float32
    b, s, h, g, p, n, chunk = (SSD_BWD_SHAPES[path][k] for k in ("b", "s", "h", "g", "p", "n",
                                                                  "chunk"))
    x, dt, A, B, C = ssd_inputs(gen, b, s, h, g, p, n, f32)
    dy = randn(gen, (b, s, h, p), f32)
    got = ssd_scan_bwd(x, dt, A, B, C, dy)[:5] + (None,)
    want = ssd_bwd_ref(x, dt, A, B, C, dy)[:5] + (None,)
    held = check_ssd_grads(got, want, SSD_TOL[f32], "ssd bwd at the training shape")
    del got, want
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    y_ref, _ = ssd_ref(*leaves, chunk)

    def plain_bwd():
        return torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)

    q = SSD_COUNT_Q
    n_flops = b * h * (-(-s // q)) * (q * q * (2 * p + 3 * n) + 10 * q * p * n)
    n_bytes = 4 * (3 * x.numel() + 2 * dt.numel() + 2 * A.numel() + 4 * B.numel())
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FP32_ACCURATE_MMA * 1e3
    ms = time_ms_events(lambda: ssd_scan_bwd(x, dt, A, B, C, dy), flush)
    rec = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        # no Pallas backward exists: the JAX package differentiates the scan
        # that ssd_kernel computes through ssd_chunked
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:28",
        "replaces_note": "gradient of ssd_kernel's scan; the JAX package takes it by "
                         "autodiff of src/repro/models/ssm.py:38 ssd_chunked",
        "path": path,
        "shape": {"B": b, "S": s, "H": h, "G": g, "P": p, "N": n, "chunk": chunk,
                  "count_q": q, "dtype": "float32"},
        **kernel_usage(ptxas, (f"fwd_walk_kernel<Li{p}ELi{n}>", f"rev_walk_kernel<Li{p}ELi{n}>")),
        "flop": n_flops, "bytes": n_bytes,
        "max_abs_err": max(e for _, e in held.values()), "tol": SSD_TOL[f32],
        "tol_rule": f"|err| <= tol (|ref| + scale), scale: the larger RMS of the "
                    f"element's row and of its {BWD_TILE}-row tile of its head; dA: the "
                    f"RMS of dA (ssd_grad_err)",
        "held": {k: {"worst_ratio": r, "max_abs_err": e} for k, (r, e) in held.items()},
        "ms": ms, "tflops": n_flops / ms * 1e-9,
        "plain_ms": time_ms_events(plain_bwd, flush),
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_fma_ms": max(t_bytes, n_flops / PEAK_FLOPS[f32] * 1e3),
    }
    del y_ref, leaves
    return rec


def phase_kernels(ptxas=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    worst_decode = check_decode(gen)
    worst_flash = check_flash(gen)
    worst_ssd = check_ssd(gen)
    worst_bwd = check_flash_bwd(gen)
    worst_lse = check_flash_lse(gen)
    worst_ssd_bwd = check_ssd_bwd(gen)
    check_refused_under_grad(gen)
    records, extra = [], []
    for path in ATTN_SHAPES:
        main, more = time_attention(gen, flush, path)
        records += main
        extra += more
    for path in SSD_SHAPES:
        main, more = time_ssd(gen, flush, path)
        records += main
        extra += more
    for key in BWD_SHAPES:
        records.append(flash_bwd_record(gen, flush, key, ptxas))
    for path in SSD_BWD_SHAPES:
        records.append(ssd_bwd_record(gen, flush, path, ptxas))
    emit("kernels", decode_cases_max_abs_err=worst_decode,
         flash_cases_max_abs_err=worst_flash, ssd_cases_max_abs_err=worst_ssd,
         flash_bwd_cases=worst_bwd, flash_lse_cases_max_abs_err=worst_lse,
         ssd_bwd_cases=worst_ssd_bwd,
         tol={str(k): v for k, v in TOL.items()},
         ssd_tol={str(k): v for k, v in SSD_TOL.items()},
         timed=records + extra)
    return records


# ---------------------------------------------------------------------------
# The main paths: (arch, published sizes, phase names, prompt length draw)
def llama_prompt_len(rng):
    return int(rng.integers(64, 1025))


def mamba2_prompt_len(rng):
    """A length the reference's chunk rule accepts (S <= 256, or a multiple
    of 256), half of them long; never 1 or 2 tokens (ROADMAP Queue 3)."""
    if rng.random() < 0.5:
        return int(rng.integers(3, 257))
    return 256 * int(rng.integers(2, 5))


# SSM and MoE spec fields checked against the published ones
SSM_SPEC = ("d_state", "expand", "head_dim", "n_groups", "d_conv", "chunk")
MOE_SPEC = ("n_experts", "top_k", "d_ff_expert", "n_shared", "capacity_factor", "first_dense")
PATHS = {
    "llama3.2-3b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab"),
        published=(28, 3072, 24, 8, 128, 8192, 128256), serve="serve", parity="parity",
        prompt_len=llama_prompt_len, parity_cut={"layers": 2}, parity_layers=2),
    "mamba2-2.7b": dict(
        sizes=("n_layers", "d_model", "vocab"), published=(64, 2560, 50280),
        ssm=(128, 2, 64, 1, 4, 256), serve="serve_ssm", parity="parity_ssm",
        prompt_len=mamba2_prompt_len, parity_cut={"layers": 2}, parity_layers=2),
    "zamba2-7b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "hybrid_period", "act"),
        published=(81, 3584, 32, 32, 112, 14336, 32000, 6, "gelu"),
        ssm=(64, 2, 64, 1, 4, 256), serve="serve_hybrid", parity="parity_hybrid",
        prompt_len=mamba2_prompt_len,
        # one group of 6 Mamba2 layers, the shared block, one tail layer; too
        # deep for the bf16 share and RMS across devices (phase_parity)
        parity_cut={"mamba_groups": 1, "mamba_tail": 1}, parity_layers=7,
        bf16_cross_device=False),
    "deepseek-moe-16b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab"),
        published=(28, 2048, 16, 16, 128, 10944, 102400),
        moe=(64, 6, 1408, 2, 1.25, 1), serve="serve_moe", parity="parity_moe",
        prompt_len=llama_prompt_len,
        # the dense layer and the first MoE layer
        parity_cut={"moe_layers": 1}, parity_layers=2),
    "gemma2-27b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "window", "local_global_period", "attn_softcap", "final_softcap",
               "attn_scale", "gemma_norm", "act"),
        published=(46, 4608, 32, 16, 128, 36864, 256000, GEMMA2_WINDOW, 2, 50.0, 30.0,
                   GEMMA2_SCALE, True, "gelu"),
        serve="serve_gemma2", parity="parity_gemma2", prompt_len=llama_prompt_len,
        # two prompts past the window, by one KV tile and by sixteen: the
        # second lands in a reused slot
        fixed_prompt_lens={2: GEMMA2_WINDOW + 64, 7: GEMMA2_WINDOW + 1024},
        max_batch=4, max_seq=GEMMA2_POOL,
        # one local and one global layer; a window of 64 that 2 x 96 prompt
        # tokens and 4 decode steps overrun on the CPU in reasonable time
        parity_cut={"layers": 2}, parity_layers=2, parity_changes={"window": 64},
        parity_prompt=96),
    "gemma-7b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "gemma_norm", "act"),
        published=(28, 3072, 16, 16, 256, 24576, 256000, True, "gelu"),
        serve="serve_gemma7b", parity="parity_gemma7b", prompt_len=llama_prompt_len,
        parity_cut={"layers": 2}, parity_layers=2, parity_prompt=64),
}


def kernel_layers(cfg):
    """(attention layers, Mamba2 layers) of a model: dense and MoE layers
    alike are attention layers; a hybrid's are the applications of its
    shared block."""
    from repro_torch.configs import HYBRID
    from repro_torch.configs import SSM
    if cfg.family == HYBRID:
        return cfg.n_layers // cfg.hybrid_period, cfg.n_layers
    if cfg.family == SSM:
        return 0, cfg.n_layers
    return cfg.n_layers, 0


def check_published(arch, cfg):
    """``cfg`` is ``arch``'s published configuration (``PATHS``)."""
    path = PATHS[arch]
    check(tuple(getattr(cfg, k) for k in path["sizes"]) == path["published"],
          f"{arch} is not at its published size")
    if "ssm" in path:
        check(tuple(getattr(cfg.ssm, k) for k in SSM_SPEC) == path["ssm"],
              f"{arch}: SSM spec is not published")
    if "moe" in path:
        check(tuple(getattr(cfg.moe, k) for k in MOE_SPEC) == path["moe"],
              f"{arch}: MoE spec is not published")


def phase_serve(arch, n_requests, max_new):
    """Serve ``n_requests`` through the engine at the published size, with the
    launch counts set to 0 just before and read just after."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.serve import Request
    from repro_torch.serve import ServeEngine
    path = PATHS[arch]
    cfg = get_arch(arch)
    check_published(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    engine = ServeEngine(cfg, params, max_batch=path.get("max_batch", 8),
                         max_seq=path.get("max_seq", 2048), device="cuda")
    rng = np.random.default_rng(0)
    reqs = []
    fixed = path.get("fixed_prompt_lens", {})
    for i in range(n_requests):
        plen = fixed[i] if i in fixed else path["prompt_len"](rng)
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
    check(engine.decode_calls > 0, "no decode_step call")
    # every prompt has 3 tokens or more, so each prefill scans
    n_attn, n_ssm = kernel_layers(cfg)
    want = {"decode_attention": n_attn * engine.decode_calls,
            "flash_attention": n_requests * n_attn, "flash_attention_bwd": 0,
            "ssd_scan": n_requests * n_ssm, "ssd_scan_bwd": 0}
    check(counts == want, f"{arch}: launches {counts}, expected {want} "
          f"({n_requests} prefills, {engine.decode_calls} decode_step calls)")
    check(bool(torch.isfinite(engine.last_logits.float()).all()), "non-finite logits")
    emit(path["serve"], arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16",
         max_batch=engine.max_batch, max_seq=engine.max_seq,
         requests=n_requests, prompt_lens=[len(r.prompt) for r in reqs],
         prompt_tokens=int(sum(len(r.prompt) for r in reqs)),
         new_tokens=tokens, seconds=seconds, tokens_per_s=tokens / seconds,
         engine_steps=steps, decode_step_calls=engine.decode_calls,
         wall_ms_per_decode_step_call=seconds * 1e3 / engine.decode_calls,
         launches=counts, init_params_seconds=init_s,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return cfg, params, counts


def parity_prompt_len(arch, cfg):
    from repro_torch.configs import DENSE
    return PATHS[arch].get("parity_prompt", 48 if cfg.family == DENSE else 64)


def parity_logits(arch, cfg, params, dev, dtype, plain=False, routes=None):
    """Logits (5, 2, vocab) of ``phase_parity``'s calls on ``dev`` in
    ``dtype``: prefill of 2 prompts into the path's cut of ``params`` + 4
    decode steps, the tokens drawn from seed 1.  ``plain`` runs the kernels'
    plain versions; ``routes`` (a MoE path) records or follows expert choices
    (``routing``)."""
    from repro_torch.configs import SSM
    from repro_torch.core.orchestrator import flash_smem_bytes
    from repro_torch.core.orchestrator import H100_SMEM_PER_BLOCK
    from repro_torch.models import decode_step
    from repro_torch.models import prefill
    path = PATHS[arch]
    cfg2 = replace(cfg, n_layers=path["parity_layers"], **path.get("parity_changes", {}))
    plen = parity_prompt_len(arch, cfg)

    def cut(tree, keep=None):
        """The tree with the first ``keep`` layers of each leaf below a key of
        ``parity_cut`` (all of them elsewhere), on ``dev``."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cut(v, path["parity_cut"].get(k, keep))
            else:
                v = v[:keep] if keep else v
                out[k] = v.to(device=dev, dtype=torch.float32 if v.dtype == torch.float32
                              else dtype)
        return out

    rng = np.random.default_rng(1)
    prompt = rng.integers(2, cfg.vocab, size=(2, plen))
    steps = rng.integers(2, cfg.vocab, size=(4, 2, 1))
    p = cut(params)
    tok = torch.as_tensor(prompt, device=dev)
    follow = routing(routes) if routes is not None else nullcontext()
    with plain_versions() if plain else nullcontext(), follow:
        if cfg.family == SSM:
            got, cache = prefill(p, tok, cfg2)
        else:
            # the whole prompt pinned where the kernel's shared memory holds
            # it (not in fp32 at head_dim 256, which streams it)
            fits = flash_smem_bytes(plen, cfg.head_dim, dtype.itemsize) <= H100_SMEM_PER_BLOCK
            got, cache = prefill(p, tok, cfg2, pinned_rows=plen if fits else 0)
            pad = torch.zeros_like(cache.k[:, :, :4])
            cache = cache._replace(k=torch.cat([cache.k, pad], dim=2),
                                   v=torch.cat([cache.v, pad], dim=2))
        outs = [got]
        for tok in steps:
            got, cache = decode_step(p, torch.as_tensor(tok, device=dev), cache, cfg2)
            outs.append(got[:, 0])
    return torch.stack(outs).float().cpu()


def held_logits(got, want):
    """Share within ``LOGIT_TOL``, RMS and largest error of bf16 logits, and
    whether the greedy tokens agree where ``want``'s top-2 margin is clear of
    the tolerance."""
    err = (got - want).abs()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * (LOGIT_TOL + LOGIT_TOL * top2[..., 0].abs())
    same = got.argmax(-1) == want.argmax(-1)
    return dict(max_abs_err=float(err.max()),
                share_within_tol=float((err <= LOGIT_TOL + LOGIT_TOL * want.abs())
                                       .float().mean()),
                rms_err=float(err.square().mean().sqrt()),
                clear_margin_tokens=int(clear.sum()), tokens_equal=int(same.sum()),
                clear_margin_tokens_equal=bool(same[clear].all()))


def router_flips(routes):
    """What a run that followed recorded expert choices (``routing``)
    replayed: the tokens routed, those it would have sent to other experts,
    their largest gap in router probability, and whether they are a few
    near-ties (``ROUTER_MAX_FLIPS``, ``ROUTER_NEAR_TIE``)."""
    flips, tokens = routes["flips"], sum(int(c.shape[0]) for c in routes["calls"])
    gap = max(flips, default=0.0)
    return dict(tokens_routed=tokens, tokens_routed_otherwise_on_cpu=len(flips),
                largest_gap=gap, near_ties=(len(flips) <= ROUTER_MAX_FLIPS * tokens
                                            and gap <= ROUTER_NEAR_TIE))


def check_near_ties(routes, what):
    """``router_flips``, after checking that they are a few near-ties."""
    flips = router_flips(routes)
    check(flips.pop("near_ties"), f"{what}: the CPU would route "
          f"{flips['tokens_routed_otherwise_on_cpu']} of {flips['tokens_routed']} "
          f"tokens otherwise, giving up {flips['largest_gap']:.2e} of probability "
          "at most: not a few near-ties")
    return flips


def phase_parity(arch, cfg, params):
    """Prefill + 4 decode steps of a cut of the served weights (2 layers; for
    the hybrid one group and one tail layer; for the MoE its dense layer and
    one MoE layer), on the card (kernels) and on the CPU (plain versions).

    In fp32 (the same weights, widened) every logit must agree within
    rtol = atol = 3e-2: that holds the kernels to the plain path inside the
    model, free of rounding noise.  In bf16, the serving type, the two devices
    round activations at other places (another summation order in every
    product flips last bits, and the flips travel through the layers), so
    over a million logits the largest difference is a tail event, not a
    fault: there the check is the share of logits within the same tolerance,
    the RMS error, and the greedy token wherever the CPU's top-2 margin is
    clear of the tolerance.  Leaves the model keeps in fp32 (the SSM's
    ``a_log``, ``d_skip``, the MoE router) stay fp32 in both runs.

    The hybrid's cut is 7 layers deep, and there the bf16 flips grow past
    what the share and RMS checks allow whatever runs the attention and SSD
    steps: the card's plain versions miss them by as much as its kernels,
    and so do 7 layers of mamba2-2.7b, which has no attention
    (``scripts/parity_depth.py``, PERF.md §6).  So for a path with ``bf16_cross_device`` False the share and RMS
    checks hold the card's kernels against the card's plain versions of the
    same steps (``plain_versions``), which isolates the kernels; the
    card-vs-CPU share and RMS are reported, and the greedy token is checked
    against both.

    A MoE layer's router is a discontinuous function of its input: where a
    token's k-th and (k+1)-th expert are nearly tied, the last bits in which
    the two devices' bf16 activations differ can tip the choice, and that
    token's output, logits included, then differs by far more than any
    tolerance.  So in bf16 the CPU run of a MoE path follows the card's
    expert choices (``routing``): the logits are held as above with the same
    choices on both sides, and the tokens the CPU would have routed otherwise
    must be near-ties, its own choice ahead of the card's by at most
    ``ROUTER_NEAR_TIE`` in probability, in at most ``ROUTER_MAX_FLIPS`` of
    the tokens routed (``scripts/moe_router_flips.py`` reads both over
    several weight draws and planted router faults).  The fp32 runs route on
    their own.  What following would hide, a router that is wrong on the
    card, a router check sees: the card's router logits (``router_log``, in
    both types) must agree with the CPU's fp32 product on the same tokens and
    weights within ROUTER_LOGIT_TOL of their largest magnitude, and a router
    planted in bf16 (``bf16_router``) must fail that."""
    from repro_torch.configs import MOE
    path = PATHS[arch]
    moe = cfg.family == MOE
    calls = {"fp32": [], "bf16": []}   # the card's router calls (a MoE path)
    with router_log(calls["fp32"]) if moe else nullcontext():
        card = parity_logits(arch, cfg, params, "cuda", torch.float32)
    cpu = parity_logits(arch, cfg, params, "cpu", torch.float32)
    check(card.shape == (5, 2, cfg.vocab), "parity: wrong logits shape")
    err32 = close(card, cpu, LOGIT_TOL, f"{arch} parity fp32: card vs CPU logits")

    def held(got, want, what, statistics=True):
        """``held_logits``, checked; share and RMS only where ``statistics``."""
        got = held_logits(got, want)
        if statistics:
            check(got["share_within_tol"] >= 0.999, f"{arch} parity bf16, {what}: only "
                  f"{got['share_within_tol']:.5f} of the logits within {LOGIT_TOL}")
            check(got["rms_err"] <= LOGIT_TOL / 2, f"{arch} parity bf16, {what}: RMS "
                  f"logit error {got['rms_err']:.4f}")
        check(got.pop("clear_margin_tokens_equal"), f"{arch} parity bf16, {what}: "
              "greedy token differs at a clear margin")
        return got

    routes = {} if moe else None
    with router_log(calls["bf16"]) if moe else nullcontext():
        card = parity_logits(arch, cfg, params, "cuda", torch.bfloat16, routes=routes)
    cpu = parity_logits(arch, cfg, params, "cpu", torch.bfloat16, routes=routes)
    check(bool(torch.isfinite(card).all()), "parity bf16: non-finite logits")
    cross = path.get("bf16_cross_device", True)
    fields = {"bf16": held(card, cpu, "card vs CPU", cross)}
    if not cross:
        fields["bf16_card_plain"] = held(
            card, parity_logits(arch, cfg, params, "cuda", torch.bfloat16, plain=True),
            "card kernels vs card plain versions")
    if moe:
        fields["router_bf16"] = check_near_ties(routes, f"{arch} parity bf16")
        fields["router_logits"] = {
            f"{k}_max_rel_err": check_router_logits(v, f"{arch} parity {k}")
            for k, v in calls.items()}
        # the planted fault: a router computed from bf16 operands on the card
        planted = []
        with bf16_router(), router_log(planted):
            parity_logits(arch, cfg, params, "cuda", torch.bfloat16)
        err = router_logit_err(planted)
        check(err > ROUTER_LOGIT_TOL, f"{arch} parity: a bf16 router on the card passes the "
              f"router-logit check ({err:.3e} of the scale)")
        fields["router_logits"]["planted_bf16_router_max_rel_err"] = err
    emit(path["parity"], arch=cfg.name, n_layers=path["parity_layers"],
         changed=path.get("parity_changes", {}),
         calls=f"prefill(2x{parity_prompt_len(arch, cfg)}) + 4 decode steps",
         tol=LOGIT_TOL, fp32_max_abs_err=err32,
         **{f"{k}_{f}": v for k, d in fields.items() for f, v in d.items()})


@contextmanager
def routing(routes):
    """A MoE model's router, recording each call's expert choices into
    ``routes["calls"]`` on the first run, and following them on the next:
    where that run's own top-k differs for a token, the token takes the
    recorded experts in the recorded order, weighted by the run's own
    probabilities renormalised over them; where the experts themselves
    differ, ``routes["flips"]`` gets the probability the run's own choice had
    over the recorded one."""
    from repro_torch.models import moe
    real = moe._route
    first = "calls" not in routes
    calls = routes.setdefault("calls", [])
    flips = routes.setdefault("flips", [])
    seen = [0]

    def route(xt, w_gate, top_k):
        w, idx = real(xt, w_gate, top_k)
        if first:
            calls.append(idx.cpu())
            return w, idx
        want = calls[seen[0]].to(idx.device)
        seen[0] += 1
        other = (idx != want).any(-1)           # other experts, or the same in another order
        if bool(other.any()):
            probs = torch.softmax(torch.matmul(xt.float(), w_gate.float()), dim=-1)
            gap = probs.gather(-1, idx).sum(-1) - probs.gather(-1, want).sum(-1)
            moved = (idx.sort(-1).values != want.sort(-1).values).any(-1)
            flips.extend(gap[moved].tolist())
            w_want = probs.gather(-1, want)
            w_want = w_want / torch.clamp(w_want.sum(-1, keepdim=True), min=1e-9)
            w = torch.where(other[:, None], w_want, w)
            idx = torch.where(other[:, None], want, idx)
        return w, idx

    moe._route = route
    try:
        yield
    finally:
        moe._route = real
    check(first or seen[0] == len(calls), "routing: the runs routed different calls")


@contextmanager
def router_log(calls):
    """A MoE model's router logits, each call's (tokens, router weights,
    logits) appended to ``calls`` on the CPU."""
    from repro_torch.models import moe
    real = moe._router_logits

    def logits(xt, w_gate):
        out = real(xt, w_gate)
        calls.append(tuple(t.detach().float().cpu() for t in (xt, w_gate, out)))
        return out

    moe._router_logits = logits
    try:
        yield
    finally:
        moe._router_logits = real


@contextmanager
def bf16_router():
    """A planted fault: the card computes the router's logits from bf16
    operands, as a router that is not kept in fp32 would."""
    from repro_torch.models import moe
    real = moe._router_logits
    moe._router_logits = lambda xt, w_gate: torch.matmul(xt.bfloat16(),
                                                         w_gate.bfloat16()).float()
    try:
        yield
    finally:
        moe._router_logits = real


def router_logit_err(calls):
    """The worst error of the card's router logits in ``calls``
    (``router_log``) against the same product on the CPU in fp32 on the
    same tokens and weights, over each call's largest logit."""
    worst = 0.0
    for xt, w_gate, got in calls:
        want = torch.matmul(xt, w_gate)
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
    return worst


def check_router_logits(calls, what):
    """Every router call of ``calls`` within ROUTER_LOGIT_TOL; the worst."""
    check(len(calls) > 0, f"{what}: no router call was recorded")
    worst = router_logit_err(calls)
    check(worst <= ROUTER_LOGIT_TOL, f"{what}: the card's router logits are {worst:.3e} "
          f"of their scale off the CPU's fp32 product (tol {ROUTER_LOGIT_TOL})")
    return worst


@contextmanager
def dropped(counts):
    """Tokens dropped at the experts' capacity: each ``_slots`` call appends
    the (token, expert) choices that found no slot to ``counts``."""
    from repro_torch.models import moe
    real = moe._slots

    def slots(w, idx, n_experts, capacity):
        tok_ids, valid, gw = real(w, idx, n_experts, capacity)
        counts.append(int(idx.numel()) - int(valid.sum()))
        return tok_ids, valid, gw

    moe._slots = slots
    try:
        yield
    finally:
        moe._slots = real


@contextmanager
def plain_versions():
    """The model's calls of the three kernels routed to their plain versions,
    whatever device the tensors lie on: a run on the card that the kernels'
    run is held against inside the model."""
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels import ssd_ref
    from repro_torch.models import layers
    from repro_torch.models import ssm

    def flash(q, k, v, *, causal=True, scale=None, softcap=None, window=None, pinned_rows=0):
        return attention_ref(q, k, v, causal=causal, scale=scale, softcap=softcap,
                             window=window)

    def decode(q, k, v, cache_len, *, scale=None, window=None, softcap=None):
        return decode_attention_ref(q, k, v, cache_len, scale=scale, window=window,
                                    softcap=softcap)

    def scan(x, dt, A, B, C, *, chunk=256, initial_state=None):
        y, state = ssd_ref(x, dt, A, B, C, chunk, initial_state=initial_state)
        return y.to(x.dtype), state

    saved = layers.flash_attention, layers.decode_attention, ssm.ssd_scan
    layers.flash_attention, layers.decode_attention, ssm.ssd_scan = flash, decode, scan
    try:
        yield
    finally:
        layers.flash_attention, layers.decode_attention, ssm.ssd_scan = saved


@contextmanager
def scan_fp64():
    """The model's SSD scans as the plain chunked scan in float64 (outputs in
    fp32): a reference whose scan rounds far below fp32's."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models import ssm

    def scan(x, dt, A, B, C, *, chunk=256, initial_state=None):
        init = initial_state.double() if initial_state is not None else None
        y, state = ssd_chunked(x.double(), dt.double(), A.double(), B.double(), C.double(),
                               chunk, initial_state=init)
        return y.float(), state.float()

    saved = ssm.ssd_scan
    ssm.ssd_scan = scan
    try:
        yield
    finally:
        ssm.ssd_scan = saved


# ---------------------------------------------------------------------------
# Training: llama3.2-3b and mamba2-2.7b at full width and depth; zamba2-7b
# and deepseek-moe-16b at full width and a cut depth
TRAIN_STEPS = 6          # the last TRAIN_MB_STEPS with microbatches=2
TRAIN_MB_STEPS = 2
GRAD_TOL = 1e-4          # fp32 gradients, card vs CPU: times the leaf's largest magnitude
GRAD_SHARE_TOL = 3e-2    # bf16 gradients: share, RMS and cap of |err| / the leaf's largest magnitude
# each trained path: its phases; the depth its train phase runs at where the
# published one does not fit the card, and why; its peak learning rate where
# it is not launch/train.py's 3e-3, and why; its parity phase's cut (changes
# to the published config), tokens (B, S) and whether that phase also
# round-trips a checkpoint
DEPTH_CUT = ("{n} layers ({params}) do not fit one 80 GB card at 12 bytes a parameter "
             "(bf16 weights and gradients, fp32 Adam moments); {keep}")
# the rate of the cut-depth paths, and why (scripts/train_trajectory.py, PERF.md
# section 6: at 1e-4 both cuts' losses fall from the first step)
SMALL_LR = (1e-4, "at 3e-3 Adam's first steps (every weight moved by about lr) throw "
                  "the full-width model's loss up for the 6 steps, with the plain "
                  "versions as with the kernels")
TRAIN_PATHS = {
    "llama3.2-3b": dict(phase="train", parity="parity_train", parity_cut={"n_layers": 2},
                        parity_tokens=(2, 64), checkpoint=True),
    "mamba2-2.7b": dict(phase="train_ssm", parity="parity_train_ssm",
                        parity_cut={"n_layers": 2}, parity_tokens=(2, 256), checkpoint=False),
    "zamba2-7b": dict(
        phase="train_hybrid", parity="parity_train_hybrid", n_layers=45, lr=SMALL_LR,
        depth_cut=DEPTH_CUT.format(
            n=81, params="6.75 B parameters", keep="45 = 7 groups of 6 Mamba2 layers, each "
            "followed by the shared block, and a tail of 3: the published 6 k + 3 shape"),
        # one group of 2, one application of the shared block, a tail of 1
        parity_cut={"n_layers": 3, "hybrid_period": 2}, parity_tokens=(2, 256),
        checkpoint=False),
    "deepseek-moe-16b": dict(
        phase="train_moe", parity="parity_train_moe", n_layers=7, lr=SMALL_LR,
        depth_cut=DEPTH_CUT.format(
            n=28, params="16.4 B parameters", keep="7 = the dense layer and 6 MoE layers"),
        # the dense layer and one MoE layer; at the published capacity factor
        # 1.25, 2 x 64 tokens overfill some experts' 15 slots: tokens drop
        parity_cut={"n_layers": 2}, parity_tokens=(2, 64), checkpoint=False),
    "gemma2-27b": dict(
        phase="train_gemma2", parity="parity_train_gemma2", n_layers=2, lr=SMALL_LR,
        depth_cut=DEPTH_CUT.format(
            n=46, params="28.4 B parameters", keep="2 = one local layer (window 4096) and "
            "one global, the published alternation; 3.49 B parameters, 2.36 B of them the "
            "embedding and the head of the 256,000-word vocabulary"),
        # one local and one global layer, the window cut to 64 so that it
        # binds in 2 x 128 tokens (2 x 256 took 134 s, most of it the CPU's
        # two runs at full width)
        parity_cut={"n_layers": 2, "window": 64}, parity_tokens=(2, 128), checkpoint=False),
    "gemma-7b": dict(
        phase="train_gemma7b", parity="parity_train_gemma7b", n_layers=8, lr=SMALL_LR,
        depth_cut=DEPTH_CUT.format(
            n=28, params="9.32 B parameters", keep="8 layers, 3.79 B parameters, 1.57 B "
            "of them the embedding and the head of the 256,000-word vocabulary"),
        # 2 x 128 tokens: head_dim 256 across two 64-row tiles (2 x 256 took
        # 78 s)
        parity_cut={"n_layers": 2}, parity_tokens=(2, 128), checkpoint=False),
}


def train_launches(cfg, microbatches):
    """The launches of a train run of ``microbatches`` microbatches: the
    forward kernel of each attention application (``kernel_layers``) and of
    each Mamba2 layer twice a microbatch (forward, and again under remat), its
    backward's BWD_KERNELS kernels once; decode never."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    n_attn, n_ssm = kernel_layers(cfg)
    return {"decode_attention": 0, "flash_attention": 2 * n_attn * microbatches,
            "flash_attention_bwd": flash_ops.BWD_KERNELS * n_attn * microbatches,
            "ssd_scan": 2 * n_ssm * microbatches,
            "ssd_scan_bwd": ssd_ops.BWD_KERNELS * n_ssm * microbatches}


def phase_train(arch):
    """``arch`` trained at full width, at its published depth or the cut of
    ``TRAIN_PATHS``: bf16 weights from a seeded generator on the card,
    ``AdamWConfig`` as ``launch/train.py`` builds it (the peak learning
    rate of ``TRAIN_PATHS`` where one is given), ``SyntheticLM``
    batches of 8 x 512 tokens, ``remat=True``; TRAIN_STEPS steps, the last
    TRAIN_MB_STEPS with 2 microbatches.  Every loss and gradient norm
    finite, the last loss below the first, and the launch counts (set to 0
    just before, read just after) exactly ``train_launches``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig
    from repro_torch.train import init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves
    train = TRAIN_PATHS[arch]
    cfg = get_arch(arch)
    check_published(arch, cfg)
    published = cfg.n_layers
    cfg = replace(cfg, n_layers=train.get("n_layers", published))
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_params(cfg, seed=0, device="cuda")
    state = init_train_state(params)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in leaves(params))
    lr, why_lr = train.get("lr", (3e-3, None))
    opt = AdamWConfig(lr=lr, warmup_steps=min(50, TRAIN_STEPS // 10), total_steps=TRAIN_STEPS)
    steps = {mb: make_train_step(cfg, opt, microbatches=mb, device="cuda") for mb in (1, 2)}
    data = SyntheticLM(cfg.vocab, s, b)
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    reset_launch_counts()
    torch.cuda.synchronize()
    # peak device memory of the set-up (weights, fp32 moments), then of the
    # steps of 1 and of 2 microbatches
    peak = {"setup": torch.cuda.max_memory_allocated()}
    log, micro = [], 0
    t_run = time.time()
    for i in range(TRAIN_STEPS):
        mb = 2 if i >= TRAIN_STEPS - TRAIN_MB_STEPS else 1
        if i in (0, TRAIN_STEPS - TRAIN_MB_STEPS):
            if i:
                peak["microbatches_1"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        state, metrics = steps[mb](state, batches[i])
        torch.cuda.synchronize()
        sec = time.time() - t0
        micro += mb
        log.append({"step": i, "microbatches": mb, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                    "seconds": sec, "tokens_per_s": b * s / sec})
    run_s = time.time() - t_run
    peak["microbatches_2"] = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    want = train_launches(cfg, micro)
    check(counts == want, f"{train['phase']}: launches {counts}, expected {want} "
          f"({micro} microbatches)")
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in log),
          f"{train['phase']}: a loss or gradient norm is not finite")
    check(log[-1]["loss"] < log[0]["loss"], f"{train['phase']}: the last loss "
          f"{log[-1]['loss']:.4f} is not below the first {log[0]['loss']:.4f}")
    steady = [r["seconds"] for r in log[1:TRAIN_STEPS - TRAIN_MB_STEPS]]
    depth = {} if cfg.n_layers == published else dict(
        n_layers_published=published, depth_cut=train["depth_cut"])
    emit(train["phase"], arch=cfg.name, n_layers=cfg.n_layers, **depth, d_model=cfg.d_model,
         n_params=n_params, dtype="bfloat16", batch=b, seq=s, remat=True, peak_lr=lr,
         **({"peak_lr_why": why_lr} if why_lr else {}), steps=log,
         seconds=run_s, seconds_per_step=statistics.median(steady),
         tokens_per_s=b * s / statistics.median(steady),
         # the last step: the first of 2 microbatches allocates their gradient sum
         seconds_per_step_microbatches_2=log[-1]["seconds"],
         tokens_per_s_microbatches_2=log[-1]["tokens_per_s"],
         launches=counts, init_params_seconds=init_s,
         peak_memory_bytes=max(peak.values()),
         **{f"peak_memory_bytes_{k}": v for k, v in peak.items()})
    del state, params, steps
    gc.collect()
    torch.cuda.empty_cache()
    return counts


CKPT_CUT = 1024   # parity_train's checkpoint: each leaf's dims cut to their first 1024


def train_parity_params(cfg2, dev, dtype):
    """A trained path's parity cut at full width in ``dtype`` on ``dev``,
    from seed 0 (drawn on the card, copied); the bf16 weights are the fp32
    ones rounded."""
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    params = init_params(cfg2, seed=0, device="cuda", dtype=dtype)
    return tree_map(lambda t: t.to(dev), params)


def phase_parity_train(arch):
    """One train step of ``arch``'s parity cut at full width (``TRAIN_PATHS``:
    2 layers; for zamba2-7b one group of 2 Mamba2 layers, one application of
    the shared block and a tail of 1; for deepseek-moe-16b the dense layer
    and one MoE layer; for gemma2-27b a local and a global layer with the
    window cut to 64) on the card (kernels) against the same step on the CPU
    (plain versions), from the same weights and batch (``SyntheticLM``
    tokens: 2 x 64 for llama3.2-3b and deepseek-moe-16b, 2 x 256 for
    mamba2-2.7b and zamba2-7b, one SSD chunk a sequence, 2 x 128 for
    gemma2-27b, whose window binds there, and gemma-7b): the loss and
    gradients that ``train_step`` computes (``loss_and_grads``), then
    ``adamw_update`` on the card.  Every gradient leaf must be nonzero on the
    card, in both types.  Where the cut has SSD layers the fp32 CPU run takes
    the plain scan in float64 (``scan_fp64``): the gradients of a_log,
    dt_bias and w_dt are sums that cancel, and an fp32 scan, the card's
    kernel or the CPU's plain one, leaves a_log's about 4.5e-5 of the leaf's
    scale off a float64 scan on the same inputs (NVIDIA H100 80GB HBM3,
    700 W; ``scripts/ssd_bwd_precision.py``), so the two fp32 scans differ by
    up to twice that, most of it the reference's own rounding.  The card is
    held to GRAD_TOL against that CPU run.

    fp32: the loss, and every gradient leaf elementwise within GRAD_TOL times
    the leaf's largest magnitude.  bf16: the two devices round activations at
    other places, so, as the serving parity phases hold logits, each
    gradient leaf is held by the share of its elements within GRAD_SHARE_TOL
    of its largest magnitude (>= 0.99), the RMS of that relative error
    (<= GRAD_SHARE_TOL / 2) and a cap on it (<= 0.5); the loss within
    LOGIT_TOL.  Updated weights are not compared: Adam's first step turns
    noise into moves of size lr.

    A MoE cut runs at the published capacity factor, which drops tokens
    here, and both sides' drops are counted (``dropped``).  In both types the
    CPU follows the card's expert choices (``routing``; forward and
    recompute route alike), and the tokens it would route otherwise must be
    a few near-ties (``router_flips``); the card's router logits are held
    against the CPU's fp32 product on the same tokens (``router_log``,
    ROUTER_LOGIT_TOL).

    Then (llama3.2-3b) the card's bf16 state after the update, each leaf cut
    to its first CKPT_CUT rows and columns (every key and type kept, about
    0.2 GB as saved), is checkpointed from the card and restored on the CPU,
    bit-equal."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.configs import MOE
    from repro_torch.data import SyntheticLM
    from repro_torch.train import AdamWConfig
    from repro_torch.train import TrainState
    from repro_torch.train import adamw_update
    from repro_torch.train import init_opt_state
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.tree import flatten_with_keys
    from repro_torch.tree import tree_map
    from repro_torch.tree import unflatten
    train = TRAIN_PATHS[arch]
    cfg2 = replace(get_arch(arch), **train["parity_cut"])
    b, s = train["parity_tokens"]
    what = train["parity"]
    tokens = SyntheticLM(cfg2.vocab, s, b).batch(0)
    opt = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=10)
    moe = cfg2.family == MOE
    fields = {}

    def grads(dev, dtype, routes, fp64_scan=False):
        """(params, gradient tree, loss, {key: gradient on the CPU}); a MoE
        cut records or follows ``routes``, counts its drops and, on the card,
        checks its router logits."""
        params = train_parity_params(cfg2, dev, dtype)
        drops, calls = [], []
        with ExitStack() as stack:
            if fp64_scan:
                stack.enter_context(scan_fp64())
            if moe:
                stack.enter_context(routing(routes))
                stack.enter_context(dropped(drops))
                if dev == "cuda":
                    stack.enter_context(router_log(calls))
            loss, g = loss_and_grads(params, torch.as_tensor(tokens).to(dev, torch.long), cfg2)
        g = unflatten(params, g)
        flat = {k: t.float().cpu() for k, t in flatten_with_keys(g)}
        if moe:
            tag = f"{'fp32' if dtype == torch.float32 else 'bf16'}_{dev.replace('cuda', 'card')}"
            check(sum(drops) > 0, f"{what} {tag}: no token was dropped")
            fields[f"{tag}_tokens_dropped"] = drops
            if dev == "cuda":
                fields[f"{tag}_router_logit_max_rel_err"] = check_router_logits(
                    calls, f"{what} {tag}")
        return params, g, float(loss), flat

    def on_card(g_card, dtype):
        """Every leaf's gradient is nonzero on the card."""
        for key, t in g_card.items():
            check(bool((t != 0).any()), f"{what} {dtype}: no gradient reaches {key} on the card")

    routes = {}
    _, _, loss_card, g_card = grads("cuda", torch.float32, routes)
    on_card(g_card, "fp32")
    _, _, loss_cpu, g_cpu = grads("cpu", torch.float32, routes, fp64_scan=cfg2.ssm is not None)
    if moe:
        fields["router_fp32"] = check_near_ties(routes, f"{what} fp32")
    check(abs(loss_card - loss_cpu) <= 1e-5 * max(1.0, abs(loss_cpu)),
          f"{what} fp32: loss {loss_card} vs {loss_cpu}")
    check(sorted(g_card) == sorted(g_cpu), f"{what}: gradient keys differ")
    worst = (0.0, "")
    for key in g_cpu:
        a, r = g_card[key], g_cpu[key]
        scale = float(r.abs().max())
        check(scale > 0, f"{what} fp32: {key} has a zero gradient on the CPU")
        err = float((a - r).abs().max())
        check(err <= GRAD_TOL * scale, f"{what} fp32: {key} max abs err {err:.3e} "
              f"beyond {GRAD_TOL} x {scale:.3e}")
        worst = max(worst, (err / scale, key))
    fields.update(fp32_loss_card=loss_card, fp32_loss_cpu=loss_cpu,
                  fp32_grad_max_rel_err=worst[0], fp32_grad_max_rel_err_leaf=worst[1])
    del g_card, g_cpu
    routes = {}
    params, g, loss_card, g_card = grads("cuda", torch.bfloat16, routes)
    on_card(g_card, "bf16")
    _, _, loss_cpu, g_cpu = grads("cpu", torch.bfloat16, routes)
    if moe:
        fields["router_bf16"] = check_near_ties(routes, f"{what} bf16")
    check(abs(loss_card - loss_cpu) <= LOGIT_TOL, f"{what} bf16: loss {loss_card} vs "
          f"{loss_cpu}")
    shares, rmss, caps = [], [], []
    for key in g_cpu:
        rel = (g_card[key] - g_cpu[key]).abs() / float(g_cpu[key].abs().max())
        shares.append(float((rel <= GRAD_SHARE_TOL).float().mean()))
        rmss.append(float(rel.square().mean().sqrt()))
        caps.append(float(rel.max()))
        check(shares[-1] >= 0.99 and rmss[-1] <= GRAD_SHARE_TOL / 2 and caps[-1] <= 0.5,
              f"{what} bf16: {key} share {shares[-1]:.4f}, RMS {rmss[-1]:.4f}, "
              f"cap {caps[-1]:.4f}")
    fields.update(bf16_loss_card=loss_card, bf16_loss_cpu=loss_cpu,
                  bf16_grad_min_share=min(shares), bf16_grad_max_rms=max(rmss),
                  bf16_grad_max_rel_err=max(caps))
    del g_card, g_cpu
    common = dict(arch=cfg2.name, n_layers=cfg2.n_layers, cut=train["parity_cut"],
                  tokens=[b, s], grad_tol_fp32=GRAD_TOL, grad_share_tol_bf16=GRAD_SHARE_TOL,
                  loss_tol_bf16=LOGIT_TOL, gradient_leaves=len(shares))
    if moe:
        common.update(capacity_factor=cfg2.moe.capacity_factor,
                      router_logit_tol=ROUTER_LOGIT_TOL)
    if not train["checkpoint"]:
        emit(what, **common, **fields)
        return
    params, opt_state, _ = adamw_update(opt, params, g, init_opt_state(params))
    del g
    # checkpoint from the card, restore on the CPU
    cut = tree_map(lambda t: t[tuple(slice(0, CKPT_CUT) for _ in t.shape)].contiguous(),
                   TrainState(params, opt_state))
    del params, opt_state
    ckpt = ROOT / "build" / "train_parity_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.time()
    CheckpointManager(str(ckpt)).save(1, cut)
    restored = CheckpointManager(str(ckpt)).restore_latest(
        tree_map(lambda t: torch.empty_like(t, device="cpu"), cut))
    check(restored is not None and restored[0] == 1, "train parity: no checkpoint restored")
    want = flatten_with_keys(cut)
    got = flatten_with_keys(restored[1])
    check([k for k, _ in got] == [k for k, _ in want], "train parity: checkpoint keys differ")
    check(all(r.is_cuda for k, r in want if k != ".opt/.step"),
          "train parity: a checkpointed leaf does not lie on the card")
    for (key, a), (_, r) in zip(got, want):
        check(a.device.type == "cpu" and a.dtype == r.dtype and torch.equal(a, r.cpu()),
              f"train parity: checkpoint leaf {key} differs after the round trip")
    ckpt_s = time.time() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    emit(what, **common, checkpoint_leaves=len(got),
         checkpoint_cut=CKPT_CUT, checkpoint_bytes=sum(
             t.numel() * 4 for _, t in want if isinstance(t, torch.Tensor)),
         checkpoint_seconds=ckpt_s, **fields)


# ---------------------------------------------------------------------------
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--requests", type=int, default=16, help="llama3.2-3b requests")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--build-log", metavar="PATH",
                    help="pass -Xptxas -v to nvcc and write its output to PATH")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")

    seconds = {}   # host seconds of each phase run, for the timing line

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        seconds[name] = round(time.time() - t0, 1)
        return out

    smi = timed("device", phase_device)
    ptxas = timed("build", phase_build, args.build_log)
    records = timed("kernels", phase_kernels, ptxas) if "kernels" in phases else []
    for arch, n_requests in (("llama3.2-3b", args.requests), ("mamba2-2.7b", PATH_REQUESTS),
                             ("zamba2-7b", PATH_REQUESTS), ("deepseek-moe-16b", PATH_REQUESTS),
                             ("gemma2-27b", PATH_REQUESTS), ("gemma-7b", PATH_REQUESTS)):
        path = PATHS[arch]
        if path["serve"] not in phases:
            continue
        cfg, params, counts = timed(path["serve"], phase_serve, arch, n_requests, args.max_new)
        for rec in records:
            if rec["path"] == arch:
                rec["launches"] = counts[rec["name"]]
                check(rec["launches"] > 0, f"{rec['name']} was not launched by the "
                      f"{arch} serve run")
        if path["parity"] in phases:
            timed(path["parity"], phase_parity, arch, cfg, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch, train in TRAIN_PATHS.items():
        if train["phase"] in phases:
            counts = timed(train["phase"], phase_train, arch)
            for rec in records:
                if rec["path"] == train["phase"]:
                    rec["launches"] = counts[rec["name"]]
                    check(rec["launches"] > 0, f"{rec['name']} was not launched by the "
                          f"{train['phase']} run")
        if train["parity"] in phases:
            timed(train["parity"], phase_parity_train, arch)
    emit("timing", seconds=seconds)
    complete = set(phases) == set(PHASES)
    if complete:
        check(all("launches" in rec for rec in records), "a kernel has no launch count")
        print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": complete, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    if not complete:
        raise SystemExit(4)


if __name__ == "__main__":
    main()
