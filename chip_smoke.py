#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                      # every phase, as a release check
    python3 chip_smoke.py --phases build,kernels --build-log nvcc.log

Phases, each printing one JSON line; any exception or failed check ends the
run with a non-zero exit code:

1. device   needs ``torch.cuda.is_available()``; prints the card's name and
            power limit as nvidia-smi gives them.
2. build    compiles ``src/repro_torch/csrc/*.cu`` into ``build/``; the
            library's ``cuobjdump -sass`` listing must show every bf16 flash
            kernel, the forward's and the backward's, every bf16 decode
            kernel, the serving one's and the slice's, and every walk kernel
            of the SSD backward issuing wgmma fed by TMA (HGMMA and UTMALDG)
            and no mma.sync (HMMA): the ``flash_sass`` line, read after the
            kernels phases.  The decode kernels' registers and spills (the
            ``decode_ptxas`` line): no spill in a bf16 serving one.
3. kernels  each hand-written kernel against its plain PyTorch version on the
            card, over dtypes, head sizes, ragged and mostly-zero lengths,
            lengths at the edges of a work unit, the poisoned dead region and
            one work unit against many, GQA groups 1-8 and 64, pool views at
            an odd row offset (decode, whose fp32 kernel's merge counters
            must be back at 0; two calls bit-identical at every timed decode
            shape), the pinned/streamed splits, GQA groups, softcap and
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
            at gemma2's 5120-token row, where its window binds, each shape's
            gradients bit-identical over two calls (no atomics).
            The backward is held elementwise on each gradient row's and
            64-row tile's scale (``grad_err``), which planted faults must
            fail.  The SSD backward (training) against its plain version
            ``ssd_bwd_ref`` and against autograd of ``ssd_ref`` over the
            SSD cases' fp32 shapes, with and without an initial state and a
            final-state gradient, and on strided views through
            ``SSDScanFn``, by the same rule at 1e-4 (``ssd_grad_err``),
            which planted faults must fail; timed at the training shapes of
            mamba2-2.7b and zamba2-7b, two calls bit-identical at each.  The
            decode kernel's slice variant
            (``decode_attention_lse``, ``csrc/decode_attention_lse.cu``) at
            every decode case, cut into three slices at rows off any unit
            and one past the cache: each slice's output and log-sum-exp
            against the plain version, the slices merged
            (``comm.merge_parts``) against the whole cache's plain version,
            with planted faults (an offset off by half a slice, an LSE off by
            0.7) that must fail; timed at llama3.2-3b's heads, batch 1, one
            rank's 16,384 rows of 32,768, beside its bound, its plain version
            and the library's flash call that also returns an LSE.
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
16. serve_qwen2vl   qwen2-vl-7b's text backbone at full width and depth (28
            layers, d_model 3584, 28 query and 4 KV heads of 128: GQA group 7;
            M-RoPE sections (16, 24, 24), whose text-only positions are the
            plain rotary ones; vocab 152064; bf16, seeded random weights)
            behind ``ServeEngine(max_batch=8, max_seq=2048)``: 8 requests
            drawn as in 4, 32 new tokens each; counts as in 4.
17. parity_qwen2vl  its 2-layer cut as in 5; before any launch, 3-plane
            (3, B, S) positions refused with ValueError by ``prefill`` and
            ``forward``, as the JAX package refuses them.
18. serve_mistral   mistral-nemo-12b at full width and depth (40 layers,
            d_model 5120, 32 query and 8 KV heads of 128, vocab 131072; bf16,
            24.5 GB) as in 16.
19. parity_mistral  its 2-layer cut as in 5.
20. serve_musicgen   musicgen-large's decoder at full width and depth (48
            layers, d_model 2048, MHA 32 x 64, GeGLU d_ff 8192, vocab 2048;
            bf16) as in 16.
21. parity_musicgen  its 2-layer cut as in 5, and one prefill of 2 x 48
            precomputed frame embeddings (``input_embeds``, the audio
            frontend's contract), card against CPU by the same rules.
22. serve_moonshot   moonshot-v1-16b-a3b at full width and depth (48 layers:
            one dense, 47 with 64 routed experts, top-6, and 2 shared; MHA 16
            x 128; vocab 163840; bf16, 56.8 GB) as in 16.
23. parity_moonshot  its cut to the dense layer and one MoE layer, as in 11.
24. train   llama3.2-3b trained at full width and depth (bf16, seeded random
            weights, 8 x 512 tokens a step, remat, AdamW as launch/train.py
            builds it): 6 steps, the last 2 in 2 microbatches; losses finite
            and falling, launch counts (set to 0 just before, read just
            after) exactly those of the forward, its recomputation and the
            backward of every layer and microbatch.
25. parity_train  one train step of its 2-layer cut at full width on the
            card against the CPU (fp32 gradients elementwise, bf16 by share),
            then the card's state, each leaf cut to its first 1024 rows and
            columns, checkpointed and restored on the CPU, bit-equal.
26. train_ssm   mamba2-2.7b trained at full width and depth (64 layers,
            d_model 2560, 2.83 B parameters), as in 24: the SSD forward twice
            and its backward's three kernels once a layer and microbatch,
            nothing else launched.
27. parity_train_ssm  one train step of its 2-layer cut at full width, 2 x
            256 tokens (two SSD chunks), card against CPU as in 25 (the
            CPU's fp32 scan in float64), without the checkpoint; every
            gradient leaf nonzero on the card (so in 25, 29 and 31 too).
28. train_hybrid   zamba2-7b trained at full width and a cut depth (45
            layers: 7 groups of 6 Mamba2 layers, each followed by the shared
            attention block at head_dim 112, and a tail of 3; 81 do not fit
            one card with Adam's state), as in 24 at a peak learning rate
            of 1e-4 (``TRAIN_PATHS``): the flash forward twice
            and its backward once an application of the shared block, the
            SSD forward twice and its backward once a Mamba2 layer, each a
            microbatch.
29. parity_train_hybrid  one train step of its cut to one group of 2 Mamba2
            layers, the shared block and a tail of 1, 2 x 256 tokens, card
            against CPU as in 27.
30. train_moe   deepseek-moe-16b trained at full width and a cut depth (7
            layers: the dense layer and 6 MoE layers; 28 do not fit), as in
            28, tokens dropped at the published capacity factor 1.25.
31. parity_train_moe  one train step of its cut to the dense layer and one
            MoE layer, 2 x 64 tokens, which drop at the capacity: card against
            CPU as in 25 without the checkpoint, the CPU following the card's
            expert choices, the tokens each side dropped counted and the
            router logits held as in 11.
32. train_gemma2   gemma2-27b trained at full width and a cut depth (2 layers:
            one local, window 4096, and one global; attention softcap 50,
            final softcap 30, score scale 144^-0.5; 46 do not fit), as in 28:
            the flash forward twice and its backward, with the window and the
            softcap, once a layer and microbatch.
33. parity_train_gemma2  one train step of its 2 layers with the window cut
            to 64, 2 x 128 tokens, so that the window binds: card against CPU
            as in 25 without the checkpoint.
34. train_gemma7b   gemma-7b trained at full width and a cut depth (8
            layers, head_dim 256; 28 do not fit), as in 28.
35. parity_train_gemma7b  one train step of its 2-layer cut, 2 x 128
            tokens: card against CPU as in 33.
36. train_mesh   training under a mesh: two processes share the one card,
            each joined to a gloo process group (NCCL refuses two ranks on one
            GPU; every collective goes through the host, so this shows
            correctness and per-rank memory, not multi-card speed).
            llama3.2-3b at full width and 4 layers on meshes (data, model)
            = (1, 2), (1, 2) with ACT_SEQ (the residual stream sharded on
            the sequence) and (2, 1) (ZeRO-1), deepseek-moe-16b at 3
            layers (the dense layer and 2 MoE layers) on (1, 2) (expert
            parallelism) and zamba2-7b at 7 (6 tensor-parallel Mamba2
            layers, the shared block, a tail layer) on (1, 2): 3 bf16 steps
            of 8 x 512 tokens each, the state placed by the sharding rules;
            each rank's step seconds, peak memory and launches (exactly
            those of its layers on its heads: 12 query and 4 KV heads a
            rank for llama, 8 x 8 for deepseek, 56 SSD heads and 16 x 16
            attention heads for zamba2).
37. parity_train_mesh  each layout of 36: one fp32 step on the mesh, its
            parameters gathered, against one process on the card (loss,
            gradient norm and every parameter leaf elementwise within 1e-5
            of the leaf's scale); llama also in bf16 (every gathered gradient
            leaf by the share rules of 25). The four mesh phases run in one
            start of the two processes.
38. serve_mesh   serving under a mesh of (1, 2), two processes sharing the
            card as in 36: llama3.2-3b (28 layers) and zamba2-7b (81
            layers) at published size, each rank's ``ServeEngine`` holding
            its parameter shards (drawn whole on the card one rank at a
            time, sliced) and its shard of the pooled cache; 4 requests of
            96 and 512 tokens, 8 new tokens each, greedy.  Each rank's
            tokens/s, decode_step calls, peak memory and launches (counts
            set to 0 just before and read just after: exactly those of its
            layers on its heads); the two ranks' tokens must be equal.
39. parity_serve_mesh  prefill of 2 x 64 tokens and 4 decode steps under
            the mesh against one process on the card, same weights:
            llama3.2-3b at 2 layers, zamba2-7b at 3 Mamba2 layers of
            period 2 (one application of the shared block, a tail layer),
            deepseek-moe-16b at 3 (the dense layer and 2 MoE layers,
            expert-parallel).  fp32: every call's logits and every gathered
            cache tensor within 1e-5 of their scale, the greedy tokens
            equal; bf16 by the share rule of 37 and the greedy tokens where
            the margin is clear (deepseek's one-process run following the
            mesh run's expert choices, those it would change a few
            near-ties); deepseek's router logits against the CPU's fp32
            product as in 11.
40. serve_kvseq   the sequence-sharded K/V layout, two ranks sharing the
            card as in 36: llama3.2-3b at published size, batch 1 (so
            ``kv_layout`` picks ``kvseq``), a 4,096-token prompt grown into a
            32,768-row cache (``grow_cache``), 8 greedy decode steps, on (1, 2)
            and (2, 1); each rank's tokens/s, peak memory, launches (28 flash
            launches for the prefill, the slice kernel once a layer and step)
            and collective operand bytes a call (``comm.collective_bytes``);
            the ranks' tokens equal.
41. parity_serve_kvseq  as 39 at a batch of 1 x 64 (``kvseq``): llama3.2-3b
            (2 layers) on (1, 2) and (2, 1), gemma2-27b (2 layers, window cut
            to 32 so that it binds across a slice boundary) on (1, 2),
            zamba2-7b (3 Mamba2 layers, period 2) on (2, 1); the four mesh
            phases and these two run in one start of the two children.
42. dryrun   ``launch/dryrun.py`` on the host: every (arch x shape x mesh)
            cell of the production meshes, its K/V layout, a rank's argument
            bytes and its roofline terms with the H100's constants (64 cells
            ok, 16 skipped).
43. simulator   the DCO cache-simulator stack, on the host (numpy, no
            kernel): all 56 cells of the conformance matrix (14 suite
            scenarios x 4 policies; the step engine, the compiled engine and
            the compiled engine fed in segments agree event for event) against
            the frozen digests of ``tests/golden/conformance_digests.json``,
            where one digest that differs fails the run; one serving replay
            of 5,000 requests (the replay benchmark's budget check) under
            ``lru`` and ``all`` with its SLO metrics; and the analytical model
            fitted to the suite's 70 simulated points and asked to predict
            them (R^2 and Kendall's tau at least the reference test's 0.80
            and 0.65).  It needs no card, so it runs in a process of its
            own from the end of the build, beside the card's phases; its
            lines are printed here, and the timing line's entry is the wait
            for it.
44. kernels_positions   the flash kernel's position variant
            (``csrc/flash_attention_pos.cu``) against its plain version
            over head sizes 64, 112, 128 and 256, both types, a window and a
            softcap, and three tables: shifted rows and packed non-monotone
            positions for queries and keys (``forward``'s mode), negative
            positions and positions past S for queries against keys at their
            row index (``keys_at_rows``, ``prefill``'s mode: rows that see no
            key get the mean of every value row); bf16 bit-identical across
            ``pinned_rows`` and ``tiles_per_chunk``; a table off by one row
            must fail.  The backward with a table (its ``_ext_`` kernels)
            against ``attention_bwd_ref`` by ``grad_err``, a table off by one
            row failing.  The serving flash kernels' registers and spills
            against SERVING_FLASH_PTXAS (a build without a ptxas report
            fails).  Timed, each beside its plain version and the library
            with the table's mask: the variant at qwen2-vl-7b's 1024 tokens
            with shifted positions in both modes, the backward at
            llama3.2-3b's training shape with a table.
45. serve_positions   qwen2-vl-7b at published size (after
            serve_qwen2vl, its weights): a 1024-token ``prefill`` and
            ``forward`` with shifted positions, 28 position-variant launches
            each and nothing else, and the training loss of that ``forward``
            under autograd (56 forward and 84 backward launches); logits
            finite.
46. parity_positions   2-layer cuts at full width of llama3.2-3b,
            qwen2-vl-7b, gemma2-27b (window 64, which binds), deepseek-moe-16b
            and zamba2-7b: ``prefill`` and ``forward`` with position tables,
            the card's kernels against the card's plain versions (fp32
            elementwise, bf16 by share).
47. examples   ``examples/quickstart_torch.py`` on the card, in a child
            process, to its ``done.``.

The kernels phase holds the attention kernels at head_dim 64, 112, 128 and
256, with and without a sliding window (both) and a softcap (decode too), and
the SSD scan at d_state 16 to 128, and times each kernel at the shapes of
every path that runs it (llama3.2-3b, zamba2-7b, deepseek-moe-16b, gemma2-27b,
gemma-7b, qwen2-vl-7b, mistral-nemo-12b and musicgen-large for attention,
moonshot-v1-16b-a3b sharing deepseek-moe-16b's heads; mamba2-2.7b and
zamba2-7b for the SSD scan);
each record of the ``kernels`` line names its path and carries the launches
of that path's serve phase (the backwards': of their train phases).  The
whole run takes under 1100 seconds of command time on an H100, the build's
30 to 50 seconds included; the ``timing`` line gives each phase's host
seconds.

fp32 products run in full fp32 on the card: TF32 is switched off for
matmuls and cuDNN.  The last lines are the ``timing`` line, the
``{"kernels": [...]}`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
from contextlib import ExitStack
from contextlib import contextmanager
from contextlib import nullcontext
from dataclasses import replace
import gc
import json
import os
from pathlib import Path
import re
import shutil
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
               "gemma-7b": (16, 16, 256), "qwen2-vl-7b": (28, 4, 128),
               "mistral-nemo-12b": (32, 8, 128), "musicgen-large": (32, 32, 64)}
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
PHASES = ("device", "build", "kernels", "kernels_positions", "serve", "parity", "serve_ssm",
          "parity_ssm", "serve_hybrid", "parity_hybrid", "serve_moe", "parity_moe",
          "serve_gemma2", "parity_gemma2", "serve_gemma7b", "parity_gemma7b", "serve_qwen2vl",
          "parity_qwen2vl", "serve_positions", "serve_mistral", "parity_mistral",
          "serve_musicgen", "parity_musicgen", "serve_moonshot", "parity_moonshot",
          "parity_positions", "train", "parity_train",
          "train_ssm", "parity_train_ssm", "train_hybrid", "parity_train_hybrid", "train_moe",
          "parity_train_moe", "train_gemma2", "parity_train_gemma2", "train_gemma7b",
          "parity_train_gemma7b", "train_mesh", "parity_train_mesh", "serve_mesh",
          "parity_serve_mesh", "serve_kvseq", "parity_serve_kvseq", "dryrun", "simulator",
          "examples")
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
    """Registers and spill bytes of each kernel, from ``nvcc -Xptxas -v``; a
    name that an earlier source already gave (the decode body compiled again
    as the slice kernel) is prefixed with its source's."""
    usage, name, source = {}, None, ""
    for line in log.splitlines():
        m = re.match(r"== (\S+)", line)
        if m:
            source = m.group(1)
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            if name in usage:
                name = f"{source}:{name}"
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


# the bf16 flash forward kernels (serving, LSE, position variant): each is
# built from wgmma fed by TMA, at every head size the kernel takes
FLASH_WGMMA_KERNELS = tuple(
    f"{name}<Li{d}{tail}>" for d in (64, 112, 128, 256)
    for name, tail in (("flash_mma_kernel", ""), ("flash_mma_lse_kernel", ""),
                       ("flash_mma_pos_kernel", "ELb0"), ("flash_mma_pos_kernel", "ELb1")))
# the bf16 flash backward kernels (dK/dV and dQ; without and with a window or
# softcap, and the position variant's), likewise
FLASH_BWD_WGMMA_KERNELS = tuple(
    f"{name}<Li{d}>" for d in (64, 112, 128, 256)
    for name in ("dkdv_wgmma_kernel", "dkdv_wgmma_ext_kernel", "dkdv_wgmma_pos_kernel",
                 "dq_wgmma_kernel", "dq_wgmma_ext_kernel", "dq_wgmma_pos_kernel"))


# the bf16 decode kernels, the serving one's and (slice:) the slice kernel's,
# with and without a softcap: wgmma fed by TMA at every head size
DECODE_WGMMA_KERNELS = tuple(
    f"{unit}decode_wgmma_kernel<Li{d}ELb{cap}>" for unit in ("", "slice:")
    for d in (64, 112, 128, 256) for cap in (0, 1))


# the SSD backward's walk kernels (training): each product is wgmma (TF32),
# x and dy arrive by TMA; at every (P, N) the backward takes
SSD_BWD_WGMMA_KERNELS = tuple(
    f"{walk}_walk_kernel<Li{p}ELi{n}>" for p in (32, 64) for n in (16, 32, 64, 128)
    for walk in ("c", "b", "x"))


def cuobjdump():
    """The CUDA toolkit's ``cuobjdump``, or the copy Triton ships; None where
    neither is found."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "cuobjdump").exists():
            return str(Path(home) / "bin" / "cuobjdump")
    try:
        import triton
    except ImportError:
        return None
    tool = Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
    return str(tool) if tool.exists() else None


def sass_counts(dump, names):
    """For each kernel of ``names`` in a ``cuobjdump -sass`` listing, how
    many HGMMA (wgmma), UTMALDG (TMA loads) and HMMA (mma.sync) instructions
    its code holds."""
    counts = {}
    for chunk in dump.split("Function : ")[1:]:
        mangled = chunk.split("\n", 1)[0].strip()
        name = kernel_name(mangled)
        if "decode_attention_lse_cu" in mangled:   # the slice kernel's unit
            name = f"slice:{name}"
        if name in names:
            counts[name] = {op: len(re.findall(rf"\b{op}\b", chunk))
                            for op in ("HGMMA", "UTMALDG", "HMMA")}
    return counts


def sass_faults(counts, names):
    """What keeps a listing's kernels from being the Hopper design: a kernel
    missing from it, or one without HGMMA or UTMALDG, or with HMMA."""
    faults = [f"{n}: not in the library" for n in names if n not in counts]
    for name, c in counts.items():
        if not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
            faults.append(f"{name}: {c}")
    return faults


def start_flash_sass(library):
    """``cuobjdump -sass`` of the built library, in a process of its own
    beside the card's phases (about 30 s on the host), into a file beside
    the library.  Fails at once where no cuobjdump is found."""
    tool = cuobjdump()
    check(tool is not None, "no cuobjdump (toolkit or Triton's copy): the flash kernels' "
          "instructions cannot be checked")
    path = Path(library).with_suffix(".sass")
    with open(path, "w") as out:
        proc = subprocess.Popen([tool, "-sass", str(library)], stdout=out,
                                stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def finish_flash_sass(started):
    """``start_flash_sass``'s listing: every bf16 flash kernel, forward
    (FLASH_WGMMA_KERNELS) and backward (FLASH_BWD_WGMMA_KERNELS), every bf16
    decode kernel (DECODE_WGMMA_KERNELS) and every walk kernel of the SSD
    backward (SSD_BWD_WGMMA_KERNELS) issues wgmma fed by TMA (HGMMA and
    UTMALDG) and no mma.sync (HMMA)."""
    proc, path = started
    _, err = proc.communicate()
    check(proc.returncode == 0, f"cuobjdump failed (exit {proc.returncode}): {err[-2000:]}")
    dump = path.read_text()
    out = {}
    for what, names in (("forward", FLASH_WGMMA_KERNELS), ("backward", FLASH_BWD_WGMMA_KERNELS),
                        ("decode", DECODE_WGMMA_KERNELS),
                        ("ssd_backward", SSD_BWD_WGMMA_KERNELS)):
        counts = sass_counts(dump, names)
        faults = sass_faults(counts, names)
        check(not faults, f"the {what} kernels (bf16 flash and decode; the SSD backward's "
              "walks) are not wgmma fed by TMA: " + "; ".join(faults))
        out[what] = dict(kernels=len(counts), **{op: sum(c[op] for c in counts.values())
                                                 for op in ("HGMMA", "UTMALDG", "HMMA")})
    emit("flash_sass", **out)
    return out


def phase_build(build_log):
    from repro_torch.kernels import build
    from repro_torch.kernels import kernels_built
    t0 = time.time()
    # -Xptxas -v always: the serving kernels' registers are checked
    # (check_serving_registers); a library loaded from the build directory
    # gives the report kept beside it, and one without a report is built again
    build.build(verbose=True)
    build.load()
    check(kernels_built(), "kernel library did not load")
    extra = {}
    log = str(build.build_info.get("log", ""))
    if build_log:
        Path(build_log).parent.mkdir(parents=True, exist_ok=True)
        Path(build_log).write_text(log)
    if log:
        extra["ptxas"] = ptxas_usage(log)
    emit("build", seconds=round(time.time() - t0, 2),
         sources=[p.name for p in build.sources()],
         library=Path(str(build.build_info["path"])).name, **extra)
    return extra.get("ptxas"), start_flash_sass(build.build_info["path"])


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
        (8, 2048, 28, 4, 128, bf, [0, 0, 801, 0, 0, 0, 0, 0]),   # group 7's serving call
        (2, 700, 128, 2, 128, bf, [700, 129]),   # group 64: the whole packed tile
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
    # a strided view of a larger pool (a layer of the engine's stacked pool),
    # one work unit against many; also from an odd row of it, group 7
    pool_k = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    pool_v = randn(gen, (2, 4, 700, 2, 128), torch.bfloat16)
    step = decode_ops.STEP_ROWS
    for heads, first in ((6, 0), (14, 3)):
        q = randn(gen, (4, heads, 128), torch.bfloat16)
        kv = pool_k[1][:, first:], pool_v[1][:, first:]
        cl = torch.tensor([700 - first, 0, 123, 17], dtype=torch.int32, device="cuda")
        ref = decode_attention_ref(q, *kv, cl)
        for rows in (None, -(-700 // step) * step, step, 3 * step):
            out = decode_attention(q, *kv, cl, rows_per_split=rows)
            close(out, ref, TOL[torch.bfloat16],
                  f"decode pool view from row {first}, group {heads // 2}, {rows} rows a unit")
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


def lse_cuts(s):
    """Three slices of a cache of ``s`` rows, cut at rows that are not
    multiples of a step or a unit, and one beyond it (rows past every
    length: no live row, as on a rank whose slice starts beyond them)."""
    a, b = s * 3 // 8 + 5, s * 3 // 4 + 3
    return [(0, a), (a, b), (b, s), (s, s + 64)]


def lse_slices(q, k, v, cl, fn, cuts, **kw):
    """``fn`` (the kernel's wrapper or its plain version) on each slice of
    ``cuts``; the rows past the cache are drawn anew (``lse_cuts``)."""
    out = []
    for lo, hi in cuts:
        if hi <= k.shape[1]:
            ks, vs = k[:, lo:hi], v[:, lo:hi]
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(hi)
            ks = randn(gen, (k.shape[0], hi - lo) + tuple(k.shape[2:]), k.dtype)
            vs = randn(gen, ks.shape, k.dtype)
        out.append(fn(q, ks, vs, cl, row_offset=lo, **kw))
    return out


def merged(parts, dtype):
    from repro_torch.sharding.comm import merge_parts
    return merge_parts(torch.stack([o for o, _ in parts]),
                       torch.stack([lse for _, lse in parts])).to(dtype)


def close_lse(got, want, tol, what):
    """The log-sum-exp: -inf exactly where the plain version's is, and
    within tol + tol * |want| elsewhere."""
    dead = torch.isneginf(want)
    check(torch.equal(torch.isneginf(got), dead), f"{what}: -inf where a row has no live key")
    return close(got[~dead], want[~dead], tol, what) if bool((~dead).any()) else 0.0


def check_decode_lse(gen):
    """The slice kernel (``decode_attention_lse``) at every case of
    ``check_decode``: each slice of ``lse_cuts`` (row offsets, a window cut
    by a slice where the case has one, a slice with no live row) against
    the plain version, output and log-sum-exp, with R chosen and fixed; the
    slices merged (``comm.merge_parts``) against the whole cache's plain
    version; and planted faults (a slice's offset or log-sum-exp shifted)
    that the merge check must fail."""
    from repro_torch.kernels import decode_attention_lse
    from repro_torch.kernels import decode_attention_lse_ref
    from repro_torch.kernels import decode_attention_ref
    worst = {}
    planted = 0
    for i, case in enumerate(decode_cases()):
        b, s, h, g, d, dtype, lens, window, softcap = (case + (None, None))[:9]
        kw = dict(window=window, softcap=softcap)
        q = randn(gen, (b, h, d), dtype)
        k = randn(gen, (b, s, g, d), dtype)
        v = randn(gen, (b, s, g, d), dtype)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        cuts = lse_cuts(s)
        refs = lse_slices(q, k, v, cl, decode_attention_lse_ref, cuts, **kw)
        whole = decode_attention_ref(q, k, v, cl, **kw)
        what = f"decode_lse {(b, s, h, g, d, dtype, lens)} window {window} softcap {softcap}"
        for rows in (None, UNIT_ROWS):
            parts = lse_slices(q, k, v, cl, decode_attention_lse, cuts, rows_per_split=rows,
                               **kw)
            torch.cuda.synchronize()
            err = 0.0
            for (lo, hi), (o, lse), (ro, rl) in zip(cuts, parts, refs):
                err = max(err, close(o, ro, TOL[dtype], f"{what} slice {lo}:{hi} output"),
                          close_lse(lse, rl, TOL[dtype], f"{what} slice {lo}:{hi} lse"))
            check(bool(torch.isneginf(parts[-1][1]).all()) and not parts[-1][0].any(),
                  f"{what}: the slice past every length must give -inf and zeros")
            err = max(err, close(merged(parts, dtype), whole, TOL[dtype], f"{what} merged"))
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
        if i == 0 or (window is not None and window > 32 and s <= 1024 and planted < 3):
            # planted faults: the merge of a slice read half its length off
            # its offset, or of a log-sum-exp off by 0.7, must fail the check
            # (short caches and windows of more than 32 rows: a window of one
            # row leaves one slice live a row, whose weight the merge divides
            # out, and in a window of 4096 rows a few rows move the output
            # less than the bf16 tolerance)
            lo, hi = cuts[1]
            shifted = list(parts)
            shifted[1] = decode_attention_lse(q, k[:, lo:hi], v[:, lo:hi], cl,
                                              row_offset=lo + (hi - lo) // 2, **kw)
            bumped = list(parts)
            bumped[1] = (parts[1][0], parts[1][1] + 0.7)
            for bad, name in ((shifted, "offset"), (bumped, "lse")):
                try:
                    close(merged(bad, dtype), whole, TOL[dtype], f"{what} planted {name}")
                except AssertionError:
                    continue
                raise AssertionError(f"{what}: a planted {name} fault passed the merge check")
            planted += 1
    check(planted >= 3, "decode_lse: too few planted faults")
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
        (2, 100, 1000, 16, 4, 128, False, None, 256, bf, 2),
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
        (1, 300, 300, 8, 2, 112, True, 50.0, 256, bf, 2),
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
    """head_dim 256 (gemma-7b: MHA, 16 heads; one consumer warpgroup a bf16
    block, whose Q and the ring leave one 64-row tile of K and V to pin; none
    in fp32): causal prompts pinned 0, 64 and whole where that fits (fp32 at
    most 8 rows), GQA groups 3, 4 and 8, non-causal, a softcap and windows,
    several Q tiles a chunk."""
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
        check(len(pins) >= 4, f"bf16 equivalence at S {s}: pins {sorted(pins)}")
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
    # softcap too, GQA groups 1 and 4
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
    out = decode_attention(q, k, v, cl, **kw)
    err = close(out, ref, TOL[bf], f"decode at {lens}, window {window}, softcap {softcap}")
    check(torch.equal(out, decode_attention(q, k, v, cl, **kw)),
          f"decode at {lens}: two calls differ")
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
        "max_abs_err": err, "tol": TOL[bf], "bit_identical": True,
        "ms": time_ms(lambda: decode_attention(q, k, v, cl, **kw), flush),
        "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, cl, **kw), flush),
        "library_ms": lib_ms if softcap is None else None,
        **({} if softcap is None else {"library_ms_no_softcap": lib_ms}),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


# the slice kernel's timed call: llama3.2-3b's heads, batch 1, one rank's
# 16,384 rows of a 32,768-row cache (the second half: every row live)
LSE_TIMED = dict(h=24, g=8, d=128, rows=16384, whole=32768)


def decode_lse_record(gen, flush):
    """The slice kernel's record at ``LSE_TIMED``: its time beside the plain
    version's, the bound (every row of the slice read once, q read, the fp32
    output and log-sum-exp written) and one library call that also returns
    a log-sum-exp: ``aten._scaled_dot_product_flash_attention`` with each
    KV head's query heads as its rows (the GQA group as a query sequence),
    a yardstick only: the port never calls it."""
    from repro_torch.kernels import decode_attention_lse
    from repro_torch.kernels import decode_attention_lse_ref
    bf = torch.bfloat16
    h, g, d, rows, whole = (LSE_TIMED[k] for k in ("h", "g", "d", "rows", "whole"))
    q = randn(gen, (1, h, d), bf)
    k = randn(gen, (1, rows, g, d), bf)
    v = randn(gen, (1, rows, g, d), bf)
    cl = torch.tensor([whole], dtype=torch.int32, device="cuda")
    off = whole - rows
    scale = d ** -0.5

    def kernel():
        return decode_attention_lse(q, k, v, cl, row_offset=off)

    def plain():
        return decode_attention_lse_ref(q, k, v, cl, row_offset=off)

    qg, kt, vt = q.view(1, g, h // g, d), k.transpose(1, 2), v.transpose(1, 2)

    def lib():
        out = torch.ops.aten._scaled_dot_product_flash_attention(qg, kt, vt, scale=scale)
        return out[0], out[1]

    (o, lse), (ro, rl) = kernel(), plain()
    err = max(close(o, ro, TOL[bf], "decode_lse at the timed shape"),
              close_lse(lse, rl, TOL[bf], "decode_lse lse at the timed shape"))
    o2, lse2 = kernel()
    check(torch.equal(o, o2) and torch.equal(lse, lse2), "decode_lse: two calls differ")
    lo, ll = lib()
    close(lo.reshape(1, h, d), ro, TOL[bf], "library decode with lse vs plain")
    close(ll.reshape(1, h), rl, TOL[bf], "library log-sum-exp vs plain")
    n_bytes = 2 * g * d * 2 * rows + q.numel() * 2 + o.numel() * 4 + lse.numel() * 4 + 4
    n_flops = 4 * h * d * rows
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    return {
        "name": "decode_attention_lse", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_lse.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:28",
        "shape": {"B": 1, "S": rows, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "row_offset": off, "cache_len": [whole], "live_rows": rows},
        "max_abs_err": err, "tol": TOL[bf], "bit_identical": True,
        "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
        "library_ms": time_ms(lib, flush), "library": "aten._scaled_dot_product_flash_attention",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "path": "serve_kvseq",
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


BWD_TILE = 64   # rows of the backward kernel's Q and KV tiles (a bf16 consumer's KV rows)
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
              tiles_per_chunk=None, positions=None):
    """(O, LSE) of one causal forward launch through the entry that
    ``FlashAttentionFn`` calls (the public wrapper returns O only); with
    ``positions``, the position variant with the keys at the queries'
    positions, as ``FlashAttentionFn`` passes them."""
    from repro_torch.kernels.flash_attention import ops
    b, s, h, d = q.shape
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = ops._forward(q, k, v, lse, causal=True, scale=scale or d ** -0.5,
                       softcap=softcap, window=window, pinned_rows=pinned_rows,
                       tiles_per_chunk=tiles_per_chunk, positions=positions)
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
    column) pair of each query head; two calls on the same inputs must give
    bit-identical gradients.  Also the forward's time with and
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
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash bwd at the training shape {key}: two calls on the same inputs differ")
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    # (worst ratio, max abs err, the row scale where it is) of dq, dk, dv
    held = {n: close_grad(a, r, TOL[bf], f"flash bwd at the training shape {key}, {n}")
            for n, a, r in zip(("dq", "dk", "dv"), got, want)}
    del got, again, want
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
                               f"dkdv_wgmma{ext}_kernel<Li{d}>",
                               f"dq_wgmma{ext}_kernel<Li{d}>")),
        "bit_identical_over_two_calls": True,
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


def ssd_bwd_counts(b, s, h, g, p, n):
    """(FLOP, bytes) of the SSD gradient at (B, S, H, G, P, N) as
    ``ssd_bwd_record`` counts them for its bound."""
    q = SSD_COUNT_Q
    n_flops = b * h * (-(-s // q)) * (q * q * (2 * p + 3 * n) + 10 * q * p * n)
    n_bytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 2 * h + 4 * b * s * g * n)
    return n_flops, n_bytes


def ssd_bwd_record(gen, flush, path, ptxas=None):
    """The backward kernel's record at the training shape of the train phase
    ``path`` (one microbatch, ``SSD_BWD_SHAPES``, fp32 as ``mamba2_block``
    passes it), with its kernels' registers where ``ptxas`` is given:
    its time (the ``BWD_KERNELS`` launches of one call) beside the plain
    version's, ``torch.autograd.grad`` through ``ssd_ref``; no library call
    computes an SSD gradient.  Two calls on the same inputs must give
    bit-identical gradients (no atomics).  The bound: the larger of the
    bytes moved once (x, dt, A,
    B, C and dy read; dx, ddt, dA, dB and dC written) over the card's memory
    rate and the operations over 3xTF32's rate, counted by ``SSD_COUNT_Q``'s
    convention extended to the products the gradient needs (not the
    kernel's, whose two consumers of a walk each form its 64 x 64 scores and
    whose three walks each carry a state): per (batch, head,
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
    again = ssd_scan_bwd(x, dt, A, B, C, dy)
    torch.cuda.synchronize()
    identical = all(torch.equal(a, c) for a, c in zip(got[:5], again[:5]))
    check(identical, f"ssd bwd at {path}'s training shape: two calls differ")
    want = ssd_bwd_ref(x, dt, A, B, C, dy)[:5] + (None,)
    held = check_ssd_grads(got, want, SSD_TOL[f32], "ssd bwd at the training shape")
    del got, again, want
    leaves = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    y_ref, _ = ssd_ref(*leaves, chunk)

    def plain_bwd():
        return torch.autograd.grad(y_ref, leaves, dy, retain_graph=True)

    q = SSD_COUNT_Q
    n_flops, n_bytes = ssd_bwd_counts(b, s, h, g, p, n)
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
        **kernel_usage(ptxas, (f"prep_kernel<Li{n}>", f"c_walk_kernel<Li{p}ELi{n}>",
                               f"b_walk_kernel<Li{p}ELi{n}>", f"x_walk_kernel<Li{p}ELi{n}>",
                               "scan_kernel", "head_sum_kernel")),
        "bit_identical_over_two_calls": identical,
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


# ---------------------------------------------------------------------------
# explicit positions: the flash kernel's position variant (forward and backward)
POS_PATTERNS = ("shifted", "packed", "negative")
POS_SHIFT = 5   # the shifted pattern's offset (serve_positions and the records too)
# the serving flash kernels' registers and spill bytes as csrc/flash_attention.cu
# alone compiles them (nvcc 12.8 -Xptxas -v for sm_90a, the flags of
# kernels/build.py; the TMA/wgmma body of the bf16 kernels, read from the
# report of the flash sources built by themselves, the position variant's
# translation unit beside them).  168 is the launch bound of a block of three
# warpgroups: setmaxnreg gives the two consumers 232 each at run time; at D
# 256 a block has one consumer and ptxas allots what it needs.  The variant
# lives in a translation unit of its own and must leave them unchanged
SERVING_FLASH_PTXAS = {
    f"{name}<{args}>": dict(spill_stores=stores, spill_loads=loads, registers=regs)
    for name, args, regs, stores, loads in (
        ("flash_kernel", "fLi64", 128, 0, 0), ("flash_kernel", "fLi112", 128, 8, 12),
        ("flash_kernel", "fLi128", 128, 0, 0), ("flash_kernel", "fLi256", 128, 4, 4),
        ("flash_mma_kernel", "Li64", 168, 0, 0), ("flash_mma_kernel", "Li112", 168, 0, 0),
        ("flash_mma_kernel", "Li128", 168, 0, 0), ("flash_mma_kernel", "Li256", 254, 0, 0),
        ("flash_mma_lse_kernel", "Li64", 168, 0, 0),
        ("flash_mma_lse_kernel", "Li112", 168, 0, 0),
        ("flash_mma_lse_kernel", "Li128", 168, 0, 0),
        ("flash_mma_lse_kernel", "Li256", 254, 0, 0))}


def position_tables(pattern, b, s, dev="cuda"):
    """(positions, keys_at_rows): an int32 (B, S) table of a pattern and
    where the keys sit.  ``shifted`` (keys at the queries' positions, as
    ``forward`` passes them): even rows at their index plus POS_SHIFT, odd
    rows at their index.  ``packed`` (as ``forward``): even rows three packed
    sequences whose positions restart at 0, odd rows a permutation.
    ``negative`` (keys at their row index, as ``prefill`` passes it): even
    rows starting at -7, whose first 7 rows see no key, odd rows at twice
    their index, past S."""
    rng = np.random.default_rng(11)
    rows = []
    for i in range(b):
        r = np.arange(s)
        if pattern == "shifted":
            rows.append(r + POS_SHIFT if i % 2 == 0 else r)
        elif pattern == "packed":
            cut = [s // 3, s // 3, s - 2 * (s // 3)]
            rows.append(np.concatenate([np.arange(n) for n in cut]) if i % 2 == 0
                        else rng.permutation(s))
        else:
            rows.append(r - 7 if i % 2 == 0 else 2 * r)
    t = torch.tensor(np.stack(rows), dtype=torch.int32, device=dev)
    return t, pattern == "negative"


def visible_by_tables(qp, keys_at_rows, sk, window=None):
    """(B, Sq, Sk) bool: the (query, key) pairs the table leaves visible,
    keys at the queries' positions or (``keys_at_rows``) at their row
    index."""
    kpos = torch.arange(sk, device=qp.device).expand(qp.shape[0], sk) if keys_at_rows else qp
    seen = kpos[:, None, :] <= qp[:, :, None]
    if window:
        seen &= kpos[:, None, :] > qp[:, :, None] - window
    return seen


def fails(fn):
    """Whether ``fn()`` fails a check (raises AssertionError)."""
    try:
        fn()
    except AssertionError:
        return True
    return False


def flash_pos_cases():
    """(B, Sq, Sk, H, G, D, dtype, window, softcap, pinned, pattern): each
    head size at a path's heads (musicgen-large's D 64 at group 4, zamba2-7b's
    112 MHA, qwen2-vl-7b's 128 at group 7, gemma-7b's 256 at group 2), both
    types, the three patterns, a window with a softcap and a window alone;
    prefill-mode queries against a longer cache."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for d, h, g in ((64, 16, 4), (112, 8, 8), (128, 28, 4), (256, 8, 4)):
        for dtype in (bf, f32):
            pin = 64 if dtype == bf or d <= 128 else 0
            for pattern in POS_PATTERNS:
                cases.append((2, 300, 300, h, g, d, dtype, None, None, pin, pattern))
            cases.append((2, 300, 300, h, g, d, dtype, 63, 50.0, 0, "shifted"))
            cases.append((2, 300, 300, h, g, d, dtype, 100, None, 0, "negative"))
    cases += [(2, 200, 333, 28, 4, 128, bf, None, None, 64, "negative"),
              (2, 200, 333, 8, 8, 112, f32, 65, 50.0, 0, "negative"),
              (1, 1024, 1024, 28, 4, 128, bf, None, None, 256, "shifted")]
    return cases


def check_flash_positions(gen):
    """The position variant against its plain version over ``flash_pos_cases``
    (TOL of the type); bf16 bit-identical across ``pinned_rows`` and
    ``tiles_per_chunk`` with a table, in both modes; a table off by one row
    (rolled) must fail the same check.  Returns the worst error of each
    type and the smallest error of the planted faults."""
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    worst, planted = {}, []
    for case in flash_pos_cases():
        b, sq, sk, h, g, d, dtype, window, softcap, pin, pattern = case
        kw = dict(window=window, softcap=softcap, scale=GEMMA2_SCALE if window else None)
        q = randn(gen, (b, sq, h, d), dtype)
        k = randn(gen, (b, sk, g, d), dtype)
        v = randn(gen, (b, sk, g, d), dtype)
        qp, at_rows = position_tables(pattern, b, sq)
        out = flash_attention(q, k, v, pinned_rows=pin, positions=qp, keys_at_rows=at_rows,
                              **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, q_positions=qp, kv_positions=None if at_rows else qp, **kw)
        err = close(out, ref, TOL[dtype], f"flash with positions {case}")
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
        if d == 128 and pattern in ("shifted", "negative") and window is None and sq == sk:
            bad = torch.roll(qp, 1, dims=1)
            off = flash_attention(q, k, v, pinned_rows=pin, positions=bad, keys_at_rows=at_rows,
                                  **kw)
            check(fails(lambda: close(off, ref, TOL[dtype], "planted")),
                  f"flash with positions {case}: a table off by one row passes")
            planted.append(float((off.float() - ref.float()).abs().max()))
    for d, h, g in ((128, 8, 2), (64, 16, 4), (256, 8, 4)):
        q = randn(gen, (2, 300, h, d), torch.bfloat16)
        k = randn(gen, (2, 300, g, d), torch.bfloat16)
        v = randn(gen, (2, 300, g, d), torch.bfloat16)
        pins = (0, 64) if d == 256 else (0, 64, 256)
        for pattern in ("shifted", "negative"):
            qp, at_rows = position_tables(pattern, 2, 300)
            base = flash_attention(q, k, v, pinned_rows=0, tiles_per_chunk=1, positions=qp,
                                   keys_at_rows=at_rows)
            for pin in pins:
                for tiles in (None, 1, 2, 3):
                    other = flash_attention(q, k, v, pinned_rows=pin, tiles_per_chunk=tiles,
                                            positions=qp, keys_at_rows=at_rows)
                    check(torch.equal(other, base), f"flash bf16 with {pattern} positions, "
                          f"D {d}: pinned {pin}, tiles {tiles} differs from pinned 0")
    return dict(max_abs_err=worst, planted_min_abs_err=min(planted))


def check_flash_positions_bwd(gen):
    """The backward kernel with a positions table (the ``_ext_`` kernels)
    against ``attention_bwd_ref`` with the same table, on the forward
    kernel's own O and LSE, each gradient by ``grad_err`` at TOL of the
    type, over both types, head sizes 64, 112, 128 and 256, the shifted and
    packed tables, a window and a softcap; the gradients of a table off by
    one row (rolled) must fail it.  Returns the worst ratio and error of each
    type and the smallest ratio of the planted faults."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import flash_attention_bwd
    worst, planted = {}, []
    for d, h, g in ((64, 8, 2), (112, 8, 8), (128, 24, 8), (256, 8, 4)):
        for dtype in (torch.bfloat16, torch.float32):
            for pattern, kw in (("shifted", {}), ("packed", {}),
                                ("shifted", dict(window=63, softcap=50.0,
                                                 scale=GEMMA2_SCALE))):
                b, s = 2, 300
                q = randn(gen, (b, s, h, d), dtype)
                k = randn(gen, (b, s, g, d), dtype)
                v = randn(gen, (b, s, g, d), dtype)
                do = randn(gen, (b, s, h, d), dtype)
                pos = position_tables(pattern, b, s)[0]
                o, lse = flash_lse(q, k, v, positions=pos, **kw)
                got = flash_attention_bwd(q, k, v, o, lse, do, positions=pos, **kw)
                torch.cuda.synchronize()
                want = attention_bwd_ref(q, k, v, o, lse, do, q_positions=pos,
                                         kv_positions=pos, **kw)
                w = worst.setdefault(str(dtype), {"ratio": 0.0, "max_abs_err": 0.0})
                what = f"flash bwd with {pattern} positions D {d} {dtype} {kw}"
                for name, a, r in zip(("dq", "dk", "dv"), got, want):
                    ratio, err, _ = close_grad(a, r, TOL[dtype], f"{what} {name}")
                    w["ratio"], w["max_abs_err"] = max(w["ratio"], ratio), max(w["max_abs_err"],
                                                                               err)
                if pattern == "shifted" and not kw:
                    bad = flash_attention_bwd(q, k, v, o, lse, do,
                                              positions=torch.roll(pos, 1, dims=1))
                    ratios = [grad_err(a, r, TOL[dtype])[1] for a, r in zip(bad, want)]
                    check(max(ratios) > 1, f"{what}: a table off by one row passes")
                    planted.append(max(ratios))
    return dict(worst=worst, planted_min_ratio=min(planted))


def check_decode_registers(ptxas):
    """The decode kernels' registers and spills (every kernel of both
    decode units, fp32's FMA ones too): no spill in a bf16 serving kernel
    (``decode_wgmma_kernel``).  Fails where the build gave no report."""
    check(bool(ptxas), "no ptxas report of the build: the decode kernels' registers "
          "cannot be checked")
    decode = {n: v for n, v in sorted(ptxas.items()) if "decode_" in n}
    serving = {n: v for n, v in decode.items() if n.startswith("decode_wgmma_kernel<")}
    check(len(serving) == len(DECODE_WGMMA_KERNELS) // 2,
          f"bf16 serving decode kernels missing from the report: {sorted(serving)}")
    spilled = {n: v for n, v in serving.items() if v.get("spill_stores") or v.get("spill_loads")}
    check(not spilled, f"a bf16 serving decode kernel spills: {spilled}")
    emit("decode_ptxas", kernels=decode)
    return decode


def check_serving_registers(ptxas):
    """The serving flash kernels' registers and spills against
    SERVING_FLASH_PTXAS; fails where the build gave no ptxas report."""
    check(bool(ptxas), "no ptxas report of the build: the serving flash kernels' registers "
          "cannot be checked")
    names = [n for n in ptxas if n.startswith(("flash_kernel<", "flash_mma_kernel<",
                                               "flash_mma_lse_kernel<"))]
    now = {n: ptxas[n] for n in sorted(names)}
    check(now == SERVING_FLASH_PTXAS, f"the serving flash kernels' registers moved: {now} "
          f"against {SERVING_FLASH_PTXAS}")
    return now


def flash_pos_record(gen, flush, ptxas=None):
    """The position variant's record at qwen2-vl-7b's 1024-token prefill
    (B 1, H 28, G 4, D 128, bf16, ``pinned_rows`` as the planner splits it)
    with its queries shifted by POS_SHIFT against the cache's keys at their
    row index (``prefill`` with explicit positions): its time beside the
    plain version's and the library's (``scaled_dot_product_attention`` with
    the boolean mask the table makes), and the bound, whose operations count
    the (row, column) pairs the table leaves visible.  The same four for the
    keys at the queries' positions (``forward``'s mode, which ``forward`` and
    training run: every KV tile not proved hidden from a Q tile), under
    ``*_forward_mode``; and the serving kernel on the same shape without a
    table."""
    from repro_torch.core.orchestrator import CacheOrchestrator
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import flash_kv_row_bytes
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    bf = torch.bfloat16
    h, g, d = ATTN_SHAPES["qwen2-vl-7b"]
    sq = 1024
    pinned = CacheOrchestrator(vmem_budget_bytes=hopper_pin_budget_bytes(d, 2)).plan_kv_split(
        sq, FLASH_TILE_ROWS, flash_kv_row_bytes(d, 2))[0]
    q = randn(gen, (1, sq, h, d), bf)
    k = randn(gen, (1, sq, g, d), bf)
    v = randn(gen, (1, sq, g, d), bf)
    qp = (torch.arange(sq, device="cuda", dtype=torch.int32) + POS_SHIFT)[None].contiguous()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * qp.numel()
    rec = {}
    # (suffix, keys_at_rows, pinned_rows): prefill's mode with the planner's
    # split, forward's as forward calls it (no pinned prefix)
    for suffix, at_rows, pin in (("", True, pinned), ("_forward_mode", False, 0)):
        seen = visible_by_tables(qp, at_rows, sq)

        def lib(seen=seen):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=seen[:, None],
                                                  enable_gqa=True)

        def kernel(at_rows=at_rows, pin=pin):
            return flash_attention(q, k, v, pinned_rows=pin, positions=qp, keys_at_rows=at_rows)

        def plain(at_rows=at_rows):
            return attention_ref(q, k, v, q_positions=qp, kv_positions=None if at_rows else qp)

        ref = plain()
        err = close(kernel(), ref, TOL[bf], f"flash with positions at qwen2-vl-7b's 1024 "
                    f"tokens, keys_at_rows {at_rows}")
        close(lib().transpose(1, 2), ref, TOL[bf],
              f"library flash with a mask vs plain, keys_at_rows {at_rows}")
        del ref
        n_seen = int(seen.sum())
        n_flops = 4 * n_seen * d * h
        t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
        ms = time_ms(kernel, flush)
        rec.update({
            f"max_abs_err{suffix}": err, f"visible_pairs{suffix}": n_seen,
            f"ms{suffix}": ms, f"tflops{suffix}": n_flops / ms * 1e-9,
            f"plain_ms{suffix}": time_ms(plain, flush),
            f"library_ms{suffix}": time_ms(lib, flush),
            f"bound_ms{suffix}": max(t_bytes, t_ops),
            f"bound_by{suffix}": "bytes" if t_bytes >= t_ops else "operations"})
        del seen
    return {
        "name": "flash_attention_pos", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_pos.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
        "replaces_note": "flash_kernel's attention masked by explicit positions, which the "
                         "JAX package computes in src/repro/models/layers.py:199-212 "
                         "gqa_attention",
        "path": "serve_positions",
        "shape": {"B": 1, "Sq": sq, "Sk": sq, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "mode": "prefill: queries at their index + 5, keys at their row index",
                  "mode_forward_mode": "forward: queries and keys at their index + 5",
                  "pinned_rows": pinned, "pinned_rows_forward_mode": 0},
        **kernel_usage(ptxas, ("flash_mma_pos_kernel<Li128ELb0>",
                               "flash_mma_pos_kernel<Li128ELb1>", "flash_pos_kernel<fLi128>")),
        "tol": TOL[bf], **rec,
        "ms_serving_kernel_without_positions": time_ms(
            lambda: flash_attention(q, k, v, pinned_rows=pinned), flush),
    }


def flash_bwd_pos_record(gen, flush, ptxas=None):
    """The backward kernel with a positions table at llama3.2-3b's training
    shape (``TRAIN_SHAPE``, bf16): even rows shifted by POS_SHIFT, one table
    for queries and keys, as ``forward`` with positions passes it under
    autograd.  Its time (three launches) beside the plain version's, the
    library's (``torch.autograd.grad`` through ``scaled_dot_product_attention``
    with the table's boolean mask) and the bound (five products of 2 * D
    FLOP for each visible pair and query head; the bytes moved once, the
    table included), and the same call without a table (the causal
    backward, whose visible pairs are the same here)."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import flash_attention_bwd
    bf = torch.bfloat16
    b, s, h, g, d = (TRAIN_SHAPE[k] for k in ("b", "s", "h", "g", "d"))
    q = randn(gen, (b, s, h, d), bf)
    k = randn(gen, (b, s, g, d), bf)
    v = randn(gen, (b, s, g, d), bf)
    do = randn(gen, (b, s, h, d), bf)
    pos = position_tables("shifted", b, s)[0]
    o, lse = flash_lse(q, k, v, positions=pos)
    got = flash_attention_bwd(q, k, v, o, lse, do, positions=pos)
    want = attention_bwd_ref(q, k, v, o, lse, do, q_positions=pos, kv_positions=pos)
    held = {n: close_grad(a, r, TOL[bf], f"flash bwd with positions at the training shape, {n}")
            for n, a, r in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    seen = visible_by_tables(pos, False, s)
    ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=seen[:, None],
                                             enable_gqa=True)
    dol = do.transpose(1, 2)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (ql, kl, vl), dol, retain_graph=True)

    n_seen = int(seen.sum())
    n_flops = 10 * d * n_seen * h
    n_bytes = (2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
               + 2 * (q.numel() + 2 * k.numel()) + 4 * pos.numel())
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_flops / PEAK_FLOPS[bf] * 1e3
    ms = time_ms_events(lambda: flash_attention_bwd(q, k, v, o, lse, do, positions=pos), flush)
    o0, lse0 = flash_lse(q, k, v)
    return {
        "name": "flash_attention_bwd_pos", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd_pos.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
        "replaces_note": "gradient of flash_kernel's attention masked by explicit positions; "
                         "the JAX package takes it by autodiff of "
                         "src/repro/models/layers.py:124 gqa_attention",
        "path": "serve_positions",
        "shape": {"B": b, "S": s, "H": h, "G": g, "D": d, "dtype": "bfloat16",
                  "positions": f"even rows at their index + {POS_SHIFT}, one table",
                  "visible_pairs": n_seen},
        # the _ext_ bodies compiled again in flash_attention_bwd_pos.cu
        **kernel_usage(ptxas, (f"dkdv_wgmma_pos_kernel<Li{d}>", f"dq_wgmma_pos_kernel<Li{d}>",
                               f"flash_attention_bwd_pos.cu:delta_kernel<13__nv_bfloat16Li{d}>")),
        "max_abs_err": max(e for _, e, _ in held.values()), "tol": TOL[bf],
        "held": {n: {"worst_ratio": r, "max_abs_err": e} for n, (r, e, _) in held.items()},
        "ms": ms, "tflops": n_flops / ms * 1e-9,
        "plain_ms": time_ms_events(lambda: attention_bwd_ref(
            q, k, v, o, lse, do, q_positions=pos, kv_positions=pos), flush),
        "library_ms": time_ms_events(lib_bwd, flush),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "ms_without_positions": time_ms_events(
            lambda: flash_attention_bwd(q, k, v, o0, lse0, do), flush),
        "forward_ms_with_lse": time_ms(lambda: flash_lse(q, k, v, positions=pos), flush),
    }


def phase_kernels_positions(ptxas=None):
    """The flash kernel's position variant and the backward with a table:
    ``check_flash_positions``, ``check_flash_positions_bwd``, the serving
    kernels' registers (``check_serving_registers``) and the two records
    (``flash_pos_record``, ``flash_bwd_pos_record``), whose launches come
    from the serve_positions phase."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    t0 = time.time()
    fwd = check_flash_positions(gen)
    bwd = check_flash_positions_bwd(gen)
    checks_s = time.time() - t0
    records = [flash_pos_record(gen, flush, ptxas), flash_bwd_pos_record(gen, flush, ptxas)]
    serving = {n: v for n, v in (ptxas or {}).items()
               if n.startswith(("flash_kernel<", "flash_mma_kernel<", "flash_mma_lse_kernel<"))}
    emit("kernels_positions", flash_pos_cases=len(flash_pos_cases()), forward=fwd,
         backward=bwd, tol={str(k): v for k, v in TOL.items()},
         serving_ptxas=serving or None, checks_seconds=checks_s, timed=records)
    check_serving_registers(ptxas)
    emit("kernels_positions", serving_registers_unchanged=True)
    return records


def phase_kernels(ptxas=None):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    check_decode_registers(ptxas)
    worst_decode = check_decode(gen)
    worst_flash = check_flash(gen)
    worst_ssd = check_ssd(gen)
    worst_bwd = check_flash_bwd(gen)
    worst_lse = check_flash_lse(gen)
    worst_ssd_bwd = check_ssd_bwd(gen)
    worst_decode_lse = check_decode_lse(gen)
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
    records.append(decode_lse_record(gen, flush))
    emit("kernels", decode_cases_max_abs_err=worst_decode,
         decode_lse_cases_max_abs_err=worst_decode_lse,
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
    "qwen2-vl-7b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "mrope_sections"),
        published=(28, 3584, 28, 4, 128, 18944, 152064, (16, 24, 24)),
        serve="serve_qwen2vl", parity="parity_qwen2vl", prompt_len=llama_prompt_len,
        parity_cut={"layers": 2}, parity_layers=2),
    "mistral-nemo-12b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab"),
        published=(40, 5120, 32, 8, 128, 14336, 131072),
        serve="serve_mistral", parity="parity_mistral", prompt_len=llama_prompt_len,
        parity_cut={"layers": 2}, parity_layers=2),
    "musicgen-large": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
               "act"),
        published=(48, 2048, 32, 32, 64, 8192, 2048, "gelu"),
        serve="serve_musicgen", parity="parity_musicgen", prompt_len=llama_prompt_len,
        parity_cut={"layers": 2}, parity_layers=2),
    "moonshot-v1-16b-a3b": dict(
        sizes=("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab"),
        published=(48, 2048, 16, 16, 128, 11264, 163840),
        moe=(64, 6, 1408, 2, 1.25, 1), serve="serve_moonshot", parity="parity_moonshot",
        prompt_len=llama_prompt_len,
        # the dense layer and the first MoE layer
        parity_cut={"moe_layers": 1}, parity_layers=2),
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
    want = {"decode_attention": n_attn * engine.decode_calls, "decode_attention_lse": 0,
            "flash_attention": n_requests * n_attn, "flash_attention_bwd": 0,
            "flash_attention_pos": 0, "flash_attention_bwd_pos": 0,
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
    from repro_torch.models import decode_step
    from repro_torch.models import prefill
    cfg2, p = parity_params(arch, cfg, params, dev, dtype)
    plen = parity_prompt_len(arch, cfg)
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, cfg.vocab, size=(2, plen))
    steps = rng.integers(2, cfg.vocab, size=(4, 2, 1))
    tok = torch.as_tensor(prompt, device=dev)
    follow = routing(routes) if routes is not None else nullcontext()
    with plain_versions() if plain else nullcontext(), follow:
        if cfg.family == SSM:
            got, cache = prefill(p, tok, cfg2)
        else:
            got, cache = prefill(p, tok, cfg2, pinned_rows=parity_pins(plen, cfg, dtype))
            pad = torch.zeros_like(cache.k[:, :, :4])
            cache = cache._replace(k=torch.cat([cache.k, pad], dim=2),
                                   v=torch.cat([cache.v, pad], dim=2))
        outs = [got]
        for tok in steps:
            got, cache = decode_step(p, torch.as_tensor(tok, device=dev), cache, cfg2)
            outs.append(got[:, 0])
    return torch.stack(outs).float().cpu()


def parity_params(arch, cfg, params, dev, dtype):
    """The parity cut of ``arch``'s config, and of ``params`` on ``dev`` in
    ``dtype``: the first layers of each leaf below a key of ``parity_cut``
    (all of them elsewhere); leaves the model keeps in fp32 stay fp32."""
    path = PATHS[arch]
    cfg2 = replace(cfg, n_layers=path["parity_layers"], **path.get("parity_changes", {}))

    def cut(tree, keep=None):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cut(v, path["parity_cut"].get(k, keep))
            else:
                v = v[:keep] if keep else v
                out[k] = v.to(device=dev, dtype=torch.float32 if v.dtype == torch.float32
                              else dtype)
        return out

    return cfg2, cut(params)


def parity_pins(plen, cfg, dtype):
    """A parity prefill's ``pinned_rows``: the whole prompt where the flash
    kernel's shared memory holds it (not in fp32 at head_dim 256, which
    streams it)."""
    from repro_torch.core.orchestrator import flash_smem_bytes
    from repro_torch.core.orchestrator import H100_SMEM_PER_BLOCK
    fits = flash_smem_bytes(plen, cfg.head_dim, dtype.itemsize) <= H100_SMEM_PER_BLOCK
    return plen if fits else 0


def embeds_logits(arch, cfg, params, dev, dtype):
    """Logits (2, vocab) of one prefill of the path's cut of ``params`` from
    2 x ``parity_prompt_len`` precomputed frame embeddings (``input_embeds``,
    drawn from seed 2 at the embedding table's scale, d_model ** -0.5) in
    place of tokens, on ``dev`` in ``dtype``."""
    from repro_torch.models import prefill
    cfg2, p = parity_params(arch, cfg, params, dev, dtype)
    plen = parity_prompt_len(arch, cfg)
    emb = np.random.default_rng(2).standard_normal((2, plen, cfg.d_model)) * cfg.d_model ** -0.5
    tok = torch.zeros((2, plen), dtype=torch.long, device=dev)
    got, _ = prefill(p, tok, cfg2, input_embeds=torch.as_tensor(emb, dtype=dtype, device=dev),
                     pinned_rows=parity_pins(plen, cfg, dtype))
    return got.float().cpu()


def check_three_planes_refused(arch, cfg, params):
    """M-RoPE's 3-plane (3, B, S) positions refused with ValueError by
    ``prefill`` and ``forward`` on the card before any launch, as the JAX
    package refuses them; the calls refused.  (B, S) positions are computed
    (``serve_positions``, ``parity_positions``)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.models import forward
    from repro_torch.models import prefill
    b, s = 2, 64
    tok = torch.zeros((b, s), dtype=torch.long, device="cuda")
    planes = torch.arange(s, device="cuda").expand(3, b, s)
    calls = []
    with torch.no_grad():
        for name, entry in (("prefill", prefill), ("forward", forward)):
            before = launch_counts()
            refused(lambda: entry(params, tok, cfg, positions=planes),
                    f"{arch} {name} with (3, B, S) positions")
            check(launch_counts() == before, f"{arch} {name}: launched before refusing")
            calls.append(f"{name} (3, B, S)")
    return calls


# ---------------------------------------------------------------------------
# explicit positions through the model's entry points
POS_SERVE_TOKENS = 1024   # serve_positions: one row of qwen2-vl-7b's prompt
# parity_positions: each path's 2-layer cut at full width (config changes),
# and its prompt of 2 x POS_PARITY_TOKENS tokens, which overruns gemma2's
# window cut to 64 as parity_gemma2 does
POS_PARITY = {"llama3.2-3b": {}, "qwen2-vl-7b": {}, "gemma2-27b": dict(window=64),
              "deepseek-moe-16b": {}, "zamba2-7b": dict(hybrid_period=2)}
POS_PARITY_TOKENS = 96


def phase_serve_positions(params=None):
    """qwen2-vl-7b at published size (28 layers, bf16, 15.2 GB of weights:
    the serve_qwen2vl phase's where it ran) with explicit (B, S) positions,
    its one row of POS_SERVE_TOKENS tokens at their index + POS_SHIFT: a
    ``prefill`` (queries at the table, keys at their row index) and a
    ``forward`` (both at the table), each launching the position variant once
    a layer and nothing else, then the training loss of the same ``forward``
    under autograd (gradients of every layer's ``wq``), which launches it
    twice a layer (forward and recompute) and the backward's three kernels
    once.  Launch counts are set to 0 just before each call and read just
    after; logits finite.  Returns the launches of the two records."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import forward
    from repro_torch.models import init_params
    from repro_torch.models import lm_loss
    from repro_torch.models import prefill
    arch = "qwen2-vl-7b"
    cfg = get_arch(arch)
    check_published(arch, cfg)
    if params is None:
        params = init_params(cfg, seed=0, device="cuda")
    s, n_attn = POS_SERVE_TOKENS, cfg.n_layers
    tok = torch.as_tensor(np.random.default_rng(3).integers(2, cfg.vocab, (1, s)), device="cuda")
    pos = (torch.arange(s, device="cuda") + POS_SHIFT)[None]
    none = {k: 0 for k in launch_counts()}
    wq = params["layers"]["attn"]["wq"]

    def train_call():
        wq.requires_grad_(True)
        try:
            loss = lm_loss(forward(params, tok, cfg, positions=pos), tok)
            grad, = torch.autograd.grad(loss, [wq])
        finally:
            wq.requires_grad_(False)
        check(bool(torch.isfinite(grad).all()) and bool(grad.abs().sum() > 0),
              "serve_positions: the gradient of wq is not finite, or zero")
        return loss[None, None]

    runs, total = {}, dict(none)
    calls = (("prefill", lambda: prefill(params, tok, cfg, positions=pos)[0],
              dict(none, flash_attention_pos=n_attn)),
             ("forward", lambda: forward(params, tok, cfg, positions=pos),
              dict(none, flash_attention_pos=n_attn)),
             ("train", train_call,
              dict(none, flash_attention_pos=2 * n_attn,
                   flash_attention_bwd_pos=flash_ops.BWD_KERNELS * n_attn)))
    for name, call, want in calls:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.no_grad() if name != "train" else nullcontext():
            out = call()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = launch_counts()
        check(counts == want, f"serve_positions {name}: launches {counts}, expected {want}")
        check(bool(torch.isfinite(out.float()).all()), f"serve_positions {name}: not finite")
        runs[name] = dict(seconds=seconds, launches={k: v for k, v in counts.items() if v},
                          shape=list(out.shape))
        total = {k: total[k] + counts[k] for k in total}
    emit("serve_positions", arch=cfg.name, n_layers=cfg.n_layers, dtype="bfloat16", batch=1,
         tokens=s, positions=f"index + {POS_SHIFT}", runs=runs,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return total


def pos_parity_logits(cfg, params, tokens, plain=False, routes=None):
    """The logits of ``parity_positions``' two calls, on the card: ``prefill``
    with the ``negative`` table (its last-token logits and the cache's K/V)
    and ``forward`` with the ``packed`` one; ``plain`` runs the kernels'
    plain versions; ``routes`` records or follows a MoE's expert choices."""
    from repro_torch.models import forward
    from repro_torch.models import prefill
    b, s = tokens.shape
    follow = routing(routes) if routes is not None else nullcontext()
    with torch.no_grad(), plain_versions() if plain else nullcontext(), follow:
        last, cache = prefill(params, tokens, cfg,
                              positions=position_tables("negative", b, s)[0])
        logits = forward(params, tokens, cfg, positions=position_tables("packed", b, s)[0])
    return dict(prefill=last.float(), cache_k=cache.k.float(), cache_v=cache.v.float(),
                forward=logits.float())


def phase_parity_positions():
    """Explicit (B, S) positions through ``prefill`` (the ``negative`` table:
    rows that see no key, and positions past S) and ``forward`` (the
    ``packed`` one) of 2-layer cuts at full width of llama3.2-3b,
    qwen2-vl-7b, gemma2-27b (window cut to 64, which the 96-token prompt
    overruns), deepseek-moe-16b (its dense layer and one MoE layer) and
    zamba2-7b (one group of 2 Mamba2 layers and the shared block), seeded
    random weights: the card's kernels against the card's plain versions of
    the same steps (``plain_versions``), fp32 elementwise within LOGIT_TOL,
    bf16 by the share rule of ``phase_parity`` (a MoE's plain run following
    the kernels' run's expert choices, those it would change a few
    near-ties)."""
    from repro_torch.configs import MOE
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    out = {}
    for arch, changes in POS_PARITY.items():
        t0 = time.time()
        cfg = get_arch(arch)
        check_published(arch, cfg)
        cfg2 = replace(cfg, n_layers=2, **changes)
        tokens = torch.as_tensor(np.random.default_rng(4).integers(
            2, cfg.vocab, (2, POS_PARITY_TOKENS)), device="cuda")
        bf = init_params(cfg2, seed=0, device="cuda")
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            params = bf if dtype == torch.bfloat16 else _tree_to(bf, torch.float32)
            routes = {} if cfg.family == MOE and dtype == torch.bfloat16 else None
            kern = pos_parity_logits(cfg2, params, tokens, routes=routes)
            plain = pos_parity_logits(cfg2, params, tokens, plain=True, routes=routes)
            for what in kern:
                key = f"{'fp32' if dtype == torch.float32 else 'bf16'}_{what}"
                if dtype == torch.float32:
                    res[key + "_max_abs_err"] = close(kern[what], plain[what], LOGIT_TOL,
                                                      f"parity_positions {arch} fp32 {what}")
                    continue
                got = held_logits(kern[what], plain[what])
                check(got["share_within_tol"] >= 0.999 and got["rms_err"] <= LOGIT_TOL / 2,
                      f"parity_positions {arch} bf16 {what}: {got}")
                if what in ("prefill", "forward"):
                    check(got["clear_margin_tokens_equal"],
                          f"parity_positions {arch} bf16 {what}: greedy token differs")
                res[key] = got
            if routes is not None:
                res["router_bf16"] = check_near_ties(routes, f"parity_positions {arch}")
            del params
        del bf
        gc.collect()
        torch.cuda.empty_cache()
        res["seconds"] = time.time() - t0
        out[arch] = res
    emit("parity_positions", n_layers=2, tokens=POS_PARITY_TOKENS, changed=POS_PARITY,
         calls="prefill (negative table) + forward (packed table)", tol=LOGIT_TOL,
         compared="card kernels vs card plain versions", **out)


def _tree_to(tree, dtype):
    """A parameter tree with every leaf in ``dtype``."""
    return {k: _tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def phase_examples():
    """``examples/quickstart_torch.py`` on the card, in a child process: the
    DCO policies simulated, a reduced llama3.2-3b trained 30 steps and the
    flash kernel against its plain version; it must end with ``done.``
    after saying that it ran the CUDA kernel."""
    import os
    t0 = time.time()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    check(proc.returncode == 0 and lines and lines[-1] == "done.",
          f"quickstart_torch.py exited {proc.returncode}:\n{proc.stdout[-2000:]}"
          f"\n{proc.stderr[-2000:]}")
    check("(the CUDA kernel)" in lines[-2], f"quickstart_torch.py: {lines[-2]}")
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    check(len(losses) == 4 and losses[-1] < losses[0], f"quickstart_torch.py losses {losses}")
    emit("examples", script="examples/quickstart_torch.py", ended="done.", losses=losses,
         kernel_line=lines[-2].strip(), seconds=time.time() - t0)


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
    planted in bf16 (``bf16_router``) must fail that.

    A model with M-RoPE sections (qwen2-vl-7b) first checks that 3-plane
    positions are refused before any launch (``check_three_planes_refused``);
    one with an audio frontend (musicgen-large) also holds a prefill from
    frame embeddings (``embeds_logits``), card against CPU, by the rules
    above."""
    from repro_torch.configs import MOE
    path = PATHS[arch]
    moe = cfg.family == MOE
    extra = {}
    if cfg.mrope_sections:
        extra["three_planes_refused"] = check_three_planes_refused(arch, cfg, params)
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
    if cfg.modality_stub == "audio":
        extra["embeds_fp32_max_abs_err"] = close(
            embeds_logits(arch, cfg, params, "cuda", torch.float32),
            embeds_logits(arch, cfg, params, "cpu", torch.float32), LOGIT_TOL,
            f"{arch} parity fp32, input_embeds prefill: card vs CPU logits")
        fields["embeds_bf16"] = held(
            embeds_logits(arch, cfg, params, "cuda", torch.bfloat16),
            embeds_logits(arch, cfg, params, "cpu", torch.bfloat16),
            "input_embeds prefill, card vs CPU")
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
         tol=LOGIT_TOL, fp32_max_abs_err=err32, **extra,
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

    def slots(w, idx, n_experts, capacity, *rest):
        tok_ids, valid, gw = real(w, idx, n_experts, capacity, *rest)
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

    def flash(q, k, v, *, causal=True, scale=None, softcap=None, window=None, pinned_rows=0,
              positions=None, keys_at_rows=False):
        return attention_ref(q, k, v, causal=causal, scale=scale, softcap=softcap,
                             window=window, q_positions=positions,
                             kv_positions=None if keys_at_rows else positions)

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
    return {"decode_attention": 0, "decode_attention_lse": 0, "flash_attention_pos": 0,
            "flash_attention_bwd_pos": 0,
            "flash_attention": 2 * n_attn * microbatches,
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
        """(params, gradient tree, loss, {key: gradient}), all on ``dev``;
        a MoE cut records or follows ``routes``, counts its drops and, on the
        card, checks its router logits.  Its seconds go to ``fields``."""
        t0 = time.time()
        tag = f"{'fp32' if dtype == torch.float32 else 'bf16'}_{dev.replace('cuda', 'card')}"
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
        flat = dict(flatten_with_keys(g))
        fields[f"{tag}_seconds"] = time.time() - t0
        if moe:
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

    def pairs(g_card, g_cpu):
        """(key, card gradient, CPU gradient) of each leaf in fp32, both on
        the card, where the comparisons run: a leaf at a time crosses the
        bus, in its own type."""
        check(sorted(g_card) == sorted(g_cpu), f"{what}: gradient keys differ")
        for key in g_cpu:
            yield key, g_card[key].float(), g_cpu[key].to("cuda").float()

    routes = {}
    _, _, loss_card, g_card = grads("cuda", torch.float32, routes)
    on_card(g_card, "fp32")
    _, _, loss_cpu, g_cpu = grads("cpu", torch.float32, routes, fp64_scan=cfg2.ssm is not None)
    if moe:
        fields["router_fp32"] = check_near_ties(routes, f"{what} fp32")
    check(abs(loss_card - loss_cpu) <= 1e-5 * max(1.0, abs(loss_cpu)),
          f"{what} fp32: loss {loss_card} vs {loss_cpu}")
    worst = (0.0, "")
    for key, a, r in pairs(g_card, g_cpu):
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
    for key, a, r in pairs(g_card, g_cpu):
        rel = (a - r).abs() / float(r.abs().max())
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
# Training under a mesh: two ranks share the one card, joined by gloo (NCCL
# refuses two ranks on one GPU); each is a process of its own (MESH_RANKS)
MESH_RANKS = 2
MESH_STEPS = 3
MESH_TIMEOUT_S = 900
# each layout of train_mesh: (arch, layers, (data, model), ACT_SEQ); the
# parity phase holds each against one process on the card
MESH_RUNS = (("llama3.2-3b", 4, (1, 2), False), ("llama3.2-3b", 4, (1, 2), True),
             ("llama3.2-3b", 4, (2, 1), False), ("deepseek-moe-16b", 3, (1, 2), False),
             # one group of 6 Mamba2 layers and the shared block, one tail layer
             ("zamba2-7b", 7, (1, 2), False))
MESH_PARITY_TOKENS = (2, 128)
# parity's optimizer: Adam's first step moves a parameter by lr g / (|g| + eps);
# at eps 1 that is smooth in g (about lr g), so the two runs' parameters can
# be held elementwise (at eps 1e-8 a gradient within rounding of 0 could move
# either way by lr); weight decay moves every matrix by lr wd |p|
MESH_PARITY_OPT = dict(lr=0.1, eps=1.0, warmup_steps=0, total_steps=10)
MESH_TOL = 1e-5          # fp32, mesh vs one process: times each leaf's largest magnitude


# serving under a mesh (serve_mesh): each path at its published size behind
# ServeEngine, these prompts, SERVE_MESH_NEW new tokens each, greedy.  Two
# pairs of equal length: two position groups, so two decode_step calls an
# engine step (each call is ~60 gloo collectives through the host for
# llama, ~220 for zamba2; scripts/gloo_cuda_probe.py times one); lengths the
# reference's SSD chunk rule accepts
SERVE_MESH_RUNS = (("llama3.2-3b", 28, (1, 2), False), ("zamba2-7b", 81, (1, 2), False))
SERVE_MESH_PROMPTS = {"llama3.2-3b": (96, 512, 96, 512), "zamba2-7b": (96, 512, 96, 512)}
SERVE_MESH_NEW = 8
# parity_serve_mesh: each path's cut at full width, prefill of B x S tokens
# and PARITY_SERVE_STEPS decode steps; zamba2: 3 Mamba2 layers at period 2,
# one application of the shared block and a tail layer; deepseek: the dense
# layer and 2 MoE layers
PARITY_SERVE_MESH_RUNS = (("llama3.2-3b", 2, (1, 2), False),
                          ("zamba2-7b", {"n_layers": 3, "hybrid_period": 2}, (1, 2), False),
                          ("deepseek-moe-16b", 3, (1, 2), False))
PARITY_SERVE_TOKENS = (2, 64)
PARITY_SERVE_STEPS = 4
# serve_kvseq: llama3.2-3b at published size, batch 1 (so kv_layout picks
# kvseq: every KV head over a rank's slice of the rows), a prompt of
# KVSEQ_PROMPT tokens into a cache of KVSEQ_ROWS rows, KVSEQ_NEW greedy
# decode steps, on (1, 2) (the rows split over model) and (2, 1) (over data)
SERVE_KVSEQ_RUNS = (("llama3.2-3b", 28, (1, 2), False), ("llama3.2-3b", 28, (2, 1), False))
KVSEQ_PROMPT, KVSEQ_ROWS, KVSEQ_NEW = 4096, 32768, 8
# parity_serve_kvseq: batch 1 (kvseq) cuts against one process, as
# parity_serve_mesh; gemma2's window cut to 32 rows so that the prompt and
# every step overrun it and the 68-row cache's slice boundary (row 34) falls
# inside it
PARITY_KVSEQ_RUNS = (("llama3.2-3b", 2, (1, 2), False), ("llama3.2-3b", 2, (2, 1), False),
                     ("gemma2-27b", {"n_layers": 2, "window": 32}, (1, 2), False),
                     ("zamba2-7b", {"n_layers": 3, "hybrid_period": 2}, (2, 1), False))
PARITY_KVSEQ_TOKENS = (1, 64)


def mesh_cfg(arch, cut):
    """``arch`` at its published size, then cut: to ``cut`` layers, or by the
    config changes of a dict."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    check_published(arch, cfg)
    return replace(cfg, **(cut if isinstance(cut, dict) else {"n_layers": cut}))


def run_mesh_children(phases):
    """Start MESH_RANKS processes of this script (``--mesh-child``) that run
    ``phases`` (one start for both mesh phases: each costs a CUDA context and
    the imports), wait for them, and return each rank's results.  A rank that
    fails, or does not end in MESH_TIMEOUT_S, fails the run; every process
    is stopped before this returns."""
    work = ROOT / "build" / "mesh"
    shutil_rmtree(work)
    work.mkdir(parents=True)
    procs = []
    try:
        for r in range(MESH_RANKS):
            log = open(work / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-child", ",".join(phases),
                 "--mesh-rank", str(r), "--mesh-dir", str(work)],
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.time() + MESH_TIMEOUT_S
        while any(p.poll() is None for p, _ in procs):
            failed = [p for p, _ in procs if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            tail = (work / f"rank{r}.log").read_text()[-3000:]
            print(f"{phases} rank {r} exited {p.returncode}:\n{tail}", file=sys.stderr)
        check(p.returncode == 0, f"{phases}: rank {r} exited with {p.returncode}")
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]


def shutil_rmtree(path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def mesh_child(phases, rank, work):
    """One rank of the mesh ``phases``: joins the gloo group of MESH_RANKS
    processes on card 0 and runs every layout of each phase's runs
    (``MESH_PHASES``); writes ``{phase: [run results], phase + "_seconds":
    s}`` to ``work/rank{rank}.json``."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}", rank=rank,
                            world_size=MESH_RANKS)
    from repro_torch.kernels import build
    build.load()
    from repro_torch.launch.mesh import make_test_mesh
    meshes, refs = {}, {}
    out = {}
    try:
        for phase in phases:
            t0 = time.time()
            out[phase] = []
            runs, fn = MESH_PHASES[phase]
            for arch, cut, shape, act_seq in runs:
                if shape not in meshes:
                    meshes[shape] = make_test_mesh(*shape, device_type="cuda")
                out[phase].append(fn(mesh_cfg(arch, cut), meshes[shape], act_seq, rank, refs))
                gc.collect()
                torch.cuda.empty_cache()
                dist.barrier()
            out[phase + "_seconds"] = time.time() - t0
            refs.clear()    # the one-process results of this phase, on the card
    finally:
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def mesh_train_run(cfg, mesh, act_seq, rank, refs):
    """MESH_STEPS bf16 steps of ``cfg`` on ``mesh`` (this rank's part): the
    whole state from seed 0 placed by the sharding rules, ``SyntheticLM``
    batches of TRAIN_SHAPE's 8 x 512 tokens (each data rank takes its rows),
    the cut-depth paths' learning rate.  Every loss and gradient norm finite;
    this rank's launches exactly ``train_launches`` of the steps (each rank
    runs every layer's attention on its heads)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.sharding import ACT_SEQ
    from repro_torch.sharding import use_mesh
    from repro_torch.train import AdamWConfig
    from repro_torch.train import init_sharded_train_state
    from repro_torch.train import make_train_step
    from repro_torch.tree import leaves
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    ACT_SEQ[0] = act_seq
    try:
        with use_mesh(mesh):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            state = init_sharded_train_state(init_params(cfg, seed=0, device="cuda"), cfg)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            setup_s = time.time() - t0
            peak_setup = torch.cuda.max_memory_allocated()
            held_bytes = torch.cuda.memory_allocated()
            local_params = sum(p.numel() for p in leaves(state.params))
            lr = SMALL_LR[0]
            step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=0,
                                                    total_steps=MESH_STEPS), device="cuda")
            data = SyntheticLM(cfg.vocab, s, b)
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            log = []
            for i in range(MESH_STEPS):
                torch.cuda.synchronize()
                t0 = time.time()
                state, metrics = step(state, data.batch(i))
                torch.cuda.synchronize()
                log.append(dict(step=i, loss=float(metrics["loss"]),
                                grad_norm=float(metrics["grad_norm"]), seconds=time.time() - t0))
            counts = launch_counts()
    finally:
        ACT_SEQ[0] = False
    want = train_launches(cfg, MESH_STEPS)
    check(counts == want, f"train_mesh rank {rank}: launches {counts}, expected {want}")
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in log),
          f"train_mesh rank {rank}: a loss or gradient norm is not finite")
    steady = statistics.median(r["seconds"] for r in log[1:])
    return dict(rank=rank, batch=b, seq=s, peak_lr=lr, steps=log, seconds_per_step=steady,
                tokens_per_s=b * s / steady, setup_seconds=setup_s, launches=counts,
                local_params=local_params, state_bytes=held_bytes,
                peak_memory_bytes_setup=peak_setup,
                peak_memory_bytes_steps=torch.cuda.max_memory_allocated())


def mesh_parity_run(cfg, mesh, act_seq, rank, refs):
    """One fp32 train step of ``cfg`` on ``mesh``, its parameters gathered,
    against the same step in one process on the card (``mesh_reference``,
    run by rank 0 once an architecture, the other rank waiting): loss and
    gradient norm within MESH_TOL, every parameter leaf after the step
    elementwise within MESH_TOL of its largest magnitude.  Dense models also
    in bf16: every gathered gradient leaf by the share rules of
    phase_parity_train, the loss within LOGIT_TOL (MoE and the hybrid are held
    in fp32 only: router near-ties flip between the ranks' sums and one
    process's, and the hybrid's 7 layers are too deep for the bf16 share)."""
    import torch.distributed as dist
    from repro_torch.configs import DENSE
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.sharding import ACT_SEQ
    from repro_torch.sharding import comm
    from repro_torch.sharding import gather_tree
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.api import dp_axes
    from repro_torch.train import AdamWConfig
    from repro_torch.train import init_sharded_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train import param_logical_axes
    from repro_torch.train.loop import local_batch
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.tree import flatten_with_keys
    from repro_torch.tree import unflatten
    b, s = MESH_PARITY_TOKENS
    tokens = torch.as_tensor(SyntheticLM(cfg.vocab, s, b).batch(0)).to("cuda", torch.long)
    axes, shapes = param_logical_axes(cfg), init_params(cfg, device="meta")
    dense = cfg.family == DENSE
    fields = {}
    ACT_SEQ[0] = act_seq
    try:
        with use_mesh(mesh):
            t0 = time.time()
            state = init_sharded_train_state(
                init_params(cfg, seed=0, device="cuda", dtype=torch.float32), cfg)
            state, met = make_train_step(cfg, AdamWConfig(**MESH_PARITY_OPT),
                                         device="cuda")(state, tokens)
            got = dict(flatten_with_keys(gather_tree(state.params, axes, shapes)))
            del state
            fields["fp32_mesh_seconds"] = time.time() - t0
            if dense:
                t0 = time.time()
                params = shard_tree(init_params(cfg, seed=0, device="cuda"), axes)
                loss, grads = loss_and_grads(params, local_batch(tokens), cfg)
                for g in grads:
                    for axis in dp_axes(mesh):
                        comm.all_reduce_(g, axis)
                got_g = dict(flatten_with_keys(gather_tree(unflatten(params, grads), axes,
                                                           shapes)))
                bf16_loss = float(loss)
                del params, grads
                fields["bf16_mesh_seconds"] = time.time() - t0
    finally:
        ACT_SEQ[0] = False
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        if cfg.name not in refs:
            refs[cfg.name] = mesh_reference(cfg, tokens, dense)
        ref = refs[cfg.name]
        check(abs(float(met["loss"]) - ref["loss"]) <= MESH_TOL * max(1.0, abs(ref["loss"])),
              f"parity_train_mesh fp32: loss {float(met['loss'])} vs {ref['loss']}")
        check(abs(float(met["grad_norm"]) - ref["grad_norm"]) <= MESH_TOL * ref["grad_norm"],
              f"parity_train_mesh fp32: grad norm {float(met['grad_norm'])} vs "
              f"{ref['grad_norm']}")
        worst = (0.0, "")
        for key, want in ref["params"].items():
            scale = float(want.abs().max())
            err = float((got[key] - want).abs().max())
            check(err <= MESH_TOL * scale, f"parity_train_mesh fp32: {key} max abs err "
                  f"{err:.3e} beyond {MESH_TOL} x {scale:.3e}")
            worst = max(worst, (err / scale, key))
        fields.update(fp32_loss_mesh=float(met["loss"]), fp32_loss_one=ref["loss"],
                      fp32_grad_norm_mesh=float(met["grad_norm"]),
                      fp32_grad_norm_one=ref["grad_norm"], fp32_param_max_rel_err=worst[0],
                      fp32_param_max_rel_err_leaf=worst[1], parameter_leaves=len(got),
                      one_process_seconds=ref["seconds"])
        if dense:
            check(abs(bf16_loss - ref["bf16_loss"]) <= LOGIT_TOL,
                  f"parity_train_mesh bf16: loss {bf16_loss} vs {ref['bf16_loss']}")
            shares, rmss, caps = [], [], []
            for key, want in ref["bf16_grads"].items():
                rel = (got_g[key].float() - want).abs() / float(want.abs().max())
                shares.append(float((rel <= GRAD_SHARE_TOL).float().mean()))
                rmss.append(float(rel.square().mean().sqrt()))
                caps.append(float(rel.max()))
                check(shares[-1] >= 0.99 and rmss[-1] <= GRAD_SHARE_TOL / 2 and caps[-1] <= 0.5,
                      f"parity_train_mesh bf16: {key} share {shares[-1]:.4f}, RMS "
                      f"{rmss[-1]:.4f}, cap {caps[-1]:.4f}")
            fields.update(bf16_loss_mesh=bf16_loss, bf16_loss_one=ref["bf16_loss"],
                          bf16_grad_min_share=min(shares), bf16_grad_max_rms=max(rmss),
                          bf16_grad_max_rel_err=max(caps), gradient_leaves=len(shares))
    dist.barrier()
    return dict(rank=rank, tokens=[b, s], opt=MESH_PARITY_OPT, **fields)


def mesh_params(cfg, mesh, rank, dtype=torch.bfloat16):
    """This rank's shards of ``cfg``'s weights from seed 0, drawn whole on the
    card one rank at a time (the whole tree and this rank's shards at once
    are 1.5 times the weights), never through the host."""
    import torch.distributed as dist
    from repro_torch.models import init_params
    from repro_torch.sharding import shard_tree
    from repro_torch.sharding import use_mesh
    from repro_torch.train import param_logical_axes
    params = None
    for r in range(MESH_RANKS):
        if r == rank:
            with use_mesh(mesh):
                params = shard_tree(init_params(cfg, seed=0, device="cuda", dtype=dtype),
                                    param_logical_axes(cfg))
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def mesh_serve_run(cfg, mesh, act_seq, rank, refs):
    """``cfg`` served under ``mesh`` by this rank's ``ServeEngine`` (its
    parameter shards and cache shard): SERVE_MESH_PROMPTS' requests,
    SERVE_MESH_NEW new tokens each, greedy.  The launch counts, set to 0
    just before and read just after, exactly those of this rank's layers on
    its heads; every rank's tokens the same."""
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.serve import Request
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import ACT_SEQ
    from repro_torch.sharding import use_mesh
    from repro_torch.tree import leaves
    prompts = SERVE_MESH_PROMPTS[cfg.name]
    ACT_SEQ[0] = act_seq
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = mesh_params(cfg, mesh, rank)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        local_params = sum(p.numel() for p in leaves(params))
        with use_mesh(mesh):
            engine = ServeEngine(cfg, params, max_batch=len(prompts), max_seq=1024,
                                 device="cuda")
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=SERVE_MESH_NEW) for i, n in enumerate(prompts)]
        for r in reqs:
            engine.add_request(r)
        dist.barrier()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        steps = engine.run_to_completion(max_steps=10000)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = launch_counts()
    finally:
        ACT_SEQ[0] = False
    tokens = [r.tokens_out for r in reqs]
    every = [None] * MESH_RANKS
    dist.all_gather_object(every, tokens)
    same = all(t == every[0] for t in every)
    check(same, f"serve_mesh {cfg.name} rank {rank}: the ranks drew different tokens")
    for r in reqs:
        check(r.done and len(r.tokens_out) == SERVE_MESH_NEW
              and all(0 <= t < cfg.vocab for t in r.tokens_out),
              f"serve_mesh {cfg.name}: request {r.uid} ended with {r.tokens_out}")
    n_attn, n_ssm = kernel_layers(cfg)
    want = {"decode_attention": n_attn * engine.decode_calls, "decode_attention_lse": 0,
            "flash_attention": len(reqs) * n_attn, "flash_attention_bwd": 0,
            "flash_attention_pos": 0, "flash_attention_bwd_pos": 0,
            "ssd_scan": len(reqs) * n_ssm, "ssd_scan_bwd": 0}
    check(counts == want, f"serve_mesh {cfg.name} rank {rank}: launches {counts}, "
          f"expected {want}")
    check(bool(torch.isfinite(engine.last_logits.float()).all()),
          f"serve_mesh {cfg.name}: non-finite logits")
    new, calls = sum(len(t) for t in tokens), engine.decode_calls
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=rank, requests=len(reqs), prompt_lens=list(prompts),
                new_tokens=new, seconds=seconds, tokens_per_s=new / seconds,
                engine_steps=steps, decode_step_calls=calls,
                launches=counts, tokens_same_on_every_rank=same, setup_seconds=setup_s,
                local_params=local_params,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def grow_cache(cache, cfg, batch, rows):
    """``cache`` (a prefill's, under the bound mesh or none) with its K/V
    grown to ``rows`` rows of zeros after the prompt's.  A ``kvseq`` cache's
    rows are sliced over ranks: its K/V are gathered whole, grown, and
    sliced again for ``rows``; the other layout grows each rank's part."""
    from repro_torch.models import Cache
    from repro_torch.models.model import gather_cache
    from repro_torch.models.model import kv_rows
    from repro_torch.models.model import shard_cache

    def grown(t):
        shape = list(t.shape)
        shape[2] = rows - shape[2]
        return torch.cat([t, t.new_zeros(shape)], dim=2)

    if cache.k is None:
        return cache
    if not kv_rows(cache):
        return cache._replace(k=grown(cache.k), v=grown(cache.v))
    whole = gather_cache(Cache(k=cache.k, v=cache.v), cfg, batch)
    part = shard_cache(Cache(k=grown(whole.k), v=grown(whole.v)), cfg, layout="kvseq")
    return cache._replace(k=part.k, v=part.v)


def serve_calls(cfg, params, mesh=None, calls=None, routes=None, tokens=PARITY_SERVE_TOKENS):
    """Prefill of ``tokens``' prompts (B, S; seed 1) and PARITY_SERVE_STEPS
    decode steps, under ``mesh`` or in one process: the logits of each call
    (steps + 1, B, V), the cache after the last step, gathered whole, on the
    host, and the K/V layout.  A MoE model's router calls go to ``calls``
    (``router_log``) and its expert choices are recorded or followed in
    ``routes`` (``routing``)."""
    from repro_torch.models import decode_step
    from repro_torch.models import prefill
    from repro_torch.models.model import gather_cache
    from repro_torch.models.model import kv_rows
    from repro_torch.sharding import use_mesh
    b, s = tokens
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab, size=(b, s)), device="cuda")
    steps = rng.integers(2, cfg.vocab, size=(PARITY_SERVE_STEPS, b, 1))
    with ExitStack() as stack:
        stack.enter_context(use_mesh(mesh))
        if calls is not None:
            stack.enter_context(router_log(calls))
        if routes is not None:
            stack.enter_context(routing(routes))
        got, cache = prefill(params, prompt, cfg)
        layout = "kvseq" if kv_rows(cache) else "heads"
        cache = grow_cache(cache, cfg, b, s + PARITY_SERVE_STEPS)
        outs = [got]
        for tok in steps:
            got, cache = decode_step(params, torch.as_tensor(tok, device="cuda"), cache, cfg)
            outs.append(got[:, 0])
        whole = gather_cache(cache, cfg, b)
    fields = {f: getattr(whole, f).float().cpu() for f in ("k", "v", "conv_x", "conv_bc", "ssm")
              if getattr(whole, f) is not None}
    return torch.stack(outs).float().cpu(), fields, layout


def share_rule(out, ref, what):
    """The port's share rule for bf16 results of two runs that sum partial
    products in other orders (as ``mesh_parity_run`` holds bf16 gradients):
    of |out - ref| over ref's largest magnitude, at least 0.99 within
    GRAD_SHARE_TOL, an RMS of at most half that and none beyond 0.5."""
    rel = (out - ref).abs() / float(ref.abs().max())
    got = dict(share=float((rel <= GRAD_SHARE_TOL).float().mean()),
               rms=float(rel.square().mean().sqrt()), cap=float(rel.max()))
    check(got["share"] >= 0.99 and got["rms"] <= GRAD_SHARE_TOL / 2 and got["cap"] <= 0.5,
          f"parity_serve_mesh {what}: {got}")
    return got


def mesh_held(out, ref, what):
    """max |out - ref| over ref's largest magnitude, after checking it is
    within MESH_TOL."""
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max()) / scale
    check(scale > 0 and err <= MESH_TOL, f"parity_serve_mesh {what}: max abs err {err:.3e} "
          f"of the scale {scale:.3e}, beyond {MESH_TOL}")
    return err


def mesh_serve_parity_run(cfg, mesh, act_seq, rank, refs, tokens=PARITY_SERVE_TOKENS,
                          layout=None):
    """``serve_calls`` of ``cfg`` on ``mesh`` against the same calls in one
    process on the card (rank 0, the other rank waiting), from the same
    weights: fp32 logits of every call and every gathered cache tensor
    within MESH_TOL of their scale and the greedy tokens equal; bf16 logits
    and caches by ``share_rule`` and the greedy tokens where the margin is
    clear (``held_logits``).  MoE: the
    mesh run's router logits against the CPU's fp32 product on the same
    tokens and weights (``router_log``); in bf16 the one-process run follows
    the mesh run's expert choices, and those it would make otherwise must be
    a few near-ties (``phase_parity``: router near-ties flip between the
    ranks' partial sums and one process's).  ``tokens``: the prompts' (B, S);
    ``layout``: the K/V layout the mesh run must have taken."""
    import torch.distributed as dist
    from repro_torch.configs import MOE
    from repro_torch.models import init_params
    from repro_torch.sharding import ACT_SEQ
    moe = cfg.family == MOE
    fields = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ACT_SEQ[0] = act_seq
        calls = [] if moe else None
        routes = {} if moe and dtype == torch.bfloat16 else None
        try:
            params = mesh_params(cfg, mesh, rank, dtype)
            t0 = time.time()
            got, cache, took = serve_calls(cfg, params, mesh, calls, routes, tokens)
            fields[f"{name}_mesh_seconds"] = time.time() - t0
            fields["kv_layout"] = took
            check(layout is None or took == layout, f"parity_serve_mesh {cfg.name}: the "
                  f"cache took the {took} layout, not {layout}")
        finally:
            ACT_SEQ[0] = False
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if moe:
            fields[f"router_logits_{name}_max_rel_err"] = check_router_logits(
                calls, f"parity_serve_mesh {cfg.name} {name}")
        if rank == 0:
            t0 = time.time()
            want, want_cache, _ = serve_calls(cfg, init_params(cfg, seed=0, device="cuda",
                                                               dtype=dtype),
                                              routes=routes, tokens=tokens)
            if routes is not None:
                fields["router_bf16"] = check_near_ties(routes, f"parity_serve_mesh {cfg.name}")
            fields[f"{name}_one_process_seconds"] = time.time() - t0
            gc.collect()
            torch.cuda.empty_cache()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  f"parity_serve_mesh {cfg.name} {name}: logits {tuple(got.shape)}")
            check(sorted(cache) == sorted(want_cache), f"parity_serve_mesh {cfg.name}: "
                  f"cache fields {sorted(cache)} vs {sorted(want_cache)}")
            if dtype == torch.float32:
                worst = [mesh_held(got[i], want[i], f"{cfg.name} fp32 call {i}")
                         for i in range(got.shape[0])]
                worst += [mesh_held(cache[f], want_cache[f], f"{cfg.name} fp32 cache {f}")
                          for f in want_cache]
                same = bool((got.argmax(-1) == want.argmax(-1)).all())
                check(same, f"parity_serve_mesh {cfg.name} fp32: greedy tokens differ")
                fields.update(fp32_max_rel_err=max(worst), fp32_greedy_tokens_equal=same)
            else:
                greedy = held_logits(got, want)
                check(greedy["clear_margin_tokens_equal"], f"parity_serve_mesh {cfg.name} "
                      "bf16: greedy token differs at a clear margin")
                shares = {f"call_{i}": share_rule(got[i], want[i], f"{cfg.name} bf16 call {i}")
                          for i in range(got.shape[0])}
                shares.update({f: share_rule(cache[f], want_cache[f], f"{cfg.name} bf16 "
                                             f"cache {f}") for f in want_cache})
                fields.update(bf16_share_rule=shares, bf16_tokens_equal=greedy["tokens_equal"],
                              bf16_clear_margin_tokens=greedy["clear_margin_tokens"])
        dist.barrier()
    b, s = tokens
    return dict(rank=rank, calls=f"prefill({b}x{s}) + {PARITY_SERVE_STEPS} decode steps",
                **fields)


def mesh_kvseq_parity_run(cfg, mesh, act_seq, rank, refs):
    """``mesh_serve_parity_run`` at a batch of 1, where the cache takes the
    kvseq layout."""
    return mesh_serve_parity_run(cfg, mesh, act_seq, rank, refs, tokens=PARITY_KVSEQ_TOKENS,
                                 layout="kvseq")


def mesh_kvseq_serve_run(cfg, mesh, act_seq, rank, refs):
    """``cfg`` at published size under ``mesh``, batch 1: a prefill of
    KVSEQ_PROMPT tokens (seed 0), its cache grown to KVSEQ_ROWS rows in the
    kvseq layout (``grow_cache``), then KVSEQ_NEW greedy decode steps.
    Each rank's prefill and decode seconds, tokens/s, peak memory, launches
    (set to 0 just before each part, read just after: the flash kernel once
    a layer for the prefill, the slice kernel once a layer and step for the
    decode, nothing else) and the collectives' operand bytes per decode
    call (``comm.collective_bytes``); every rank's tokens the same."""
    import torch.distributed as dist
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import decode_step
    from repro_torch.models import prefill
    from repro_torch.models.model import kv_rows
    from repro_torch.sharding import comm
    from repro_torch.sharding import use_mesh
    params = mesh_params(cfg, mesh, rank)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab, size=(1, KVSEQ_PROMPT)), device="cuda")
    n_attn, _ = kernel_layers(cfg)
    none = {k: 0 for k in launch_counts()}
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), use_mesh(mesh):
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        logits, cache = prefill(params, prompt, cfg)
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        prefill_counts = launch_counts()
        check(kv_rows(cache) == KVSEQ_PROMPT, f"serve_kvseq {cfg.name}: the prefill's cache "
              "is not in the kvseq layout")
        cache = grow_cache(cache, cfg, 1, KVSEQ_ROWS)
        local_rows = cache.k.shape[2]
        tokens = [int(logits[0].argmax())]
        dist.barrier()
        reset_launch_counts()
        comm.reset_collective_bytes()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(KVSEQ_NEW):
            tok = torch.tensor([[tokens[-1]]], device="cuda")
            logits, cache = decode_step(params, tok, cache, cfg)
            tokens.append(int(logits[0, 0].argmax()))
        torch.cuda.synchronize()
        decode_s = time.time() - t0
        counts = launch_counts()
        coll = comm.collective_bytes()
    check(prefill_counts == dict(none, flash_attention=n_attn),
          f"serve_kvseq {cfg.name} rank {rank}: prefill launches {prefill_counts}")
    check(counts == dict(none, decode_attention_lse=n_attn * KVSEQ_NEW),
          f"serve_kvseq {cfg.name} rank {rank}: decode launches {counts}")
    every = [None] * MESH_RANKS
    dist.all_gather_object(every, tokens)
    same = all(t == every[0] for t in every)
    check(same, f"serve_kvseq {cfg.name} rank {rank}: the ranks drew different tokens")
    check(all(0 <= t < cfg.vocab for t in tokens), f"serve_kvseq {cfg.name}: {tokens}")
    peak = torch.cuda.max_memory_allocated()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rank=rank, prompt=KVSEQ_PROMPT, cache_rows=KVSEQ_ROWS, local_rows=local_rows,
                new_tokens=KVSEQ_NEW, prefill_seconds=prefill_s, decode_seconds=decode_s,
                tokens_per_s=KVSEQ_NEW / decode_s, prefill_launches=prefill_counts,
                launches=counts, collective_bytes_per_call={k: v / KVSEQ_NEW
                                                            for k, v in coll.items()},
                tokens=tokens, tokens_same_on_every_rank=same, peak_memory_bytes=peak)


def mesh_reference(cfg, tokens, dense):
    """The one-process side of ``mesh_parity_run`` on the card, kept there
    for the comparisons: the fp32 step's loss, gradient norm and parameters,
    and (dense) the bf16 loss and gradients in fp32."""
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig
    from repro_torch.train import init_train_state
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.tree import flatten_with_keys
    t0 = time.time()
    one = init_train_state(init_params(cfg, seed=0, device="cuda", dtype=torch.float32))
    one, met = make_train_step(cfg, AdamWConfig(**MESH_PARITY_OPT), device="cuda")(one, tokens)
    ref = dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
               params=dict(flatten_with_keys(one.params)))
    del one
    if dense:
        params = init_params(cfg, seed=0, device="cuda")
        loss, grads = loss_and_grads(params, tokens, cfg)
        ref.update(bf16_loss=float(loss), bf16_grads={
            k: g.float() for (k, _), g in zip(flatten_with_keys(params), grads)})
        del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    ref["seconds"] = time.time() - t0
    return ref


# each mesh phase: its runs (arch, layers or config changes, (data, model),
# ACT_SEQ) and the function that runs one on a rank
MESH_PHASES = {"train_mesh": (MESH_RUNS, mesh_train_run),
               "parity_train_mesh": (MESH_RUNS, mesh_parity_run),
               "serve_mesh": (SERVE_MESH_RUNS, mesh_serve_run),
               "parity_serve_mesh": (PARITY_SERVE_MESH_RUNS, mesh_serve_parity_run),
               "serve_kvseq": (SERVE_KVSEQ_RUNS, mesh_kvseq_serve_run),
               "parity_serve_kvseq": (PARITY_KVSEQ_RUNS, mesh_kvseq_parity_run)}


def phase_mesh(phases):
    """The mesh phases asked for, run by one start of MESH_RANKS ranks on the
    one card (``run_mesh_children``).  ``train_mesh``: every layout of
    MESH_RUNS trained (``mesh_train_run``); its lines hold each rank's step
    seconds and peak memory.  ``parity_train_mesh``: every layout's step
    against one process (``mesh_parity_run``).  ``serve_mesh``: each path of
    SERVE_MESH_RUNS served (``mesh_serve_run``), each rank's tokens/s, decode
    calls, peak memory and launches.  ``parity_serve_mesh``: each cut of
    PARITY_SERVE_MESH_RUNS against one process (``mesh_serve_parity_run``).
    Two ranks on one card show correctness and per-rank memory, not
    multi-card speed: the collectives go through gloo and the host, not
    NVLink and NCCL."""
    # the children share the card with this process: give back what its
    # earlier phases left in PyTorch's cache
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    ranks = run_mesh_children(phases)
    for phase in phases:
        for i, (arch, cut, shape, act_seq) in enumerate(MESH_PHASES[phase][0]):
            cfg = mesh_cfg(arch, cut)
            head = dict(arch=arch, n_layers=cfg.n_layers, mesh=list(shape), act_seq=act_seq)
            if phase in ("train_mesh", "serve_mesh", "serve_kvseq"):
                emit(phase, **head, d_model=cfg.d_model, dtype="bfloat16", backend="gloo",
                     ranks=[r[phase][i] for r in ranks],
                     phase_seconds=ranks[0][phase + "_seconds"], parent_reserved_bytes=held)
            elif phase in ("parity_serve_mesh", "parity_serve_kvseq"):
                emit(phase, **head, changed=cut if isinstance(cut, dict) else {},
                     tol_fp32=MESH_TOL, tol_bf16=LOGIT_TOL,
                     phase_seconds=ranks[0][phase + "_seconds"], **ranks[0][phase][i])
            else:
                emit(phase, **head, tol_fp32=MESH_TOL, grad_share_tol_bf16=GRAD_SHARE_TOL,
                     loss_tol_bf16=LOGIT_TOL, phase_seconds=ranks[0][phase + "_seconds"],
                     **ranks[0][phase][i])
    return ranks


# ---------------------------------------------------------------------------
def phase_dryrun():
    """The dry run of every (arch x shape x mesh) cell on the production
    meshes (``launch/dryrun.py``, on the host: shapes only, no device): the
    K/V layout, one rank's argument bytes and the roofline terms with the
    H100's constants; 64 cells ok and the 16 full-attention long_500k cells
    skipped."""
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import run_cell
    t0 = time.time()
    rows = []
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                rec = run_cell(arch, shape, mesh)
                row = [arch, shape, mesh, rec["status"]]
                if rec["status"] == "ok":
                    rf = rec["roofline"]
                    row += [rec["kv_layout"], rec["argument_size_in_bytes"], rf["t_compute"],
                            rf["t_memory"], rf["bottleneck"]]
                else:
                    row.append(rec["reason"])
                rows.append(row)
    n_ok = sum(r[3] == "ok" for r in rows)
    check(len(rows) == 80 and n_ok == 64, f"dryrun: {n_ok} of {len(rows)} cells ok")
    emit("dryrun", ran_on="host", cells=len(rows), ok=n_ok, skipped=len(rows) - n_ok,
         columns=["arch", "shape", "mesh", "status", "kv_layout", "argument_bytes_per_rank",
                  "t_compute_s", "t_memory_s", "bottleneck"], table=rows,
         seconds=time.time() - t0)


# ---------------------------------------------------------------------------
REPLAY_REQUESTS = 5000        # the replay benchmark's budget check (N_SMOKE)
REPLAY_LLC_BYTES = 128 * 1024  # its LLC: about the live KV of a full batch
FIT_MIN_R2 = 0.80             # tests/test_analytical.py's validation floor
FIT_MIN_TAU = 0.65


def start_simulator():
    """``phase_simulator`` in a process of its own (it needs no card), its
    lines held back for ``finish_simulator``; killed at exit if still
    running."""
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--simulator-child"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def finish_simulator(proc):
    """Wait for ``start_simulator``'s process and print its lines."""
    out, err = proc.communicate()
    sys.stdout.write(out)
    sys.stdout.flush()
    check(proc.returncode == 0, f"simulator phase failed (exit {proc.returncode}): "
          f"{err[-3000:]}")


def phase_simulator():
    """The cache-simulator stack on the host: the conformance matrix against
    the frozen digests, a serving replay, and the analytical fit."""
    from repro_torch.conformance import load_golden
    from repro_torch.conformance import matrix_entries
    from repro_torch.conformance import run_matrix
    from repro_torch.core import SimConfig
    from repro_torch.core import fit_params
    from repro_torch.core import kendall_tau
    from repro_torch.core import named_policy
    from repro_torch.core import predict
    from repro_torch.core import r_squared
    from repro_torch.core import run_policies
    from repro_torch.dataflows import SUITE_POLICIES
    from repro_torch.dataflows import lower_to_counts
    from repro_torch.dataflows import lower_to_trace
    from repro_torch.dataflows import registry_keys
    from repro_torch.dataflows import suite_case
    from repro_torch.serve.replay import run_replay
    from repro_torch.serve.traffic import TrafficConfig

    golden = load_golden()
    check(golden is not None, "simulator: tests/golden/conformance_digests.json is "
          "missing or of another event schema")
    entries = list(matrix_entries())
    t0 = time.time()
    cells = run_matrix(entries, golden=golden)
    matrix_s = time.time() - t0
    failed = [f"{c.scenario}/{c.policy}: {c.failure}" for c in cells if not c.ok]
    check(not failed, f"simulator: conformance cells failed: {failed}")
    equal = sum(c.digest == golden[f"{c.scenario}/{c.policy}"] for c in cells)
    check(len(cells) == len(entries) == equal, f"simulator: {equal} of {len(entries)} "
          "cells equal their frozen digests")

    traffic = TrafficConfig(n_requests=REPLAY_REQUESTS)
    replay = {}
    t0 = time.time()
    for pol in ("lru", "all"):
        res = run_replay(traffic, pol, SimConfig(llc_bytes=REPLAY_LLC_BYTES))
        check(res.slo["completed"]["n"] == REPLAY_REQUESTS and res.rounds > 0,
              f"simulator: replay under {pol} completed {res.slo['completed']}")
        check(all(np.isfinite(v) for m in ("ttft_ms", "tpot_ms") for v in res.slo[m].values()),
              f"simulator: replay under {pol}: SLO metrics not finite: {res.slo}")
        replay[pol] = dict(slo=res.slo, rounds=res.rounds, segments=res.segments,
                           hit_rate=res.sim.hit_rate, cycles=res.sim.cycles)
    replay_s = time.time() - t0

    t0 = time.time()
    points = []
    for key in registry_keys():
        case = suite_case(key)
        counts = lower_to_counts(case.spec)
        results = run_policies(lower_to_trace(case.spec),
                               [named_policy(p, gqa=case.gqa) for p in SUITE_POLICIES],
                               case.cfg, record_history=False)
        points += [(counts, case.cfg.llc_bytes, p, "optimal", case.gqa, counts.n_rounds,
                    r.cycles) for p, r in zip(SUITE_POLICIES, results)]
    hw = suite_case(registry_keys()[0]).cfg
    params = fit_params(points, hw)
    pred = np.array([predict(c, llc, p, hw, params, v, g, n_rounds=n).cycles
                     for c, llc, p, v, g, n, _ in points])
    target = np.array([t for *_, t in points])
    r2, tau = r_squared(pred, target), kendall_tau(pred, target)
    fit_s = time.time() - t0
    check(bool(np.isfinite(pred).all() and (pred > 0).all()), "simulator: a prediction is "
          "not a positive finite cycle count")
    check(r2 >= FIT_MIN_R2 and tau >= FIT_MIN_TAU, f"simulator: fit R^2 {r2:.4f}, tau "
          f"{tau:.4f} below {FIT_MIN_R2} / {FIT_MIN_TAU}")
    emit("simulator", ran_on="host", cells=len(cells), cells_equal=equal,
         events=sum(c.n_events for c in cells), matrix_seconds=matrix_s,
         replay_requests=REPLAY_REQUESTS, replay_llc_bytes=REPLAY_LLC_BYTES,
         replay=replay, replay_seconds=replay_s, fit_points=len(points),
         fit_params=dict(theta1=params.theta1, theta2=params.theta2, theta3=params.theta3,
                         lam=params.lam, round_overhead=params.round_overhead),
         fit_r2=r2, fit_kendall_tau=tau, fit_seconds=fit_s)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--requests", type=int, default=16, help="llama3.2-3b requests")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--build-log", metavar="PATH",
                    help="pass -Xptxas -v to nvcc and write its output to PATH")
    # the simulator phase, started by start_simulator
    ap.add_argument("--simulator-child", action="store_true", help=argparse.SUPPRESS)
    # one rank of a mesh phase, started by run_mesh_children
    ap.add_argument("--mesh-child", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_child:
        mesh_child(args.mesh_child.split(","), args.mesh_rank, Path(args.mesh_dir))
        return
    if args.simulator_child:
        phase_simulator()
        return
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
    ptxas, sass = timed("build", phase_build, args.build_log)
    simulator = start_simulator() if "simulator" in phases else None
    records = timed("kernels", phase_kernels, ptxas) if "kernels" in phases else []
    if "kernels_positions" in phases:
        records += timed("kernels_positions", phase_kernels_positions, ptxas)
    timed("flash_sass", finish_flash_sass, sass)
    pos_counts = None
    for arch, path in PATHS.items():   # in the order of PHASES
        n_requests = args.requests if arch == "llama3.2-3b" else PATH_REQUESTS
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
        if arch == "qwen2-vl-7b" and "serve_positions" in phases:
            pos_counts = timed("serve_positions", phase_serve_positions, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "serve_positions" in phases and pos_counts is None:   # qwen2-vl-7b not served
        pos_counts = timed("serve_positions", phase_serve_positions)
    for rec in records:
        if rec["path"] == "serve_positions" and pos_counts is not None:
            rec["launches"] = pos_counts[rec["name"]]
            check(rec["launches"] > 0, f"{rec['name']} was not launched by serve_positions")
    if "parity_positions" in phases:
        timed("parity_positions", phase_parity_positions)
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
    mesh_phases = [p for p in MESH_PHASES if p in phases]
    if mesh_phases:
        ranks = timed(",".join(mesh_phases), phase_mesh, mesh_phases)
        for rec in records:
            if rec["path"] in mesh_phases:
                # the first run's rank 0 (the other rank launches as many)
                rec["launches"] = ranks[0][rec["path"]][0]["launches"][rec["name"]]
                check(rec["launches"] > 0, f"{rec['name']} was not launched by the "
                      f"{rec['path']} run")
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun)
    if simulator is not None:
        timed("simulator", finish_simulator, simulator)
    if "examples" in phases:
        timed("examples", phase_examples)
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
