#!/usr/bin/env python
"""Where a training step of the PyTorch/CUDA port spends its time on the card.

Builds ``--arch`` (llama3.2-3b unless given; mamba2-2.7b is the SSM family)
at full width and depth (random bf16 weights, seed 0) and the train step of
``chip_smoke.py``'s train phases (``SyntheticLM`` batches of 8 x 512 tokens,
``remat=True``, one microbatch unless ``--microbatches``), runs two steps to
warm up, then traces ``--steps`` steps with ``torch.profiler`` and prints one
JSON object: wall time per step, device-busy time and idle share, and device
time by kind of kernel: the flash forward (the forward and its recomputation
under remat: ``flash_mma_lse_kernel``), the flash backward (``delta_kernel``
and the dK/dV and dQ kernels), the SSD forward and its recomputation
(``ssd_scan_kernel``), the SSD backward (its tile preparation, three walks,
dcum scan and head sums), the weight products (cuBLAS's GEMM kernels) and everything else
(elementwise, reductions, the embedding's backward, copies).  Beside it, timed alone with
CUDA events on the same state: ``adamw_update`` on gradients of the
parameters' shapes, and ``lm_loss`` forward + backward on logits of the
step's shape (with a final softcap, as gemma2-27b's ``lm_logits`` applies
it, also timed with the cap before the loss).

    python scripts/torch_train_profile.py [--arch mamba2-2.7b] [--steps 2] [--layers N]
        [--microbatches 2]

Needs one CUDA device and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

import argparse
from dataclasses import replace
import json
from pathlib import Path
import re
import subprocess
import sys
import time

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# the port
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.models import init_params
from repro_torch.models import lm_loss
from repro_torch.train import AdamWConfig
from repro_torch.train import adamw_update
from repro_torch.train import init_train_state
from repro_torch.train import make_train_step
from repro_torch.tree import tree_map

KINDS = (("flash_forward", re.compile(r"flash_mma")),
         ("flash_backward", re.compile(r"dkdv_|dq_(mma_)?(ext_)?kernel|delta_kernel")),
         ("ssd_forward", re.compile(r"ssd_scan_kernel")),
         ("ssd_backward", re.compile(r"prep_kernel|[cbx]_walk_kernel|scan_kernel\(|"
                                     r"head_sum_kernel")),
         ("weight_products", re.compile(r"gemm|nvjet|xmma|cutlass|s16816|Kernel2")))


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if pattern.search(name):
            return kind
    return "other"


def events_ms(fn, reps: int = 3) -> float:
    """Device milliseconds of one ``fn()``, the median of ``reps``."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, help="cut the depth (default: published)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    cfg = get_arch(args.arch)
    cfg = replace(cfg, n_layers=args.layers or cfg.n_layers)
    state = init_train_state(init_params(cfg, seed=0, device="cuda"))
    opt = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=100)
    step = make_train_step(cfg, opt, microbatches=args.microbatches, device="cuda")
    data = SyntheticLM(cfg.vocab, args.seq, args.batch)
    for i in range(2):
        state, _ = step(state, data.batch(i))
    torch.cuda.synchronize()

    reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        for i in range(args.steps):
            state, metrics = step(state, data.batch(2 + i))
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    by_kind = {}
    for name, ms, n in rows:
        k = by_kind.setdefault(kind_of(name), {"ms_per_step": 0.0, "launches_per_step": 0})
        k["ms_per_step"] += ms / args.steps
        k["launches_per_step"] += n / args.steps
    rows.sort(key=lambda r: -r[1])
    launches = launch_counts()
    del prof

    # the optimizer and the loss alone, on the same state
    grads = tree_map(lambda p: torch.randn_like(p) * 1e-3, state.params)
    adamw_ms = events_ms(lambda: adamw_update(opt, state.params, grads, state.opt))
    del grads
    logits = torch.randn(args.batch, args.seq, cfg.vocab, device="cuda",
                         dtype=torch.bfloat16).requires_grad_()
    tokens = torch.as_tensor(data.batch(0), device="cuda").long()
    loss_ms = events_ms(lambda: torch.autograd.grad(lm_loss(logits, tokens), logits))
    cap = cfg.final_softcap
    capped_ms = events_ms(lambda: torch.autograd.grad(
        lm_loss(torch.tanh(logits / cap) * cap, tokens), logits)) if cap else None
    del logits

    print(json.dumps({
        "card": smi, "arch": cfg.name, "n_layers": cfg.n_layers, "batch": args.batch,
        "seq": args.seq, "microbatches": args.microbatches, "steps": args.steps,
        "loss": float(metrics["loss"]),
        "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "device_ms_by_kind": by_kind,
        "adamw_update_ms_alone": adamw_ms,
        "lm_loss_fwd_bwd_ms_alone": loss_ms,
        **({"lm_loss_with_final_softcap_fwd_bwd_ms_alone": capped_ms} if cap else {}),
        "launches": launches,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_step": ms / args.steps, "count": n}
            for k, ms, n in rows[:15]],
    }, indent=1))


if __name__ == "__main__":
    main()
