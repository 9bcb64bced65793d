#!/usr/bin/env python
"""Where a serving step of the PyTorch/CUDA port spends its time on the card.

Builds llama3.2-3b, mamba2-2.7b, deepseek-moe-16b or gemma2-27b at full width
and depth (random bf16 weights) behind the ``ServeEngine`` pool that
``chip_smoke.py`` serves it with (its ``PATHS`` entry: ``max_batch=8,
max_seq=2048``, gemma2-27b ``max_batch=4, max_seq=6144``), fills every slot
with prompts drawn as there (the entry's fixed lengths where they fall on a
slot: gemma2-27b's third prompt is 4160 tokens long, past its 4096-row
window), runs a few engine steps to warm up, then
traces a window of steps with ``torch.profiler`` and prints one JSON object:
wall time of the window, device-busy time and idle share, ``decode_step``
calls, and the kernels that took most device time.

    python scripts/torch_serve_profile.py [--arch mamba2-2.7b] [--steps 4] [--layers N]
    python scripts/torch_serve_profile.py --arch deepseek-moe-16b
    python scripts/torch_serve_profile.py --arch gemma2-27b

Needs one CUDA device and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

import argparse
from dataclasses import replace
import json
from pathlib import Path
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import PATHS
# the port
from repro_torch.configs import SSM
from repro_torch.configs import get_arch
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.models import init_params
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=["llama3.2-3b", "mamba2-2.7b", "deepseek-moe-16b", "gemma2-27b"])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--layers", type=int, help="cut the depth (default: published)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs one CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    cfg = get_arch(args.arch)
    cfg = replace(cfg, n_layers=args.layers or cfg.n_layers)
    params = init_params(cfg, seed=0, device="cuda")
    path = PATHS[args.arch]
    max_batch, max_seq = path.get("max_batch", 8), path.get("max_seq", 2048)
    engine = ServeEngine(cfg, params, max_batch=max_batch, max_seq=max_seq, device="cuda")
    rng = np.random.default_rng(0)
    fixed = path.get("fixed_prompt_lens", {})
    for i in range(max_batch):
        # an SSM prompt keeps the reference's chunk rule (S <= chunk here)
        plen = int(rng.integers(3, 257) if cfg.family == SSM else rng.integers(64, 1025))
        plen = fixed.get(i, plen)
        prompt = rng.integers(2, cfg.vocab, size=plen).astype(np.int32)
        engine.add_request(Request(uid=i, prompt=prompt, max_new_tokens=10_000))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()

    reset_launch_counts()
    calls0 = engine.decode_calls
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    calls = engine.decode_calls - calls0
    print(json.dumps({
        "card": smi, "arch": cfg.name, "n_layers": cfg.n_layers,
        "engine_steps": args.steps, "decode_step_calls": calls,
        "window_wall_ms": wall_ms, "wall_ms_per_decode_step_call": wall_ms / calls,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "device_kernel_launches": sum(r[2] for r in rows),
        "launches": launch_counts(),
        "top_device_kernels": [
            {"name": k[:80], "ms": ms, "count": n} for k, ms, n in rows[:12]],
    }, indent=1))


if __name__ == "__main__":
    main()
