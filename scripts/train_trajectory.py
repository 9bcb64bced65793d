#!/usr/bin/env python3
"""The loss and gradient norm of each step of a short training run on the
card, with the kernels or with their plain versions, at one or more
learning rates: whether a rise of the loss comes from the kernels or from
the model and optimizer at that rate.

    python3 scripts/train_trajectory.py --arch zamba2-7b --layers 45
    python3 scripts/train_trajectory.py --arch deepseek-moe-16b --layers 7 \\
        --lr 3e-3,1e-3,3e-4 --steps 6 --warmup 2

For each learning rate the model is drawn at full width (bf16, seed 0),
``--layers`` deep (default: the published depth), and trained ``--steps``
steps on ``SyntheticLM`` batches of 8 x 512 tokens with ``remat=True`` and
``AdamWConfig(lr, warmup_steps, total_steps=steps)``, the warmup
``launch/train.py``'s ``min(50, steps // 10)`` unless ``--warmup`` is given:
once through the kernels, and, with ``--plain``, once more with the model's
kernel calls routed to their plain versions (``chip_smoke.plain_versions``:
``attention_ref`` and ``ssd_ref``, differentiated by autograd) from the same
weights and batches.  One JSON line a run; the last line is the card's
name and power limit.
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext
from dataclasses import replace
import gc
import json
from pathlib import Path
import subprocess
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke
# the port
from repro_torch.configs import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig
from repro_torch.train import init_train_state
from repro_torch.train import make_train_step


def run(cfg, lr, warmup, steps, plain):
    """{"loss": [...], "grad_norm": [...], "lr": [...]} of ``steps`` steps."""
    state = init_train_state(init_params(cfg, seed=0, device="cuda"))
    opt = AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    step = make_train_step(cfg, opt, device="cuda")
    data = SyntheticLM(cfg.vocab, 512, 8)
    out = {"loss": [], "grad_norm": [], "lr": []}
    with chip_smoke.plain_versions() if plain else nullcontext():
        for i in range(steps):
            state, metrics = step(state, data.batch(i))
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
            out["lr"].append(float(metrics["lr"]))
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--layers", type=int, help="cut the depth (default: published)")
    ap.add_argument("--lr", default="3e-3", help="comma-separated learning rates")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int,
                    help="warmup steps (default: launch/train.py's min(50, steps // 10))")
    ap.add_argument("--plain", action="store_true",
                    help="also run each rate through the kernels' plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_trajectory: needs one CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_arch(args.arch)
    cfg = replace(cfg, n_layers=args.layers or cfg.n_layers)
    warmup = args.warmup if args.warmup is not None else min(50, args.steps // 10)
    for lr in (float(x) for x in args.lr.split(",")):
        for plain in (False, True) if args.plain else (False,):
            print(json.dumps({"arch": cfg.name, "n_layers": cfg.n_layers, "peak_lr": lr,
                              "warmup_steps": warmup, "steps": args.steps,
                              "attention_and_scan": "plain" if plain else "kernels",
                              **run(cfg, lr, warmup, args.steps, plain)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
