"""Training driver: synthetic-data LM training with checkpointing,
auto-resume and the straggler watchdog, as the JAX package's
``launch/train.py`` (same flags and log lines).

Runs on the card unless ``--device cpu`` is given; there is no fallback.  On
the card attention's gradient is the hand-written flash backward kernel,
which takes the dense family (causal, head_dim 64 or 128, no window or
softcap); another architecture raises there before its first step.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train --reduce --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 100 --batch 8 --seq 512 --microbatches 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional
from typing import Sequence

import torch

from .. import require_device
from ..checkpoint import CheckpointManager
from ..configs import get_arch
from ..configs import reduce_for_smoke
from ..data import SyntheticLM
from ..models import init_params
from ..train import AdamWConfig
from ..train import StepTimer
from ..train import StepWatchdog
from ..train import init_train_state
from ..train import make_train_step
from ..tree import leaves


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduce", action="store_true",
                    help="smoke-reduced config (CPU-sized)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    cfg = get_arch(args.arch)
    if args.reduce:
        cfg = reduce_for_smoke(cfg)
    changes = {}
    if args.d_model:
        changes.update(d_model=args.d_model,
                       d_ff=4 * args.d_model if cfg.d_ff else 0,
                       head_dim=args.d_model // max(cfg.n_heads, 1)
                       if cfg.n_heads else 0)
    if args.layers:
        changes["n_layers"] = args.layers
    if changes:
        cfg = dataclasses.replace(cfg, **changes)

    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    state = init_train_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches, device=dev)
    data = SyntheticLM(cfg.vocab, args.seq, args.batch)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        restored = mgr.restore_latest(state)
        if restored is not None:
            start_step, state = restored
            print(f"resumed from step {start_step}")

    watchdog = StepWatchdog(
        on_straggler=lambda s, d: print(
            f"[watchdog] step {s}: {d:.2f}s — straggler policy engaged "
            f"(log/alert; evict+elastic-restart on real cluster)"))

    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch(step)
        with StepTimer() as t:
            state, metrics = step_fn(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        watchdog.record(step, t.elapsed)
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / t.elapsed
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"{t.elapsed * 1e3:.0f}ms {tok_s:.0f} tok/s")
        if mgr and step and step % args.ckpt_every == 0:
            mgr.save(step, state)
    if mgr:
        mgr.save(args.steps, state)
    print(f"done in {time.time() - t_start:.1f}s "
          f"(stragglers flagged: {len(watchdog.flagged_steps)})")


if __name__ == "__main__":
    main()
