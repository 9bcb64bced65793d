"""Serving launcher: batched requests through the ServeEngine.

Runs on the card unless ``--device cpu`` is given.  ``--reduce`` (the
default, as in the JAX package's launcher) shrinks the architecture to a
smoke size; ``--full`` (or ``--no-reduce``) serves the published widths and
depth, which the JAX launcher's ``store_true, default=True`` flag cannot
switch on.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --full --requests 6 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b --device cpu

The prompts are 4 to 23 tokens long, which every architecture's SSD chunk
rule accepts (S <= chunk, so chunk = S), the hybrid zamba2-7b's too; they
stay inside gemma2-27b's window (4096 rows; 64 reduced), which the local
layers apply all the same.  gemma2-27b at full size takes 56.8 GB of bf16
weights: it fits one 80 GB card.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional
from typing import Sequence

import numpy as np
import torch

from .. import require_device
from ..configs import get_arch
from ..configs import reduce_for_smoke
from ..models import init_params
from ..serve import Request
from ..serve import ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduce", dest="reduce", action="store_true", default=True,
                    help="shrink the architecture to a smoke size (default)")
    ap.add_argument("--no-reduce", "--full", dest="reduce", action="store_false",
                    help="serve the architecture at full width and depth")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = require_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduce:
        cfg = reduce_for_smoke(cfg)
    params = init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, max_batch=args.max_batch,
                         max_seq=args.max_seq, device=device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(2, cfg.vocab, size=plen).astype(np.int32)
        req = Request(uid=i, prompt=prompt, max_new_tokens=args.max_new)
        engine.add_request(req)
        reqs.append(req)

    t0 = time.time()
    steps = 0
    while any(not r.done for r in reqs):
        engine.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(r.tokens_out) for r in reqs)
    for r in reqs:
        print(f"req {r.uid}: prompt_len={len(r.prompt)} -> {r.tokens_out}")
    print(f"{args.requests} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {steps} engine steps, "
          f"slot reuse via dead-block retirement) on {device}")


if __name__ == "__main__":
    main()
