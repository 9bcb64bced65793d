#!/usr/bin/env python3
"""How far bf16 logits of the card and of the CPU drift apart with depth.

    python3 scripts/parity_depth.py            # on one CUDA device

For cuts of mamba2-2.7b (2 and 7 layers) and zamba2-7b (one group of 6
Mamba2 layers, the shared block and one tail layer: 7) at full width, with
random weights (seed 0), the calls of ``chip_smoke.py``'s parity phases
(prefill of 2 x 64 tokens + 4 decode steps) run four ways: on the card with
the kernels, on the card with the plain versions of the three kernels
(``chip_smoke.plain_versions``), on the CPU, each in bf16, and on the card
and the CPU in fp32.  One JSON line a cut gives, for each pair, the share of
logits within rtol = atol = 3e-2, the RMS error and the largest error; the
last two lines are the card's name and power limit and the device record.
"""

from __future__ import annotations

from dataclasses import replace
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke
import numpy as np
from repro_torch.configs import get_arch
from repro_torch.models import decode_step
from repro_torch.models import init_params
from repro_torch.models import prefill
import torch

TOL = 3e-2
CUTS = (("mamba2-2.7b", 2), ("mamba2-2.7b", 7), ("zamba2-7b", 7))


def to(tree, dev, dtype):
    return {k: to(v, dev, dtype) if isinstance(v, dict) else
            v.to(device=dev, dtype=torch.float32 if v.dtype == torch.float32 else dtype)
            for k, v in tree.items()}


def run(params, cfg, prompt, steps, dev, dtype):
    p = to(params, dev, dtype)
    kw = {} if cfg.family == "ssm" else {"pinned_rows": prompt.shape[1]}
    got, cache = prefill(p, torch.as_tensor(prompt, device=dev), cfg, **kw)
    if cache.k is not None:
        pad = torch.zeros_like(cache.k[:, :, :4])
        cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    outs = [got]
    for tok in steps:
        got, cache = decode_step(p, torch.as_tensor(tok, device=dev), cache, cfg)
        outs.append(got[:, 0])
    return torch.stack(outs).float().cpu()


def apart(a, b):
    err = (a - b).abs()
    return {"share_within_tol": float((err <= TOL + TOL * b.abs()).float().mean()),
            "rms_err": float(err.square().mean().sqrt()), "max_abs_err": float(err.max())}


def main() -> None:
    smi = chip_smoke.phase_device()
    for name, n_layers in CUTS:
        cfg = replace(get_arch(name), n_layers=n_layers)
        params = init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(1)
        prompt = rng.integers(2, cfg.vocab, size=(2, 64))
        steps = rng.integers(2, cfg.vocab, size=(4, 2, 1))
        bf = torch.bfloat16
        kernels = run(params, cfg, prompt, steps, "cuda", bf)
        with chip_smoke.plain_versions():
            plain = run(params, cfg, prompt, steps, "cuda", bf)
        cpu = run(params, cfg, prompt, steps, "cpu", bf)
        fp32 = apart(run(params, cfg, prompt, steps, "cuda", torch.float32),
                     run(params, cfg, prompt, steps, "cpu", torch.float32))
        print(json.dumps({"arch": name, "n_layers": n_layers,
                          "bf16_kernels_vs_cpu": apart(kernels, cpu),
                          "bf16_card_plain_vs_cpu": apart(plain, cpu),
                          "bf16_kernels_vs_card_plain": apart(kernels, plain),
                          "fp32_kernels_vs_cpu": fp32}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
