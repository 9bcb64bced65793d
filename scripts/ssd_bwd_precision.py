#!/usr/bin/env python
"""How far an fp32 SSD scan's gradients lie from a float64 scan's, on the
card and on the CPU: what ``chip_smoke.py``'s ``parity_train_ssm`` rests on.

mamba2-2.7b's 2-layer cut at full width (fp32 weights, seed 0) takes one
``loss_and_grads`` on 2 x 256 ``SyntheticLM`` tokens four ways: on the card
with the kernels (``card``), on the card with the scan as the plain chunked
scan in float64 (``card64``), on the CPU in fp32 (``cpu``), and on the CPU
with the float64 scan (``cpu64``, ``chip_smoke.scan_fp64``).  Prints, for
each pair, the loss difference and every gradient leaf's max |a - b| / max
|b| above 1e-5, then one JSON object with all of them and the card.
``card`` against ``card64`` is the kernel's own rounding on the same inputs,
``cpu`` against ``cpu64`` the plain version's.

    python scripts/ssd_bwd_precision.py

Needs one CUDA device and nvcc (the kernels are built at first use).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import replace
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
from repro_torch.train.loop import loss_and_grads
from repro_torch.tree import flatten_with_keys
from repro_torch.tree import unflatten


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_precision: needs one CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg2 = replace(get_arch("mamba2-2.7b"), n_layers=2)
    tokens = SyntheticLM(cfg2.vocab, 256, 2).batch(0)

    def grads(dev, s64):
        params = chip_smoke.train_parity_params(cfg2, dev, torch.float32)
        with chip_smoke.scan_fp64() if s64 else nullcontext():
            loss, g = loss_and_grads(params, torch.as_tensor(tokens).to(dev, torch.long), cfg2)
        g = unflatten(params, g)
        return float(loss), {k: t.double().cpu() for k, t in flatten_with_keys(g)}

    runs = {"card": grads("cuda", False), "card64": grads("cuda", True),
            "cpu": grads("cpu", False), "cpu64": grads("cpu", True)}
    out = {"card": smi}
    for a, b in (("card", "card64"), ("cpu", "cpu64"), ("card64", "cpu64"), ("card", "cpu64"),
                 ("card", "cpu")):
        ga, gb = runs[a][1], runs[b][1]
        rel = {k: float((ga[k] - gb[k]).abs().max() / gb[k].abs().max()) for k in gb}
        out[f"{a}_vs_{b}"] = {"loss": runs[a][0] - runs[b][0], "grad_max_rel_err": rel}
        print(a, "vs", b, "loss", runs[a][0] - runs[b][0],
              {k: f"{v:.2e}" for k, v in rel.items() if v > 1e-5}, flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
