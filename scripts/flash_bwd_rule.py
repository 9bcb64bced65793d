#!/usr/bin/env python3
"""How tightly three tolerance rules hold the flash-attention backward kernel.

    python3 scripts/flash_bwd_rule.py > rule.json      # on one NVIDIA GPU

Over ``chip_smoke.py``'s backward cases (bf16 and fp32, head_dim 64 and 128,
GQA groups 1-8, lengths 17-1024), each gradient of the kernel is held
against ``attention_bwd_ref`` under three rules, each as the ratio of the
error to its limit (a rule passes at <= 1):

- ``tensor_max``: max |err| <= tol * max(1, max |ref|) over the tensor;
- ``tile``: |err| <= tol * (|ref| + the RMS of the element's 64-row tile);
- ``row_tile``: the same with the larger RMS of the element's row and tile
  (``chip_smoke.grad_err``, the rule the smoke run holds the kernel to).

At lengths 100, 1000 and 1024 the faults of ``chip_smoke.bwd_faults`` are
planted in the kernel's dK and dV and read under the same rules.  Prints one
JSON object: per dtype, the real kernel's worst ratio under each rule, the
planted faults' least ratio and how many of them each rule passes.
"""

import json
from pathlib import Path
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as smoke


def tile_rms(ref):
    b, s, h, _ = ref.shape
    out = torch.empty((b, s, h, 1), device=ref.device)
    for lo in range(0, s, smoke.BWD_TILE):
        rows = ref[:, lo:lo + smoke.BWD_TILE]
        out[:, lo:lo + smoke.BWD_TILE] = rows.square().mean(dim=(1, 3)).sqrt()[:, None, :, None]
    return out


def ratios(out, ref, tol):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    return {
        "tensor_max": float(err.max()) / (tol * max(1.0, float(ref.abs().max()))),
        "tile": float((err / (tol * (ref.abs() + tile_rms(ref)))).max()),
        "row_tile": smoke.grad_err(out, ref, tol)[1],
    }


def main():
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    build.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rules = ("tensor_max", "tile", "row_tile")
    summary = {}
    for case in smoke.flash_bwd_cases():
        b, s, h, g, d, dtype = case
        q, do = (smoke.randn(gen, (b, s, h, d), dtype) for _ in range(2))
        k, v = (smoke.randn(gen, (b, s, g, d), dtype) for _ in range(2))
        o, lse = smoke.flash_lse(q, k, v)
        got = flash_attention_bwd(q, k, v, o, lse, do)
        want = attention_bwd_ref(q, k, v, o, lse, do)
        tol = smoke.TOL[dtype]
        w = summary.setdefault(str(dtype), {
            "kernel_worst": dict.fromkeys(rules, 0.0),
            "fault_least": dict.fromkeys(rules, float("inf")),
            "faults_passed": dict.fromkeys(rules, 0), "faults": 0})
        for a, r in zip(got, want):
            for rule, x in ratios(a, r, tol).items():
                w["kernel_worst"][rule] = max(w["kernel_worst"][rule], x)
        if s < 100:
            continue
        for planted in smoke.bwd_faults(q, k, v, o, lse, do, got[1], got[2]).values():
            for a, r in zip(planted, want[1:]):
                w["faults"] += 1
                for rule, x in ratios(a, r, tol).items():
                    w["fault_least"][rule] = min(w["fault_least"][rule], x)
                    w["faults_passed"][rule] += x <= 1.0
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rules": summary}))


if __name__ == "__main__":
    main()
