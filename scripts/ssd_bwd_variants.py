#!/usr/bin/env python3
"""Variants of the SSD backward kernel, built side by side and timed in turns.

    python3 scripts/ssd_bwd_variants.py                  # this tree's kernel alone
    python3 scripts/ssd_bwd_variants.py VARIANTS.json    # and its variants

VARIANTS.json maps a name to a list of [old, new] text replacements applied to
``src/repro_torch/csrc/ssd_scan_bwd.cu`` (each ``old`` must occur), or to
{"file": PATH}, a whole source with this tree's C interface.  Each variant is
built into a library of its own (``build/variants/<name>/``, with the
``*.cuh`` of ``csrc`` beside it; ``-Xptxas -v``), and the wrapper
``ops.ssd_scan_bwd`` is pointed at each in turn.  Prints one JSON line a
variant with its walks' registers and spills, then one line a training
shape of ``chip_smoke.SSD_BWD_SHAPES``: each variant's worst ratio of
``chip_smoke.ssd_grad_err`` against ``ssd_bwd_ref``, its largest error of
each gradient relative to autograd of the chunked scan in float64, and its
time (``chip_smoke.time_ms_events``) twice, in the order base, variants,
variants reversed, base; and the last variant's kernels' device time by the
profiler.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path
import sys
import time

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs
# the port
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ssd_bwd_ref
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

CSRC = ROOT / "src" / "repro_torch" / "csrc"


def build_variants(variants):
    """{name: the variant's dco_ssd_scan_bwd}, "base" first."""
    src0 = (CSRC / "ssd_scan_bwd.cu").read_text()
    fns = {}
    for name, patches in {"base": [], **variants}.items():
        if isinstance(patches, dict):
            src = Path(patches["file"]).read_text()
        else:
            src = src0
            for old, new in patches:
                if old not in src:
                    raise SystemExit(f"variant {name}: text not found: {old[:60]!r}")
                src = src.replace(old, new)
        d = kbuild.build_dir() / "variants" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ssd_scan_bwd.cu").write_text(src)
        for hdr in CSRC.glob("*.cuh"):
            (d / hdr.name).write_text(hdr.read_text())
        path = kbuild.build(verbose=True, csrc=d)
        usage = {k: v for k, v in cs.ptxas_usage(Path(path).with_suffix(".log").read_text()).items()
                 if "walk" in k}
        print(json.dumps({"variant": name, "ptxas": usage}), flush=True)
        fn = getattr(ctypes.CDLL(str(path)), "dco_ssd_scan_bwd")
        fn.argtypes, fn.restype = ops.BWD_ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def watchdog(seconds):
    """Exit the process if the card has not finished its work in ``seconds``
    (an mbarrier that never completes would hang it until the call's limit)."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.time()
    while not ev.query():
        if time.time() - t0 > seconds:
            print("watchdog: the card did not finish", flush=True)
            os._exit(3)
        time.sleep(0.01)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = json.loads(Path(sys.argv[1]).read_text()) if len(sys.argv) > 1 else {}
    fns = build_variants(variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for path, shape in cs.SSD_BWD_SHAPES.items():
        b, s, h, g, p, n = (shape[k] for k in ("b", "s", "h", "g", "p", "n"))
        x, dt, A, B, C = cs.ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
        dy = cs.randn(gen, (b, s, h, p), torch.float32)
        want = ssd_bwd_ref(x, dt, A, B, C, dy)
        leaves = [t.double().requires_grad_() for t in (x, dt, A, B, C)]
        y64, _ = ssd_chunked(*leaves, shape["chunk"])
        g64 = torch.autograd.grad(y64, leaves, dy.double())
        del y64, leaves
        res = {}
        for name, fn in fns.items():
            ops._fns["dco_ssd_scan_bwd"] = fn
            got = ops.ssd_scan_bwd(x, dt, A, B, C, dy)
            watchdog(20)
            torch.cuda.synchronize()
            res[name] = {
                "worst_ratio": max(cs.ssd_grad_err(k, a, r, cs.SSD_TOL[torch.float32])[1]
                                   for k, a, r in zip(cs.SSD_GRADS[:5], got[:5], want[:5])),
                "rel_vs_fp64": {k: float((a.double() - r).abs().max() / r.abs().max())
                                for k, a, r in zip(cs.SSD_GRADS[:5], got[:5], g64)}}
            del got
        names = list(fns)
        for order in (names, names[::-1]):
            for name in order:
                ops._fns["dco_ssd_scan_bwd"] = fns[name]
                res[name].setdefault("ms", []).append(
                    cs.time_ms_events(lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy), flush))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            for _ in range(3):
                ops.ssd_scan_bwd(x, dt, A, B, C, dy)
            torch.cuda.synchronize()
        kernels = {ev.key.split("<")[0].split("::")[-1]: ev.device_time_total / 3000
                   for ev in prof.key_averages() if ev.device_time_total > 0}
        print(json.dumps({"path": path, "last_variant_kernels_ms": kernels, **res}), flush=True)
        del want, g64


if __name__ == "__main__":
    main()
