#!/usr/bin/env python3
"""Time the decode and SSD kernels against an earlier tree's, in one run.

    git show <rev>:src/repro_torch/csrc/decode_attention.cu > reports/base/decode_attention.cu
    git show <rev>:src/repro_torch/csrc/ssd_scan.cu > reports/base/ssd_scan.cu
    python3 scripts/kernel_compare.py --baseline reports/base

The earlier sources go in a directory of their own (never under ``csrc/``:
``kernels/build.py`` links every ``csrc/*.cu`` into one library, and two copies
would clash on their ``extern "C"`` names); they are built into a library of
their own and called through their own C interfaces, which ``Baseline`` knows
for the earlier trees' two-launch decode kernel (with ``n_splits``) and SSD
kernel (with no ring-depth argument).

One JSON line per shape, on the inputs and with the timing of ``chip_smoke.py``
(``decode_record`` / ``ssd_record``: CUDA-graph replay, L2 rewritten before
each call): this tree's record (ms, plain, library, bound), the earlier
kernel's ``baseline_ms``, both timed in turns (old, new, new, old:
``turns_ms``), and for decode the time at each fixed ``rows_per_split`` beside
the rows the kernel chose.  Decode runs on the engine's pool (8 slots x 2048
rows, llama3.2-3b heads, bf16) at mixed positions, a serving call's one live
position group of 801 and of 97 rows, and every slot full; SSD at mamba2-2.7b's
prompts of 1024 and 256 tokens.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
import subprocess
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs

DECODE_SHAPES = {
    "ragged": cs.DECODE_RAGGED,
    "one group of 801": cs.DECODE_ONE_GROUP,
    "one group of 97": [0, 0, 97, 0, 0, 0, 0, 0],
    "full": [2048] * 8,
}
FIXED_ROWS = (32, 64, 128, 256, 512)


class Baseline:
    """The decode and SSD kernels of an earlier tree, built from ``csrc`` into
    a library of their own."""

    def __init__(self, csrc):
        from repro_torch.kernels import build
        self.lib = ctypes.CDLL(str(build.build(csrc=Path(csrc).resolve())))
        self.lib.dco_decode_attention.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        self.lib.dco_ssd_scan.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p] * 2)
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count

    def decode(self, q, k, v, cl):
        """The two-launch decode interface: the valid range cut into n_splits
        pieces (two blocks an SM, 64 rows a piece at least, 32 pieces at most),
        a partial kernel and a combine kernel."""
        b, h, d = q.shape
        _, s, g, _ = k.shape
        n_splits = max(1, min(-(-2 * self.sms // (b * g)), s // 64, 32))
        out = torch.empty_like(q)
        scratch = torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32, device="cuda")
        st = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                     *v.stride()[:3])
        rc = self.lib.dco_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 0 if q.dtype == torch.bfloat16 else 1, b, s, h, g, d,
            n_splits, 1.0 / d ** 0.5, st, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"baseline decode launch failed ({rc})")
        return out

    def ssd(self, x, dt, A, B, C):
        """The SSD interface (fp32 dt and A, no initial state)."""
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        y = torch.empty_like(x)
        state = torch.empty((b, h, p, n), dtype=torch.float32, device="cuda")
        st = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                                      *C.stride()[:3])
        rc = self.lib.dco_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), None,
            y.data_ptr(), state.data_ptr(), 0 if x.dtype == torch.bfloat16 else 1,
            b, s, h, g, p, n, st, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"baseline ssd launch failed ({rc})")
        return y, state


def in_turns(new, old, flush):
    """``new`` and ``old`` timed old, new, new, old."""
    turns = [cs.time_ms(fn, flush) for fn in (old, new, new, old)]
    return {"ms_in_turns": (turns[1] + turns[2]) / 2,
            "baseline_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="DIR", required=True,
                    help="directory holding the earlier decode_attention.cu and ssd_scan.cu")
    ap.add_argument("--kernel", choices=("decode", "ssd", "both"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: needs a CUDA device")
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    base = Baseline(args.baseline)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf, f32 = torch.bfloat16, torch.float32
    if args.kernel in ("decode", "both"):
        for name, lens in DECODE_SHAPES.items():
            q, k, v, cl = cs.decode_inputs(gen, lens)
            rec = cs.decode_record(q, k, v, cl, flush)
            cs.close(base.decode(q, k, v, cl), decode_attention_ref(q, k, v, cl), cs.TOL[bf],
                     f"baseline decode at {name}")
            rec.update(in_turns(lambda: decode_attention(q, k, v, cl),
                                lambda: base.decode(q, k, v, cl), flush))
            rec["ms_fixed_rows"] = {str(r): cs.time_ms(
                lambda: decode_attention(q, k, v, cl, rows_per_split=r), flush)
                for r in FIXED_ROWS}
            print(json.dumps({"shape_name": name, **rec}), flush=True)
    if args.kernel in ("ssd", "both"):
        for s in cs.SSD_PROMPTS:
            x, dt, A, B, C = cs.ssd_inputs(gen, 1, s, 80, 1, 64, 128, f32)
            chunk = min(256, s)
            rec = cs.ssd_record(x, dt, A, B, C, chunk, flush)
            y_ref, st_ref = ssd_ref(x, dt, A, B, C, chunk)
            yb, stb = base.ssd(x, dt, A, B, C)
            cs.close(yb, y_ref, cs.SSD_TOL[f32], "baseline ssd vs plain")
            cs.close(stb, st_ref, cs.SSD_TOL[f32], "baseline ssd state vs plain")
            rec.update(in_turns(lambda: ssd_scan(x, dt, A, B, C, chunk=chunk),
                                lambda: base.ssd(x, dt, A, B, C), flush))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
