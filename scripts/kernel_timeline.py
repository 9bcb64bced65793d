#!/usr/bin/env python3
"""Where the time of the decode and SSD kernels goes, phase by phase, on the card.

    python3 scripts/kernel_timeline.py            # both kernels, at the serving shapes
    python3 scripts/kernel_timeline.py --kernel ssd

Builds instrumented copies of ``src/repro_torch/csrc/decode_attention.cu`` and
``ssd_scan.cu`` (under ``build/timeline/``; the sources in the tree are not
touched): at fixed places, marked by comments of the source, a thread reads the
card's ``%globaltimer`` (nanoseconds) into a device array that the host reads
back after one launch.  One JSON line per shape:

* decode (thread 0 of every block, its first work item): from the earliest
  block start to q in registers, to the first step's rows landed, to the end of
  the row loop, the block's merge, the partial written and counted, and the
  last unit's merge;
* SSD (lane 0 of each warp of block (0, 0, 0), every 64-row sub-chunk): the
  median nanoseconds of each phase (C B^T, C state^T, the scores, y, the state,
  and the wait for the next sub-chunk's rows), per warp;
* mma (``--kernel mma``): the rate of back-to-back ``mma.sync`` products with
  no loads, TF32 m16n8k8 (the SSD kernel's) and bf16 m16n8k16 (the flash
  kernel's), 8 independent accumulators a warp, 4 to 16 warps an SM, one
  block on each SM: the ceiling of a kernel built on ``mma.sync``.

The stamps cost a few instructions at each place; the launch is timed with CUDA
events beside the stamps.  Needs one CUDA device and nvcc, like the kernels.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
import statistics
import sys

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke

STAMP = ('do {{ if ({cond}) {{ unsigned long long t_; asm volatile("mov.u64 %0, '
         '%%globaltimer;" : "=l"(t_) :: "memory"); dco_timeline[{index}] = t_; }} }} while (0);')
SLOTS = 1 << 16

# (anchor line in the source, where the stamp goes, stamp number, extra condition)
FIRST = " && item == blockIdx.x"
DECODE_MARKS = [
    ("  // R: the caller's, or chosen from this call's lengths (every block reads",
     "before", 0, ""),
    ("  float m[HPB], l[HPB], acc[HPB][EPL];", "before", 1, FIRST),
    ("    const uint4* st = ring + (t % STAGES) * L::CHUNKS * THREADS + tid;", "after", 2,
     FIRST + " && t == 0"),
    ("  // merge the four lane groups of a warp", "before", 3, FIRST),
    ("  // the last unit of this (batch, head block) to finish merges the partials",
     "before", 4, FIRST),
    ("  if (!sm_last) return;", "after", 5, FIRST),
    ("    for (int e = 0; e < 4; ++e) a.out[(bh0 + hh) * D + 4 * d4 + e] = Vec<T>::to(x[e]);"
     "\n  }", "after", 6, FIRST),
]
DECODE_PHASES = ["to q", "to the first rows", "row loop", "block merge and partial",
                 "partial counted", "last unit's merge"]
SSD_MARKS = [
    ("    __syncthreads();  // sub-chunk c has landed for every thread", "after", 0, ""),
    ("    // 3. C state^T with the state of the rows before this sub-chunk", "before", 1, ""),
    ("    __syncthreads();  // cum, ecum, dtw and tot are ready", "after", 2, ""),
    ("    __syncthreads();  // the scores are ready; every read of the old state is done",
     "after", 3, ""),
    ("    // 6. state = state exp(total) + B^T (x dt exp(total - cum)), on this warp's piece",
     "before", 4, ""),
    ("    __syncthreads();  // the next sub-chunk overwrites this stage, the scores and the state",
     "before", 5, ""),
]
SSD_PHASES = ["C B^T", "C state^T + barrier", "scores + barrier", "y", "state",
              "barrier + next rows"]


def instrument(src: str, marks, cond: str, index: str) -> str:
    out = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                      f"dco_timeline[{SLOTS}];\n", 1)
    for anchor, where, k, extra in marks:
        if out.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
        stamp = "  " + STAMP.format(cond=cond + extra, index=index.format(k=k))
        out = out.replace(anchor, f"{stamp}\n{anchor}" if where == "before"
                          else f"{anchor}\n{stamp}")
    return out + ('\nextern "C" int dco_timeline_read(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, dco_timeline, "
                  "sizeof(dco_timeline));\n}\n"
                  'extern "C" int dco_timeline_clear() {\n'
                  "  void* p = nullptr;\n"
                  "  cudaError_t e = cudaGetSymbolAddress(&p, dco_timeline);\n"
                  "  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(dco_timeline)));"
                  "\n}\n")


def build(name: str, src: str) -> ctypes.CDLL:
    from repro_torch.kernels import build as kbuild
    d = kbuild.build_dir() / "timeline" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.cu").write_text(src)
    return ctypes.CDLL(str(kbuild.build(csrc=d)))


def on_wrapper(ops, lib, name: str) -> None:
    """Point the wrapper module ``ops`` at ``name`` of the instrumented
    library ``lib``, which has the same C interface as the package's own."""
    real = ops._kernel()
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = real.argtypes, real.restype
    ops._fn = fn


def read(lib) -> list:
    buf = (ctypes.c_ulonglong * SLOTS)()
    lib.dco_timeline_read.argtypes = [ctypes.c_void_p]
    if lib.dco_timeline_read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the timeline failed")
    return list(buf)


def flushed_launch(lib, fn, flush):
    """One launch of ``fn`` after the L2 is rewritten and the timeline cleared."""
    if lib.dco_timeline_clear() != 0:
        raise RuntimeError("clearing the timeline failed")
    flush.zero_()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def decode_timeline(flush, gen):
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    src = (ROOT / "src/repro_torch/csrc/decode_attention.cu").read_text()
    src = instrument(src, DECODE_MARKS, "threadIdx.x == 0 && blockIdx.x < 8192",
                     "blockIdx.x * 8 + {k}")
    # attend_unit's stamps need the item: pass it in
    for old, new in (("    attend_unit<T, D, HPB>(a, ", "    attend_unit<T, D, HPB>(item, a, "),
                     ("__device__ __forceinline__ void attend_unit(const Args<T>& a,",
                      "__device__ __forceinline__ void attend_unit(int item, const Args<T>& a,")):
        if src.count(old) != 1:
            raise RuntimeError(f"not found once in the source: {old!r}")
        src = src.replace(old, new)
    lib = build("decode_attention", src)
    on_wrapper(ops, lib, "dco_decode_attention")
    b, s, h, g, d = 8, 2048, 24, 8, 128
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, s, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, s, g, d), generator=gen, device="cuda").to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for lens in (chip_smoke.DECODE_RAGGED, chip_smoke.DECODE_ONE_GROUP):
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        plan = ops.decode_plan(b, s, h, g, d, None, sms)

        def launch():
            ops.decode_attention(q, k, v, cl)

        out = ops.decode_attention(q, k, v, cl)
        torch.cuda.synchronize()
        err = float((out.float() - decode_attention_ref(q, k, v, cl).float()).abs().max())
        ms = flushed_launch(lib, launch, flush)
        t = read(lib)
        n_items = len(plan.items(lens))
        blocks = min(n_items, plan.blocks)
        t0 = min(t[i * 8] for i in range(blocks))
        phases = {name: [] for name in DECODE_PHASES}
        for i in range(blocks):
            stamps = [t[i * 8 + j] for j in range(7)]
            if not all(stamps[:5]):
                continue                                     # a cache_len 0 item
            for j, name in enumerate(DECODE_PHASES[:4]):
                phases[name].append(stamps[j + 1] - (stamps[j] if j else t0))
            if stamps[5]:                                    # the unit that merged
                phases["partial counted"].append(stamps[5] - stamps[4])
        ends = [t[i * 8 + 6] - t0 for i in range(blocks) if t[i * 8 + 6] > t0]
        merges = [t[i * 8 + 6] - t[i * 8 + 5] for i in range(blocks)
                  if t[i * 8 + 6] > t[i * 8 + 5] > 0]
        phases["last unit's merge"] = merges
        print(json.dumps({
            "kernel": "decode_attention", "cache_len": lens, "rows": plan.rows_for(lens),
            "event_ms": ms, "max_abs_err": err, "busy_blocks": len(phases["to q"]),
            "phase_ns_median_max": {k2: [int(statistics.median(v2)), int(max(v2))]
                                    for k2, v2 in phases.items() if v2},
            "end_ns_max": max(ends) if ends else None}), flush=True)


def ssd_timeline(flush, gen):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    src = (ROOT / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    lib = build("ssd_scan", instrument(
        src, SSD_MARKS, "blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && "
        "threadIdx.x % 32 == 0 && c < 256", "(c * 8 + threadIdx.x / 32) * 8 + {k}"))
    on_wrapper(ops, lib, "dco_ssd_scan")
    for s in (1024, 256):
        b, h, g, p, n = 1, 80, 1, 64, 128
        x = torch.randn((b, s, h, p), generator=gen, device="cuda")
        dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda")) * 0.1
        A = -torch.exp(torch.rand((h,), generator=gen, device="cuda") * 2 - 1)
        B = torch.randn((b, s, g, n), generator=gen, device="cuda")
        C = torch.randn((b, s, g, n), generator=gen, device="cuda")

        def launch():
            ops.ssd_scan(x, dt, A, B, C, chunk=min(256, s))

        y, _ = ops.ssd_scan(x, dt, A, B, C, chunk=min(256, s))
        torch.cuda.synchronize()
        y_ref, _ = ssd_ref(x, dt, A, B, C, min(256, s))
        err = float((y - y_ref).abs().max())
        ms = flushed_launch(lib, launch, flush)
        t = read(lib)
        n_sub = -(-s // ops.SUB_CHUNK)
        per_warp = {}
        for w in range(8):
            rows = [[t[(c * 8 + w) * 8 + k] for k in range(6)] for c in range(n_sub)]
            durs = {name: [] for name in SSD_PHASES}
            for c, r in enumerate(rows):
                for k, name in enumerate(SSD_PHASES[:-1]):
                    durs[name].append(r[k + 1] - r[k])
                if c + 1 < n_sub:
                    durs[SSD_PHASES[-1]].append(rows[c + 1][0] - r[5])
            per_warp[f"warp{w}"] = {k2: int(statistics.median(v2)) for k2, v2 in durs.items()}
        block_ns = t[((n_sub - 1) * 8) * 8 + 5] - t[0]
        print(json.dumps({
            "kernel": "ssd_scan", "S": s, "event_ms": ms,
            "max_abs_err": err, "block_000_ns": block_ns,
            "sub_chunk_ns": block_ns // max(n_sub - 1, 1),
            "phase_ns_median": per_warp}), flush=True)


MMA_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int KIND>
__global__ void mma_rate(float* out, int iters) {
  float c[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int dco_mma_rate(int kind, int blocks, int warps, int iters, void* out) {
  if (kind == 0) mma_rate<0><<<blocks, 32 * warps>>>(static_cast<float*>(out), iters);
  else mma_rate<1><<<blocks, 32 * warps>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate():
    lib = build("mma_rate", MMA_SRC)
    fn = lib.dco_mma_rate
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 16 * 32, device="cuda")
    iters = 20000
    for kind, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                             (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            fn(kind, sms, warps, 100, out.data_ptr())
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            if fn(kind, sms, warps, iters, out.data_ptr()) != 0:
                raise RuntimeError("launch failed")
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            n = sms * warps * iters * 8
            print(json.dumps({"mma": name, "warps_per_sm": warps, "ms": ms,
                              "tflops": n * flop / ms * 1e-9}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("decode", "ssd", "both", "mma"), default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timeline: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.kernel in ("decode", "both"):
        decode_timeline(flush, gen)
    if args.kernel in ("ssd", "both"):
        ssd_timeline(flush, gen)
    if args.kernel == "mma":
        mma_rate()


if __name__ == "__main__":
    main()
