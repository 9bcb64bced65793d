#!/usr/bin/env python3
"""Where the time of the decode and SSD kernels goes, phase by phase, on the card.

    python3 scripts/kernel_timeline.py            # both kernels, at the serving shapes
    python3 scripts/kernel_timeline.py --kernel ssd
    python3 scripts/kernel_timeline.py --kernel ssd_bwd --baseline reports/base_ssd_bwd
    python3 scripts/kernel_timeline.py --kernel wgmma

Builds instrumented copies of ``src/repro_torch/csrc/decode_attention.cu``,
``ssd_scan.cu`` and ``ssd_scan_bwd.cu`` (under ``build/timeline/``; the
sources in the tree are not touched): at fixed places, marked by comments of
the source, a thread reads the card's ``%globaltimer`` (nanoseconds) into a
device array that the host reads back after one launch.  One JSON line per
shape:

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
  block on each SM: the ceiling of a kernel built on ``mma.sync``;
* SSD backward (``--kernel ssd_bwd [--baseline DIR]``): at both training
  shapes, commit 377bd0d's FMA kernel from DIR/ssd_scan_bwd.cu (thread 0 of
  block (0, 0) at each phase of each sub-chunk of its two walks, and every
  block's first and last stamp: each kernel's span), then this tree's wgmma
  kernel (the first thread of each consumer warpgroup of block (0, 0) in
  each of the three walks); the median nanoseconds of each phase a
  sub-chunk;
* wgmma (``--kernel wgmma``): TF32 wgmma with a register A and a K-major
  swizzled B against float64 (the fragment layout the SSD backward uses,
  with the K order permuted on both sides, and 3xTF32), whether the tensor
  cores truncate or round an fp32 operand, and the rate of the backward's
  product() pattern with no loads (two warpgroups an SM).

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
SLOTS = 1 << 17

# (anchor line in the source, where the stamp goes, stamp number, extra condition)
FIRST = " && item == blockIdx.x"
# the parent's kernel (commit 25f5216: FMA lane groups, per-call R, counter merge)
PARENT_DECODE_MARKS = [
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
PARENT_DECODE_PHASES = ["to q", "to the first rows", "row loop", "block merge and partial",
                        "partial counted", "last unit's merge"]
# this tree's bf16 kernel (TMA + wgmma, a cluster a (batch row, KV head)):
# the first thread of every block, the one that issues its copies (slot
# block * 8 + k)
WGMMA_BLOCK = "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))"
WGMMA_DECODE_MARKS = [
    ("  if (threadIdx.x == 0) {\n    mbar_init(q_full, 1);", "before", 0, ""),
    ("  if (rank == 0 || n_tiles > 0) mbar_wait(q_full, 0);", "after", 1, ""),
    ("    mbar_wait(k_full(st), lap & 1);", "after", 2, " && n == 0"),
    ("  // the tile loop's end", "before", 3, ""),
    ("  cluster_arrive();  // the partials written, released to the cluster", "before", 4, ""),
    ("  const uint32_t pm_s = smem_addr(pm), pl_s = smem_addr(pl), pacc_s = smem_addr(pacc);",
     "before", 5, ""),
    ("  cluster_arrive();  // no block leaves while another reads its partial", "before", 6, ""),
]
WGMMA_DECODE_PHASES = ["to q", "to the first K tile", "tile loop", "partial written",
                       "cluster barrier", "merge"]
# the decode shapes stamped: (path, cache_len) on the engine's pool of 8 x 2048 rows
DECODE_TIMELINE_SHAPES = [
    ("llama3.2-3b", chip_smoke.DECODE_RAGGED), ("llama3.2-3b", chip_smoke.DECODE_ONE_GROUP),
    ("llama3.2-3b", [0, 0, 97, 0, 0, 0, 0, 0]), ("llama3.2-3b", [2048] * 8),
    ("qwen2-vl-7b", chip_smoke.DECODE_RAGGED), ("zamba2-7b", chip_smoke.DECODE_RAGGED)]
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


def instrument(src: str, marks, cond: str = "", index: str = "") -> str:
    """``src`` with a stamp at each mark: (anchor, "before" or "after", k,
    extra condition), the stamp's condition ``cond`` + extra and its slot
    ``index`` with k filled in; or (anchor, where, condition, slot) where
    ``cond`` is empty, each mark with its own."""
    out = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                      f"dco_timeline[{SLOTS}];\n", 1)
    for anchor, where, k, extra in marks:
        every = where.endswith("*")   # at each place the anchor stands (one per walk)
        where = where.rstrip("*")
        if out.count(anchor) != 1 and not (every and out.count(anchor) > 1):
            raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
        stamp = "  " + (STAMP.format(cond=cond + extra, index=index.format(k=k)) if cond
                        else STAMP.format(cond=k, index=extra))
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


def build(name: str, src: str, headers: Path = None) -> ctypes.CDLL:
    """``src`` built alone into a library of its own (with the ``*.cuh`` of
    ``headers`` beside it)."""
    from repro_torch.kernels import build as kbuild
    d = kbuild.build_dir() / "timeline" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.cu").write_text(src)
    for hdr in sorted(headers.glob("*.cuh")) if headers else ():
        (d / hdr.name).write_text(hdr.read_text())
    return ctypes.CDLL(str(kbuild.build(csrc=d)))


def on_wrapper(ops, lib, name: str) -> None:
    """Point the wrapper module ``ops`` at ``name`` of the instrumented
    library ``lib``, which has the same C interface as the package's own."""
    real = ops._kernel(name)
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = real.argtypes, real.restype
    ops._fns[name] = fn


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


def decode_timeline(flush, gen, baseline=None):
    """``baseline``: the parent's kernel from DIR/decode_attention.cu, called
    through its own one-launch interface; else this tree's."""
    if baseline is None:
        return wgmma_decode_timeline(flush, gen)
    sys.path.insert(0, str(ROOT / "scripts"))
    from kernel_compare import Baseline
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    src = (Path(baseline) / "decode_attention.cu").read_text()
    src = instrument(src, PARENT_DECODE_MARKS, "threadIdx.x == 0 && blockIdx.x < 8192",
                     "blockIdx.x * 8 + {k}")
    # attend_unit's stamps need the item: pass it in
    for old, new in (("    attend_unit<T, D, HPB, CAP>(a, ",
                      "    attend_unit<T, D, HPB, CAP>(item, a, "),
                     ("__device__ __forceinline__ void attend_unit(const Args<T>& a,",
                      "__device__ __forceinline__ void attend_unit(int item, const Args<T>& a,")):
        if src.count(old) != 1:
            raise RuntimeError(f"not found once in the source: {old!r}")
        src = src.replace(old, new)
    lib = build("decode_attention_parent", src)
    for path, lens in DECODE_TIMELINE_SHAPES:
        h, g, d = chip_smoke.ATTN_SHAPES[path]
        q, k, v, cl = chip_smoke.decode_inputs(gen, lens, h, g, d)
        call, out = Baseline.decode_entry(lib.dco_decode_attention, q, k, v, cl)
        call()
        torch.cuda.synchronize()
        err = float((out.float() - decode_attention_ref(q, k, v, cl).float()).abs().max())
        ms = flushed_launch(lib, call, flush)
        t = read(lib)
        starts = [t[i * 8] for i in range(8192) if t[i * 8]]
        t0 = min(starts)
        phases = {name: [] for name in PARENT_DECODE_PHASES}
        ends = []
        for i in range(len(starts)):
            stamps = [t[i * 8 + j] for j in range(7)]
            if not all(stamps[:4]):
                continue                                     # a cache_len 0 item
            for j, name in enumerate(PARENT_DECODE_PHASES[:3]):
                phases[name].append(stamps[j + 1] - (stamps[j] if j else t0))
            if stamps[4]:                                    # a unit of several
                phases["block merge and partial"].append(stamps[4] - stamps[3])
                if stamps[5]:                                # the unit that merged
                    phases["partial counted"].append(stamps[5] - stamps[4])
                    phases["last unit's merge"].append(stamps[6] - stamps[5])
                    ends.append(stamps[6] - t0)
        print(json.dumps({
            "kernel": "decode_attention (parent)", "path": path, "cache_len": lens,
            "event_ms": ms, "max_abs_err": err, "blocks": len(starts),
            "busy_blocks": len(phases["to q"]),
            "block_start_spread_ns": max(starts) - t0,
            "phase_ns_median_max": {k2: [int(statistics.median(v2)), int(max(v2))]
                                    for k2, v2 in phases.items() if v2},
            "merge_end_ns_max": max(ends) if ends else None}), flush=True)


def wgmma_decode_timeline(flush, gen):
    """This tree's bf16 kernel through the wrapper, stamped at
    WGMMA_DECODE_MARKS: per block from the earliest block start to q landed,
    to the first K tile, the tile loop, the partial written, the cluster's
    barrier and the block's share of the merge."""
    from repro_torch.kernels.build import CSRC
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    src = instrument((CSRC / "decode_attention.cu").read_text(), WGMMA_DECODE_MARKS,
                     f"threadIdx.x == 0 && {WGMMA_BLOCK} < 8192",
                     f"{WGMMA_BLOCK} * 8 + {{k}}")
    lib = build("decode_attention", src, CSRC)
    on_wrapper(ops, lib, "dco_decode_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for path, lens in DECODE_TIMELINE_SHAPES:
        h, g, d = chip_smoke.ATTN_SHAPES[path]
        q, k, v, cl = chip_smoke.decode_inputs(gen, lens, h, g, d)
        plan = ops.wgmma_plan(8, k.shape[1], h, g, d, sm_count=sms,
                              cluster_room=ops._cluster_room(q.device, d, h // g))

        def launch():
            ops.decode_attention(q, k, v, cl)

        out = ops.decode_attention(q, k, v, cl)
        torch.cuda.synchronize()
        err = float((out.float() - decode_attention_ref(q, k, v, cl).float()).abs().max())
        ms = flushed_launch(lib, launch, flush)
        t = read(lib)
        n_blocks = plan.units * g * 8
        starts = [t[i * 8] for i in range(n_blocks) if t[i * 8]]
        t0 = min(starts)
        phases = {name: [] for name in WGMMA_DECODE_PHASES}
        ends = []
        for i in range(n_blocks):
            st = [t[i * 8 + j] for j in range(7)]
            if not st[2]:
                continue                                  # a block with no rows
            phases["to q"].append(st[1] - t0)
            phases["to the first K tile"].append(st[2] - st[1])
            phases["tile loop"].append(st[3] - st[2])
            if st[4]:
                phases["partial written"].append(st[4] - st[3])
                phases["cluster barrier"].append(st[5] - st[4])
                phases["merge"].append(st[6] - st[5])
                ends.append(st[6] - t0)
            else:
                ends.append(st[3] - t0)
        print(json.dumps({
            "kernel": "decode_attention (wgmma)", "path": path, "cache_len": lens,
            "units": plan.units, "event_ms": ms, "max_abs_err": err, "blocks": len(starts),
            "busy_blocks": len(phases["to q"]),
            "block_start_spread_ns": max(starts) - t0,
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


# the SSD backward of commit 377bd0d (FMA): block (0, 0)'s thread 0 at each
# phase of every 64-row sub-chunk of its two walks (slots c * 8 + k of the
# forward walk, 512 + c * 8 + k of the reverse), and every block's first and
# last stamp (the forward walk's from 2048, the reverse's from 4096 and the
# head sums' from 8192, two a block)
SSD_BWD_ONE = "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && c0 < 64 * 64"
SSD_BWD_REV_ONE = "blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && c < 64"
SSD_BWD_SPAN = "threadIdx.x == 0"
FMA_BWD_MARKS = [
    ("  for (int c0 = 0; c0 < S; c0 += Q) {\n    const int valid = min(Q, S - c0);", "after",
     SSD_BWD_ONE, "(c0 / 64) * 8 + 0"),
    ("    if (tid < 32) chunk_cumsum(dts, a, cum2, ecum, w, tot, true);", "before",
     SSD_BWD_ONE, "(c0 / 64) * 8 + 1"),
    ("    // ML[t][s] = dt_s L[t, s] (dy_t . x_s), zero above the diagonal", "before",
     SSD_BWD_ONE, "(c0 / 64) * 8 + 2"),
    ("    // dC^h = diag(exp(cum)) DY ST + ML Bs", "before", SSD_BWD_ONE, "(c0 / 64) * 8 + 3"),
    ("    __syncthreads();  // every read of the old state is done", "after", SSD_BWD_ONE,
     "(c0 / 64) * 8 + 4"),
    ("    __syncthreads();  // the next sub-chunk overwrites the tiles\n  }\n\n  // <dFinal",
     "before", SSD_BWD_ONE, "(c0 / 64) * 8 + 5"),
    ("  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;\n  const float a = A[h];",
     "after", SSD_BWD_SPAN, "2048 + 2 * (blockIdx.y * H + blockIdx.x)"),
    ("    fdot[b * H + h] = s;", "after", SSD_BWD_SPAN,
     "2048 + 2 * (blockIdx.y * H + blockIdx.x) + 1"),
    ("    const int c0 = c * Q;\n    const int valid = min(Q, S - c0);", "after",
     SSD_BWD_REV_ONE, "512 + c * 8 + 0"),
    ("    if (tid < 32) chunk_cumsum(dts, a, cum2, ecum, w, tot, false);", "before",
     SSD_BWD_REV_ONE, "512 + c * 8 + 1"),
    ("    // SL[t'][t] = L[t', t] (C_t' . B_t) and ML[t'][t] = dt_t L[t', t] (dy_t' . x_t),",
     "before", SSD_BWD_REV_ONE, "512 + c * 8 + 2"),
    ("    // dXD = diag(w) B R^T + SL^T DY; dx = dXD dt, dxdx_t = dXD_t . x_t", "before",
     SSD_BWD_REV_ONE, "512 + c * 8 + 3"),
    ("    // dB^h = diag(w dt) X R + ML^T Cs; dcum_t = C_t . dC^h_t - B_t . dB^h_t", "before",
     SSD_BWD_REV_ONE, "512 + c * 8 + 4"),
    ("    __syncthreads();  // every read of R is done; dxdx and dcum are ready", "after",
     SSD_BWD_REV_ONE, "512 + c * 8 + 5"),
    ("    // warp 0: da = the reverse running sum of dcum, from the carry; ddt and dA", "before",
     SSD_BWD_REV_ONE, "512 + c * 8 + 6"),
    ("    __syncthreads();  // the next sub-chunk overwrites the tiles; R is updated", "after",
     SSD_BWD_REV_ONE, "512 + c * 8 + 7"),
    ("  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, lane = tid % 32;\n"
     "  const float a = A[h];", "after", SSD_BWD_SPAN, "4096 + 2 * (blockIdx.y * H + blockIdx.x)"),
    ("  if (dinit != nullptr)\n    for (int i = tid; i < P * N; i += THREADS) dinit", "before",
     SSD_BWD_SPAN, "4096 + 2 * (blockIdx.y * H + blockIdx.x) + 1"),
    ("  const int rep = H / G;\n  if (i < 2 * n_out) {", "before", SSD_BWD_SPAN,
     "8192 + 2 * blockIdx.x"),
    ("    (is_c ? dC : dB)[i] = s;", "after", SSD_BWD_SPAN, "8192 + 2 * blockIdx.x + 1"),
]
FMA_BWD_PHASES = {
    "forward walk": (0, ["loads", "cumsum", "scores dY X^T", "dC^h (two products)",
                         "state update + barrier"]),
    "reverse walk": (512, ["loads", "cumsum", "scores C B^T, dY X^T", "dXD (two products)",
                           "dB^h (two products) + dcum", "R update", "dcum scan, ddt"]),
}


# the wgmma SSD backward (this tree): the first thread of each consumer
# warpgroup of block (0, 0) at each phase of every sub-chunk of the three
# walks (slots (2 W + consumer) * 512 + n * 8 + k, W the walk, n the
# sub-chunk in walk order), and every block's first consumer thread at its
# walk's start and end (from 4096 + 2048 W, two a block)
WG_BWD_ONE = ("blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x == 0 || threadIdx.x == 128) "
              "&& n < 64")
WG_BWD_AT = "(W * 2 + threadIdx.x / 128) * 512 + n * 8 + {k}"
WG_BWD_MARKS = [
    ("    mbar_wait(full(stg), (n / STAGES) & 1);", "after", WG_BWD_ONE, WG_BWD_AT.format(k=0)),
    ("    consumer_sync();  // the tiles and dts are written", "after", WG_BWD_ONE,
     WG_BWD_AT.format(k=1)),
    ("      consumer_sync();  // cum2, ecum, w and tot are ready", "before*", WG_BWD_ONE,
     WG_BWD_AT.format(k=2)),
    ("      consumer_sync();  // cum2, ecum, w and tot are ready", "after*", WG_BWD_ONE,
     WG_BWD_AT.format(k=3)),
    ("[&](int ks, float (&v)[4]) { acc_frag<64>(sc, ks, v); });", "after*", WG_BWD_ONE,
     WG_BWD_AT.format(k=4)),
    ("      // ST = exp(tot) ST + X^T diag(dt w) B", "before", WG_BWD_ONE, WG_BWD_AT.format(k=5)),
    ("      // R = exp(tot) R + dY^T diag(exp(cum)) C", "before", WG_BWD_ONE,
     WG_BWD_AT.format(k=5)),
    ("      // R^T = exp(tot) R^T + C^T diag(exp(cum)) dY, 64 rows of N at a time", "before",
     WG_BWD_ONE, WG_BWD_AT.format(k=5)),
    ("    consumer_sync();  // every read of the staged rows and the B tiles is done", "before",
     WG_BWD_ONE, WG_BWD_AT.format(k=6)),
    ("    write_state_tile(sacc);\n    fence_proxy_async();", "after", WG_BWD_ONE,
     WG_BWD_AT.format(k=7)),
    ("  const int ctid = threadIdx.x;", "after", "threadIdx.x == 0",
     "4096 + W * 2048 + 2 * (blockIdx.y * H + blockIdx.x)"),
    ("  if constexpr (W == C_WALK) {\n    // <dFinal", "before", "threadIdx.x == 0",
     "4096 + W * 2048 + 2 * (blockIdx.y * H + blockIdx.x) + 1"),
]
WG_BWD_PHASES = ["tiles + dt (and ring wait)", "products on staged rows", "wait for the cumsum",
                 "decays + intra-chunk product", "epilogue (out, fp64 partials)",
                 "state product", "barrier + state tile"]
WALKS = ("c_walk", "b_walk", "x_walk")


def spans(t, first, n):
    """(kernel span ns, median block ns) of the blocks whose first and last
    stamps sit at ``first + 2 i`` and ``+ 1``, i < n (blocks that stamped)."""
    pairs = [(t[first + 2 * i], t[first + 2 * i + 1]) for i in range(n)]
    pairs = [(a, b) for a, b in pairs if a and b >= a]
    if not pairs:
        return None, None
    return (max(b for _, b in pairs) - min(a for a, _ in pairs),
            int(statistics.median(b - a for a, b in pairs)))


def ssd_bwd_timeline(flush, gen, baseline):
    """The SSD backward's phases at both training shapes
    (``chip_smoke.SSD_BWD_SHAPES``): commit 377bd0d's FMA kernel from
    ``baseline``/ssd_scan_bwd.cu where given, then this tree's."""
    from repro_torch.kernels import ssd_bwd_ref
    if baseline is not None:
        fma_bwd_timeline(flush, gen, baseline)
    from repro_torch.kernels.ssd_scan import ops
    csrc = ROOT / "src/repro_torch/csrc"
    lib = build("ssd_scan_bwd", instrument((csrc / "ssd_scan_bwd.cu").read_text(), WG_BWD_MARKS),
                headers=csrc)
    on_wrapper(ops, lib, "dco_ssd_scan_bwd")
    for path, shape in chip_smoke.SSD_BWD_SHAPES.items():
        b, s, h, g, p, n = (shape[k] for k in ("b", "s", "h", "g", "p", "n"))
        x, dt, A, B, C = chip_smoke.ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
        dy = chip_smoke.randn(gen, (b, s, h, p), torch.float32)
        got = ops.ssd_scan_bwd(x, dt, A, B, C, dy)
        torch.cuda.synchronize()
        want = ssd_bwd_ref(x, dt, A, B, C, dy)
        held = chip_smoke.check_ssd_grads(got[:5] + (None,), want[:5] + (None,),
                                          chip_smoke.SSD_TOL[torch.float32],
                                          "instrumented ssd bwd")
        del got, want
        ms = flushed_launch(lib, lambda: ops.ssd_scan_bwd(x, dt, A, B, C, dy), flush)
        t = read(lib)
        n_sub = -(-s // 64)
        phases, kernels = {}, {}
        for wk, walk in enumerate(WALKS):
            for cw in range(2):
                base = (2 * wk + cw) * 512
                durs = {name: [] for name in WG_BWD_PHASES}
                for c in range(n_sub):
                    row = [t[base + c * 8 + k] for k in range(len(WG_BWD_PHASES) + 1)]
                    for k, name in enumerate(WG_BWD_PHASES):
                        durs[name].append(row[k + 1] - row[k])
                phases[f"{walk} consumer {cw}"] = {k: int(statistics.median(v))
                                                   for k, v in durs.items()}
            kernels[walk] = dict(zip(("span_ns", "block_ns_median"),
                                     spans(t, 4096 + 2048 * wk, b * h)))
        print(json.dumps({
            "kernel": "ssd_scan_bwd (wgmma)", "path": path, "shape": shape, "event_ms": ms,
            "worst_ratio": {k: r for k, (r, _) in held.items()}, "kernels": kernels,
            "sub_chunk_phase_ns_median": phases}), flush=True)


def fma_bwd_timeline(flush, gen, baseline):
    """The phases of commit 377bd0d's FMA kernel from ``baseline``/ssd_scan_bwd.cu."""
    sys.path.insert(0, str(ROOT / "scripts"))
    from kernel_compare import Baseline
    from repro_torch.kernels import ssd_bwd_ref
    src = (Path(baseline) / "ssd_scan_bwd.cu").read_text()
    lib = build("ssd_scan_bwd_fma", instrument(src, FMA_BWD_MARKS))
    for path, shape in chip_smoke.SSD_BWD_SHAPES.items():
        b, s, h, g, p, n = (shape[k] for k in ("b", "s", "h", "g", "p", "n"))
        x, dt, A, B, C = chip_smoke.ssd_inputs(gen, b, s, h, g, p, n, torch.float32)
        dy = chip_smoke.randn(gen, (b, s, h, p), torch.float32)
        call, outs = Baseline.ssd_bwd_entry(lib.dco_ssd_scan_bwd, x, dt, A, B, C, dy)
        call()
        torch.cuda.synchronize()
        want = ssd_bwd_ref(x, dt, A, B, C, dy)
        held = chip_smoke.check_ssd_grads(tuple(outs) + (None,), want[:5] + (None,),
                                          chip_smoke.SSD_TOL[torch.float32],
                                          "instrumented FMA ssd bwd")
        del want
        ms = flushed_launch(lib, call, flush)
        t = read(lib)
        n_sub = -(-s // 64)
        phases = {}
        for walk, (base, names) in FMA_BWD_PHASES.items():
            durs = {name: [] for name in names}
            for c in range(n_sub):
                row = [t[base + c * 8 + k] for k in range(len(names) + 1)]
                for k, name in enumerate(names):
                    durs[name].append(row[k + 1] - row[k])
            phases[walk] = {k: int(statistics.median(v)) for k, v in durs.items()}
        n_head = (2 * b * s * g * n + h + 255) // 256
        kernels = {name: dict(zip(("span_ns", "block_ns_median"), spans(t, first, cnt)))
                   for name, first, cnt in (("fwd_walk", 2048, b * h), ("rev_walk", 4096, b * h),
                                            ("head_sum", 8192, n_head))}
        print(json.dumps({
            "kernel": "ssd_scan_bwd (FMA, commit 377bd0d)", "path": path, "shape": shape,
            "event_ms": ms, "worst_ratio": {k: r for k, (r, _) in held.items()},
            "kernels": kernels, "sub_chunk_phase_ns_median": phases}), flush=True)


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


WGMMA_SRC = r"""
#include "hopper.cuh"
#include <cuda_runtime.h>
using namespace dco_hopper;

__device__ __forceinline__ int swoff(int rows, int r, int c) {
  return (c / 32) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// D (64 x N) = A (64 x K) B (K x N) by TF32 wgmma, A from registers, B a
// K-major 128-byte-swizzled tile written here.  MODE 0: A's fragment columns
// t, t + 4 and B in order; 1: columns 2t, 2t + 1 (an accumulator's) and K
// permuted in B to match; 2: 3xTF32, both split into hi and lo (mode 0's
// order).  Modes 0 and 1 hand the fp32 values over as they are.
template <int N>
__global__ void layout_kernel(const float* A, const float* B, float* D, int K, int mode) {
  extern __shared__ unsigned char sm[];
  const uint32_t s0 = smem_addr(sm);
  const uint32_t base = (s0 + 1023) & ~1023u;
  unsigned char* bp = sm + (base - s0);
  const int tb = N * 128 * (K / 32);
  for (int i = threadIdx.x; i < N * K; i += 128) {
    const int n = i / K, k = i % K;
    const float v = B[k * N + n];
    const int kk = mode == 1 ? ((k & ~7) | (((k & 7) >> 1) + 4 * (k & 1))) : k;
    uint32_t hi = __float_as_uint(v), lo = 0;
    if (mode == 2) {
      hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
      lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
    }
    *(uint32_t*)(bp + swoff(N, n, kk)) = hi;
    *(uint32_t*)(bp + tb + swoff(N, n, kk)) = lo;
  }
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r = 16 * w + g;
  for (int ks = 0; ks < K / 8; ++ks) {
    const int c0 = 8 * ks + (mode == 1 ? 2 * t : t), c1 = mode == 1 ? c0 + 1 : c0 + 4;
    const float av[4] = {A[r * K + c0], A[(r + 8) * K + c0], A[r * K + c1], A[(r + 8) * K + c1]};
    uint32_t ah[4], al[4];
    for (int i = 0; i < 4; ++i) {
      ah[i] = __float_as_uint(av[i]);
      al[i] = 0;
      if (mode == 2) {
        ah[i] = (__float_as_uint(av[i]) + 0x1000u) & 0xffffe000u;
        al[i] = (__float_as_uint(av[i] - __uint_as_float(ah[i])) + 0x1000u) & 0xffffe000u;
      }
    }
    const int boff = (ks / 4) * N * 128 + (ks % 4) * 32;
    wgmma_fence();
    wgmma_tf32<N>(d, ah, smem_desc(base + boff), 1);
    wgmma_tf32<N>(d, al, smem_desc(base + boff), 1);
    wgmma_tf32<N>(d, ah, smem_desc(base + tb + boff), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }
  for (int j = 0; j < N / 8; ++j) {
    D[r * N + 8 * j + 2 * t] = d[4 * j];
    D[r * N + 8 * j + 2 * t + 1] = d[4 * j + 1];
    D[(r + 8) * N + 8 * j + 2 * t] = d[4 * j + 2];
    D[(r + 8) * N + 8 * j + 2 * t + 1] = d[4 * j + 3];
  }
}

// Back-to-back 3xTF32 k-steps as ssd_scan_bwd.cu's product() issues them
// (K = 64, batches of four k-steps, a wait after each), two warpgroups a
// block, one block an SM, fragments held in registers: the ceiling of that
// pattern.
template <int N>
__global__ void __launch_bounds__(256, 1) rate_kernel(float* out, int iters) {
  extern __shared__ unsigned char sm[];
  const uint32_t s0 = smem_addr(sm);
  const uint32_t base = (s0 + 1023) & ~1023u;
  unsigned char* bp = sm + (base - s0);
  const int box = N * 128, half = 2 * box;
  for (int i = threadIdx.x; i < 2 * half / 4; i += 256)
    reinterpret_cast<uint32_t*>(bp)[i] = 0x3f800000u ^ (i & 0x1fff);
  fence_proxy_async();
  __syncthreads();
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t hi[8][4], lo[8][4];
  for (int k = 0; k < 8; ++k)
    for (int e = 0; e < 4; ++e) {
      hi[k][e] = 0x3f800000u + threadIdx.x + k;
      lo[k][e] = 0x33800000u + e;
    }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kb = 0; kb < 8; kb += 4) {
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ks = kb + i;
        const uint32_t at = base + (ks >> 2) * box + (ks & 3) * 32;
        wgmma_tf32<N>(d, hi[ks], smem_desc(at), 1);
        wgmma_tf32<N>(d, lo[ks], smem_desc(at), 1);
        wgmma_tf32<N>(d, hi[ks], smem_desc(at + half), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int dco_wgmma_layout(const float* A, const float* B, float* D, int N, int K, int mode) {
  const int smem = 1024 + 2 * N * 128 * (K / 32);
  if (N == 64) {
    cudaFuncSetAttribute(layout_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    layout_kernel<64><<<1, 128, smem>>>(A, B, D, K, mode);
  } else {
    cudaFuncSetAttribute(layout_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    layout_kernel<128><<<1, 128, smem>>>(A, B, D, K, mode);
  }
  return (int)cudaGetLastError();
}

extern "C" int dco_wgmma_rate(int n, float* out, int blocks, int iters) {
  const int smem = 1024 + 4 * n * 128 * 2;
  if (n == 32) {
    cudaFuncSetAttribute(rate_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    rate_kernel<32><<<blocks, 256, smem>>>(out, iters);
  } else if (n == 64) {
    cudaFuncSetAttribute(rate_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    rate_kernel<64><<<blocks, 256, smem>>>(out, iters);
  } else {
    cudaFuncSetAttribute(rate_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    rate_kernel<128><<<blocks, 256, smem>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
"""


def wgmma_probe():
    """What the SSD backward's products rest on: TF32 wgmma with a register
    A and a K-major swizzled B against float64 (the fragment layout as the
    header of csrc/ssd_scan_bwd.cu states it, with the K order permuted on
    both sides, and 3xTF32), whether the tensor cores truncate an fp32
    operand to TF32 or round it, and the rate of product()'s pattern."""
    lib = build("wgmma_probe", WGMMA_SRC, headers=ROOT / "src/repro_torch/csrc")
    lib.dco_wgmma_layout.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.dco_wgmma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def tf32(t, how):
        u = t.view(torch.int32)
        return ((u if how == "truncated" else u + 0x1000) & ~0x1FFF).view(torch.float32)

    for n in (64, 128):
        a = torch.randn(64, 64, device="cuda", generator=gen)
        b = torch.randn(64, n, device="cuda", generator=gen)
        ref = a.double() @ b.double()
        rec = {"n": n, "k": 64}
        for mode, name in ((0, "in_order"), (1, "k_permuted"), (2, "3xtf32")):
            d = torch.zeros(64, n, device="cuda")
            if lib.dco_wgmma_layout(a.data_ptr(), b.data_ptr(), d.data_ptr(), n, 64, mode) != 0:
                raise RuntimeError("wgmma layout probe failed to launch")
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            if mode == 2:
                rec["3xtf32_vs_fp64"] = float((d.double() - ref).abs().max()) / scale
                continue
            for how in ("truncated", "rounded"):
                want = tf32(a, how).double() @ tf32(b, how).double()
                rec[f"{name}_vs_{how}_inputs"] = float((d.double() - want).abs().max()) / scale
        print(json.dumps({"wgmma_layout": rec}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 256, device="cuda")
    iters = 2000
    for n in (32, 64, 128):
        lib.dco_wgmma_rate(n, out.data_ptr(), sms, 10)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        if lib.dco_wgmma_rate(n, out.data_ptr(), sms, iters) != 0:
            raise RuntimeError("wgmma rate probe failed to launch")
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        flop = sms * 2 * iters * 8 * 3 * 2 * 64 * n * 8   # two warpgroups a block
        print(json.dumps({"wgmma_tf32_rate": {"n": n, "ms": ms, "tflops": flop / ms * 1e-9}}),
              flush=True)


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
    ap.add_argument("--kernel", choices=("decode", "ssd", "both", "mma", "ssd_bwd", "wgmma"),
                    default="both")
    ap.add_argument("--baseline", metavar="DIR",
                    help="ssd_bwd: the directory of commit 377bd0d's ssd_scan_bwd.cu; "
                         "decode: of commit 25f5216's decode_attention.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timeline: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.kernel in ("decode", "both"):
        decode_timeline(flush, gen, args.baseline)
    if args.kernel in ("ssd", "both"):
        ssd_timeline(flush, gen)
    if args.kernel == "mma":
        mma_rate()
    if args.kernel == "ssd_bwd":
        ssd_bwd_timeline(flush, gen, args.baseline)
    if args.kernel == "wgmma":
        wgmma_probe()


if __name__ == "__main__":
    main()
