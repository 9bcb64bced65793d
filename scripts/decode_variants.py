#!/usr/bin/env python3
"""Variants of the bf16 decode kernel, built side by side and timed in turns.

    python3 scripts/decode_variants.py

Builds this tree's ``src/repro_torch/csrc/decode_attention.cu`` and each
variant of ``VARIANTS`` into a library of its own (``build/variants/decode/
<name>/``, with the ``*.cuh`` of ``csrc`` beside it; ``-Xptxas -v``), points
the wrapper ``ops.decode_attention`` at each in turn and, at every bf16
decode shape of PERF.md's table (``kernel_compare.DECODE_SHAPES``), checks
each against the plain version and times it (``chip_smoke.time_ms``) twice,
in the order base, variants, variants reversed, base.  A variant is a list
of [old, new] text replacements of the source (each ``old`` must occur
once), and may set the wrapper's ``UNIT_TILES_AT_MOST`` or hand the kernel a
scratch buffer and counters (the counter merge).  First prints, for each
library, the clusters of 1 to 8 blocks the card runs at once at each head
size (``dco_decode_clusters``) and its decode kernels' registers.  Needs one
CUDA device and nvcc.

The variants are the forms PERF.md records against this tree's kernel:
``counter_merge`` (each block's partial to global scratch, a counter, the
last block merging: the alternative to the cluster merge, on the same map),
``unit_tiles_16`` (the cluster size C from a cap of 16 tiles a block, where
this tree's takes 8) and ``stages_3`` (three ring stages at D 112 and 128,
two blocks an SM).
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path
import subprocess
import sys

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs
import kernel_compare as kc
# the port
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import decode_attention
from repro_torch.kernels import decode_attention_ref
from repro_torch.kernels.decode_attention import ops

CSRC = ROOT / "src" / "repro_torch" / "csrc"

# the counter merge: partials to `part`, the last block of a (batch row, KV
# head) to count itself in merging them, the counter set back to 0; no cluster
COUNTER_MERGE = [
    ("  float* lse;         // SLICE: each row's log-sum-exp (B, H)\n",
     "  float* lse;         // SLICE: each row's log-sum-exp (B, H)\n"
     "  float* part;        // partials: (B, G, units) x (group x D, then m, l)\n"
     "  int* counters;      // (B, G), 0 between calls\n"),
    ("  float* pm = reinterpret_cast<float*>(qbuf_ptr + (ring - qbuf));  // m of the group's rows\n"
     "  float* pl = pm + W_PACKED;                                        // then l\n"
     "  float* pacc = pl + W_PACKED;                                      // then acc, group x D\n",
     "  const long long part_n = (long long)group * D + (2 * group + 3) / 4 * 4;\n"
     "  float* pacc = a.part + (((long long)b * a.G + g) * C + rank) * part_n;\n"
     "  float* pm = pacc + group * D;\n"
     "  float* pl = pm + group;\n"),
    ("  cluster_arrive();  // the partials written, released to the cluster\n"
     "  cluster_wait();\n",
     "  if (rank >= active) return;\n"
     "  int& last = *reinterpret_cast<int*>(qbuf_ptr + (bars - qbuf) + W_BAR_BYTES - 32);\n"
     "  __threadfence();\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     "    int* ctr = a.counters + (long long)b * a.G + g;\n"
     "    last = atomicAdd(ctr, 1) == active - 1;\n"
     "    if (last) atomicExch(ctr, 0);\n"
     "  }\n"
     "  __syncthreads();\n"
     "  if (!last) return;\n"
     "  __threadfence();\n"),
    ("  const uint32_t pm_s = smem_addr(pm), pl_s = smem_addr(pl), pacc_s = smem_addr(pacc);\n"
     "  const int n4 = group * D / 4;\n"
     "  const int share = (n4 + C - 1) / C;\n"
     "  const int e_end = min(n4, (rank + 1) * share);\n"
     "  for (int e = rank * share + threadIdx.x; e < e_end; e += W_THREADS) {\n",
     "  const long long part0 = ((long long)b * a.G + g) * C * part_n;\n"
     "  const int n4 = group * D / 4;\n"
     "  for (int e = threadIdx.x; e < n4; e += W_THREADS) {\n"),
    ("        mv[v] = ld_cluster(cluster_map(pm_s + 4 * r, v));\n"
     "        lv[v] = ld_cluster(cluster_map(pl_s + 4 * r, v));\n"
     "        av[v] = ld_cluster4(cluster_map(pacc_s + 4 * (r * D + col), v));\n",
     "        const float* pv = a.part + part0 + v * part_n;\n"
     "        mv[v] = __ldcg(pv + group * D + r);\n"
     "        lv[v] = __ldcg(pv + group * D + group + r);\n"
     "        av[v] = __ldcg(reinterpret_cast<const float4*>(pv + r * D + col));\n"),
    ("  cluster_arrive();  // no block leaves while another reads its partial\n"
     "  cluster_wait();\n}\n", "}\n"),
    ("  cfg.numAttrs = 1;\n  err = cudaLaunchKernelEx(", "  cfg.numAttrs = 0;\n  err = cudaLaunchKernelEx("),
    ("                void* out, void* lse, int B, int S, int H, int G, int units, int rows,\n",
     "                void* out, void* lse, void* scratch, void* counters, int B, int S, int H,\n"
     "                int G, int units, int rows,\n"),
    ("  a.lse = static_cast<float*>(lse);\n  a.B = B;\n",
     "  a.lse = static_cast<float*>(lse);\n  a.part = static_cast<float*>(scratch);\n"
     "  a.counters = static_cast<int*>(counters);\n  a.B = B;\n"),
    ("    return launch_bf16(D, q, k, v, cache_len, out, lse, B, S, H, G, units, rows, target,\n",
     "    return launch_bf16(D, q, k, v, cache_len, out, lse, scratch, counters, B, S, H, G, units,\n"
     "                       rows, target,\n"),
]
VARIANTS = {
    "counter_merge": dict(patches=COUNTER_MERGE, scratch=True),
    "unit_tiles_16": dict(unit_tiles_at_most=16),
    "stages_3": dict(patches=[("return D > 128 ? 3 : D > 64 ? 2 : 4;",
                               "return D > 128 ? 3 : D > 64 ? 3 : 4;"),
                              ("  return D > 128 ? 1 : 3;\n}", "  return D > 128 ? 1 : 2;\n}")]),
}


def build(name, patches):
    """The variant's library: its ``dco_decode_attention`` and its
    ``dco_decode_clusters``."""
    src = (CSRC / "decode_attention.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: text not found once: {old[:60]!r}")
        src = src.replace(old, new)
    d = kbuild.build_dir() / "variants" / "decode" / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "decode_attention.cu").write_text(src)
    for hdr in CSRC.glob("*.cuh"):
        (d / hdr.name).write_text(hdr.read_text())
    path = kbuild.build(verbose=True, csrc=d)
    usage = {k: v for k, v in cs.ptxas_usage(Path(path).with_suffix(".log").read_text()).items()
             if "decode_wgmma" in k}
    lib = ctypes.CDLL(str(path))
    fn = lib.dco_decode_attention
    fn.argtypes, fn.restype = ops.ARGTYPES, ctypes.c_int
    clusters = lib.dco_decode_clusters
    clusters.argtypes, clusters.restype = [ctypes.c_int] * 3, ctypes.c_int
    print(json.dumps({"variant": name, "ptxas": usage, "clusters_at_once": {
        d_: [clusters(d_, 3, c) for c in range(1, 9)] for d_ in (64, 112, 128, 256)}}),
        flush=True)
    return fn, clusters


def with_scratch(fn):
    """``fn`` handed a scratch buffer and zeroed counters in place of the
    wrapper's nulls (bf16 calls), sized for the largest call timed here."""
    scratch = torch.empty(8 * 32 * 8 * 1024, dtype=torch.float32, device="cuda")
    counters = torch.zeros(8 * 32, dtype=torch.int32, device="cuda")

    def call(*args):
        args = list(args)
        if args[7] == 0:   # dtype bf16
            args[5], args[6] = scratch.data_ptr(), counters.data_ptr()
        return fn(*args)
    call.buffers = (scratch, counters)
    return call


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    libs = {"base": build("base", [])}
    for name, spec in VARIANTS.items():
        libs[name] = build(name, spec.get("patches", []))
    rooms = {name: {} for name in libs}
    fns = {name: with_scratch(fn) if VARIANTS.get(name, {}).get("scratch") else fn
           for name, (fn, _) in libs.items()}
    default_cap = ops.UNIT_TILES_AT_MOST

    def use(name):
        ops._fns["dco_decode_attention"] = fns[name]
        ops._fns["dco_decode_clusters"] = libs[name][1]
        ops._rooms = rooms[name]
        ops.UNIT_TILES_AT_MOST = VARIANTS.get(name, {}).get("unit_tiles_at_most", default_cap)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    order = list(libs)
    for path, lens, local in kc.DECODE_SHAPES:
        h, g, d = cs.ATTN_SHAPES[path]
        timed = cs.ATTN_TIMED.get(path, {})
        kw = {key: timed[key] for key in ("softcap", "scale") if key in timed}
        if local:
            kw["window"] = timed["window"]
        pool = {"s": timed["pool"]} if "pool" in timed else {}
        q, k, v, cl = cs.decode_inputs(gen, lens, h, g, d, **pool)
        ref = decode_attention_ref(q, k, v, cl, **kw)
        units = {}
        for name in order:
            use(name)
            cs.close(decode_attention(q, k, v, cl, **kw), ref, cs.TOL[torch.bfloat16],
                     f"{name} at {path} {lens}")
            units[name] = ops.wgmma_plan(
                8, k.shape[1], h, g, d, window=kw.get("window"),
                cluster_room=ops._cluster_room(q.device, d, h // g)).units

        def run(name):
            def f():
                use(name)
                return decode_attention(q, k, v, cl, **kw)
            return f
        turns = {}
        for name in order + order[::-1]:
            turns.setdefault(name, []).append(cs.time_ms(run(name), flush))
        print(json.dumps({"shape": f"{path} {lens}{' local' if local else ''}", "units": units,
                          "ms": {n: sum(t) / len(t) for n, t in turns.items()},
                          "turns_ms": turns}), flush=True)
    use("base")


if __name__ == "__main__":
    main()
