#!/usr/bin/env python3
"""Registers and spill bytes of the serving kernels in two ``nvcc -Xptxas -v``
logs: an earlier tree's source against this tree's build log.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
        -Xptxas -v -c OLD/decode_attention.cu -o /tmp/old.o > old_ptxas.log 2>&1
    python3 chip_smoke.py --phases device,build --build-log new_ptxas.log
    python3 scripts/ptxas_compare.py old_ptxas.log new_ptxas.log
    python3 scripts/ptxas_compare.py --kernel flash old_flash.log new_ptxas.log
    python3 scripts/ptxas_compare.py --kernel flash_bwd old_bwd.log new_ptxas.log

The build log has a ``== <source>`` line before each source's output.
``--kernel decode`` (the default): the serving kernels are those of
``decode_attention.cu``, the variant those of ``decode_attention_lse.cu``
(the same body, compiled again).  ``--kernel flash``: the serving kernels
are ``flash_kernel``, ``flash_mma_kernel`` and ``flash_mma_lse_kernel`` of
``flash_attention.cu`` (an earlier ``flash_attention.cu`` needs
``bf16_tiles.cuh`` beside it), the variant the position kernels of
``flash_attention_pos.cu``.  ``--kernel flash_bwd``: the backward's
kernels of ``flash_attention_bwd.cu`` (the delta kernel, the fp32 ones and
the bf16 ones, whose names changed with the Hopper kernels: the earlier
``dkdv_mma*`` / ``dq_mma*`` are listed beside today's ``dkdv_wgmma*`` /
``dq_wgmma*``), the variant those of ``flash_attention_bwd_pos.cu``; an
earlier ``flash_attention_bwd.cu`` needs its headers beside it, and
``scripts/kernel_compare.py --kernel flash_bwd`` prints both builds' maps.
Prints how many kernels of both logs keep the earlier registers and spills,
each that does not, the kernels of one log only, and the variant's range and
spills.
"""

import argparse
from pathlib import Path
import re

# kernel: (serving kernels' names, serving source, the variant's source)
KERNELS = {
    "decode": (("decode_kernel",), "decode_attention.cu", "decode_attention_lse.cu"),
    "flash": (("flash_kernel", "flash_mma_kernel", "flash_mma_lse_kernel",
               "flash_pos_kernel", "flash_mma_pos_kernel"),
              "flash_attention.cu", "flash_attention_pos.cu"),
    "flash_bwd": (("delta_kernel", "dkdv_kernel", "dkdv_ext_kernel", "dq_kernel", "dq_ext_kernel",
                   "dkdv_mma_kernel", "dkdv_mma_ext_kernel", "dq_mma_kernel", "dq_mma_ext_kernel",
                   "dkdv_wgmma_kernel", "dkdv_wgmma_ext_kernel", "dkdv_wgmma_pos_kernel",
                   "dq_wgmma_kernel", "dq_wgmma_ext_kernel", "dq_wgmma_pos_kernel"),
                  "flash_attention_bwd.cu", "flash_attention_bwd_pos.cu"),
}


def usage(log, names, source=None):
    """{kernel and template arguments: {registers, spill_stores,
    spill_loads}} of the kernels ``names`` in ``log``, of ``source``'s
    section where given."""
    out, name, cur = {}, None, None
    pattern = re.compile(r"Compiling entry function '\w*?\d+(" + "|".join(names)
                         + r")I(\w+?)E+v")
    for line in log.splitlines():
        m = re.match(r"== (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        if source is not None and cur != source:
            continue
        m = pattern.search(line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
            out[name] = {}
            continue
        if "Compiling entry function" in line:
            name = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the earlier source's ptxas output")
    ap.add_argument("new", type=Path, help="this tree's build log (--build-log)")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="decode")
    args = ap.parse_args()
    names, serving, variant = KERNELS[args.kernel]
    old = usage(args.old.read_text(), names)
    text = args.new.read_text()
    new = usage(text, names, serving)
    sliced = usage(text, names, variant)
    if args.kernel == "flash_bwd":   # the earlier log: its serving source's kernels only
        old = usage(args.old.read_text(), names, serving) or old
    both = [k for k in old if k in new]
    same = [k for k in both if new[k] == old[k]]
    print(f"serving {args.kernel} kernels: {len(old)} before, {len(new)} now, {len(same)} with "
          "the same registers and spills")
    for k in both:
        if new[k] != old[k]:
            print(f"  differs: {k} {old[k]} -> {new[k]}")
    for k in old:
        if k not in new:
            print(f"  before only: {k} {old[k]}")
    for k in new:
        if k not in old:
            print(f"  now only: {k} {new[k]}")
    if sliced:
        regs = [v["registers"] for v in sliced.values()]
        spills = {k: v for k, v in sliced.items() if v.get("spill_stores")}
        print(f"{variant} kernels: {len(sliced)}, registers {min(regs)}-{max(regs)}, "
              f"with spills: {spills}")
        for k, v in sorted(sliced.items()):
            print(f"  {k} {v}")


if __name__ == "__main__":
    main()
