#!/usr/bin/env python3
"""Registers and spill bytes of the decode kernels in two ``nvcc -Xptxas -v``
logs: an earlier tree's decode source against this tree's build log.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
        -Xptxas -v -c OLD/decode_attention.cu -o /tmp/old.o > old_ptxas.log 2>&1
    python3 chip_smoke.py --phases device,build --build-log new_ptxas.log
    python3 scripts/ptxas_compare.py old_ptxas.log new_ptxas.log

The build log has a ``== <source>`` line before each source's output: the
serving kernels are those of ``decode_attention.cu``, the slice kernels
those of ``decode_attention_lse.cu`` (the same body, compiled again).  Prints
how many serving kernels keep the earlier registers and spills, each that
does not, and the slice kernels' range and spills.
"""

import argparse
from pathlib import Path
import re


def usage(log, source=None):
    """{template arguments of decode_kernel: {registers, spill_stores,
    spill_loads}} in ``log``, of ``source``'s section where given."""
    out, name, cur = {}, None, None
    for line in log.splitlines():
        m = re.match(r"== (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        if source is not None and cur != source:
            continue
        m = re.search(r"Compiling entry function '\w*?decode_kernelI(\w+?)EEv", line)
        if m:
            name = m.group(1)
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
    ap.add_argument("old", type=Path, help="the earlier decode source's ptxas output")
    ap.add_argument("new", type=Path, help="this tree's build log (--build-log)")
    args = ap.parse_args()
    old = usage(args.old.read_text())
    text = args.new.read_text()
    new = usage(text, "decode_attention.cu")
    sliced = usage(text, "decode_attention_lse.cu")
    same = [k for k in old if new.get(k) == old[k]]
    print(f"serving decode kernels: {len(old)} before, {len(new)} now, {len(same)} with the "
          "same registers and spills")
    for k in old:
        if new.get(k) != old[k]:
            print(f"  differs: {k} {old[k]} -> {new.get(k)}")
    if sliced:
        regs = [v["registers"] for v in sliced.values()]
        spills = {k: v for k, v in sliced.items() if v.get("spill_stores")}
        print(f"slice kernels: {len(sliced)}, registers {min(regs)}-{max(regs)}, "
              f"with spills: {spills}")


if __name__ == "__main__":
    main()
