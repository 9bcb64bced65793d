#!/usr/bin/env python3
"""Which gloo collectives carry CUDA tensors, two ranks sharing one card.

    python3 scripts/gloo_cuda_probe.py

Starts two processes of this script on card 0, joined to a gloo process
group (NCCL refuses two ranks on one GPU, so ``chip_smoke.py``'s mesh phases
use gloo), and tries ``all_reduce`` (sum, max), ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter`` and ``reduce_scatter_tensor``
on CUDA tensors in fp32, bf16 and int64; then times one all-reduce of 256
MB of fp32.  Prints the card's name and power limit and one JSON object.
"""

import json
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def child(rank, store):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    res = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        x = (torch.arange(8, device="cuda") + rank).to(dt)
        calls = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
            "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(16, dtype=dt, device="cuda"), x),
            "reduce_scatter": lambda: dist.reduce_scatter(
                torch.empty(4, dtype=dt, device="cuda"), list(x.clone().chunk(2))),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(4, dtype=dt, device="cuda"), x.clone()),
        }
        for name, call in calls.items():
            try:
                call()
                torch.cuda.synchronize()
                res[f"{dt}/{name}"] = "ok"
            except RuntimeError as exc:
                res[f"{dt}/{name}"] = f"{type(exc).__name__}: {str(exc)[:120]}"
    big = torch.ones(1 << 26, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    dist.all_reduce(big)
    torch.cuda.synchronize()
    res["all_reduce_256MB_fp32_seconds"] = time.time() - t0
    if rank == 0:
        print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main():
    if len(sys.argv) == 3:
        child(int(sys.argv[1]), sys.argv[2])
        return
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, __file__, str(r), f"{d}/store"])
                 for r in range(2)]
        codes = [p.wait(timeout=300) for p in procs]
    if any(codes):
        raise SystemExit(f"gloo_cuda_probe: ranks exited {codes}")


if __name__ == "__main__":
    main()
