"""Quickstart of the PyTorch/CUDA port: the three layers of the DCO
reproduction in one script, as ``examples/quickstart.py`` runs them on the
JAX package.

1. paper core — simulate the DCO policies on a GQA FlashAttention trace
   (host numpy, the port's copy of the simulator),
2. model zoo  — train a reduced llama3.2-3b for 30 steps,
3. Hopper side — plan the pinned KV prefix with the CacheOrchestrator
   against an H100 block's shared memory and run the DCO-orchestrated flash
   kernel against its plain version.

Runs on the card unless ``--device cpu`` is given; on the CPU parts 2 and 3
run the plain versions of the kernels, and part 3 says so.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

from repro_torch import require_device
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.core import CacheOrchestrator
from repro_torch.core import SimConfig
from repro_torch.core import build_fa2_trace
from repro_torch.core import get_workload
from repro_torch.core import hopper_pin_budget_bytes
from repro_torch.core import named_policy
from repro_torch.core import run_policy
from repro_torch.core.orchestrator import FLASH_TILE_ROWS
from repro_torch.core.orchestrator import flash_kv_row_bytes
from repro_torch.data import SyntheticLM
from repro_torch.kernels import attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig
from repro_torch.train import init_train_state
from repro_torch.train import make_train_step

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
dev = require_device(ap.parse_args().device)

# ---- 1. the paper's cache policies under thrashing -----------------------
print("=== DCO policies on Gemma3-27B attention (2K ctx, 4MB LLC) ===")
wl = get_workload("gemma3-27b", seq_len=2048)
trace = build_fa2_trace(wl)
cfg = SimConfig(llc_bytes=4 * 2**20)
lru = run_policy(trace, named_policy("lru"), cfg, record_history=False)
for pol in ("at", "at+bypass", "all"):
    res = run_policy(trace, named_policy(pol), cfg, record_history=False)
    print(f"  {pol:10s}: {lru.cycles / res.cycles:.2f}x over LRU "
          f"(hit {res.hit_rate:.2f} vs {lru.hit_rate:.2f})")

# ---- 2. train a tiny assigned architecture -------------------------------
print(f"=== Train a reduced llama3.2-3b for 30 steps ({dev.type}) ===")
arch = reduce_for_smoke(get_arch("llama3.2-3b"))
state = init_train_state(init_params(arch, seed=0, device=dev))
step = make_train_step(arch, AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=30), device=dev)
data = SyntheticLM(arch.vocab, 64, 8)
for i in range(30):
    state, m = step(state, data.batch(i))
    if i % 10 == 0 or i == 29:
        print(f"  step {i:2d} loss={float(m['loss']):.3f}")

# ---- 3. the Hopper transfer: orchestrated flash attention ----------------
print("=== CacheOrchestrator → pinned/streamed KV split ===")
seq, d = 1024, 128
budget = hopper_pin_budget_bytes(d, 2)
orch = CacheOrchestrator(vmem_budget_bytes=budget, b_bits=3)
pinned, streamed = orch.plan_kv_split(seq, FLASH_TILE_ROWS, flash_kv_row_bytes(d, 2))
print(f"  shared-memory budget {budget // 1024}KB → pin {pinned} KV rows "
      f"(anti-thrashing), stream {streamed} (bypass)")
gen = torch.Generator(device=dev).manual_seed(1)
q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
           for shape in ((1, seq, 4, d), (1, seq, 2, d), (1, seq, 2, d)))
out = flash_attention(q, k, v, causal=True, pinned_rows=pinned)
ref = attention_ref(q, k, v, causal=True)
err = float((out.float() - ref.float()).abs().max())
ran = "the CUDA kernel" if dev.type == "cuda" else "the plain version: no kernel on the CPU"
print(f"  kernel vs oracle max |err| = {err:.2e}  ({ran})")
print("done.")
