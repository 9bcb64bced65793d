"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) — MoE 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L, d_model 2048, 16H GQA kv=16,
head_dim 128, expert d_ff 1408, 2 shared experts, vocab 163840, first
layer dense.
"""
from . import ArchConfig
from . import MOE
from . import MoESpec

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b", family=MOE,
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=11264, vocab=163840,
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                first_dense=1),
)
