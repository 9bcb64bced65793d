"""Llama-3.2-3B — small dense Llama3.

[hf:meta-llama/Llama-3.2-3B; unverified]  28L, d_model 3072, 24H GQA kv=8,
head_dim 128, d_ff 8192, vocab 128256, rope theta 500k.
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="llama3.2-3b", family=DENSE,
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=500_000.0,
)
