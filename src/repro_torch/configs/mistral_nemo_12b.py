"""Mistral-Nemo-12B — dense, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]  40L, d_model 5120, 32H GQA
kv=8, head_dim 128, d_ff 14336, vocab 131072, rope theta 1e6.
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="mistral-nemo-12b", family=DENSE,
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1e6, tie_embeddings=False,
)
