"""Gemma2-27B — dense, local+global alternating attention, logit softcap.

[arXiv:2408.00118; hf]  46L, d_model 4608, 32H GQA kv=16, head_dim 128,
d_ff 36864, vocab 256000; sliding window 4096 on local layers (every other
layer global), attention softcap 50.0, final-logit softcap 30.0,
query scale (d_model/n_heads)^-0.5 = 144^-0.5.
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="gemma2-27b", family=DENSE,
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000, act="gelu",
    attn_softcap=50.0, final_softcap=30.0,
    window=4096, local_global_period=2,
    attn_scale=144.0 ** -0.5, gemma_norm=True,
)
