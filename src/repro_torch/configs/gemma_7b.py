"""Gemma-7B — dense, GeGLU, head_dim 256.

[arXiv:2403.08295; hf]  28L, d_model 3072, 16H (kv=16: MHA on 7b; MQA is
the 2b variant), head_dim 256, d_ff 24576, vocab 256000, GeGLU.
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="gemma-7b", family=DENSE,
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="gelu", gemma_norm=True,
)
