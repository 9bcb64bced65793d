"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242; unverified]  81 Mamba2 layers (d_model 3584, ssm_state
64) with a single weight-shared transformer block (32H MHA kv=32, d_ff
14336) applied every ``hybrid_period`` Mamba layers.  Deviation noted in
DESIGN.md: the published model alternates two shared blocks with LoRA
projectors; we implement one shared block every 6 layers.
"""
from . import ArchConfig
from . import HYBRID
from . import SSMSpec

ARCH = ArchConfig(
    name="zamba2-7b", family=HYBRID,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="gelu",
    ssm=SSMSpec(d_state=64, expand=2, head_dim=64, chunk=256),
    hybrid_period=6, sub_quadratic=True,
)
