"""Mamba2-2.7B — pure SSM (SSD / state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L, d_model 2560, d_state 128,
expand 2 → d_inner 5120, head_dim 64 → 80 SSD heads.  DCO-applicability:
attention-free → the paper's KV-cache bypass/anti-thrash policies do not
apply (DESIGN.md §4); the SSD chunk-state lifetime still maps to the
dead-block insight.
"""
from . import ArchConfig
from . import SSM
from . import SSMSpec

ARCH = ArchConfig(
    name="mamba2-2.7b", family=SSM,
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm=SSMSpec(d_state=128, expand=2, head_dim=64, chunk=256),
    sub_quadratic=True,
)
