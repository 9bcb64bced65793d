"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed, top-6.

[arXiv:2401.06066; hf]  28L, d_model 2048, 16H MHA kv=16, head_dim 128,
expert d_ff 1408, vocab 102400; layer 0 uses a dense FFN (intermediate
10944 in the published model — we use 8*1408=11264-class width via
cfg.d_ff=10944).
"""
from . import ArchConfig
from . import MOE
from . import MoESpec

ARCH = ArchConfig(
    name="deepseek-moe-16b", family=MOE,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                first_dense=1),
)
