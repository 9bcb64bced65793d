"""Qwen2-VL-7B — VLM backbone with M-RoPE (dynamic resolution frontend
stubbed).

[arXiv:2409.12191; hf]  28L, d_model 3584, 28H GQA kv=4, d_ff 18944,
vocab 152064.  M-RoPE splits rotary frequencies into temporal/height/width
sections (16, 24, 24 half-dims).  The vision tower is a stub per spec:
``input_specs`` provides token ids + 3-plane position ids.
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="qwen2-vl-7b", family=DENSE,
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24), tie_embeddings=False,
    modality_stub="vision",
)
