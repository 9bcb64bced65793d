"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L, d_model 2048, 32 heads (MHA), d_ff 8192,
vocab 2048 (one EnCodec codebook; the audio frontend — EnCodec encoder and
the codebook delay pattern — is a stub per spec: ``input_specs`` provides
precomputed frame token ids).
"""
from . import ArchConfig
from . import DENSE

ARCH = ArchConfig(
    name="musicgen-large", family=DENSE,
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="gelu", rope_theta=10_000.0,
    tie_embeddings=False, modality_stub="audio",
)
