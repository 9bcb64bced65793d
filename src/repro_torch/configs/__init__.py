"""Architecture configs (one module per assigned arch) + shape grid.

``get_arch(name)`` returns the full published config; ``reduce_for_smoke``
shrinks it to a CPU-runnable size with the same structure (family, GQA
ratio, MoE top-k, SSD chunking all preserved).
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace
import importlib
from typing import Dict
from typing import Optional
from typing import Tuple

DENSE, MOE, SSM, HYBRID = "dense", "moe", "ssm", "hybrid"


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0          # leading layers with dense FFN


@dataclass(frozen=True)
class SSMSpec:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"
    rope_theta: float = 1e4
    mrope_sections: Optional[Tuple[int, int, int]] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None
    local_global_period: Optional[int] = None  # every Nth layer is global
    attn_scale: Optional[float] = None
    qk_norm: bool = False
    gemma_norm: bool = False
    tie_embeddings: bool = True
    moe: Optional[MoESpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid_period: Optional[int] = None        # shared attn every N ssm layers
    sub_quadratic: bool = False                # supports long_500k
    modality_stub: Optional[str] = None        # "audio" | "vision" frontends

    @property
    def attention_free(self) -> bool:
        return self.family == SSM


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "musicgen_large", "zamba2_7b", "mamba2_2p7b", "qwen2_vl_7b",
    "gemma2_27b", "llama3p2_3b", "mistral_nemo_12b", "gemma_7b",
    "deepseek_moe_16b", "moonshot_v1_16b_a3b",
]

_ALIASES = {
    "musicgen-large": "musicgen_large",
    "zamba2-7b": "zamba2_7b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "gemma2-27b": "gemma2_27b",
    "llama3.2-3b": "llama3p2_3b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "gemma-7b": "gemma_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}


def get_arch(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.ARCH


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is (arch × shape) runnable? Returns (ok, reason-if-skipped).

    Per spec: long_500k needs sub-quadratic context handling — skipped for
    pure full-attention archs (documented in DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k requires sub-quadratic"
    return True, ""


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Shrink to a single-CPU testable size preserving the family shape."""
    changes = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab=512,
        window=min(cfg.window, 64) if cfg.window else None,
    )
    if cfg.moe:
        # capacity_factor = E/k → capacity ≥ tokens: no drops, so prefill
        # vs full-forward equivalence is exact in the smoke tests
        changes["moe"] = replace(cfg.moe, n_experts=8, top_k=2,
                                 d_ff_expert=64,
                                 n_shared=min(cfg.moe.n_shared, 1),
                                 first_dense=min(cfg.moe.first_dense, 1),
                                 capacity_factor=4.0)
    if cfg.ssm:
        changes["ssm"] = replace(cfg.ssm, d_state=16, head_dim=32, chunk=32)
    if cfg.hybrid_period:
        changes["n_layers"] = 4
        changes["hybrid_period"] = 2
    if cfg.n_kv_heads == cfg.n_heads:        # preserve MHA
        changes["n_kv_heads"] = changes["n_heads"]
    if cfg.mrope_sections:
        changes["mrope_sections"] = (8, 12, 12)   # sums to head_dim/2 = 32
    return replace(cfg, **changes)
