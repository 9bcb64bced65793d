"""Roofline terms of a dry-run cell, for one NVIDIA H100 SXM, as the JAX
package's ``launch/roofline.py`` derives them for a TPU.

Three terms per (arch × shape × mesh):

    compute    = flops_per_chip       / PEAK_FLOPS
    memory     = bytes_per_chip       / HBM_BW
    collective = coll_bytes_per_chip  / NVLINK_BW

The constants are the H100 SXM5's (NVIDIA H100 Tensor Core GPU datasheet,
dense rates without sparsity): 989 TFLOP/s of bf16 tensor-core products,
3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s a GPU, 450 GB/s each way.  The
collective term divides the bytes that one card's collectives put on the
wire by what one card sends each way, 450 GB/s: a ring step sends as much as
it receives, and every card of a step sends at once.

The reference takes its per-chip FLOPs and bytes from XLA's cost analysis
and its collective bytes from the compiled HLO.  The port has no compiler
between the model and the card: ``launch/dryrun.py`` states the model's own
counts (``model_flops``, ``model_bytes``) divided by the ranks, and the
collective bytes are ``sharding.comm``'s tally of a run of the cell, or
``None`` (with the reason in the record) where the cell is not run.
``model_flops``, ``model_bytes``, ``param_count`` and their helpers are the
reference's, line for line: their numbers equal its.
"""

from __future__ import annotations

from dataclasses import asdict
from dataclasses import dataclass
from typing import Dict
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s of one H100 SXM
HBM_BW = 3.35e12             # bytes/s of one H100 SXM's HBM3
NVLINK_BW = 450e9            # bytes/s one H100 SXM sends over NVLink 4 (900 GB/s both ways)


@dataclass
class RooflineEntry:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: Optional[float]
    coll_breakdown: Optional[Dict[str, int]]
    peak_memory_bytes: Optional[float]
    model_flops_global: float
    model_bytes_global: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        if self.coll_bytes_per_chip is None:
            return None
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max((k for k in terms if terms[k] is not None), key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / per-chip FLOPs times chips."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def useful_bytes_ratio(self) -> float:
        total = self.bytes_per_chip * self.chips
        return self.model_bytes_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The time the binding resource needs for the model's own work
        (model FLOPs at peak compute or model bytes at peak HBM rate, the
        larger) over the largest of the three terms."""
        tmax = max(t for t in (self.t_compute, self.t_memory, self.t_collective)
                   if t is not None)
        useful_c = self.model_flops_global / self.chips / PEAK_FLOPS
        useful_m = self.model_bytes_global / self.chips / HBM_BW
        useful = max(useful_c, useful_m)
        return useful / tmax if tmax > 0 else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 useful_bytes_ratio=self.useful_bytes_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for training;
    2·N·D for inference forward; decode counts one new token per seq."""
    n = param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    flops = 2.0 * n * tokens
    if cfg.n_heads:
        apps = cfg.n_layers if cfg.hybrid_period is None \
            else cfg.n_layers // cfg.hybrid_period
        flops += (4.0 * cfg.n_heads * cfg.head_dim * shape.seq_len
                  * apps * tokens)
    return flops


def model_bytes(cfg, shape) -> float:
    """Algorithmically necessary global HBM traffic for one step.

    train:   3 passes over params (fwd read, bwd read, update rw) in bf16
             + moment reads/writes (fp32 m+v r/w) + activations ≈ params-
             dominated at these batch sizes.
    prefill: params read once (weights stream past activations) + KV write.
    decode:  params read + FULL KV cache read (the binding term) + state.
    """
    n = param_count(cfg)
    if shape.kind == "train":
        return 3 * 2.0 * n + 4 * 4.0 * n          # bf16 passes + fp32 m,v
    if shape.kind == "prefill":
        kv_write = _kv_cache_bytes(cfg, shape)
        return 2.0 * n + kv_write
    return 2.0 * n + _kv_cache_bytes(cfg, shape) + _state_bytes(cfg, shape)


def _kv_cache_bytes(cfg, shape) -> float:
    if not cfg.n_heads:
        return 0.0
    apps = cfg.n_layers if cfg.hybrid_period is None \
        else cfg.n_layers // cfg.hybrid_period
    return (2.0 * apps * shape.global_batch * shape.seq_len
            * cfg.n_kv_heads * cfg.head_dim * 2.0)


def _state_bytes(cfg, shape) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    di = cfg.ssm.expand * cfg.d_model
    h = di // cfg.ssm.head_dim
    per_l = h * cfg.ssm.head_dim * cfg.ssm.d_state * 4.0
    return 2.0 * cfg.n_layers * shape.global_batch * per_l   # read+write


def param_count(cfg, active_only: bool = False) -> float:
    """Approximate parameter count from the config (embedding included
    once; MoE counts only active experts when ``active_only``)."""
    d = cfg.d_model
    n = cfg.vocab * d * 2                       # embed + lm_head
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d if cfg.n_heads else 0
    if cfg.family == "dense":
        n += cfg.n_layers * (attn + 3 * d * cfg.d_ff)
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense
        n += nd * (attn + 3 * d * cfg.d_ff)
        e_active = cfg.moe.top_k if active_only else cfg.moe.n_experts
        per_e = 3 * d * cfg.moe.d_ff_expert
        shared = cfg.moe.n_shared * per_e
        n += (cfg.n_layers - nd) * (attn + e_active * per_e + shared)
    elif cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.expand * d
        h = di // cfg.ssm.head_dim
        gn = cfg.ssm.n_groups * cfg.ssm.d_state
        per_l = d * (2 * di + 2 * gn + h) + di * d
        n += cfg.n_layers * per_l
        if cfg.family == "hybrid":
            n += attn + 3 * d * cfg.d_ff       # shared block (once)
    return float(n)

