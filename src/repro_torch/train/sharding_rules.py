"""Per-architecture logical sharding rules for params / optimizer state /
inputs, as the JAX package's ``train/sharding_rules.py``: pure data.

The rules are trees of *logical axis tuples* structurally matching
``models.init_params(cfg)``; ``repro_torch.sharding.logical_spec`` translates
them to specs for a concrete mesh.
"""

from __future__ import annotations

from typing import Any
from typing import Tuple

from ..configs import ArchConfig
from ..configs import DENSE
from ..configs import HYBRID
from ..configs import MOE
from ..configs import SSM


def _attn_axes(stacked: bool, qk_norm: bool):
    L = (None,) if stacked else ()
    p = {
        "ln": L + (None,),
        "wq": L + (None, "tp", None),
        "wk": L + (None, "tp", None),
        "wv": L + (None, "tp", None),
        "wo": L + ("tp", None, None),
    }
    if qk_norm:
        p["q_norm"] = L + (None,)
        p["k_norm"] = L + (None,)
    return p


def _mlp_axes(stacked: bool):
    L = (None,) if stacked else ()
    return {
        "ln": L + (None,),
        "w_gate": L + (None, "tp"),
        "w_up": L + (None, "tp"),
        "w_down": L + ("tp", None),
    }


def _moe_axes():
    # experts sharded over the model axis (EP); shared experts TP-sharded
    return {
        "ln": (None, None),
        "w_gate": (None, None, None),
        "w1": (None, "ep", None, None),
        "w3": (None, "ep", None, None),
        "w2": (None, "ep", None, None),
        "sh_gate": (None, None, "tp"),
        "sh_up": (None, None, "tp"),
        "sh_down": (None, "tp", None),
    }


def _mamba_axes(extra_lead: Tuple = (None,)):
    L = extra_lead
    return {
        "ln": L + (None,),
        "w_z": L + (None, "tp"),
        "w_x": L + (None, "tp"),
        "w_bc": L + (None, None),
        "w_dt": L + (None, "tp"),
        "conv_x_w": L + (None, "tp"),
        "conv_x_b": L + ("tp",),
        "conv_bc_w": L + (None, None),
        "conv_bc_b": L + (None,),
        "dt_bias": L + ("tp",),
        "a_log": L + ("tp",),
        "d_skip": L + ("tp",),
        "out_ln": L + ("tp",),
        "w_out": L + ("tp", None),
    }


def _map_axes(fn, axes):
    """``fn`` over every axes tuple of a rules tree (dicts of tuples)."""
    if isinstance(axes, dict):
        return {k: _map_axes(fn, v) for k, v in axes.items()}
    return fn(axes)


def param_logical_axes(cfg: ArchConfig) -> Any:
    axes: dict = {
        "embed": (None, "tp"),       # D-sharded: row gather stays local
        "ln_f": (None,),
        "lm_head": (None, "tp"),     # vocab-sharded logits
    }
    if cfg.family == DENSE:
        axes["layers"] = {"attn": _attn_axes(True, cfg.qk_norm),
                          "mlp": _mlp_axes(True)}
    elif cfg.family == MOE:
        if cfg.moe.first_dense:
            axes["dense_layers"] = {"attn": _attn_axes(True, cfg.qk_norm),
                                    "mlp": _mlp_axes(True)}
        moe_axes = _moe_axes()
        if not cfg.moe.n_shared:
            for k in ("sh_gate", "sh_up", "sh_down"):
                moe_axes.pop(k)
        axes["moe_layers"] = {"attn": _attn_axes(True, cfg.qk_norm),
                              "moe": moe_axes}
    elif cfg.family == SSM:
        axes["layers"] = _mamba_axes((None,))
    elif cfg.family == HYBRID:
        axes["mamba_groups"] = _mamba_axes((None, None))
        if cfg.n_layers % cfg.hybrid_period:
            axes["mamba_tail"] = _mamba_axes((None,))
        axes["shared_attn"] = _attn_axes(False, cfg.qk_norm)
        axes["shared_mlp"] = _mlp_axes(False)
    return axes


def opt_logical_axes(cfg: ArchConfig) -> Any:
    """ZeRO-1: moments get an extra 'zero' (data-axis) sharding on the
    first axis that the param rules leave unsharded and whose size is
    large (the leading stacked-layer axis)."""
    p_axes = param_logical_axes(cfg)

    def zero_ify(axes):
        axes = tuple(axes)
        if len(axes) >= 2 and axes[0] is None:
            return ("zero",) + axes[1:]
        return axes

    return _map_axes(zero_ify, p_axes)


def batch_logical_axes() -> Tuple:
    return ("dp", None)              # (batch, seq)
