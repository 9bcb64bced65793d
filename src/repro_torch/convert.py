"""Carry parameter and cache trees from the JAX package into the port.

The port keeps the JAX package's tree layout (same keys, same stacked
leading layer axis), so the bridge is a 1:1 map over leaves.  The caller
hands over numpy arrays; bf16 leaves cross as fp32 (numpy has no bf16) and
are narrowed again here, which is exact.  The leaves the reference keeps in
fp32 (the SSM's ``a_log`` and ``d_skip``, the MoE router's ``moe/w_gate``,
the SSM state) stay fp32.
"""

from __future__ import annotations

from typing import Any
from typing import Dict
from typing import Mapping
from typing import Tuple

import numpy as np
import torch

from . import require_device
from .models.model import Cache
from .models.model import DTYPE

# parameters the reference keeps in fp32, as the ends of their paths in the
# tree: a dense MLP's ``mlp/w_gate`` takes the model's type, the MoE
# router's ``moe/w_gate`` does not
FP32_LEAVES = (("a_log",), ("d_skip",), ("moe", "w_gate"))


def _put(a, dev, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)


def params_from_numpy(tree: Mapping[str, Any], device="cuda", *,
                      dtype=DTYPE) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same nested dict of tensors on
    ``device``: of ``dtype``, except the leaves whose path ends as one of
    ``FP32_LEAVES``, which stay fp32."""
    dev = require_device(device)

    def put(node, path: Tuple[str, ...]):
        if isinstance(node, Mapping):
            return {key: put(leaf, path + (key,)) for key, leaf in node.items()}
        fp32 = any(path[-len(end):] == end for end in FP32_LEAVES)
        return _put(node, dev, torch.float32 if fp32 else dtype)

    return put(tree, ())


def cache_from_numpy(k=None, v=None, pos=0, device="cuda", *, conv_x=None, conv_bc=None,
                     ssm=None, dtype=DTYPE) -> Cache:
    """The arrays of a JAX ``Cache`` and its next position → a port
    ``Cache``: K/V (L, B, S, G, hd) and the conv histories in ``dtype``, the
    SSM state (L, B, H, P, N) in fp32.  Fields left ``None`` stay ``None``."""
    dev = require_device(device)

    def put(a, dt):
        return None if a is None else _put(a, dev, dt)

    return Cache(k=put(k, dtype), v=put(v, dtype), conv_x=put(conv_x, dtype),
                 conv_bc=put(conv_bc, dtype), ssm=put(ssm, torch.float32), pos=int(pos))


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The way back: tensors → fp32 numpy arrays, same keys."""
    out: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = params_to_numpy(leaf)
        else:
            out[key] = leaf.detach().float().cpu().numpy()
    return out
