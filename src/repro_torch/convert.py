"""Carry parameter and cache trees from the JAX package into the port.

The port keeps the JAX package's tree layout (same keys, same stacked
leading layer axis), so the bridge is a 1:1 map over leaves.  The caller
hands over numpy arrays; bf16 leaves cross as fp32 (numpy has no bf16) and
are narrowed again here, which is exact.
"""

from __future__ import annotations

from typing import Any
from typing import Dict
from typing import Mapping

import numpy as np
import torch

from . import require_device
from .models.model import Cache
from .models.model import DTYPE


def params_from_numpy(tree: Mapping[str, Any], device="cuda", *,
                      dtype=DTYPE) -> Dict[str, Any]:
    """Nested dict of numpy arrays → the same nested dict of tensors of
    ``dtype`` on ``device``."""
    dev = require_device(device)
    out: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = params_from_numpy(leaf, dev, dtype=dtype)
        else:
            arr = np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
            out[key] = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return out


def cache_from_numpy(k, v, pos, device="cuda", *, dtype=DTYPE) -> Cache:
    """K/V arrays (L, B, S, G, hd) and the next position → a port ``Cache``."""
    dev = require_device(device)

    def put(a):
        arr = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
        return torch.from_numpy(arr).to(device=dev, dtype=dtype)

    return Cache(k=put(k), v=put(v), pos=int(pos))


def params_to_numpy(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The way back: tensors → fp32 numpy arrays, same keys."""
    out: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[key] = params_to_numpy(leaf)
        else:
            out[key] = leaf.detach().float().cpu().numpy()
    return out
