"""PyTorch/CUDA port of the DCO system for one NVIDIA H100.

Same sub-packages and function names as the JAX package ``repro`` so a
reader finds the counterpart; this package imports ``torch`` and numpy
only.  Every entry point runs on the card (``device="cuda"``) unless the
caller asks for the CPU; on the CPU the kernel wrappers use their plain
PyTorch versions.
"""

from __future__ import annotations

import torch

__all__ = ["require_device"]


def require_device(device) -> torch.device:
    """Resolve ``device`` and raise where it names a card that is absent.

    The port never moves work to the CPU on its own: a caller that wants
    the CPU says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "versions on the CPU")
    return dev
