"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel package has ``ops.py`` (the wrapper: checks, output and scratch
allocation, the launch, the launch count) and ``ref.py`` (the plain version
of the same function); the CUDA sources are under ``repro_torch/csrc`` and
are built by :mod:`repro_torch.kernels.build` at first use.  On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it computes
the plain version.

``launch_counts()`` / ``reset_launch_counts()`` expose the wrappers'
counters and ``kernels_built()`` says whether the library is loaded, so
that a smoke run or a tracer can show which kernels the main path went
through without reaching into the wrappers.
"""

from typing import Dict

from .build import kernels_built
from .decode_attention import decode_attention
from .decode_attention import decode_attention_ref
from .decode_attention import ops as _decode_ops
from .flash_attention import attention_ref
from .flash_attention import flash_attention
from .flash_attention import ops as _flash_ops
from .ssd_scan import ops as _ssd_ops
from .ssd_scan import ssd_ref
from .ssd_scan import ssd_scan

__all__ = ["decode_attention", "decode_attention_ref", "attention_ref",
           "flash_attention", "kernels_built", "launch_counts",
           "reset_launch_counts", "ssd_ref", "ssd_scan"]

_WRAPPERS = {"decode_attention": _decode_ops, "flash_attention": _flash_ops,
             "ssd_scan": _ssd_ops}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: mod.LAUNCHES[0] for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.LAUNCHES[0] = 0
