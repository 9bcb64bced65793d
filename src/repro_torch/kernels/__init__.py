"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel package has ``ops.py`` (the wrapper: checks, output and scratch
allocation, the launch, the launch count) and ``ref.py`` (the plain version
of the same function); the CUDA sources are under ``repro_torch/csrc`` and
are built by :mod:`repro_torch.kernels.build` at first use.  On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it computes
the plain version.  The flash module holds the forward and, for training,
its backward (``FlashAttentionFn``), the SSD module the scan and its
backward (``SSDScanFn``), the decode module the serving kernel and its
variant over one rank's slice of a sequence-sharded cache, which also writes
each row's log-sum-exp (``decode_attention_lse``); the decode kernel has no
backward and raises under autograd on the card.

``launch_counts()`` / ``reset_launch_counts()`` expose the wrappers'
counters and ``kernels_built()`` says whether the library is loaded, so
that a smoke run or a tracer can show which kernels the main path went
through without reaching into the wrappers.
"""

from typing import Dict

from .build import kernels_built
from .decode_attention import decode_attention
from .decode_attention import decode_attention_lse
from .decode_attention import decode_attention_lse_ref
from .decode_attention import decode_attention_ref
from .decode_attention import ops as _decode_ops
from .flash_attention import attention_bwd_ref
from .flash_attention import attention_ref
from .flash_attention import flash_attention
from .flash_attention import flash_attention_bwd
from .flash_attention import ops as _flash_ops
from .ssd_scan import ops as _ssd_ops
from .ssd_scan import ssd_bwd_ref
from .ssd_scan import ssd_ref
from .ssd_scan import ssd_scan
from .ssd_scan import ssd_scan_bwd

__all__ = ["decode_attention", "decode_attention_lse", "decode_attention_lse_ref",
           "decode_attention_ref", "attention_bwd_ref",
           "attention_ref", "flash_attention", "flash_attention_bwd", "kernels_built", "launch_counts",
           "reset_launch_counts", "ssd_bwd_ref", "ssd_ref", "ssd_scan", "ssd_scan_bwd"]

# each wrapper's counter: the flash and SSD modules count their forward
# launches and their backward launches apart
_COUNTERS = {"decode_attention": _decode_ops.LAUNCHES,
             "decode_attention_lse": _decode_ops.LSE_LAUNCHES,
             "flash_attention": _flash_ops.LAUNCHES,
             "flash_attention_bwd": _flash_ops.BWD_LAUNCHES,
             "ssd_scan": _ssd_ops.LAUNCHES,
             "ssd_scan_bwd": _ssd_ops.BWD_LAUNCHES}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset (each
    backward call, flash or SSD, launches three kernels and counts three)."""
    return {name: count[0] for name, count in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for count in _COUNTERS.values():
        count[0] = 0
