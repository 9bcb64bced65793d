"""Model assembly of the port (dense, MoE, SSM and hybrid families)."""

from .model import Cache
from .model import cache_logical_axes
from .model import decode_step
from .model import forward
from .model import init_cache
from .model import init_params
from .model import lm_loss
from .model import local_flags
from .model import prefill

__all__ = ["Cache", "cache_logical_axes", "decode_step", "forward", "init_cache", "init_params",
           "lm_loss", "local_flags", "prefill"]
