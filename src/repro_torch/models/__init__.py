"""Model assembly of the port (dense, MoE, SSM and hybrid families)."""

from .model import Cache
from .model import decode_step
from .model import forward
from .model import init_cache
from .model import init_params
from .model import local_flags
from .model import prefill

__all__ = ["Cache", "decode_step", "forward", "init_cache", "init_params",
           "local_flags", "prefill"]
