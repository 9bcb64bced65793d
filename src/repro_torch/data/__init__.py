from .synthetic import SyntheticLM
from .synthetic import make_batch

__all__ = ["SyntheticLM", "make_batch"]
