from .ops import ssd_scan
from .ref import ssd_ref

__all__ = ["ssd_scan", "ssd_ref"]
