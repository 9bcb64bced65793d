from .ops import ssd_scan
from .ops import ssd_scan_bwd
from .ref import ssd_bwd_ref
from .ref import ssd_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_bwd_ref", "ssd_ref"]
