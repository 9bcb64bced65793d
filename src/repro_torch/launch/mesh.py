"""The meshes of the port, as the JAX package's ``launch/mesh.py``: functions, not
module-level constants, so that importing this module touches no process
group and no device.

The caller owns the process group: it calls
``torch.distributed.init_process_group`` (backend, address, world size and
rank its own) before building a mesh, and the world size must equal the
mesh's number of ranks.  The device type defaults to the card; the CPU tests
pass ``"cpu"``.
"""

from __future__ import annotations

import math
from typing import Sequence


def _mesh(shape: Sequence[int], names: Sequence[str], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("build a mesh after torch.distributed.init_process_group")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.

    Axes: ``data`` (DP / ZeRO / sequence-parallel), ``model`` (TP / EP),
    and ``pod`` (cross-pod data parallelism) in the multi-pod mesh.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A small (data, model) mesh over the process group's ranks (tests)."""
    return _mesh((data, model), ("data", "model"), device_type)
