"""Fault-tolerant checkpointing in the JAX package's on-disk format: atomic
writes, CRC manifest, keep-N, resume from the newest valid checkpoint.

Layout (the same as ``repro/checkpoint/manager.py``, so that each package
reads the other's checkpoints)::

    <dir>/step_<N>/
        arrays.npz          # flattened tree leaves, keyed by path
        manifest.json       # step, keys, crc32, dtype and shape per leaf, marker

Keys are the paths the JAX package writes (``repro_torch.tree``): for a
``TrainState``, ``.params/embed``, ``.params/layers/attn/wq``,
``.opt/.m/embed``, ``.opt/.step``.  bf16 leaves are widened to fp32 on save
(npz has no bf16; exact) and restore casts each leaf to its template's type
and device.

Writes go to ``step_<N>.tmp`` and are renamed into place only after the
manifest (written last) is fsynced: a crash at any point leaves either a
complete checkpoint or an ignorable ``.tmp``.  ``restore_latest`` walks
checkpoints newest-first and skips any with a missing or corrupt manifest or
a CRC mismatch.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any
from typing import Dict
from typing import List
from typing import Optional
from typing import Tuple
import zipfile
import zlib

import numpy as np
import torch

from ..tree import flatten_with_keys
from ..tree import unflatten


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()        # npz cannot hold bf16; widen exactly to fp32
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in flatten_with_keys(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        flat = _flatten(tree)
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "crc32": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                      for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "complete": True,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        return final

    # ------------------------------------------------------------------
    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _prune(self) -> None:
        steps = self._steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def _validate(self, path: str) -> Optional[Dict[str, np.ndarray]]:
        """The arrays of a complete checkpoint whose CRCs match, else None."""
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            if not manifest.get("complete"):
                return None
            with np.load(os.path.join(path, "arrays.npz")) as z:
                arrays = {k: z[k] for k in manifest["keys"]}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
                zlib.error):
            return None
        for k, v in arrays.items():
            if zlib.crc32(np.ascontiguousarray(v).tobytes()) != manifest["crc32"].get(k):
                return None
        return arrays

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        """Restore the newest valid checkpoint into the structure of ``like``
        (a template tree: each leaf gives its type and device).  Returns
        (step, tree) or None."""
        for step in reversed(self._steps()):
            arrays = self._validate(os.path.join(self.dir, f"step_{step:08d}"))
            if arrays is None:
                continue
            out = []
            for key, leaf in flatten_with_keys(like):
                arr = arrays.get(key)
                shape = leaf.shape if isinstance(leaf, torch.Tensor) else np.shape(leaf)
                if arr is None or tuple(arr.shape) != tuple(shape):
                    break
                if isinstance(leaf, torch.Tensor):
                    out.append(torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                                  dtype=leaf.dtype))
                else:
                    out.append(arr.astype(np.asarray(leaf).dtype))
            else:
                return step, unflatten(like, out)
        return None
