"""Build ``csrc/*.cu`` with nvcc at first use and load the result with ctypes.

The kernels have a plain C interface (no PyTorch headers), so a build takes
seconds.  Each source is compiled to an object by its own nvcc process, all
started together, and the objects are linked into one shared library.  The
library's name carries a hash of the sources: an edited kernel is rebuilt,
an unchanged one is loaded from ``build/``.  Nothing here runs at import
time, and a failed build raises: there is no quiet switch to the plain
versions.

``build(csrc=...)`` builds another directory of sources the same way into a
library of its own (``scripts/kernel_compare.py`` times an earlier tree's
kernels with it, ``scripts/kernel_timeline.py`` instrumented copies);
``load()`` only ever loads this package's own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from pathlib import Path
import shutil
import subprocess
import time
from typing import Dict
from typing import List
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` or ``build/`` beside ``src/``."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[2] / "build"


def sources(csrc: Path = CSRC) -> List[Path]:
    return sorted(csrc.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH, $CUDA_HOME and /usr/local/cuda)")


def _digest(srcs: List[Path], csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(csrc.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, csrc: Path = CSRC) -> Path:
    """Compile and link the kernels of ``csrc`` if the library for these
    sources is not in the build directory yet; returns the library's path."""
    srcs = sources(csrc)
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    out_dir = build_dir()
    lib_path = out_dir / f"libdco_kernels_{_digest(srcs, csrc)}.so"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    tag = f"{lib_path.stem}.{os.getpid()}"
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in srcs:
        obj = out_dir / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(log))
    tmp = out_dir / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernels failed\n" + link.stdout)
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    build_info.update(path=str(lib_path), seconds=time.time() - t0,
                      cached=False, log="\n".join(log))
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on the first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def kernels_built() -> bool:
    """True once the shared library has been built and loaded here."""
    return _lib is not None
