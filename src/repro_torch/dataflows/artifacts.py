"""Content-addressed artifact cache for the lowering pipeline.

Lowered traces, reuse-distance profiles, and geometry plans are pure
functions of a :class:`~repro_torch.dataflows.ir.DataflowSpec`, yet every
process that needs one (suite_bench, the CI smoke loop, scripts/
suite_gate.py re-runs, tests) used to recompute it from scratch.  This
module gives each spec a **deterministic content fingerprint** and keys
the lowered artifacts by it on disk, so the second consumer of a spec —
in this process, another process, or another session — loads arrays
instead of re-walking schedules.

Keying scheme (DESIGN.md §8.5):

* ``spec_fingerprint(spec)`` — SHA-256 over a canonical byte
  serialization of the spec *content*: dataclass fields in declaration
  order, dict items sorted by key, floats via ``repr`` (exact for IEEE
  doubles), numpy arrays via dtype + shape + raw bytes.  No Python
  ``hash()``, no ``id()``, no dict iteration order — two fresh
  interpreters agree on the fingerprint and any field edit changes it
  (pinned by tests/test_artifacts.py).
* the on-disk key additionally folds in a **code-version salt** (hash
  of the lowering sources) so editing ``lower.py``/``reuse.py``/
  ``traces.py`` invalidates every cached artifact instead of serving
  stale lowerings;
* artifact kinds carry their own parameters in the key — the compiled
  trace by ``line_bytes``, plans by ``(num_sets, hash_sets)``.

Writes are atomic (temp file + ``os.replace``) so concurrent suite
workers never observe a torn artifact; unreadable or truncated files
are treated as misses and rebuilt.  Set ``REPRO_ARTIFACTS=0`` to
disable the cache, ``REPRO_ARTIFACT_DIR`` to relocate it (default:
``<repo>/.cache/artifacts_torch``, beside the JAX package's
``artifacts``; the salt names this package too, so the two never read
each other's files even in one directory).
"""

from __future__ import annotations

from dataclasses import fields
from dataclasses import is_dataclass
import hashlib
import json
import os
from pathlib import Path
import tempfile
from typing import Dict
from typing import Optional

import numpy as np

_FORMAT_VERSION = "3"     # 3: compiled traces grew the u_tid column

#: folded into the salt so a directory shared with the JAX package's
#: cache never serves one package's artifact to the other
_PACKAGE = "repro_torch"

#: lowering sources whose bytes salt the on-disk key: an edit to any of
#: them must invalidate cached artifacts (the fingerprint itself stays a
#: pure content hash)
_VERSIONED_SOURCES = ("ir.py", "lower.py", "addr.py", "reuse.py",
                      "compose.py", "../core/traces.py")


# ---------------------------------------------------------------------------
# deterministic content fingerprint
# ---------------------------------------------------------------------------
def _fold(h, obj) -> None:
    """Fold one value into the hash with an unambiguous type-tagged
    encoding (length-prefixed strings, declaration-ordered dataclass
    fields, key-sorted dicts)."""
    if obj is None:
        h.update(b"N;")
    elif obj is True:
        h.update(b"T;")
    elif obj is False:
        h.update(b"F;")
    elif isinstance(obj, (int, np.integer)):
        h.update(b"i%d;" % int(obj))
    elif isinstance(obj, (float, np.floating)):
        # repr round-trips IEEE doubles exactly and is platform-stable
        h.update(b"f" + repr(float(obj)).encode() + b";")
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        h.update(b"s%d:" % len(b) + b)
    elif isinstance(obj, bytes):
        h.update(b"b%d:" % len(obj) + obj)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        h.update(b"a" + str(a.dtype).encode() + b"|"
                 + repr(a.shape).encode() + b"|")
        h.update(a.tobytes())
    elif is_dataclass(obj) and not isinstance(obj, type):
        h.update(b"D" + type(obj).__name__.encode() + b"{")
        for f in fields(obj):
            if f.name.startswith("_"):
                continue             # caches et al. are not content
            h.update(f.name.encode() + b"=")
            _fold(h, getattr(obj, f.name))
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"[" if isinstance(obj, list) else b"(")
        for x in obj:
            _fold(h, x)
        h.update(b"]" if isinstance(obj, list) else b")")
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=lambda k: (type(k).__name__, str(k))):
            _fold(h, k)
            h.update(b":")
            _fold(h, obj[k])
        h.update(b"}")
    else:
        raise TypeError(
            f"cannot canonically serialize {type(obj).__name__} for the "
            f"spec fingerprint")


def spec_fingerprint(spec) -> str:
    """Deterministic SHA-256 content hash of a :class:`DataflowSpec`.

    Stable across processes and sessions; memoized on the spec object
    (specs are frozen after ``SpecBuilder.build``)."""
    cached = spec.__dict__.get("_dco_fingerprint")
    if cached is not None:
        return cached
    h = hashlib.sha256()
    _fold(h, spec)
    fp = h.hexdigest()
    spec.__dict__["_dco_fingerprint"] = fp
    return fp


def try_spec_fingerprint(spec) -> Optional[str]:
    """Like :func:`spec_fingerprint` but ``None`` when the spec carries
    content outside the canonical-serialization domain (exotic workload
    objects, or no ``__dict__`` to memoize on) — the lowerings then
    simply skip the artifact cache."""
    try:
        return spec_fingerprint(spec)
    except (TypeError, AttributeError):
        return None


# ---------------------------------------------------------------------------
# on-disk store
# ---------------------------------------------------------------------------
def artifacts_enabled() -> bool:
    return os.environ.get("REPRO_ARTIFACTS", "1") != "0"


def cache_dir() -> Path:
    env = os.environ.get("REPRO_ARTIFACT_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / ".cache" / "artifacts_torch"


_code_version_cache: Optional[str] = None


def code_version() -> str:
    """Hash of the package name and the lowering sources — the
    artifact-key salt."""
    global _code_version_cache
    if _code_version_cache is None:
        h = hashlib.sha256()
        h.update(_FORMAT_VERSION.encode())
        h.update(_PACKAGE.encode())
        here = Path(__file__).resolve().parent
        for rel in _VERSIONED_SOURCES:
            try:
                h.update((here / rel).read_bytes())
            except OSError:
                h.update(b"?")
        _code_version_cache = h.hexdigest()[:16]
    return _code_version_cache


def _path(kind: str, key: str) -> Path:
    return cache_dir() / f"{kind}-{key}-{code_version()}.npz"


def load_arrays(kind: str, key: str) -> Optional[Dict[str, np.ndarray]]:
    """Load one artifact; ``None`` on miss, disabled cache, or a
    corrupt/unreadable file (callers rebuild and re-store)."""
    if not artifacts_enabled():
        return None
    path = _path(kind, key)
    try:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None


def store_arrays(kind: str, key: str,
                 arrays: Dict[str, np.ndarray]) -> None:
    """Atomically persist one artifact (temp file + rename), so pooled
    suite workers racing on the same key never see a torn file."""
    if not artifacts_enabled():
        return
    path = _path(kind, key)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass                          # cache is best-effort, never fatal


def _json_blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode("utf-8"), dtype=np.uint8)


def _json_unblob(arr: np.ndarray):
    return json.loads(bytes(arr.tobytes()).decode("utf-8"))


# ---------------------------------------------------------------------------
# typed artifact adapters
# ---------------------------------------------------------------------------
_CT_ARRAYS = ("u_addrs", "u_dense", "u_write", "u_force", "u_nonleader",
              "u_core", "u_tid", "u_dups", "round_off", "n_acc_round",
              "flops_round", "tll_addrs", "tll_tids", "tll_tiles",
              "tll_nacc", "tll_off")


def compiled_trace_key(fingerprint: str, line_bytes: int) -> str:
    return f"{fingerprint}-lb{line_bytes}"


def store_compiled_trace(key: str, ct) -> None:
    arrays = {name: getattr(ct, name) for name in _CT_ARRAYS}
    arrays["scalars"] = np.asarray(
        [ct.line_bytes, ct.n_rounds, ct.n_seen_lines], dtype=np.int64)
    store_arrays("trace", key, arrays)


def load_compiled_trace(key: str):
    z = load_arrays("trace", key)
    if z is None or "scalars" not in z:
        return None
    from ..core.traces import CompiledTrace
    lb, n_rounds, n_seen = (int(x) for x in z["scalars"])
    return CompiledTrace(lb, n_rounds, n_seen,
                         *(z[name] for name in _CT_ARRAYS))


_PROF_ARRAYS = ("e_round", "e_tensor", "e_line", "e_mass", "e_dlive",
                "e_ddead", "e_intercore", "e_mshr", "e_store", "e_tile",
                "e_prev_round", "cold_rt", "byp_cold_rt", "byp_rep_rt",
                "flops_round", "t_line", "t_mass", "t_tensor", "t_dies",
                "t_cold_store", "t_cold_round", "t_last_round",
                "t_tail_dlive", "t_tail_ddead", "tenant_of_tensor")


def store_reuse_profile(key: str, prof) -> None:
    arrays = {name: getattr(prof, name) for name in _PROF_ARRAYS}
    arrays["meta"] = _json_blob({
        "name": prof.name, "line_bytes": prof.line_bytes,
        "n_rounds": prof.n_rounds, "tensor_names": prof.tensor_names,
        "max_live_lines": prof.max_live_lines,
        "tenant_names": prof.tenant_names,
    })
    store_arrays("profile", key, arrays)


def load_reuse_profile(key: str):
    z = load_arrays("profile", key)
    if z is None or "meta" not in z:
        return None
    from .reuse import ReuseProfile
    meta = _json_unblob(z["meta"])
    return ReuseProfile(
        name=meta["name"], line_bytes=meta["line_bytes"],
        n_rounds=meta["n_rounds"], tensor_names=list(meta["tensor_names"]),
        max_live_lines=meta["max_live_lines"],
        tenant_names=list(meta["tenant_names"]),
        **{name: z[name] for name in _PROF_ARRAYS})


def plan_key(trace_key: str, num_sets: int, hash_sets: bool) -> str:
    return f"{trace_key}-s{num_sets}-h{int(hash_sets)}"


def store_plan_pass_idx(key: str, pass_idx: np.ndarray) -> None:
    store_arrays("plan", key, {"pass_idx": pass_idx})


def load_plan_pass_idx(key: str) -> Optional[np.ndarray]:
    z = load_arrays("plan", key)
    if z is None or "pass_idx" not in z:
        return None
    return z["pass_idx"]
