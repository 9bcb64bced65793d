"""Content-addressed artifact cache (repro_torch.dataflows.artifacts):
fingerprint determinism across processes, sensitivity to every content
field, and bit-identical round-trips of the cached lowerings."""

import os
import subprocess
import sys

import numpy as np

# the port
from repro_torch.core import SimConfig
from repro_torch.core import named_policy
from repro_torch.core import run_policy
from repro_torch.core.workloads import AttnWorkload
from repro_torch.core.workloads import TEMPORAL
from repro_torch.dataflows import artifacts
from repro_torch.dataflows import artifacts_enabled
from repro_torch.dataflows import fa2_spec
from repro_torch.dataflows import lower_to_counts
from repro_torch.dataflows import lower_to_trace
from repro_torch.dataflows import matmul_spec
from repro_torch.dataflows import registry_keys
from repro_torch.dataflows import spec_fingerprint
from repro_torch.dataflows import suite_case
from repro_torch.dataflows import try_spec_fingerprint

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _wl():
    return AttnWorkload("fp", n_q_heads=8, n_kv_heads=4, head_dim=128,
                        seq_len=512, group_alloc=TEMPORAL)


# ---------------------------------------------------------------------------
# fingerprint determinism
# ---------------------------------------------------------------------------
_SUBPROC = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core.workloads import AttnWorkload, TEMPORAL
from repro_torch.dataflows import fa2_spec, spec_fingerprint
wl = AttnWorkload("fp", n_q_heads=8, n_kv_heads=4, head_dim=128,
                  seq_len=512, group_alloc=TEMPORAL)
print(spec_fingerprint(fa2_spec(wl, 4)))
"""


def test_fingerprint_stable_across_fresh_processes():
    """Two cold interpreters agree — no Python hash(), no dict-order or
    id() leakage (PYTHONHASHSEED varies per process by default)."""
    outs = [
        subprocess.run([sys.executable, "-c", _SUBPROC.format(src=SRC)],
                       capture_output=True, text=True, check=True,
                       env={**os.environ, "PYTHONHASHSEED": seed})
        .stdout.strip()
        for seed in ("0", "12345")
    ]
    assert outs[0] == outs[1]
    assert outs[0] == spec_fingerprint(fa2_spec(_wl(), 4))


def test_fingerprint_changes_on_any_field_edit():
    base = spec_fingerprint(fa2_spec(_wl(), 4))
    # a different core count, sequence length, or tile size must rekey
    assert spec_fingerprint(fa2_spec(_wl(), 8)) != base
    wl2 = AttnWorkload("fp", n_q_heads=8, n_kv_heads=4, head_dim=128,
                       seq_len=1024, group_alloc=TEMPORAL)
    assert spec_fingerprint(fa2_spec(wl2, 4)) != base
    assert (spec_fingerprint(matmul_spec(256, 256, 256, tile=128,
                                         n_cores=4))
            != spec_fingerprint(matmul_spec(256, 256, 512, tile=128,
                                            n_cores=4)))


def test_fingerprint_memoized_and_try_variant():
    spec = fa2_spec(_wl(), 4)
    assert spec_fingerprint(spec) == spec_fingerprint(spec)
    assert try_spec_fingerprint(spec) == spec_fingerprint(spec)
    assert try_spec_fingerprint(object()) is None


def test_registry_fingerprints_distinct():
    """Every registered scenario hashes to its own key — the registry-
    level handle into the artifact store."""
    fps = [suite_case(k).fingerprint for k in registry_keys()]
    assert len(set(fps)) == len(fps)


# ---------------------------------------------------------------------------
# on-disk round-trips
# ---------------------------------------------------------------------------
def _sim(trace):
    return run_policy(trace, named_policy("at+dbp"),
                      SimConfig(llc_bytes=256 * 1024, llc_slices=8))


def test_artifact_roundtrip_bit_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_ARTIFACTS", raising=False)
    assert artifacts_enabled()

    spec = fa2_spec(_wl(), 4)
    cold = _sim(lower_to_trace(spec))
    counts_cold = lower_to_counts(spec)
    stored = list(tmp_path.glob("*.npz"))
    kinds = {p.name.split("-")[0] for p in stored}
    assert {"trace", "profile"} <= kinds

    warm = _sim(lower_to_trace(spec))          # second lowering: cache hit
    counts_warm = lower_to_counts(spec)
    for f in ("cycles", "hits", "mshr_hits", "cold_misses",
              "conflict_misses", "bypassed", "writebacks", "dram_lines"):
        assert getattr(cold, f) == getattr(warm, f), f
    pc, pw = counts_cold.reuse_profile, counts_warm.reuse_profile
    for name in artifacts._PROF_ARRAYS:
        np.testing.assert_array_equal(getattr(pc, name), getattr(pw, name))
    assert pc.tensor_names == pw.tensor_names
    assert pc.n_rounds == pw.n_rounds


def test_artifacts_disable_and_corruption(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_ARTIFACTS", "0")
    assert not artifacts_enabled()
    spec = fa2_spec(_wl(), 4)
    trace = lower_to_trace(spec)
    assert trace.fingerprint is None           # lowering skips the cache
    _sim(trace)
    assert list(tmp_path.glob("*.npz")) == []

    monkeypatch.setenv("REPRO_ARTIFACTS", "1")
    ref = _sim(lower_to_trace(spec))
    files = list(tmp_path.glob("*.npz"))
    assert files
    for p in files:                            # torn/corrupt file == miss
        p.write_bytes(b"not an npz")
    got = _sim(lower_to_trace(spec))
    assert got.cycles == ref.cycles and got.hits == ref.hits


def test_code_version_salts_the_key():
    key = artifacts.compiled_trace_key("deadbeef", 128)
    assert key == "deadbeef-lb128"
    path = artifacts._path("trace", key)
    assert artifacts.code_version() in path.name


def test_store_load_plan_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_ARTIFACTS", raising=False)
    idx = np.arange(17, dtype=np.int64)[::-1].copy()
    key = artifacts.plan_key("k", 2048, True)
    artifacts.store_plan_pass_idx(key, idx)
    got = artifacts.load_plan_pass_idx(key)
    np.testing.assert_array_equal(got, idx)
    assert artifacts.load_plan_pass_idx(artifacts.plan_key("k", 1024,
                                                           True)) is None
