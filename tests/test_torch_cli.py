"""The port's command lines over the simulator stack and its two examples.

``scripts/conformance_torch.py``, ``scripts/spec_lint_torch.py`` and
``scripts/trace_dump_torch.py`` run beside the reference's scripts on the
same arguments, each pair at once: the exit codes, the standard output, the
``--report`` / ``--json`` files and the ``--npz`` columns must agree (a
conformance cell's seconds and a report's path are the only fields masked).
The cases are the reference's own tests of its scripts:
``tests/test_conformance.py::test_conformance_script_single_cell``, the three
``spec_lint`` CLI tests of ``tests/test_verify.py`` and the six of
``tests/test_trace_dump.py``.  The rule inventory is compared byte for byte
once the reference's one tag of its own history (``HISTORY_TAG``, in
DCO202's text) is taken out: the port's copy of the rules does not name
the reference's changes.  ``--update-golden`` is refused by the port and
no golden changes.  Then ``examples/quickstart_torch.py`` and
``examples/train_tiny_lm_torch.py --fast`` (fewer steps) run to their end on
the CPU."""

import json
from pathlib import Path
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
GOLDEN = REPO / "tests" / "golden" / "conformance_digests.json"
# one thread a process: each pair runs at once beside the suite's other workers
ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
       "OMP_NUM_THREADS": "1"}


def run_pair(name, args, tmp_path):
    """(reference, port) CompletedProcess of ``scripts/<name>.py`` and
    ``scripts/<name>_torch.py`` on ``args``, where ``{out}`` in an argument
    is a path under a directory of each side's own."""
    procs = []
    for side, script in (("ref", f"{name}.py"), ("port", f"{name}_torch.py")):
        out = tmp_path / side
        out.mkdir(exist_ok=True)
        argv = [a.replace("{out}", str(out)) for a in args]
        procs.append(subprocess.Popen([sys.executable, str(SCRIPTS / script), *argv], cwd=REPO,
                                      env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    done = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    return done


def masked(text, tmp_path):
    """Standard output with the side's own directory and a cell's seconds
    masked."""
    text = re.sub(re.escape(str(tmp_path)) + r"/(ref|port)", "<out>", text)
    return re.sub(r"events +\d+\.\d+s", "events <s>", text)


def same_output(ref, port, tmp_path):
    assert port.returncode == ref.returncode, (ref.returncode, port.returncode, port.stderr)
    assert masked(port.stdout, tmp_path) == masked(ref.stdout, tmp_path)


def without_seconds(blob):
    if isinstance(blob, dict):
        return {k: without_seconds(v) for k, v in blob.items() if k != "seconds"}
    if isinstance(blob, list):
        return [without_seconds(v) for v in blob]
    return blob


# ---------------------------------------------------------------------------
# scripts/conformance_torch.py
# ---------------------------------------------------------------------------
def test_conformance_single_cell_agrees_with_the_reference_script(tmp_path):
    ref, port = run_pair("conformance", ["--scenario", "matmul", "--policy", "lru",
                                         "--report", "{out}/report.json"], tmp_path)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    same_output(ref, port, tmp_path)
    blobs = [json.loads((tmp_path / side / "report.json").read_text())
             for side in ("ref", "port")]
    assert blobs[1]["failures"] == 0 and blobs[1]["cells"][0]["scenario"] == "matmul"
    assert without_seconds(blobs[1]) == without_seconds(blobs[0])


def test_conformance_refuses_to_update_the_goldens(tmp_path):
    before = GOLDEN.read_bytes()
    stamp = GOLDEN.stat().st_mtime_ns
    proc = subprocess.run([sys.executable, str(SCRIPTS / "conformance_torch.py"),
                           "--update-golden", "--scenario", "matmul", "--policy", "lru"],
                          cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 2
    assert "scripts/conformance.py alone" in proc.stderr
    assert proc.stdout == ""
    assert GOLDEN.read_bytes() == before and GOLDEN.stat().st_mtime_ns == stamp


# ---------------------------------------------------------------------------
# scripts/spec_lint_torch.py (tests/test_verify.py's three CLI tests)
# ---------------------------------------------------------------------------
def test_spec_lint_clean_scenario_agrees_with_the_reference_script(tmp_path):
    ref, port = run_pair("spec_lint", ["matmul", "--json", "{out}/lint.json"], tmp_path)
    assert ref.returncode == 0 and "spec lint OK" in port.stdout
    same_output(ref, port, tmp_path)
    blobs = [json.loads((tmp_path / side / "lint.json").read_text()) for side in ("ref", "port")]
    assert blobs[1] == blobs[0] and blobs[1]["n_errors"] == 0


@pytest.mark.parametrize("args", [[], ["no-such-scenario"]], ids=["none", "unknown"])
def test_spec_lint_usage_errors_agree_with_the_reference_script(tmp_path, args):
    ref, port = run_pair("spec_lint", args, tmp_path)
    assert ref.returncode == 2
    same_output(ref, port, tmp_path)
    assert port.stderr == ref.stderr


# a change of the reference's history named in its rule texts (DCO202's,
# src/repro/dataflows/verify.py:161); the port's copy leaves it out
HISTORY_TAG = re.compile(r" PR \d+ ")


def test_spec_lint_rules_inventory_agrees_with_the_reference_script(tmp_path):
    ref, port = run_pair("spec_lint", ["--rules"], tmp_path)
    assert ref.returncode == port.returncode == 0 and "DCO0" in port.stdout
    lines = ref.stdout.splitlines()
    tagged = [i for i, line in enumerate(lines) if HISTORY_TAG.search(line)]
    assert len(tagged) == 1 and lines[tagged[0] - 1].startswith("DCO202 ")
    assert port.stdout == HISTORY_TAG.sub(" ", ref.stdout)
    assert port.stderr == ref.stderr


# ---------------------------------------------------------------------------
# scripts/trace_dump_torch.py (tests/test_trace_dump.py's six tests)
# ---------------------------------------------------------------------------
TRACE_CASES = {
    "head_render": (["matmul", "--policy", "at+dbp", "--head", "5"], 0),
    "round_window": (["matmul", "--round", "4", "--window", "1"], 0),
    "npz_export": (["matmul", "--npz", "{out}/events.npz"], 0),
    "unknown_scenario": (["no-such-scenario"], 2),
    "unknown_policy": (["matmul", "--policy", "no-such-policy"], 2),
    "bad_engine": (["matmul", "--engine", "warp"], 2),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_dump_agrees_with_the_reference_script(tmp_path, case):
    args, rc = TRACE_CASES[case]
    ref, port = run_pair("trace_dump", args, tmp_path)
    assert ref.returncode == rc, ref.stderr
    same_output(ref, port, tmp_path)
    if rc:
        if case != "bad_engine":        # argparse names the script in its usage line
            assert port.stderr == ref.stderr
        else:
            assert "invalid choice: 'warp'" in port.stderr
    if case == "npz_export":
        got, want = (np.load(tmp_path / side / "events.npz") for side in ("port", "ref"))
        assert sorted(got.files) == sorted(want.files)
        for col in want.files:
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)


# ---------------------------------------------------------------------------
# the examples, on the CPU
# ---------------------------------------------------------------------------
def test_quickstart_runs_to_its_end_on_the_cpu():
    proc = subprocess.run([sys.executable, str(REPO / "examples" / "quickstart_torch.py"),
                           "--device", "cpu"], cwd=REPO, env=ENV, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "done."
    assert "the plain version: no kernel on the CPU" in lines[-2]
    assert float(re.search(r"max \|err\| = (\S+)", lines[-2]).group(1)) == 0.0
    losses = [float(x) for x in re.findall(r"loss=(\S+)", proc.stdout)]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert proc.stdout.count("x over LRU") == 3


def test_train_tiny_lm_fast_runs_to_its_end_on_the_cpu(tmp_path):
    argv = [sys.executable, str(REPO / "examples" / "train_tiny_lm_torch.py"), "--fast",
            "--device", "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path / "ckpt"),
            "--ckpt-every", "3"]
    proc = subprocess.run(argv, cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "arch=llama3.2-3b" in proc.stdout and "done in" in proc.stdout
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())[-1] == "step_00000006"
    again = subprocess.run(argv[:-4] + ["--steps", "8", "--ckpt-dir", str(tmp_path / "ckpt")],
                           cwd=REPO, env=ENV, capture_output=True, text=True, timeout=600)
    assert again.returncode == 0 and "resumed from step 6" in again.stdout
