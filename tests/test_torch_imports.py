"""The port stands alone: it imports neither jax nor the JAX package, its
smoke script refuses to run without a card, and its entry points raise
without one unless the caller asks for the CPU."""

import ast
from pathlib import Path
import subprocess
import sys

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"] + [
    REPO / p for p in ("scripts/conformance_torch.py", "scripts/spec_lint_torch.py",
                       "scripts/trace_dump_torch.py", "examples/quickstart_torch.py",
                       "examples/train_tiny_lm_torch.py", "examples/serve_batched_torch.py",
                       "examples/dco_cache_study_torch.py")]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "repro")


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             # one thread: beside the suite's other workers the examples' CPU
             # training would otherwise oversubscribe the cores
             "OMP_NUM_THREADS": "1"}, timeout=300)


@pytest.mark.parametrize("module", [
    "repro_torch", "repro_torch.serve.engine", "repro_torch.launch.serve",
    "repro_torch.kernels", "repro_torch.convert", "repro_torch.models.moe", "chip_smoke",
    "repro_torch.train", "repro_torch.data", "repro_torch.checkpoint",
    "repro_torch.launch.train", "repro_torch.kernels.ssd_scan", "repro_torch.models.ssm",
    "repro_torch.core.simulator", "repro_torch.dataflows", "repro_torch.conformance",
    "repro_torch.serve.replay", "repro_torch.sharding", "repro_torch.launch.mesh",
    "repro_torch.train.compression", "repro_torch.launch.dryrun",
    "repro_torch.launch.roofline"])
def test_import_leaves_jax_and_repro_out(module):
    code = (
        "import sys, importlib\n"
        "sys.path.insert(0, '.')\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")


def test_running_the_simulator_stack_leaves_jax_and_repro_out():
    """Not only importing: a conformance cell, a replay and an analytical
    fit run through the port, and neither jax nor the JAX package is loaded
    by any lazy import on their way."""
    code = (
        "import sys\n"
        "from repro_torch.conformance import compare_scenario, load_golden\n"
        "from repro_torch.core import fit_params, predict, run_policy, named_policy\n"
        "from repro_torch.dataflows import lower_to_counts, lower_to_trace, suite_case\n"
        "from repro_torch.serve.replay import run_replay\n"
        "from repro_torch.serve.traffic import TrafficConfig\n"
        "res, = compare_scenario('serve-replay', ('at+dbp',), golden=load_golden())\n"
        "assert res.ok and res.golden == res.digest, res\n"
        "rep = run_replay(TrafficConfig(n_requests=16, seed=1), 'all', verify=True)\n"
        "assert rep.slo and rep.rounds > 0\n"
        "case = suite_case('matmul')\n"
        "counts = lower_to_counts(case.spec)\n"
        "sim = run_policy(lower_to_trace(case.spec), named_policy('lru'), case.cfg)\n"
        "pts = [(counts, case.cfg.llc_bytes, 'lru', 'optimal', False, counts.n_rounds,"
        " sim.cycles)]\n"
        "params = fit_params(pts, case.cfg)\n"
        "assert predict(counts, case.cfg.llc_bytes, 'lru', case.cfg, params).cycles > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")


# the port's command lines and examples, each run in-process on arguments that
# exercise it (the examples on the CPU, the trainer for 2 steps)
PORT_RUNS = {
    "scripts/conformance_torch.py": ["--scenario", "matmul", "--policy", "lru"],
    "scripts/spec_lint_torch.py": ["matmul", "--cross-check"],
    "scripts/trace_dump_torch.py": ["matmul", "--head", "3"],
    "examples/quickstart_torch.py": ["--device", "cpu"],
    "examples/train_tiny_lm_torch.py": ["--fast", "--device", "cpu", "--steps", "2",
                                        "--ckpt-dir", "{tmp}"],
}


@pytest.mark.parametrize("script", sorted(PORT_RUNS))
def test_running_the_port_scripts_and_examples_leaves_jax_and_repro_out(script, tmp_path):
    args = [a.replace("{tmp}", str(tmp_path)) for a in PORT_RUNS[script]]
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}] + {args!r}\n"
        "try:\n"
        f"    runpy.run_path({script!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("clean")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_port_sources_do_not_call_library_attention():
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


@pytest.mark.parametrize("module", ["flash_attention", "ssd_scan"])
def test_backward_wrappers_compute_no_product_themselves(module):
    """The wrappers that tie a forward kernel to its backward kernel
    (``FlashAttentionFn``, ``SSDScanFn``) hand every product of the
    attention or the scan to the kernels: no library product in them."""
    text = (REPO / "src" / "repro_torch" / "kernels" / module / "ops.py").read_text()
    for call in ("torch.matmul", "einsum", "bmm", "torch.compile", "@ ", "autograd.grad"):
        assert call not in text, f"{module}/ops.py: {call}"


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_cuda_sources_are_in_the_tree():
    from repro_torch.kernels import build
    names = [p.name for p in build.sources()]
    assert names == ["decode_attention.cu", "decode_attention_lse.cu", "flash_attention.cu",
                     "flash_attention_bwd.cu", "flash_attention_bwd_pos.cu",
                     "flash_attention_pos.cu", "ssd_scan.cu", "ssd_scan_bwd.cu"]
    assert not build.kernels_built()          # nothing is built at import time
