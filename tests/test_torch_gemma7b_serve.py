"""The port's serving engine on gemma-7b at its published head size, 256
(reduced width: ``replace(reduce_for_smoke(gemma-7b), head_dim=256)``),
against the JAX engine on the same requests; the planner's pin budget at
that head size; the launcher and the batched serving example on the CPU.

``max_batch=2`` and three prompts of 70, 40 and 58 tokens, 6 new tokens each:
the two slots sit at different positions, so every step decodes two position
groups, and the third request reuses the slot of the first to finish.  At
head_dim 256 the flash kernel's pin budget holds a prompt of 58 rows whole
and no 64-row tile of a longer one, so the engine pins the second and third
prompts and streams the first.  Weights come from the JAX package and cross
through ``repro_torch.convert``.  Logit tolerance 3e-2 (rtol = atol), the
bf16 model's; the reference's tokens are followed (as in
tests/test_torch_serve.py) and the port's own greedy choice must agree
wherever the reference's top-2 margin exceeds twice the tolerance.  The JAX
engine runs op by op (``jax.disable_jit()``), once per module."""

from dataclasses import replace
from pathlib import Path
import runpy
import sys

import jax
import numpy as np
import pytest

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
# the port
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.core.orchestrator import flash_smem_bytes
from repro_torch.core.orchestrator import H100_SMEM_PER_BLOCK
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as port_layers
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine

TOL = 3e-2
PROMPT_LENS = (70, 40, 58)
MAX_NEW = 6
MAX_BATCH, MAX_SEQ = 2, 96
CFG = replace(reduce_for_smoke(get_arch("gemma-7b")), head_dim=256)
JCFG = replace(jax_reduce(jax_get_arch("gemma-7b")), head_dim=256)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_batched_torch.py"


@pytest.fixture(scope="module")
def setup():
    jparams = jm.init_params(JCFG, jax.random.key(0))
    params = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, CFG.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    return jparams, params, prompts


@pytest.fixture(scope="module")
def reference(setup):
    """The JAX engine op by op: its requests, and call by call the logits it
    picked from."""
    jparams, _, prompts = setup
    eng = JaxServeEngine(JCFG, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ)
    calls = []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def prefill(p, t):
        out = inner_prefill(p, t)
        calls.append(np.asarray(out[0], np.float32))
        return out

    def decode(p, t, c):
        out = inner_decode(p, t, c)
        calls.append(np.asarray(out[0], np.float32)[:, 0])
        return out

    eng._prefill, eng._decode = prefill, decode
    reqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    with jax.disable_jit():
        steps = eng.run_to_completion()
    return reqs, calls, steps


class FollowingEngine(ServeEngine):
    """Picks the reference's token at every step and records its own choice
    beside it."""

    def __init__(self, *args, follow, **kwargs):
        super().__init__(*args, **kwargs)
        self.follow = follow
        self.own = {uid: [] for uid in follow}

    def _pick(self, logits, uid):
        self.own[uid].append(super()._pick(logits, uid))
        return self.follow[uid][len(self.own[uid]) - 1]


def run_port(params, prompts, monkeypatch, follow):
    """The port's engine on the prompts: its requests, call by call the rows
    it served and their logits, and the pinned rows of each flash call."""
    from repro_torch.serve import engine as engine_mod
    calls, pins = [], []
    inner_prefill, inner_decode = engine_mod.prefill, engine_mod.decode_step
    real_flash = port_layers.flash_attention

    def prefill(p, t, c, **kw):
        out = inner_prefill(p, t, c, **kw)
        calls.append(([0], out[0].float().numpy()))
        return out

    def decode_step(p, t, cache, c, **kw):
        out = inner_decode(p, t, cache, c, **kw)
        calls.append((list(kw["rows"]), out[0].float().numpy()[:, 0]))
        return out

    def flash(q, k, v, **kw):
        pins.append((q.shape[1], q.shape[-1], kw["pinned_rows"]))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(engine_mod, "prefill", prefill)
    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    monkeypatch.setattr(port_layers, "flash_attention", flash)
    eng = FollowingEngine(CFG, params, follow=follow, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                          device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()
    return eng, reqs, calls, pins, steps


def test_engine_matches_jax_engine(setup, reference, monkeypatch):
    _, params, prompts = setup
    jreqs, jcalls, jsteps = reference
    eng, reqs, calls, _, steps = run_port(params, prompts, monkeypatch,
                                          follow={r.uid: r.tokens_out for r in jreqs})
    assert steps == jsteps and eng._tmu.live_tiles == 0
    assert eng.prefill_calls == 3 and len(calls) == len(jcalls)
    assert any(len(rows) == 1 for rows, _ in calls[1:])
    clear = 0
    for (rows, got), want in zip(calls, jcalls):
        np.testing.assert_allclose(got[rows], want[rows], rtol=TOL, atol=TOL)
        for i in rows:
            top2 = np.sort(want[i])[-2:]
            if top2[1] - top2[0] > 2 * (TOL + TOL * abs(top2[1])):
                assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
                clear += 1
    assert clear > 0
    for jr, r in zip(jreqs, reqs):
        assert r.done and r.tokens_out == jr.tokens_out and len(r.tokens_out) == MAX_NEW


def test_planner_pins_what_the_kernel_holds_at_head_dim_256(setup, reference, monkeypatch):
    """The engine's planner, at head_dim 256 in bf16, pins a prompt of 40
    rows whole and streams those of 58 and 70: the budget is the one 64-row
    tile of K and V (64 KB) that the kernel's one consumer leaves, and the
    planner's reserve lets a whole prompt take 56 rows of it.  Every split it
    grants fits the kernel's shared memory, one flash call a layer."""
    _, params, prompts = setup
    jreqs, _, _ = reference
    _, _, _, pins, _ = run_port(params, prompts, monkeypatch,
                                follow={r.uid: r.tokens_out for r in jreqs})
    assert pins == [(n, 256, p) for n, p in ((70, 0), (40, 40), (58, 0))
                    for _ in range(CFG.n_layers)]
    for n, d, p in pins:
        assert flash_smem_bytes(p, d, 2) <= H100_SMEM_PER_BLOCK


def test_launcher_serves_gemma7b_on_the_cpu(capsys):
    launch_serve.main(["--arch", "gemma-7b", "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "3 requests, 9 tokens" in out


def test_batched_example_serves_on_the_cpu(monkeypatch, capsys):
    """``examples/serve_batched_torch.py``, the port's counterpart of
    ``examples/serve_batched.py`` (gemma-7b, reduced; six requests, three
    slots), passes ``--device cpu`` on to the launcher."""
    monkeypatch.setattr(sys, "argv", [str(EXAMPLE), "--device", "cpu"])
    runpy.run_path(str(EXAMPLE), run_name="__main__")
    out = capsys.readouterr().out
    assert out.count("req ") == 6 and "6 requests, 48 tokens" in out and "on cpu" in out
