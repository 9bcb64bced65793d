"""The port's serving engine on gemma2 (reduced gemma2-27b: a local layer
with a 64-row window, then a global one; softcaps 50 and 30) against the
JAX engine on the same requests.

``max_batch=2`` and three prompts of 70, 100 and 30 tokens, 6 new tokens
each: the first two overrun the window at prefill and at every decode step,
the two slots sit at different positions, so every step decodes two
position groups, and the third request reuses the slot of the first to
finish.  Weights come from the JAX package and cross through
``repro_torch.convert``.  Logit tolerance 3e-2 (rtol = atol), the bf16
model's; the reference's tokens are followed (as in
tests/test_torch_serve.py) and the port's own greedy choice must agree
wherever the reference's top-2 margin exceeds twice the tolerance.  The JAX
engine runs op by op (``jax.disable_jit()``), once per module."""

from dataclasses import replace

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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as port_layers
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod

TOL = 3e-2
PROMPT_LENS = (70, 100, 30)
MAX_NEW = 6
MAX_BATCH, MAX_SEQ = 2, 112
CFG = reduce_for_smoke(get_arch("gemma2-27b"))
JCFG = jax_reduce(jax_get_arch("gemma2-27b"))


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


def run_port(cfg, params, prompts, monkeypatch, follow=None):
    """The port's engine on the prompts: its requests, and call by call the
    rows it served and their logits."""
    calls = []
    inner_prefill, inner_decode = engine_mod.prefill, engine_mod.decode_step

    def prefill(p, t, c, **kw):
        out = inner_prefill(p, t, c, **kw)
        calls.append(("prefill", [0], out[0].float().numpy()))
        return out

    def decode_step(p, t, cache, c, **kw):
        out = inner_decode(p, t, cache, c, **kw)
        calls.append(("decode", list(kw["rows"]), out[0].float().numpy()[:, 0]))
        return out

    monkeypatch.setattr(engine_mod, "prefill", prefill)
    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    kw = dict(max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    eng = (ServeEngine(cfg, params, **kw) if follow is None
           else FollowingEngine(cfg, params, follow=follow, **kw))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()
    return eng, reqs, calls, steps


def test_engine_matches_jax_engine(setup, reference, monkeypatch):
    _, params, prompts = setup
    jreqs, jcalls, jsteps = reference
    eng, reqs, calls, steps = run_port(CFG, params, prompts, monkeypatch,
                                       follow={r.uid: r.tokens_out for r in jreqs})
    assert steps == jsteps and eng._tmu.live_tiles == 0
    assert eng.prefill_calls == 3 and len(calls) == len(jcalls)
    assert any(kind == "decode" and len(rows) == 1 for kind, rows, _ in calls)
    clear = 0
    for (_, rows, got), want in zip(calls, jcalls):
        np.testing.assert_allclose(got[rows], want[rows], rtol=TOL, atol=TOL)
        for i in rows:
            top2 = np.sort(want[i])[-2:]
            if top2[1] - top2[0] > 2 * (TOL + TOL * abs(top2[1])):
                assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
                clear += 1
    assert clear > 0
    for jr, r in zip(jreqs, reqs):
        assert r.done and r.tokens_out == jr.tokens_out and len(r.tokens_out) == MAX_NEW


def test_window_binds_on_the_served_requests(setup, reference, monkeypatch):
    """Served without its window, the same weights give other logits for the
    requests past it, and the same for the one that stays inside it."""
    _, params, prompts = setup
    jreqs, _, _ = reference
    follow = {r.uid: r.tokens_out for r in jreqs}
    _, _, calls, _ = run_port(CFG, params, prompts, monkeypatch, follow=follow)
    monkeypatch.undo()
    _, _, wide, _ = run_port(replace(CFG, window=None), params, prompts, monkeypatch,
                             follow=follow)
    moved = [float(np.abs(a - b).max()) for (kind, _, a), (_, _, b) in zip(calls, wide)
             if kind == "prefill"]
    assert min(moved[:2]) > 0.1                     # the prefills of 70 and 100 tokens
    assert moved[2] == 0.0                          # 30 tokens: inside the window


def test_reused_slot_past_the_window_keeps_nothing_of_the_retired_request(setup):
    """A slot that held 100 + 6 rows takes a 30-token prompt: the K/V past
    the new prompt are zeros, and the new request attends only to its own
    rows in both kernels' plain versions."""
    _, params, prompts = setup
    eng = ServeEngine(CFG, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    first = Request(uid=0, prompt=prompts[1], max_new_tokens=MAX_NEW)
    second = Request(uid=1, prompt=prompts[2], max_new_tokens=MAX_NEW)
    eng.add_request(first)
    eng.add_request(second)
    while not first.done:
        eng.step()
    assert eng.cache.k[:, 0, 100:105].any()
    eng._admit()
    assert not eng.cache.k[:, 0, 30:].any() and not eng.cache.v[:, 0, 30:].any()
    eng.run_to_completion()
    alone = ServeEngine(CFG, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    again = Request(uid=1, prompt=prompts[2], max_new_tokens=MAX_NEW)
    alone.add_request(again)
    alone.run_to_completion()
    assert second.tokens_out == again.tokens_out


def test_each_attention_call_of_a_served_step_carries_the_window(setup, monkeypatch):
    """What the chip run counts, on the CPU: one flash call a layer a prefill
    and one decode call a layer a ``decode_step`` call, the window on the
    local layer's calls only."""
    _, params, prompts = setup
    seen = {"flash_attention": [], "decode_attention": []}

    def spy(name):
        real = getattr(port_layers, name)

        def call(*args, **kw):
            seen[name].append(kw.get("window"))
            return real(*args, **kw)
        monkeypatch.setattr(port_layers, name, call)

    spy("flash_attention")
    spy("decode_attention")
    eng = ServeEngine(CFG, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    for i, p in enumerate(prompts):
        eng.add_request(Request(uid=i, prompt=p, max_new_tokens=3))
    eng.run_to_completion()
    assert seen["flash_attention"] == [64, None] * 3
    assert seen["decode_attention"] == [64, None] * eng.decode_calls


def test_launcher_serves_gemma2_on_the_cpu(capsys):
    launch_serve.main(["--arch", "gemma2-27b", "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "3 requests, 9 tokens" in out
