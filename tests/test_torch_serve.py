"""The port's serving engine against the JAX engine on the same requests.

``max_batch=2`` and three prompts of different length: the two slots sit at
different positions, so every step decodes two position groups, and the
third request reuses the slot of the first to finish.  Weights come from the
JAX package and cross through ``repro_torch.convert``.  Logit tolerance 3e-2
(rtol = atol), the bf16 model's; token ids must agree wherever the
reference's top-2 logit margin exceeds twice that.  The JAX side runs under
``jax.disable_jit()`` (see tests/test_torch_model.py for why)."""

import jax
import numpy as np
import pytest
import torch

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
from repro_torch.models import init_params
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine
from repro_torch.serve import ServeTruncation
from repro_torch.serve import engine as engine_mod

TOL = 3e-2
PROMPT_LENS = (9, 14, 5)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def jax_op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduce(jax_get_arch("llama3.2-3b"))
    cfg = reduce_for_smoke(get_arch("llama3.2-3b"))
    jparams = jm.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


def run_jax(jcfg, jparams, prompts):
    """The JAX engine's tokens and, call by call, the logits it picked from."""
    eng = JaxServeEngine(jcfg, jparams, max_batch=2, max_seq=32)
    calls = []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def prefill(p, t):
        out = inner_prefill(p, t)
        calls.append(("prefill", np.asarray(out[0], np.float32)))
        return out

    def decode(p, t, c):
        out = inner_decode(p, t, c)
        calls.append(("decode", np.asarray(out[0], np.float32)[:, 0]))
        return out

    eng._prefill, eng._decode = prefill, decode
    reqs = [JaxRequest(uid=i, prompt=prompt, max_new_tokens=MAX_NEW)
            for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    with jax.disable_jit():
        steps = eng.run_to_completion()
    assert eng._tmu.live_tiles == 0
    return reqs, calls, steps


class FollowingEngine(ServeEngine):
    """Picks the reference's token at every step (so that a near-tie cannot
    send the two engines down different continuations) and records its own
    choice beside it."""

    def __init__(self, *args, follow, **kwargs):
        super().__init__(*args, **kwargs)
        self.follow = follow
        self.own = {uid: [] for uid in follow}

    def _pick(self, logits, uid):
        self.own[uid].append(super()._pick(logits, uid))
        return self.follow[uid][len(self.own[uid]) - 1]


def test_engine_matches_jax_engine(setup, monkeypatch):
    jcfg, cfg, jparams, params, prompts = setup
    jreqs, jcalls, jsteps = run_jax(jcfg, jparams, prompts)

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
    eng = FollowingEngine(cfg, params, max_batch=2, max_seq=32, device="cpu",
                          follow={r.uid: r.tokens_out for r in jreqs})
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=MAX_NEW)
            for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()

    assert steps == jsteps
    assert eng._tmu.live_tiles == 0
    assert eng.prefill_calls == 3 and eng.decode_calls == len(calls) - 3
    assert [kind for kind, _ in jcalls] == [kind for kind, _, _ in calls]
    assert any(kind == "decode" and len(rows) == 1 for kind, rows, _ in calls)
    checked = 0
    for (_, want), (_, rows, got) in zip(jcalls, calls):
        np.testing.assert_allclose(got[rows], want[rows], rtol=TOL, atol=TOL)
        checked += len(rows)
    assert checked == 3 * MAX_NEW
    for jr, r in zip(jreqs, reqs):
        assert r.done and r.tokens_out == jr.tokens_out and len(r.tokens_out) == MAX_NEW
    # the port's own greedy choice is the reference's wherever the reference's
    # top-2 margin is clear of the tolerance
    clear = 0
    for (_, want), (_, rows, got) in zip(jcalls, calls):
        for i in rows:
            top2 = np.sort(want[i])[-2:]
            if top2[1] - top2[0] > 2 * (TOL + TOL * abs(top2[1])):
                assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
                clear += 1
    assert clear > 0
    assert sum(len(v) for v in eng.own.values()) == 3 * MAX_NEW


def test_free_running_engine_finishes_and_retires_slots(setup):
    _, cfg, _, params, prompts = setup
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, device="cpu")
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=4) for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    assert all(r.done and len(r.tokens_out) == 4 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.tokens_out)
    assert eng._tmu.live_tiles == 0 and eng.sched.drained
    assert torch.isfinite(eng.last_logits.float()).all()


def test_batched_matches_single(setup):
    """Continuous batching must not change greedy outputs (the JAX package's
    own engine test, on the port)."""
    _, cfg, _, params, prompts = setup
    single = []
    for i, prompt in enumerate(prompts[:2]):
        eng = ServeEngine(cfg, params, max_batch=1, max_seq=32, device="cpu")
        req = Request(uid=i, prompt=prompt, max_new_tokens=5)
        eng.add_request(req)
        eng.run_to_completion()
        single.append(req.tokens_out)
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, device="cpu")
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=5) for i, prompt in enumerate(prompts[:2])]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    assert [r.tokens_out for r in reqs] == single


def test_reused_slot_keeps_nothing_of_the_retired_request(setup):
    _, cfg, _, params, prompts = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_seq=32, device="cpu")
    first = Request(uid=0, prompt=prompts[1], max_new_tokens=6)     # 14 + 6 rows
    second = Request(uid=1, prompt=prompts[2], max_new_tokens=1)    # 5 rows
    eng.add_request(first)
    eng.add_request(second)
    while not first.done:
        eng.step()
    assert eng.cache.k[:, 0, 14:19].any()
    eng._admit()                                  # second takes the slot: prefill + splice
    assert eng.cache.k[:, 0, :5].any()
    assert not eng.cache.k[:, 0, 5:].any() and not eng.cache.v[:, 0, 5:].any()


def test_truncation_is_raised_on_a_short_budget(setup):
    _, cfg, _, params, prompts = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_seq=32, device="cpu")
    for i, prompt in enumerate(prompts):
        eng.add_request(Request(uid=i, prompt=prompt, max_new_tokens=8))
    with pytest.raises(ServeTruncation) as info:
        eng.run_to_completion(max_steps=3)
    assert info.value.steps == 3 and info.value.active + info.value.queued == 3


def test_sampling_engine_runs(setup):
    _, cfg, _, params, prompts = setup
    eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, greedy=False, device="cpu")
    req = Request(uid=7, prompt=prompts[0], max_new_tokens=3, eos_id=None)
    eng.add_request(req)
    eng.run_to_completion()
    assert req.done and len(req.tokens_out) == 3


def test_sampling_draws_the_first_token_only(setup, monkeypatch):
    """``greedy=False`` as in the reference engine: the first token is drawn
    after prefill from a generator seeded with the uid (the same in two runs),
    and every decoded token is the argmax of the logits it was picked from."""
    _, cfg, _, params, prompts = setup
    seen = []
    inner = engine_mod.decode_step

    def decode_step(p, t, cache, c, **kw):
        out = inner(p, t, cache, c, **kw)
        seen.extend(out[0][i, 0].clone() for i in kw["rows"])
        return out

    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    firsts = []
    for _ in range(2):
        seen.clear()
        eng = ServeEngine(cfg, params, max_batch=2, max_seq=32, greedy=False, device="cpu")
        req = Request(uid=7, prompt=prompts[0], max_new_tokens=6)
        eng.add_request(req)
        eng.run_to_completion()
        assert len(seen) == 5
        assert req.tokens_out[1:] == [int(torch.argmax(logits)) for logits in seen]
        firsts.append(req.tokens_out[0])
    assert firsts[0] == firsts[1]


def test_decoding_past_max_seq_is_refused(setup):
    """An attention model has no K/V row past ``max_seq``: the step that
    would decode there raises (the reference clamps the write onto the last
    row instead; ROADMAP Queue 3)."""
    _, cfg, _, params, prompts = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_seq=8, device="cpu")
    req = Request(uid=0, prompt=prompts[2], max_new_tokens=8)       # 5 prompt rows
    eng.add_request(req)
    with pytest.raises(ValueError, match="max_seq"):
        eng.run_to_completion()
    assert len(req.tokens_out) == 4 and not req.done


def test_prompt_longer_than_the_pool_is_refused(setup):
    _, cfg, _, params, _ = setup
    eng = ServeEngine(cfg, params, max_batch=1, max_seq=8, device="cpu")
    eng.add_request(Request(uid=0, prompt=np.arange(2, 12, dtype=np.int32)))
    with pytest.raises(ValueError, match="max_seq"):
        eng.step()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(setup, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg, _, params, _ = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launch_serve.main(["--requests", "1"])
    launch_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out


def test_launch_reduce_can_be_switched_off():
    """``--full`` / ``--no-reduce`` reach the published widths (checked on the
    parser only: a full-width model is not built on the CPU here)."""
    import argparse
    seen = {}

    def fake_parse(self, argv=None):
        ns = real_parse(self, argv)
        seen.update(vars(ns))
        raise SystemExit(0)

    real_parse = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = fake_parse
    try:
        for flag, want in (("--full", False), ("--no-reduce", False), ("--reduce", True)):
            with pytest.raises(SystemExit):
                launch_serve.main([flag, "--device", "cpu"])
            assert seen["reduce"] is want
        with pytest.raises(SystemExit):
            launch_serve.main(["--device", "cpu"])
        assert seen["reduce"] is True
    finally:
        argparse.ArgumentParser.parse_args = real_parse
