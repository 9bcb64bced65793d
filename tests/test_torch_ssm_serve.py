"""The port's serving engine on the SSM family (reduced mamba2-2.7b) against
the JAX engine on the same requests.

``max_batch=2`` and three prompts of different lengths (all below the
reduced chunk of 32, so every prompt is its own chunk): the two slots sit at
different positions, every step decodes two position groups, and the third
request reuses the slot of the first to finish.  Weights as in
tests/test_torch_ssm.py.  The JAX engine runs jitted; logits are held within
3e-2 (rtol = atol) and token ids must agree wherever the reference's top-2
margin exceeds twice that.  torch runs on one thread (see
tests/test_torch_ssd_scan.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import engine as jax_engine_mod
# the port
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_cache
from repro_torch.models import init_params
from repro_torch.models import prefill
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod

TOL = 3e-2
PROMPT_LENS = (9, 14, 5)
MAX_NEW = 6
CFG = reduce_for_smoke(get_arch("mamba2-2.7b"))
JCFG = jax_reduce(jax_get_arch("mamba2-2.7b"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    params = init_params(CFG, seed=0, device="cpu")
    arrays = convert.params_to_numpy(params)
    shapes = jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.key(0)))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, CFG.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    return jparams, params, prompts


def run_jax(jparams, prompts):
    """The JAX engine's tokens and, call by call, the logits it picked from."""
    eng = JaxServeEngine(JCFG, jparams, max_batch=2, max_seq=32)
    calls = []
    inner_prefill, inner_decode = eng._prefill, eng._decode

    def prefill_(p, t):
        out = inner_prefill(p, t)
        calls.append(("prefill", np.asarray(out[0], np.float32)))
        return out

    def decode(p, t, c):
        out = inner_decode(p, t, c)
        calls.append(("decode", np.asarray(out[0], np.float32)[:, 0]))
        return out

    eng._prefill, eng._decode = prefill_, decode
    reqs = [JaxRequest(uid=i, prompt=prompt, max_new_tokens=MAX_NEW)
            for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()
    assert eng._tmu.live_tiles == 0
    return reqs, calls, steps, eng


class FollowingEngine(ServeEngine):
    """Picks the reference's token at every step and records its own choice."""

    def __init__(self, *args, follow, **kwargs):
        super().__init__(*args, **kwargs)
        self.follow = follow
        self.own = {uid: [] for uid in follow}

    def _pick(self, logits, uid):
        self.own[uid].append(super()._pick(logits, uid))
        return self.follow[uid][len(self.own[uid]) - 1]


def test_engine_matches_jax_engine(setup, monkeypatch):
    jparams, params, prompts = setup
    jreqs, jcalls, jsteps, jeng = run_jax(jparams, prompts)

    calls = []
    inner_prefill, inner_decode = engine_mod.prefill, engine_mod.decode_step

    def prefill_(p, t, c, **kw):
        assert not kw                         # no KV split to plan without attention
        out = inner_prefill(p, t, c)
        calls.append(("prefill", [0], out[0].float().numpy()))
        return out

    def decode_step(p, t, cache, c, **kw):
        out = inner_decode(p, t, cache, c, **kw)
        calls.append(("decode", list(kw["rows"]), out[0].float().numpy()[:, 0]))
        return out

    monkeypatch.setattr(engine_mod, "prefill", prefill_)
    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    eng = FollowingEngine(CFG, params, max_batch=2, max_seq=32, device="cpu",
                          follow={r.uid: r.tokens_out for r in jreqs})
    assert eng._orch is None
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
    checked = clear = 0
    for (_, want), (_, rows, got) in zip(jcalls, calls):
        np.testing.assert_allclose(got[rows], want[rows], rtol=TOL, atol=TOL)
        checked += len(rows)
        for i in rows:
            top2 = np.sort(want[i])[-2:]
            if top2[1] - top2[0] > 2 * (TOL + TOL * abs(top2[1])):
                assert int(np.argmax(got[i])) == int(np.argmax(want[i]))
                clear += 1
    assert checked == 3 * MAX_NEW and clear > 0
    for jr, r in zip(jreqs, reqs):
        assert r.done and r.tokens_out == jr.tokens_out and len(r.tokens_out) == MAX_NEW
    # the pooled states after the run: the JAX engine's merged cache
    for k in ("conv_x", "conv_bc", "ssm"):
        np.testing.assert_allclose(getattr(eng.cache, k).float().numpy(),
                                   np.asarray(getattr(jeng.cache, k), np.float32),
                                   rtol=TOL, atol=TOL)


def test_free_running_engine_finishes_and_matches_single_runs(setup):
    """Continuous batching must not change greedy outputs (the JAX package's
    own engine test, on the SSM family)."""
    _, params, prompts = setup
    single = []
    for i, prompt in enumerate(prompts):
        eng = ServeEngine(CFG, params, max_batch=1, max_seq=32, device="cpu")
        req = Request(uid=i, prompt=prompt, max_new_tokens=5)
        eng.add_request(req)
        eng.run_to_completion()
        single.append(req.tokens_out)
    eng = ServeEngine(CFG, params, max_batch=2, max_seq=32, device="cpu")
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=5) for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    assert [r.tokens_out for r in reqs] == single
    assert eng._tmu.live_tiles == 0 and eng.sched.drained
    assert torch.isfinite(eng.last_logits.float()).all()


def test_reused_slot_keeps_nothing_of_the_retired_request(setup):
    _, params, prompts = setup
    eng = ServeEngine(CFG, params, max_batch=1, max_seq=32, device="cpu")
    first = Request(uid=0, prompt=prompts[1], max_new_tokens=6)
    second = Request(uid=1, prompt=prompts[2], max_new_tokens=1)
    eng.add_request(first)
    eng.add_request(second)
    while not first.done:
        eng.step()
    assert eng.cache.ssm[:, 0].any()
    eng._admit()                                  # second takes the slot: prefill + splice
    _, fresh = prefill(params, torch.as_tensor(prompts[2][None], dtype=torch.long), CFG)
    for k in ("conv_x", "conv_bc", "ssm"):
        assert torch.equal(getattr(eng.cache, k)[:, 0], getattr(fresh, k)[:, 0])


def test_two_token_prompt_splices_as_the_reference_does(setup):
    """After a 2-token prompt the prefill keeps two conv rows; the JAX
    engine's ``_splice`` writes them to rows 0 and 1 of the slot and leaves
    the last row as it was (zeros in a fresh pool).  The port does the same
    and zeroes that row in a reused slot (ROADMAP Queue 3)."""
    jparams, params, prompts = setup
    tok = prompts[0][:2]
    _, one = prefill(params, torch.as_tensor(tok[None], dtype=torch.long), CFG)
    assert one.conv_x.shape[2] == 2
    port_pool = init_cache(CFG, 2, 32, device="cpu")
    port_pool.conv_x[:, 1] = 7.0                  # a retired request's leftovers
    engine_mod._splice(port_pool, one, 1)
    jpool = jm.init_cache(JCFG, 2, 32)
    jone = jm.Cache(conv_x=jnp.asarray(one.conv_x.float().numpy(), jnp.bfloat16),
                    conv_bc=jnp.asarray(one.conv_bc.float().numpy(), jnp.bfloat16),
                    ssm=jnp.asarray(one.ssm.numpy()), pos=jnp.asarray(2, jnp.int32))
    jspliced = jax_engine_mod._splice(jpool, jone, 1, 2, 32)
    for k in ("conv_x", "conv_bc", "ssm"):
        np.testing.assert_array_equal(getattr(port_pool, k).float().numpy(),
                                      np.asarray(getattr(jspliced, k), np.float32))
    assert not port_pool.conv_x[:, 1, 2].any()


def test_max_seq_bounds_no_state_as_in_the_reference(setup):
    """An SSM has no K/V, so ``max_seq`` bounds nothing: with ``max_seq`` 8 a
    4-token prompt decodes 8 new tokens, and a 12-token prompt (one chunk of
    the reduced chunk rule) is served, as the reference engine does both."""
    jparams, params, prompts = setup
    chosen = [prompts[1][:4], prompts[1][:12]]
    jeng = JaxServeEngine(JCFG, jparams, max_batch=2, max_seq=8)
    eng = ServeEngine(CFG, params, max_batch=2, max_seq=8, device="cpu")
    jreqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(chosen)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(chosen)]
    for jr, r in zip(jreqs, reqs):
        jeng.add_request(jr)
        eng.add_request(r)
    jeng.run_to_completion()
    eng.run_to_completion()
    for jr, r in zip(jreqs, reqs):
        assert r.done and len(r.tokens_out) == 8
        assert r.tokens_out == jr.tokens_out


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    launch_serve.main(["--arch", "mamba2-2.7b", "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out
