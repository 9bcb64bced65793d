"""The port's serving engine on the hybrid family (reduced zamba2-7b) against
the JAX engine on the same requests.

A hybrid has both kinds of cache: K/V for each application of the shared
attention block, conv history and state for each Mamba2 layer.  The engine
must plan each prefill's pinned KV split (it has attention), splice both
kinds into the pool and zero what a reused slot held, and decode one
``decode_step`` per position group that writes only its own rows of both.

``max_batch=2``, three prompts of 9 tokens (one length: the op-by-op JAX
side compiles one prefill shape) and different ``max_new_tokens``, so the
third request takes the first slot to retire while the other slot is some
positions ahead: from then on every step decodes two position groups.
Weights as in tests/test_torch_hybrid.py.  The JAX engine runs op by op
(``jax.disable_jit()``), which the port follows; bf16 logits and pooled
caches are held as tests/test_torch_hybrid.py holds them (at least 99.9%
within 3e-2 and an RMS error under 3e-2 / 2, rtol = atol) and token ids
must agree wherever the reference's top-2 margin exceeds twice the
tolerance.  torch runs on one thread (see tests/test_torch_ssd_scan.py)."""

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
PROMPT_LEN = 9
MAX_NEW = (3, 6, 5)
MAX_SEQ = 24
CFG = reduce_for_smoke(get_arch("zamba2-7b"))
JCFG = jax_reduce(jax_get_arch("zamba2-7b"))
FIELDS = ("k", "v", "conv_x", "conv_bc", "ssm")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close_bf16(got, want, what):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    share = float((err <= TOL + TOL * np.abs(want)).mean())
    assert share >= 0.999, f"{what}: only {share:.5f} within {TOL}"
    assert float(np.sqrt(np.mean(err ** 2))) <= TOL / 2, what


@pytest.fixture(scope="module")
def setup():
    params = init_params(CFG, seed=0, device="cpu")
    arrays = convert.params_to_numpy(params)
    shapes = jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.key(0)))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, CFG.vocab, size=PROMPT_LEN).astype(np.int32)
               for _ in MAX_NEW]
    return jparams, params, prompts


def run_jax(jparams, prompts):
    """The JAX engine, op by op: its tokens and, call by call, the logits it
    picked from."""
    eng = JaxServeEngine(JCFG, jparams, max_batch=2, max_seq=MAX_SEQ)
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
    reqs = [JaxRequest(uid=i, prompt=prompt, max_new_tokens=n)
            for i, (prompt, n) in enumerate(zip(prompts, MAX_NEW))]
    for r in reqs:
        eng.add_request(r)
    with jax.disable_jit():
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
        assert set(kw) == {"pinned_rows"}       # the planner's split: attention is there
        out = inner_prefill(p, t, c, **kw)
        calls.append(("prefill", [0], out[0].float().numpy()))
        return out

    def decode_step(p, t, cache, c, **kw):
        out = inner_decode(p, t, cache, c, **kw)
        calls.append(("decode", list(kw["rows"]), out[0].float().numpy()[:, 0]))
        return out

    monkeypatch.setattr(engine_mod, "prefill", prefill_)
    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    eng = FollowingEngine(CFG, params, max_batch=2, max_seq=MAX_SEQ, device="cpu",
                          follow={r.uid: r.tokens_out for r in jreqs})
    assert eng._orch is not None
    assert eng.cache.k.shape[0] == CFG.n_layers // CFG.hybrid_period
    assert eng.cache.ssm.shape[0] == CFG.n_layers
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=n)
            for i, (prompt, n) in enumerate(zip(prompts, MAX_NEW))]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()

    assert steps == jsteps
    assert eng._tmu.live_tiles == 0
    assert eng.prefill_calls == 3 and eng.decode_calls == len(calls) - 3
    assert [kind for kind, _ in jcalls] == [kind for kind, _, _ in calls]
    assert any(kind == "decode" and len(rows) == 1 for kind, rows, _ in calls)
    got = np.concatenate([out[rows] for _, rows, out in calls])
    want = np.concatenate([out[rows] for (_, out), (_, rows, _) in zip(jcalls, calls)])
    assert got.shape[0] == sum(MAX_NEW)
    close_bf16(got, want, "logits")
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * (TOL + TOL * np.abs(top2[:, 1]))
    assert clear.any()
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()
    for jr, r in zip(jreqs, reqs):
        assert r.done and r.tokens_out == jr.tokens_out
        assert len(r.tokens_out) == r.max_new_tokens
    # the pooled K/V and states after the run: the JAX engine's merged cache
    for k in FIELDS:
        close_bf16(getattr(eng.cache, k), getattr(jeng.cache, k), k)


def test_free_running_engine_finishes_and_matches_single_runs(setup):
    """Continuous batching must not change greedy outputs (the JAX package's
    own engine test, on the hybrid family)."""
    _, params, prompts = setup
    lens = (PROMPT_LEN, 14, 5)
    prompts = [np.resize(p, n) for p, n in zip(prompts, lens)]
    single = []
    for i, prompt in enumerate(prompts):
        eng = ServeEngine(CFG, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
        req = Request(uid=i, prompt=prompt, max_new_tokens=5)
        eng.add_request(req)
        eng.run_to_completion()
        single.append(req.tokens_out)
    eng = ServeEngine(CFG, params, max_batch=2, max_seq=MAX_SEQ, device="cpu")
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=5) for i, prompt in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_to_completion()
    assert [r.tokens_out for r in reqs] == single
    assert eng._tmu.live_tiles == 0 and eng.sched.drained
    assert torch.isfinite(eng.last_logits.float()).all()


def test_reused_slot_keeps_nothing_of_the_retired_request(setup):
    """The second request takes the slot of the first: its K/V rows past its
    prompt are zeros again, and its conv history and state are its own."""
    _, params, prompts = setup
    eng = ServeEngine(CFG, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    first = Request(uid=0, prompt=np.resize(prompts[1], 14), max_new_tokens=6)
    second = Request(uid=1, prompt=prompts[2][:5], max_new_tokens=1)
    eng.add_request(first)
    eng.add_request(second)
    while not first.done:
        eng.step()
    assert eng.cache.k[:, 0, 5:19].any() and eng.cache.ssm[:, 0].any()
    eng._admit()                                  # second takes the slot: prefill + splice
    _, fresh = prefill(params, torch.as_tensor(prompts[2][None, :5], dtype=torch.long), CFG)
    for k in FIELDS:
        rows = getattr(fresh, k).shape[2] if k in ("k", "v") else None
        pool = getattr(eng.cache, k)[:, 0]
        one = getattr(fresh, k)[:, 0]
        if rows is None:
            assert torch.equal(pool, one), k
        else:
            assert torch.equal(pool[:, :rows], one), k
            assert not pool[:, rows:].any(), k


def test_splice_matches_the_reference_splice(setup):
    """Into a pool slot that held another request: K/V padded with zeros to
    ``max_seq`` and the states, as the JAX engine's ``_splice`` writes them."""
    _, params, prompts = setup
    _, one = prefill(params, torch.as_tensor(prompts[0][None], dtype=torch.long), CFG)
    pool = init_cache(CFG, 2, MAX_SEQ, device="cpu")
    for k in FIELDS:
        getattr(pool, k)[:, 1] = 7.0              # a retired request's leftovers
    dtypes = {k: jnp.float32 if k == "ssm" else jnp.bfloat16 for k in FIELDS}
    jpool = jm.Cache(**{k: jnp.asarray(f32(getattr(pool, k)), dtypes[k]) for k in FIELDS},
                     pos=jnp.asarray(0, jnp.int32))
    jone = jm.Cache(**{k: jnp.asarray(f32(getattr(one, k)), dtypes[k]) for k in FIELDS},
                    pos=jnp.asarray(PROMPT_LEN, jnp.int32))
    engine_mod._splice(pool, one, 1)
    jspliced = jax_engine_mod._splice(jpool, jone, 1, PROMPT_LEN, MAX_SEQ)
    for k in FIELDS:
        np.testing.assert_array_equal(f32(getattr(pool, k)), f32(getattr(jspliced, k)))
    assert not pool.k[:, 1, PROMPT_LEN:].any() and not pool.v[:, 1, PROMPT_LEN:].any()


def test_launcher_serves_zamba2_on_the_cpu(capsys):
    launch_serve.main(["--arch", "zamba2-7b", "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out
