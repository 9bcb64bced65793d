"""The port's serving engine on the MoE family (reduced deepseek-moe-16b)
against the JAX engine on the same requests, with a capacity that binds at
decode.

A MoE is the first family whose batch rows interact: the tokens of one call
compete for the experts' slots, earlier rows first.  The JAX engine decodes
the whole padded batch once per position group and keeps only the group's
cache rows, so the rows outside the group (other requests, empty slots with
token 0) still take expert slots and can push a group row's token out.  The
port must give those rows the same hidden states to get the same tokens.

``max_batch=8``, five requests with prompts of five lengths (every step
decodes five position groups), four experts, top-3 and capacity factor 0.5
in both packages: ``max(int(0.5 * 8 * 3 / 4), 4) = 4`` slots an expert for 24
choices of the 8 rows, so tokens drop at decode, and which ones depends on
the experts the earlier rows chose; the test asserts that the reference
dropped a group row's token.  Weights come from the port's
``init_params`` and cross to JAX through numpy.  The JAX engine runs op by
op (``jax.disable_jit()``).  The port runs free (it picks its own tokens),
and its tokens must be the reference's; the group rows' bf16 logits are held
as tests/test_torch_moe.py holds them (99.9% within 3e-2, RMS under 3e-2 /
2, rtol = atol)."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from repro_torch.models import init_params
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine
from repro_torch.serve import engine as engine_mod

TOL = 3e-2
PROMPT_LENS = (9, 14, 5, 11, 7)
MAX_NEW = 6
MAX_BATCH, MAX_SEQ = 8, 32
BINDING = dict(n_experts=4, top_k=3, capacity_factor=0.5)
CFG = reduce_for_smoke(get_arch("deepseek-moe-16b"))
CFG = replace(CFG, moe=replace(CFG.moe, **BINDING))
JCFG = jax_reduce(jax_get_arch("deepseek-moe-16b"))
JCFG = replace(JCFG, moe=replace(JCFG.moe, **BINDING))


@pytest.fixture(scope="module")
def setup():
    params = init_params(CFG, seed=0, device="cpu")
    arrays = convert.params_to_numpy(params)
    shapes = jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.key(0)))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, CFG.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    return jparams, params, prompts


@pytest.fixture(scope="module")
def reference(setup):
    """The JAX engine, op by op: its requests and, decode call by decode
    call, the logits, the group's rows and the tokens its capacity dropped
    (the two ``top_k`` of the MoE layer: the routing, then the slots)."""
    jparams, _, prompts = setup
    eng = JaxServeEngine(JCFG, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ)
    calls, picks = [], []
    inner_decode, merge, top_k = eng._decode, jax_engine_mod._merge_slots, jax.lax.top_k

    def decode(p, t, c):
        first = len(picks)
        out = inner_decode(p, t, c)
        (_, idx), (top_prio, tok_ids) = picks[first:]
        selected = np.zeros((JCFG.moe.n_experts, MAX_BATCH), dtype=bool)
        kept = np.zeros_like(selected)
        for e in range(JCFG.moe.n_experts):
            selected[e] = (np.asarray(idx) == e).any(-1)
            kept[e, np.asarray(tok_ids[e])[np.isfinite(np.asarray(top_prio[e]))]] = True
        calls.append(dict(logits=np.asarray(out[0], np.float32)[:, 0],
                          dropped=(selected & ~kept).any(0)))
        return out

    def merge_spy(old, new, slots):
        calls[-1]["rows"] = list(slots)
        return merge(old, new, slots)

    def spy(operand, k):
        out = top_k(operand, k)
        picks.append(out)
        return out

    eng._decode = decode
    reqs = [JaxRequest(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    jax_engine_mod._merge_slots, jax.lax.top_k = merge_spy, spy
    try:
        with jax.disable_jit():
            steps = eng.run_to_completion()
    finally:
        jax_engine_mod._merge_slots, jax.lax.top_k = merge, top_k
    return reqs, calls, steps


def test_capacity_binds_at_decode_in_the_reference(reference):
    """The setting has teeth: in some decode calls the reference's capacity
    drops the token of a row of the position group."""
    _, calls, _ = reference
    assert len(calls) == len(PROMPT_LENS) * (MAX_NEW - 1)     # one call a request a step
    hit = [c for c in calls if c["dropped"][c["rows"]].any()]
    assert hit, "no group row's token was dropped at decode"


def test_engine_gives_the_reference_engines_tokens(setup, reference, monkeypatch):
    """Free running, the port's engine gives every request the reference
    engine's tokens, with the same steps and decode calls; the group rows'
    logits follow the reference's."""
    _, params, prompts = setup
    jreqs, jcalls, jsteps = reference
    calls = []
    inner = engine_mod.decode_step

    def decode_step(p, t, cache, c, **kw):
        out = inner(p, t, cache, c, **kw)
        calls.append((list(kw["rows"]), out[0].float().numpy()[:, 0]))
        return out

    monkeypatch.setattr(engine_mod, "decode_step", decode_step)
    eng = ServeEngine(CFG, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    steps = eng.run_to_completion()
    assert steps == jsteps and eng.decode_calls == len(jcalls) == len(calls)
    assert [rows for rows, _ in calls] == [c["rows"] for c in jcalls]
    for jr, r in zip(jreqs, reqs):
        assert r.done and len(r.tokens_out) == MAX_NEW
        assert r.tokens_out == jr.tokens_out, r.uid
    got = np.concatenate([out[rows] for rows, out in calls])
    want = np.concatenate([c["logits"][c["rows"]] for c in jcalls])
    err = np.abs(got - want)
    assert float((err <= TOL + TOL * np.abs(want)).mean()) >= 0.999
    assert float(np.sqrt(np.mean(err ** 2))) <= TOL / 2
    assert eng._tmu.live_tiles == 0 and eng.sched.drained


def test_launcher_serves_deepseek_moe_on_the_cpu(capsys):
    launch_serve.main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out and "on cpu" in out
