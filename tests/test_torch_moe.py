"""The port's MoE family (deepseek-moe-16b: fine-grained routed experts with
first-come-first-served capacity, shared experts, ``first_dense`` dense
layers) against the JAX package's, on the CPU.

The MoE block's pieces (``_route``, ``_routed_experts``, ``_shared_experts``,
``moe_ffn``) take seeded numpy inputs at reduced widths, (B, S) = (2, 16),
with a capacity that drops tokens (the test asserts it does); both sides get
the same routing, so the outputs, the chosen experts and the kept tokens
can be held one against the other.  Tolerances (rtol = atol): 1e-4 in fp32,
3e-2 in bf16, the reference's.

The reduced deepseek-moe-16b (one dense layer, one MoE layer) runs
``forward``, ``prefill`` and ``decode_step`` against JAX in two settings:
``reduce_for_smoke``'s capacity factor 4.0, which drops nothing, and 0.5,
which drops tokens at prefill.  Weights come from the port's
``init_params`` and cross to JAX through numpy.  fp32 logits are held
elementwise at 1e-4; bf16 logits and caches by share (99.9% within 3e-2),
RMS, a 6e-2 cap and the greedy token, as tests/test_torch_hybrid.py holds
them.  The JAX side runs op by op (``jax.disable_jit()``), once per module
for the block and once per setting for the model."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import moe as jmoe
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import layers as port_layers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

TOL = 3e-2
FP32_TOL = 1e-4
B, S, STEPS = 2, 16, 4
T = B * S
D, E, F, K = 64, 8, 32, 2
CAPACITY = 5           # below the 8 slots an expert needs on average: tokens drop
DTYPES = {"float32": (torch.float32, jnp.float32, FP32_TOL),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, TOL)}
SETTINGS = {"reduced": {}, "dropping": dict(capacity_factor=0.5)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def close_bf16(got, want, what=""):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = np.abs(got - want)
    share = float((err <= TOL + TOL * np.abs(want)).mean())
    assert share >= 0.999, f"{what}: only {share:.5f} within {TOL}"
    assert err.max() <= 2 * TOL, f"{what}: max abs err {err.max():.4f}"
    assert float(np.sqrt(np.mean(err ** 2))) <= TOL / 2, what


def close_logits(got, want):
    close_bf16(got, want, "logits")
    got, want = f32(got), f32(want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * (TOL + TOL * np.abs(top2[..., 1]))
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def kept_mask(tok_ids, valid):
    """(E, T) bool: the tokens each expert keeps."""
    tok_ids, valid = np.asarray(tok_ids), np.asarray(valid)
    kept = np.zeros((tok_ids.shape[0], T), dtype=bool)
    for e in range(tok_ids.shape[0]):
        kept[e, tok_ids[e][valid[e]]] = True
    return kept


# ---------------------------------------------------------------------------
# the MoE block on seeded inputs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    """Seeded fp32 arrays and, per dtype, the reference's results op by op:
    routing, the routed experts (with the slots its capacity top-k chose),
    the shared experts and the whole ``moe_ffn``."""
    rng = np.random.default_rng(0)
    a = {
        "x": rng.standard_normal((B, S, D)).astype(np.float32),
        "ln": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        "w_gate": (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32),
        "w1": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w3": (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32),
        "w2": (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32),
        "sh_gate": (rng.standard_normal((D, 2 * F)) * D ** -0.5).astype(np.float32),
        "sh_up": (rng.standard_normal((D, 2 * F)) * D ** -0.5).astype(np.float32),
        "sh_down": (rng.standard_normal((2 * F, D)) * (2 * F) ** -0.5).astype(np.float32),
    }
    jcfg = jax_reduce(jax_get_arch("deepseek-moe-16b"))
    spec = replace(jcfg.moe, n_experts=E, top_k=K, d_ff_expert=F, n_shared=2,
                   capacity_factor=0.5)
    ref = {}
    top_k = jax.lax.top_k
    for name, (_, jdt, _) in DTYPES.items():
        jp = {k: jnp.asarray(v, jnp.float32 if k == "w_gate" else jdt) for k, v in a.items()}
        xt = jp["x"].reshape(T, D)
        picks = []

        def spy(operand, k):
            out = top_k(operand, k)
            picks.append(out)
            return out

        with jax.disable_jit():
            w, idx = jmoe._route(xt, jp["w_gate"], K)
            jax.lax.top_k = spy
            try:
                routed = jmoe._routed_experts(xt, w, idx, jp["w1"], jp["w3"], jp["w2"], 0,
                                              CAPACITY, jax.nn.silu)
            finally:
                jax.lax.top_k = top_k
            shared = jmoe._shared_experts(xt, jp, jax.nn.silu)
            body = {k: v for k, v in jp.items() if k != "x"}
            ffn = jmoe.moe_ffn(body, jp["x"], jcfg, spec)
        (top_prio, tok_ids), = picks
        ref[name] = dict(jp=jp, w=w, idx=idx, routed=routed, shared=shared, ffn=ffn,
                         kept=kept_mask(tok_ids, np.isfinite(np.asarray(top_prio))))
    return a, jcfg, spec, ref


def port_inputs(a, dtype):
    return {k: torch.from_numpy(v).to(torch.float32 if k == "w_gate" else dtype)
            for k, v in a.items()}


@pytest.mark.parametrize("name", list(DTYPES))
def test_route_matches_jax(block, name):
    """fp32 router: the same experts in the same order, the same weights."""
    a, _, _, ref = block
    dtype = DTYPES[name][0]
    p = port_inputs(a, dtype)
    w, idx = tmoe._route(p["x"].reshape(T, D), p["w_gate"], K)
    assert w.dtype == torch.float32 and idx.shape == (T, K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[name]["idx"]))
    close(w, ref[name]["w"], 1e-6)
    close(w.sum(-1), np.ones(T), 1e-6)


@pytest.mark.parametrize("name", list(DTYPES))
def test_routed_experts_match_jax_and_drop_tokens(block, name):
    """With the reference's routing: the same kept tokens (the earliest
    ones, up to the capacity), some tokens dropped, and the same output."""
    a, _, _, ref = block
    dtype, _, tol = DTYPES[name]
    r = ref[name]
    p = port_inputs(a, dtype)
    w = torch.tensor(f32(r["w"]))
    idx = torch.tensor(np.asarray(r["idx"])).long()
    tok_ids, valid, gw = tmoe._slots(w, idx, E, CAPACITY)
    kept = kept_mask(tok_ids.numpy(), valid.numpy())
    np.testing.assert_array_equal(kept, r["kept"])
    selected = np.zeros((E, T), dtype=bool)
    for t in range(T):
        selected[idx[t].numpy(), t] = True
    assert (kept <= selected).all()
    assert kept.sum() < selected.sum()                   # tokens were dropped
    for e in range(E):                    # first come, first served
        assert (np.flatnonzero(kept[e]) == np.flatnonzero(selected[e])[:CAPACITY]).all()
    assert bool((gw[~valid] == 0).all()) and bool((tok_ids[~valid] == 0).all())
    out = tmoe._routed_experts(p["x"].reshape(T, D), w, idx, p["w1"], p["w3"], p["w2"],
                               CAPACITY, port_layers._silu)
    assert out.dtype == dtype and out.shape == (T, D)
    close(out, r["routed"], tol)


def test_combine_adds_in_the_reference_order_bit_for_bit():
    """The deterministic scatter-add of the slots' bf16 outputs equals the
    reference's ``zeros.at[tok_ids].add(y)`` to the last bit.  Top-4 of 8
    experts, so a token sums up to four rows and the order of the sums shows
    in the last bit (adding the same rows in reverse order differs)."""
    rng = np.random.default_rng(3)
    k = 4
    idx = torch.from_numpy(np.argsort(rng.random((T, E)), axis=1)[:, :k].copy())
    w = torch.softmax(torch.from_numpy(rng.standard_normal((T, k))).float(), -1)
    tok_ids, valid, _ = tmoe._slots(w, idx, E, 12)
    assert int(valid.sum()) < T * k                      # some tokens dropped
    y = rng.standard_normal((E, tok_ids.shape[1], D)) * rng.uniform(0.01, 10, (E, 1, 1))
    y = np.where(valid.numpy()[..., None], y, 0.0).astype(np.float32)
    yb = torch.from_numpy(y).to(torch.bfloat16)
    with jax.disable_jit():
        want = jnp.zeros((T, D), jnp.bfloat16).at[jnp.asarray(tok_ids.numpy()).reshape(-1)].add(
            jnp.asarray(y, jnp.bfloat16).reshape(-1, D))
    got = tmoe._combine(yb, tok_ids, valid, idx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))
    backwards = tmoe._combine(yb.flip(0), tok_ids.flip(0), valid.flip(0), E - 1 - idx)
    assert not np.array_equal(f32(backwards), f32(want))


@pytest.mark.parametrize("name", list(DTYPES))
def test_shared_experts_match_jax(block, name):
    a, _, _, ref = block
    dtype, _, tol = DTYPES[name]
    p = port_inputs(a, dtype)
    out = tmoe._shared_experts(p["x"].reshape(T, D), p, port_layers._silu)
    close(out, ref[name]["shared"], tol)


@pytest.mark.parametrize("name", list(DTYPES))
def test_moe_ffn_matches_jax(block, name):
    """The whole block, pre-norm included, with its own routing and the
    capacity ``max(int(0.5 * 32 * 2 / 8), 4) = 4``, which drops tokens."""
    a, jcfg, spec, ref = block
    dtype, _, tol = DTYPES[name]
    p = port_inputs(a, dtype)
    x = p.pop("x")
    cfg = replace(reduce_for_smoke(get_arch("deepseek-moe-16b")), moe=spec)
    assert max(int(spec.capacity_factor * T * K / E), 4) == 4
    out = tmoe.moe_ffn(p, x, cfg, cfg.moe)
    assert out.shape == (B, S, D) and out.dtype == dtype
    close(out, ref[name]["ffn"], tol)


# ---------------------------------------------------------------------------
# the reduced deepseek-moe-16b
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(SETTINGS))
def case(request):
    """Configs, weights on both sides, tokens, and JAX's results op by op:
    forward over S tokens (bf16 and fp32), prefill of S tokens, STEPS decode
    steps from that prefill's cache (grown by STEPS rows)."""
    changes = SETTINGS[request.param]
    cfg = reduce_for_smoke(get_arch("deepseek-moe-16b"))
    jcfg = jax_reduce(jax_get_arch("deepseek-moe-16b"))
    cfg = replace(cfg, moe=replace(cfg.moe, **changes))
    jcfg = replace(jcfg, moe=replace(jcfg.moe, **changes))
    arrays = convert.params_to_numpy(tm.init_params(cfg, seed=0, device="cpu"))
    shapes = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.key(0)))
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, shapes)
    params = convert.params_from_numpy(arrays, "cpu")
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, size=(B, S + STEPS))
    ref = {}
    with jax.disable_jit():
        prompt = jnp.asarray(tokens[:, :S])
        ref["forward"] = jm.forward(jparams, prompt, jcfg, remat=False)
        ref["prefill"] = jm.prefill(jparams, prompt, jcfg)
        pad = [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]
        jcache = ref["prefill"][1]
        jcache = jcache._replace(k=jnp.pad(jcache.k, pad), v=jnp.pad(jcache.v, pad))
        ref["decode_from"] = jcache
        ref["decode"] = []
        for t in range(S, S + STEPS):
            logits, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                            jcache, jcfg)
            ref["decode"].append(logits)
        ref["decode_cache"] = jcache
        jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
        ref["forward_fp32"] = jm.forward(jp32, prompt, jcfg, remat=False)
    return dict(cfg=cfg, jcfg=jcfg, arrays=arrays, shapes=shapes,
                jparams=jparams, params=params, tokens=tokens, ref=ref)


def test_init_params_tree_matches_jax(case):
    """Keys, shapes and dtypes of ``init_params`` are the reference's:
    ``dense_layers`` {attn, mlp} and ``moe_layers`` {attn, moe} stacked on a
    layer axis, the router ``moe/w_gate`` in fp32, ``mlp/w_gate`` in bf16."""
    cfg, shapes = case["cfg"], case["shapes"]
    own = tm.init_params(cfg, seed=0, device="cpu")
    jl, jdef = jax.tree.flatten(shapes)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    nd = cfg.moe.first_dense
    assert own["dense_layers"]["mlp"]["w_gate"].shape == (nd, cfg.d_model, cfg.d_ff)
    assert own["moe_layers"]["moe"]["w1"].shape[:2] == (cfg.n_layers - nd, cfg.moe.n_experts)
    assert own["moe_layers"]["moe"]["w_gate"].dtype == torch.float32
    assert own["dense_layers"]["mlp"]["w_gate"].dtype == torch.bfloat16


def test_convert_keeps_the_router_in_fp32_by_its_path(case):
    """A JAX MoE tree crosses with each leaf's dtype and shape: ``moe/w_gate``
    stays fp32, ``mlp/w_gate`` and ``dense_layers/mlp/w_gate`` take the model
    dtype; the round trip through numpy gives the same tree back."""
    jparams = jm.init_params(case["jcfg"], jax.random.key(1))
    params = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), "cpu")
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree.leaves(params)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
        assert tuple(a.shape) == tuple(b.shape), path
        np.testing.assert_array_equal(f32(a), f32(b))
    assert params["moe_layers"]["moe"]["w_gate"].dtype == torch.float32
    assert params["dense_layers"]["mlp"]["w_gate"].dtype == torch.bfloat16
    dense = convert.params_from_numpy({"mlp": {"w_gate": np.ones((2, 3), np.float32)}}, "cpu")
    assert dense["mlp"]["w_gate"].dtype == torch.bfloat16
    again = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    assert jax.tree.structure(again) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_cache_matches_jax(case):
    """One K/V entry per layer, the dense layers first."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    cache = tm.init_cache(cfg, 3, 24, device="cpu")
    jcache = jm.init_cache(jcfg, 3, 24)
    assert cache.pos == 0 and cache.ssm is None and jcache.ssm is None
    for k in ("k", "v"):
        t, j = getattr(cache, k), getattr(jcache, k)
        assert t.shape == j.shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads, cfg.head_dim)
        assert str(t.dtype).split(".")[-1] == str(j.dtype) and not t.any()


def test_forward_matches_jax(case):
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    got = tm.forward(params, torch.from_numpy(tokens[:, :S]), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.bfloat16
    close_logits(got, case["ref"]["forward"])


def test_forward_matches_jax_in_fp32(case):
    """The same weights widened to fp32 on both sides: the logits agree
    elementwise within 1e-4, the tokens the capacity drops included."""
    cfg, tokens = case["cfg"], case["tokens"]
    params = convert.params_from_numpy(case["arrays"], "cpu", dtype=torch.float32)
    assert params["moe_layers"]["moe"]["w_gate"].dtype == torch.float32
    got = tm.forward(params, torch.from_numpy(tokens[:, :S]), cfg)
    assert got.dtype == torch.float32
    close(got, case["ref"]["forward_fp32"], FP32_TOL)


def test_prefill_matches_jax(case):
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    jlogits, jcache = case["ref"]["prefill"]
    logits, cache = tm.prefill(params, torch.from_numpy(tokens[:, :S]), cfg, pinned_rows=S)
    close_logits(logits, jlogits)
    for k in ("k", "v"):
        assert getattr(cache, k).shape == getattr(jcache, k).shape, k
        close_bf16(getattr(cache, k), getattr(jcache, k), k)
    assert cache.pos == int(jcache.pos) == S


def test_decode_steps_match_jax(case):
    """Four decode steps from the reference's prefilled cache: logits every
    step, then K/V; the port writes into the cache it was given."""
    cfg, params, tokens, ref = case["cfg"], case["params"], case["tokens"], case["ref"]
    jfrom = ref["decode_from"]
    cache = convert.cache_from_numpy(f32(jfrom.k), f32(jfrom.v), int(jfrom.pos), "cpu")
    k0 = cache.k
    for t, jlogits in zip(range(S, S + STEPS), ref["decode"]):
        logits, cache = tm.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]), cache, cfg)
        assert logits.shape == (B, 1, cfg.vocab)
        close_logits(logits, jlogits)
    assert cache.k is k0
    jcache = ref["decode_cache"]
    assert cache.pos == int(jcache.pos) == S + STEPS
    for k in ("k", "v"):
        close_bf16(getattr(cache, k), getattr(jcache, k), k)


@pytest.mark.parametrize("case", ["reduced"], indirect=True)
def test_prefill_then_decode_matches_forward(case):
    """Without drops (``reduce_for_smoke``'s capacity factor 4.0 gives every
    expert room for every token), prefill then decode one token at a time
    follows the full forward.  With drops the two differ by design: a call's
    tokens compete for slots, so the tokens of a call decide."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    tok = torch.from_numpy(tokens)
    full = tm.forward(params, tok, cfg)
    logits, cache = tm.prefill(params, tok[:, :S], cfg)
    close(logits, full[:, S - 1], TOL)
    pad = torch.zeros_like(cache.k[:, :, :STEPS])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    for t in range(S, S + STEPS):
        logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, cfg)
        close(logits[:, 0], full[:, t], TOL)


def test_decode_step_rows_run_every_row_and_write_only_their_own(case):
    """A step for slot 1 of a MoE model: every row takes the step (the
    batch's tokens compete for the experts), so slot 1's logits and K/V
    are the whole-batch step's to the bit; slot 0 keeps all of its K/V."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    rng = np.random.default_rng(7)
    cache = tm.init_cache(cfg, B, 8, device="cpu")
    for t in (cache.k, cache.v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    k0, v0 = cache.k.clone(), cache.v.clone()
    tok = torch.from_numpy(tokens[:, :1])
    full = tm.Cache(k=k0.clone(), v=v0.clone(), pos=5)
    want, full = tm.decode_step(params, tok, full, cfg)
    got, new = tm.decode_step(params, tok, cache._replace(pos=5), cfg, rows=[1])
    assert new.pos == 6
    assert torch.equal(cache.k[:, 0], k0[:, 0]) and torch.equal(cache.v[:, 0], v0[:, 0])
    assert torch.equal(cache.k[:, 1], full.k[:, 1]) and torch.equal(cache.v[:, 1], full.v[:, 1])
    assert not torch.equal(cache.k[:, 1, 5], k0[:, 1, 5])
    assert torch.equal(got, want)


def test_each_kernel_runs_once_a_layer(case, monkeypatch):
    """What the chip run counts, on the CPU: a prefill calls flash attention
    once per layer (dense and MoE), a decode step decode attention once per
    layer, also when it runs for some rows only."""
    cfg, params, tokens = case["cfg"], case["params"], case["tokens"]
    calls = {"flash_attention": 0, "decode_attention": 0}

    def counting(name):
        real = getattr(port_layers, name)

        def spy(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(port_layers, name, spy)

    counting("flash_attention")
    counting("decode_attention")
    _, cache = tm.prefill(params, torch.from_numpy(tokens[:, :S]), cfg)
    assert tmodel._n_attn_apps(cfg) == cfg.n_layers
    assert calls == {"flash_attention": cfg.n_layers, "decode_attention": 0}
    pad = torch.zeros_like(cache.k[:, :, :2])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    _, cache = tm.decode_step(params, torch.from_numpy(tokens[:, S:S + 1]), cache, cfg)
    tm.decode_step(params, torch.from_numpy(tokens[:, S + 1:S + 2]), cache, cfg, rows=[0])
    assert calls == {"flash_attention": cfg.n_layers, "decode_attention": 2 * cfg.n_layers}


def test_published_sizes_and_spec():
    """deepseek-moe-16b's published sizes and MoE spec, as the chip run
    serves them."""
    cfg = get_arch("deepseek-moe-16b")
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared, m.capacity_factor,
            m.first_dense) == (64, 6, 1408, 2, 1.25, 1)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == (28, 2048, 16, 16, 128, 10944, 102400)
