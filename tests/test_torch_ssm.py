"""The port's Mamba2 (SSM family) against the JAX package's, on the CPU.

Weights come from the port's ``init_params`` (seed 0), cross to numpy and
go to JAX with the dtypes of the JAX package's own ``init_params`` tree
(read with ``jax.eval_shape``), and back into the port through
``repro_torch.convert``.

Tolerances (rtol = atol): the blocks' pieces are compared op by op with
eager JAX, where the bf16 steps (softplus, the depthwise convolutions,
silu) agree **exactly** and SSD results within 1e-4 (fp32); block outputs
in bf16 within 3e-2.  Model logits are compared with jitted JAX within
3e-2, the JAX package's own logit tolerance: XLA's fused evaluation rounds
bf16 at other places than the op-by-op one (which the port matches), and
on the reduced mamba2 the two differ by one bf16 step (0.031) at logits
above 2, inside the tolerance.

torch runs on one thread (see tests/test_torch_ssd_scan.py for why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import model as jmodel
from repro.models import ssm as jssm
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import ssm as tssm

TOL = 3e-2
SSD_TOL = 1e-4
B, S = 2, 64
CFG = reduce_for_smoke(get_arch("mamba2-2.7b"))
JCFG = jax_reduce(jax_get_arch("mamba2-2.7b"))


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


def jax_tree_shapes():
    return jax.eval_shape(lambda: jm.init_params(JCFG, jax.random.key(0)))


@pytest.fixture(scope="module")
def weights():
    own = tm.init_params(CFG, seed=0, device="cpu")
    arrays = convert.params_to_numpy(own)
    jparams = jax.tree.map(lambda a, sd: jnp.asarray(a, sd.dtype), arrays, jax_tree_shapes())
    params = convert.params_from_numpy(arrays, "cpu")
    tokens = np.random.default_rng(0).integers(2, CFG.vocab, size=(B, S + 2))
    return jparams, params, tokens


@pytest.fixture(scope="module")
def jax_prefill():
    return jax.jit(lambda p, t: jm.prefill(p, t, JCFG))


def layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


# ---------------------------------------------------------------------------
# models/ssm.py, function by function
# ---------------------------------------------------------------------------
def test_segsum_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 16)).astype(np.float32)
    got = f32(tssm.segsum(torch.from_numpy(x)))
    want = f32(jssm.segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(with_init):
    rng = np.random.default_rng(2)
    b, s, h, g, p, n = 2, 64, 4, 2, 16, 8
    arrs = [rng.standard_normal((b, s, h, p)), np.log1p(np.exp(rng.standard_normal((b, s, h)))),
            -np.exp(rng.uniform(-1, 1, h)), rng.standard_normal((b, s, g, n)),
            rng.standard_normal((b, s, g, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_init else None
    y, st = tssm.ssd_chunked(*map(torch.from_numpy, arrs), 16,
                             initial_state=None if init is None else torch.from_numpy(init))
    jy, jst = jssm.ssd_chunked(*map(jnp.asarray, arrs), 16,
                               initial_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(f32(y), f32(jy), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(f32(st), f32(jst), rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    b, h, g, p, n = 2, 4, 2, 16, 8
    arrs = [rng.standard_normal((b, h, p, n)), rng.standard_normal((b, h, p)),
            np.log1p(np.exp(rng.standard_normal((b, h)))), -np.exp(rng.uniform(-1, 1, h)),
            rng.standard_normal((b, g, n)), rng.standard_normal((b, g, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    y, st = tssm.ssd_decode_step(*map(torch.from_numpy, arrs))
    jy, jst = jssm.ssd_decode_step(*map(jnp.asarray, arrs))
    np.testing.assert_allclose(f32(y), f32(jy), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(f32(st), f32(jst), rtol=SSD_TOL, atol=SSD_TOL)


def bf16_pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def test_bf16_steps_match_jax_bit_for_bit():
    """softplus, the causal conv and the decode branch's conv step round in
    bf16 exactly where XLA's op-by-op evaluation does."""
    rng = np.random.default_rng(4)
    jx, tx = bf16_pair(rng, (2, 37, 96), 2.0)
    jw, tw = bf16_pair(rng, (4, 96), 0.1)
    jb, tb = bf16_pair(rng, (96,), 0.1)
    np.testing.assert_array_equal(f32(tssm._softplus(tx)), f32(jax.nn.softplus(jx)))
    np.testing.assert_array_equal(f32(tssm._causal_conv(tx, tw, tb)),
                                  f32(jssm._causal_conv(jx, jw, jb)))
    jh, th = bf16_pair(rng, (2, 4, 96), 2.0)
    want = jax.nn.silu(jnp.einsum("bkc,kc->bc", jh, jw) + jb)
    np.testing.assert_array_equal(f32(tssm._conv_step(th, tw, tb)), f32(want))


@pytest.mark.parametrize("mode", ["forward", "prefill_from_state", "decode"])
def test_mamba2_block_matches_jax(weights, mode):
    """Both branches: the full-sequence one (through the ssd_scan wrapper),
    with and without a carried state, and the one-token recurrence."""
    jparams, params, _ = weights
    rng = np.random.default_rng(5)
    s = 1 if mode == "decode" else 32
    jx, tx = bf16_pair(rng, (B, s, CFG.d_model))
    jcache = cache = None
    if mode != "forward":
        d_inner = CFG.ssm.expand * CFG.d_model
        h = d_inner // CFG.ssm.head_dim
        k = CFG.ssm.d_conv - 1
        jcx, tcx = bf16_pair(rng, (B, k, d_inner))
        jcbc, tcbc = bf16_pair(rng, (B, k, 2 * CFG.ssm.n_groups * CFG.ssm.d_state))
        st = (rng.standard_normal((B, h, CFG.ssm.head_dim, CFG.ssm.d_state)) * 0.5
              ).astype(np.float32)
        jcache = jssm.Mamba2Cache(conv_x=jcx, conv_bc=jcbc, ssm=jnp.asarray(st))
        cache = tssm.Mamba2Cache(conv_x=tcx, conv_bc=tcbc, ssm=torch.from_numpy(st))
    want, jnew = jssm.mamba2_block(layer(jparams["layers"]), jx, JCFG.ssm, cache=jcache)
    got, new = tssm.mamba2_block(layer(params["layers"]), tx, CFG.ssm, cache=cache)
    assert got.dtype == torch.bfloat16 and got.shape == (B, s, CFG.d_model)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)
    if mode == "forward":
        assert new is None and jnew is None
        return
    # the conv histories are rows of bf16 projections: products summed in
    # another order flip a last bit now and then
    np.testing.assert_allclose(f32(new.conv_x), f32(jnew.conv_x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f32(new.conv_bc), f32(jnew.conv_bc), rtol=TOL, atol=TOL)
    assert new.ssm.dtype == torch.float32
    np.testing.assert_allclose(f32(new.ssm), f32(jnew.ssm), rtol=SSD_TOL, atol=SSD_TOL)


# ---------------------------------------------------------------------------
# parameters, caches, convert
# ---------------------------------------------------------------------------
def test_init_params_tree_matches_jax():
    own = tm.init_params(CFG, seed=0, device="cpu")
    shapes = jax_tree_shapes()
    jl, jdef = jax.tree.flatten(shapes)
    tl, tdef = jax.tree.flatten(own)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
    lay = own["layers"]
    assert lay["a_log"].dtype == lay["d_skip"].dtype == torch.float32
    h = lay["a_log"].shape[1]
    np.testing.assert_allclose(f32(lay["a_log"][1]),
                               f32(jnp.log(jnp.linspace(1.0, 16.0, h))), rtol=1e-6)


def test_convert_round_trip_keeps_the_reference_dtypes(weights):
    """params_from_numpy narrows to bf16 except the leaves the reference keeps
    in fp32; cache_from_numpy carries conv_x/conv_bc (bf16) and ssm (fp32)."""
    jparams, params, _ = weights
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree.leaves(params)):
        assert str(b.dtype).split(".")[-1] == str(a.dtype), path
        np.testing.assert_array_equal(f32(a), f32(b))
    again = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        assert torch.equal(a, b)
    jcache = jm.init_cache(JCFG, B, 8)
    rng = np.random.default_rng(6)
    arrays = {k: rng.standard_normal(getattr(jcache, k).shape).astype(np.float32)
              for k in ("conv_x", "conv_bc", "ssm")}
    cache = convert.cache_from_numpy(pos=5, device="cpu", **arrays)
    assert cache.k is None and cache.v is None and cache.pos == 5
    for k, arr in arrays.items():
        t = getattr(cache, k)
        assert str(t.dtype).split(".")[-1] == str(getattr(jcache, k).dtype)
        assert t.shape == getattr(jcache, k).shape
        np.testing.assert_array_equal(f32(t), f32(jnp.asarray(arr, getattr(jcache, k).dtype)))


def test_init_cache_matches_jax():
    cache = tm.init_cache(CFG, 3, 16, device="cpu")
    jcache = jm.init_cache(JCFG, 3, 16)
    assert cache.k is None and cache.v is None and cache.pos == 0
    for k in ("conv_x", "conv_bc", "ssm"):
        t, j = getattr(cache, k), getattr(jcache, k)
        assert t.shape == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        assert not t.any()


# ---------------------------------------------------------------------------
# the model: prefill / decode / forward
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_jax(weights, jax_prefill):
    jparams, params, tokens = weights
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(tokens[:, :S]))
    logits, cache = tm.prefill(params, torch.from_numpy(tokens[:, :S]), CFG)
    np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)
    for k in ("conv_x", "conv_bc", "ssm"):
        assert getattr(cache, k).shape == getattr(jcache, k).shape
        np.testing.assert_allclose(f32(getattr(cache, k)), f32(getattr(jcache, k)),
                                   rtol=TOL, atol=TOL)
    assert cache.ssm.dtype == torch.float32 and cache.pos == int(jcache.pos) == S

    # carry the JAX cache over and decode two tokens on each side
    cache = convert.cache_from_numpy(
        pos=int(jcache.pos), device="cpu",
        **{k: f32(getattr(jcache, k)) for k in ("conv_x", "conv_bc", "ssm")})
    tensors = (cache.conv_x, cache.conv_bc, cache.ssm)
    jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, JCFG))
    for t in (S, S + 1):
        jlogits, jcache = jdecode(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache)
        logits, cache = tm.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                       cache, CFG)
        assert logits.shape == (B, 1, CFG.vocab)
        np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)
    assert all(a is b for a, b in zip(tensors, (cache.conv_x, cache.conv_bc, cache.ssm)))
    assert cache.pos == int(jcache.pos) == S + 2
    np.testing.assert_allclose(f32(cache.ssm), f32(jcache.ssm), rtol=TOL, atol=TOL)


def test_forward_matches_jax_and_prefill(weights):
    """The reference's SSM forward (embed → ``_ssm_stack`` of mamba2_block →
    lm_logits) evaluated op by op with eager JAX, which the port matches to a
    last bit here and there; jitted, XLA's fused rounding puts single logits
    near zero a bf16 step (0.031) away."""
    jparams, params, tokens = weights
    tok = tokens[:, :S]
    full = tm.forward(params, torch.from_numpy(tok), CFG)
    x = jmodel.embed_tokens(jparams, jnp.asarray(tok), JCFG)
    for i in range(JCFG.n_layers):
        y, _ = jssm.mamba2_block(layer(jparams["layers"], i), x, JCFG.ssm)
        x = x + y
    want = jmodel.lm_logits(jparams, x, JCFG)
    assert full.shape == (B, S, CFG.vocab)
    np.testing.assert_allclose(f32(full), f32(want), rtol=TOL, atol=TOL)
    logits, _ = tm.prefill(params, torch.from_numpy(tok), CFG)
    assert torch.equal(logits, full[:, -1])


def test_prefill_then_decode_matches_forward(weights):
    """Prefill one chunk, decode the next 32 tokens one by one: the logits
    follow the full forward's."""
    _, params, tokens = weights
    tok = torch.from_numpy(tokens[:, :S])
    full = tm.forward(params, tok, CFG)
    logits, cache = tm.prefill(params, tok[:, :32], CFG)
    np.testing.assert_allclose(f32(logits), f32(full[:, 31]), rtol=TOL, atol=TOL)
    for t in range(32, S):
        logits, cache = tm.decode_step(params, tok[:, t:t + 1], cache, CFG)
    np.testing.assert_allclose(f32(logits[:, 0]), f32(full[:, -1]), rtol=TOL, atol=TOL)
    assert cache.pos == S


def test_prompt_off_the_chunk_grid_raises_as_in_the_reference(weights, jax_prefill):
    """chunk = min(spec.chunk, S) and S % chunk == 0: 40 tokens at chunk 32
    fail in the reference (an assert while tracing) and in the port (a
    ValueError that states the rule)."""
    jparams, params, tokens = weights
    assert CFG.ssm.chunk == 32
    with pytest.raises(AssertionError, match="chunk-aligned"):
        jax_prefill(jparams, jnp.asarray(tokens[:, :40]))
    with pytest.raises(ValueError, match="chunk-aligned: length 40 is no multiple of chunk 32"):
        tm.prefill(params, torch.from_numpy(tokens[:, :40]), CFG)
    tm.prefill(params, torch.from_numpy(tokens[:, :31]), CFG)      # S < chunk: chunk = S


def test_one_token_prompt_takes_the_decode_branch(weights, jax_prefill):
    jparams, params, tokens = weights
    tok = tokens[:, :1]
    logits, cache = tm.prefill(params, torch.from_numpy(tok), CFG)
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(tok))
    np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)
    assert cache.conv_x.shape == jcache.conv_x.shape
    assert cache.conv_x.shape[2] == CFG.ssm.d_conv - 1 and cache.pos == 1
    step, _ = tm.decode_step(params, torch.from_numpy(tok),
                             tm.init_cache(CFG, B, 1, device="cpu"), CFG)
    assert torch.equal(step[:, 0], logits)


def test_two_token_prompt_keeps_two_conv_rows(weights, jax_prefill):
    """The reference keeps ``xr[:, -(d_conv-1):]``: two rows after a 2-token
    prompt, not d_conv - 1 (ROADMAP Queue 3)."""
    jparams, params, tokens = weights
    logits, cache = tm.prefill(params, torch.from_numpy(tokens[:, :2]), CFG)
    jlogits, jcache = jax_prefill(jparams, jnp.asarray(tokens[:, :2]))
    assert cache.conv_x.shape == jcache.conv_x.shape
    assert cache.conv_x.shape[2] == cache.conv_bc.shape[2] == 2
    np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)


def test_decode_step_rows_leave_other_slots_untouched(weights):
    _, params, tokens = weights
    rng = np.random.default_rng(7)
    cache = tm.init_cache(CFG, B, 8, device="cpu")
    for t in (cache.conv_x, cache.conv_bc, cache.ssm):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    before = [t.clone() for t in (cache.conv_x, cache.conv_bc, cache.ssm)]
    tok = torch.from_numpy(tokens[:, :1])
    full = tm.Cache(conv_x=before[0].clone(), conv_bc=before[1].clone(),
                    ssm=before[2].clone(), pos=5)
    want, full = tm.decode_step(params, tok, full, CFG)
    got, new = tm.decode_step(params, tok, cache._replace(pos=5), CFG, rows=[1])
    assert new.pos == 6
    for t, old, upd in zip((cache.conv_x, cache.conv_bc, cache.ssm), before,
                           (full.conv_x, full.conv_bc, full.ssm)):
        assert torch.equal(t[:, 0], old[:, 0])          # slot 0 untouched
        assert torch.equal(t[:, 1], upd[:, 1])          # slot 1 as a full step
        assert not torch.equal(t[:, 1], old[:, 1])
    assert torch.equal(got[1], want[1])

