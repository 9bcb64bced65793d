"""The port's dense model against the JAX package's, from the same weights.

Weights are made by the JAX package's ``init_params``, widened to fp32 numpy
and carried over by ``repro_torch.convert``.  Logit tolerance 3e-2 (rtol =
atol): a bf16 model whose products accumulate in another order on each side;
it is the JAX package's own tolerance for prefill-vs-forward.

The JAX side runs under ``jax.disable_jit()``: op by op, as PyTorch runs.
XLA's fused ``lax.scan`` body rounds bf16 at other places than the same JAX
functions evaluated op by op, and on these inputs the two evaluations of the
JAX package differ from each other by up to 0.047 in a logit, beyond the
tolerance; the port follows the op-by-op one."""

from dataclasses import replace
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduce_for_smoke as jax_reduce
# the port
from repro_torch import convert
from repro_torch import models as tm
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.models import model as tmodel

TOL = 3e-2
B, S = 2, 12


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(autouse=True)
def jax_op_by_op():
    with jax.disable_jit():
        yield


@pytest.fixture(scope="module", params=["llama3.2-3b", "gemma-7b", "mistral-nemo-12b",
                                        "qwen2-vl-7b"])
def arch(request):
    jcfg = jax_reduce(jax_get_arch(request.param))
    cfg = reduce_for_smoke(get_arch(request.param))
    jparams = jm.init_params(jcfg, jax.random.key(0))
    params = convert.params_from_numpy(to_numpy(jparams), "cpu")
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, size=(B, S))
    return jcfg, cfg, jparams, params, tokens


def test_convert_keeps_keys_shapes_dtypes(arch):
    jcfg, cfg, jparams, params, _ = arch
    jl, tdef = jax.tree.flatten(jparams)
    tl, tdef2 = jax.tree.flatten(params)
    assert tdef == tdef2
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
    back = convert.params_to_numpy(params)
    again = convert.params_from_numpy(back, "cpu")
    for a, b in zip(tl, jax.tree.leaves(again)):
        assert torch.equal(a, b)
    own = tm.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.structure(own) == tdef
    for a, b in zip(tl, jax.tree.leaves(own)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_forward_matches_jax(arch):
    jcfg, cfg, jparams, params, tokens = arch
    want = jm.forward(jparams, jnp.asarray(tokens), jcfg, remat=False)
    got = tm.forward(params, torch.from_numpy(tokens), cfg)
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)


def test_prefill_and_decode_match_jax(arch):
    jcfg, cfg, jparams, params, tokens = arch
    jlogits, jcache = jm.prefill(jparams, jnp.asarray(tokens[:, :-2]), jcfg)
    logits, cache = tm.prefill(params, torch.from_numpy(tokens[:, :-2]), cfg,
                               pinned_rows=S - 2)
    np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f32(cache.k), f32(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f32(cache.v), f32(jcache.v), rtol=TOL, atol=TOL)
    assert cache.pos == int(jcache.pos) == S - 2

    # carry the JAX cache over, grown to S, and decode two tokens on each side
    pad = [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)]
    jcache = jcache._replace(k=jnp.pad(jcache.k, pad), v=jnp.pad(jcache.v, pad))
    cache = convert.cache_from_numpy(np.asarray(jcache.k, np.float32),
                                     np.asarray(jcache.v, np.float32),
                                     int(jcache.pos), "cpu")
    k_before = cache.k
    for t in (S - 2, S - 1):
        jlogits, jcache = jm.decode_step(jparams, jnp.asarray(tokens[:, t:t + 1]),
                                         jcache, jcfg)
        logits, cache = tm.decode_step(params, torch.from_numpy(tokens[:, t:t + 1]),
                                       cache, cfg)
        assert logits.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(f32(logits), f32(jlogits), rtol=TOL, atol=TOL)
    assert cache.k is k_before                       # the cache is updated in place
    assert cache.pos == int(jcache.pos) == S
    np.testing.assert_allclose(f32(cache.k), f32(jcache.k), rtol=TOL, atol=TOL)


def test_prefill_then_decode_matches_forward(arch):
    """Decode with a prefilled cache reproduces full-forward logits."""
    _, cfg, _, params, tokens = arch
    tok = torch.from_numpy(tokens)
    full = tm.forward(params, tok, cfg)
    logits_p, cache = tm.prefill(params, tok[:, :-1], cfg)
    pad = torch.zeros_like(cache.k[:, :, :1])
    cache = cache._replace(k=torch.cat([cache.k, pad], 2), v=torch.cat([cache.v, pad], 2))
    logits_d, cache2 = tm.decode_step(params, tok[:, -1:], cache, cfg)
    np.testing.assert_allclose(f32(logits_p), f32(full[:, -2]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(f32(logits_d[:, 0]), f32(full[:, -1]), rtol=TOL, atol=TOL)
    assert cache2.pos == S


def test_decode_step_rows_leave_other_slots_untouched(arch):
    """Two slots at different positions: a step for one of them must not
    write the other's K/V at that position (the cache is not copied)."""
    _, cfg, _, params, tokens = arch
    rng = np.random.default_rng(1)
    cache = tm.init_cache(cfg, B, S, device="cpu")
    cache.k.copy_(torch.from_numpy(rng.standard_normal(cache.k.shape).astype(np.float32)))
    cache.v.copy_(torch.from_numpy(rng.standard_normal(cache.v.shape).astype(np.float32)))
    k0, v0 = cache.k.clone(), cache.v.clone()
    tok = torch.from_numpy(tokens[:, :1])
    want, _ = tm.decode_step(params, tok, tm.Cache(k=k0.clone(), v=v0.clone(), pos=5), cfg)
    got, new = tm.decode_step(params, tok, cache._replace(pos=5), cfg, rows=[1])
    assert new.pos == 6
    assert torch.equal(cache.k[:, 0], k0[:, 0]) and torch.equal(cache.v[:, 0], v0[:, 0])
    assert not torch.equal(cache.k[:, 1, 5], k0[:, 1, 5])
    assert torch.equal(got[1], want[1])
    assert torch.isfinite(got).all()


def test_local_flags_match():
    for name in ("llama3.2-3b", "gemma2-27b"):
        want = [bool(x) for x in jm.local_flags(jax_get_arch(name))]
        assert list(tm.local_flags(get_arch(name))) == want


def test_unknown_family_is_refused():
    """Every family of the reference is ported; a config of any other family
    is refused, not run down another family's path."""
    cfg = replace(reduce_for_smoke(get_arch("llama3.2-3b")), family="unknown")
    with pytest.raises(NotImplementedError, match="unknown family"):
        tm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="unknown family"):
        tm.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("window", [None, 64, 8])
def test_windowed_config_matches_jax_on_its_local_layer(window):
    """reduce_for_smoke(gemma2-27b): layer 0 is local, layer 1 global.  With
    80 tokens a window of 64 (the reduced config's) or 8 binds on layer 0,
    and the port's logits follow the reference's; they differ from those of
    the same weights without a window."""
    jcfg = replace(jax_reduce(jax_get_arch("gemma2-27b")), window=window)
    cfg = replace(reduce_for_smoke(get_arch("gemma2-27b")), window=window)
    assert tm.local_flags(cfg) == ((True, False) if window else (False, False))
    jparams = jm.init_params(jcfg, jax.random.key(3))
    params = convert.params_from_numpy(to_numpy(jparams), "cpu")
    tokens = np.random.default_rng(3).integers(2, cfg.vocab, size=(1, 80))
    want = jm.forward(jparams, jnp.asarray(tokens), jcfg, remat=False)
    got = tm.forward(params, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL, atol=TOL)
    wide = tm.forward(params, torch.from_numpy(tokens), replace(cfg, window=None))
    tail = np.abs(f32(wide) - f32(got))[:, 64:]
    assert (tail.max() > 0.1) == (window is not None)
    assert np.array_equal(f32(wide)[:, :8], f32(got)[:, :8])


# the published sizes the chip run serves these configurations at
# (chip_smoke.PATHS), as (n_layers, d_model, n_heads, n_kv_heads, head_dim,
# d_ff, vocab) and the fields each adds
PUBLISHED = {
    "qwen2-vl-7b": ((28, 3584, 28, 4, 128, 18944, 152064), dict(mrope_sections=(16, 24, 24))),
    "mistral-nemo-12b": ((40, 5120, 32, 8, 128, 14336, 131072), {}),
    "musicgen-large": ((48, 2048, 32, 32, 64, 8192, 2048), dict(act="gelu")),
}


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py``, whose ``check_published`` the serve phases call."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_sizes(smoke, name):
    """The port's config of each dense configuration the chip run serves is
    its published one, and the chip run checks the same tuple."""
    cfg = get_arch(name)
    sizes, more = PUBLISHED[name]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab) == sizes
    assert {k: getattr(cfg, k) for k in more} == more
    assert cfg.family == "dense" and cfg.moe is None and cfg.window is None
    smoke.check_published(name, cfg)
    with pytest.raises(AssertionError, match="published size"):
        smoke.check_published(name, replace(cfg, n_layers=2))


@pytest.fixture(scope="module")
def qwen2vl():
    jcfg = jax_reduce(jax_get_arch("qwen2-vl-7b"))
    cfg = reduce_for_smoke(get_arch("qwen2-vl-7b"))
    jparams = jm.init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, jparams, convert.params_from_numpy(to_numpy(jparams), "cpu")


POSITIONS = {"three_plane": (3, B, S), "one_plane": (B, S)}


@pytest.mark.parametrize("planes", sorted(POSITIONS))
@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_explicit_positions_are_refused_with_the_reason(qwen2vl, entry, planes):
    """qwen2-vl-7b's M-RoPE positions, 3-plane or (B, S), are refused by
    ``forward`` and ``prefill`` before any layer runs, with why: the kernels
    mask by row index, and the JAX package cannot run 3-plane positions."""
    _, cfg, _, params = qwen2vl
    pos = torch.arange(S).expand(POSITIONS[planes])
    tokens = torch.zeros((B, S), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="mask by row index") as err:
        getattr(tm, entry)(params, tokens, cfg, positions=pos)
    assert str(err.value) == tmodel.POSITIONS_REFUSED


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_the_reference_fails_on_three_plane_positions(qwen2vl, entry):
    """The reason the refusal gives: the JAX package's ``forward`` and
    ``prefill`` raise on 3-plane positions (its attention takes them as
    (B, S) query positions), so no reference holds what the port would do."""
    jcfg, _, jparams, _ = qwen2vl
    pos = jnp.broadcast_to(jnp.arange(S), (3, B, S))
    with pytest.raises(ValueError):
        getattr(jm, entry)(jparams, jnp.zeros((B, S), jnp.int32), jcfg, positions=pos)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduce_for_smoke(get_arch("llama3.2-3b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.make_generator(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({"a": np.zeros(2, np.float32)})
