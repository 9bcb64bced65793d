"""The sequence-sharded K/V layout (``kvseq``) at the level of one attention
call: the decode kernel's plain version over a slice of the cache's rows
(``decode_attention_lse_ref``, what ``decode_attention_lse`` computes on the
CPU), each slice's output and log-sum-exp, and their merge
(``comm.merge_parts``) against the JAX package on the whole cache.

The same inputs, drawn with numpy from a seed, go to both packages; the
cache is cut at random slice boundaries, and a slice may hold no live row
(one that starts beyond a length, or ends below a window), as on a rank.  Without a
window or softcap the reference is the JAX package's ``decode_attention_ref``;
with them, its ``gqa_attention`` with the query at position ``cache_len - 1``
(its decode mask).  A row of ``cache_len`` 0 has no reference (JAX gives
NaN there): the port gives zeros.  fp32, within 1e-5 of the output's scale;
each slice's log-sum-exp against a float64 numpy one within 1e-5 of its
magnitude.  The mesh cases (prefill and decode steps under ``kvseq`` against
the JAX package's ``decode_step``) are in the ``tests/test_torch_mesh_serve*``
files, in their shape's gloo worlds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.models.layers import gqa_attention as jax_gqa
# the port
from repro_torch.kernels import decode_attention_lse
from repro_torch.kernels import decode_attention_lse_ref
from repro_torch.kernels import decode_attention_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.sharding.comm import merge_parts


TOL = 1e-5

# (B, S, H, G, D, lengths, window, softcap)
CASES = [
    (3, 64, 4, 2, 64, [64, 17, 0], None, None),
    (2, 96, 8, 2, 128, [96, 40], None, None),
    (4, 48, 4, 4, 112, [48, 1, 33, 16], None, None),
    (2, 40, 2, 1, 256, [40, 9], None, None),
    # windows that slices of 8-16 rows straddle or miss
    (4, 64, 4, 2, 64, [64, 31, 8, 3], 8, None),
    (3, 64, 8, 4, 128, [64, 50, 20], 5, 50.0),
    (2, 48, 4, 4, 112, [48, 13], 16, None),
    (2, 64, 2, 2, 256, [64, 37], 7, 30.0),
    # softcap alone
    (2, 32, 4, 2, 64, [32, 5], None, 20.0),
    (2, 32, 2, 1, 256, [29, 32], None, 50.0),
]


def case_id(c):
    b, s, h, g, d, lens, window, cap = c
    return f"B{b}-S{s}-H{h}G{g}-D{d}-w{window}-cap{cap}"


def _inputs(case, seed):
    b, s, h, g, d, lens, _, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


def _cuts(s, rng):
    """Slice boundaries 0 = c0 < c1 < ... < s at random: slices of 1 to s
    rows, which a length or a window may leave without a live row."""
    inner = sorted(set(rng.integers(1, s, size=int(rng.integers(1, 5))).tolist()))
    bounds = [0] + inner + [s]
    return list(zip(bounds[:-1], bounds[1:]))


def _jax_whole(q, k, v, lens, window, cap):
    """The JAX package's attention of the whole cache (B, H, D), fp32."""
    if window is None and cap is None:
        return np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(lens)), np.float32)
    b, s = k.shape[:2]
    out = jax_gqa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v), window=window,
                  softcap=cap, q_positions=jnp.asarray(lens - 1)[:, None],
                  kv_positions=jnp.broadcast_to(jnp.arange(s), (b, s)))
    return np.asarray(out, np.float32)[:, 0]


def _lse64(q, k, lens, lo, hi, window, cap):
    """float64 log-sum-exp of each (row, head) over the slice [lo, hi)'s live
    rows; -inf where none is live."""
    b, h, d = q.shape
    g = k.shape[2]
    qg = q.astype(np.float64).reshape(b, g, h // g, d)
    sc = np.einsum("bgqd,btgd->bgqt", qg, k[:, lo:hi].astype(np.float64)) / np.sqrt(d)
    if cap is not None:
        sc = np.tanh(sc / cap) * cap
    t = np.arange(lo, hi)[None, None, None, :]
    n = lens.astype(np.int64)[:, None, None, None]
    live = t < n
    if window is not None:
        live &= t >= n - window
    sc = np.where(live, sc, -np.inf)
    m = sc.max(axis=-1, initial=-np.inf, keepdims=True)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        out = np.log(np.exp(sc - safe).sum(axis=-1)) + safe[..., 0]
    return out.reshape(b, h)


def _slices(q, k, v, lens, cuts, window, cap):
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    return [decode_attention_lse(tq, tk[:, lo:hi].contiguous(), tv[:, lo:hi].contiguous(),
                                 tl, row_offset=lo, window=window, softcap=cap)
            for lo, hi in cuts]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_merged_slices_match_the_jax_reference(case, seed):
    q, k, v, lens = _inputs(case, seed)
    window, cap = case[6], case[7]
    cuts = _cuts(k.shape[1], np.random.default_rng(100 + seed))
    parts = _slices(q, k, v, lens, cuts, window, cap)
    got = merge_parts(torch.stack([o for o, _ in parts]),
                      torch.stack([lse for _, lse in parts])).numpy()
    live = lens > 0
    want = _jax_whole(q, k, v, lens, window, cap)
    scale = float(np.abs(want[live]).max())
    err = float(np.abs(got[live] - want[live]).max())
    assert err <= TOL * scale, (cuts, err, scale)
    assert not np.isnan(got).any()
    assert (got[~live] == 0).all()
    # and the port's own whole-cache plain version, which the serving kernel follows
    whole = decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, lens)),
                                 window=window, softcap=cap).numpy()
    assert float(np.abs(got - whole).max()) <= TOL * scale


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_slice_lse_matches_float64(case):
    q, k, v, lens = _inputs(case, 7)
    window, cap = case[6], case[7]
    cuts = _cuts(k.shape[1], np.random.default_rng(7))
    for (lo, hi), (o, lse) in zip(cuts, _slices(q, k, v, lens, cuts, window, cap)):
        want = _lse64(q, k, lens, lo, hi, window, cap)
        got = lse.numpy().astype(np.float64)
        dead = np.isneginf(want)
        assert (np.isneginf(got) == dead).all(), (lo, hi)
        assert (o.numpy()[dead] == 0).all()
        if (~dead).any():
            err = np.abs(got[~dead] - want[~dead])
            assert (err <= TOL * np.maximum(1.0, np.abs(want[~dead]))).all(), (lo, hi, err.max())
    # the whole cache's LSE is the log-sum-exp of the slices'
    whole = _lse64(q, k, lens, 0, k.shape[1], window, cap)
    parts = np.stack([lse.numpy().astype(np.float64)
                      for _, lse in _slices(q, k, v, lens, cuts, window, cap)])
    with np.errstate(divide="ignore"):
        merged = np.logaddexp.reduce(parts, axis=0)
    live = np.isfinite(whole)
    assert np.allclose(merged[live], whole[live], rtol=TOL, atol=TOL)
    assert np.isneginf(merged[~live]).all()


def test_merge_of_empty_slices_is_zero_not_nan():
    o = torch.randn(3, 2, 4, 64)
    lse = torch.full((3, 2, 4), float("-inf"))
    lse[1, 0] = 0.5
    out = merge_parts(o, lse)
    assert not torch.isnan(out).any()
    assert torch.equal(out[1], torch.zeros(4, 64))
    assert torch.allclose(out[0], o[1, 0])


@pytest.mark.parametrize("window", [None, 8, 20])
def test_the_plan_reads_exactly_the_live_rows_of_a_slice(window):
    """The kernel's schedule (``DecodePlan`` with a row offset, as csrc's
    live_rows) covers exactly the rows of a slice that the plain version
    counts live, for every length and slice start; a slice wholly below the
    window or beyond the length has no unit that reads a row."""
    s, off = 48, 32
    plan = decode_ops.decode_plan(4, s, 4, 2, 64, window=window, row_offset=off)
    for n in range(0, off + s + 40):
        rows = plan.rows_for([n])
        seen = [r for u in range(plan.live_units(n, rows)) for r in plan.unit_rows(u, n, rows)]
        t = np.arange(s) + off
        live = (t < n) & ((t >= n - window) if window else True)
        assert seen == np.flatnonzero(live).tolist(), (n, seen)


def test_row_offset_is_checked():
    q, k = torch.zeros(1, 2, 64), torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        decode_attention_lse(q, k, k, torch.tensor([3]), row_offset=-1)
    o, lse = decode_attention_lse(q, k, k, torch.tensor([3]), row_offset=8)
    assert torch.isneginf(lse).all() and not o.any()


def test_the_plain_version_is_the_serving_one_on_a_whole_cache():
    q, k, v, lens = _inputs(CASES[5], 3)
    t = [torch.from_numpy(a) for a in (q, k, v, lens)]
    o, _ = decode_attention_lse_ref(*t, window=5, softcap=50.0)
    want = decode_attention_ref(*t, window=5, softcap=50.0)
    assert torch.allclose(o, want, rtol=0, atol=1e-6)
