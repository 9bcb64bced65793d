"""The bf16 decode kernel rebuilt for Hopper (csrc/decode_attention.cu,
``decode_wgmma_kernel``), on the CPU: its arithmetic, emulated in plain torch
(``_torch_decode_wgmma.emulate_wgmma``: 64-row tiles from the first live row,
P in the value type before P V, the blocks' partials merged as the kernel
merges them), against the JAX package's ``decode_kernel`` in interpret mode
(64-row blocks) or, with a window or a softcap, its model path's
``gqa_attention``; its work map (``WgmmaPlan``) against the live rows; and
what the source must hold.  Tolerances: 2e-2 (bf16) and 2e-5 (fp32),
rtol = atol, the JAX package's own; on fp32 inputs the emulation is the same
map and merge with P unrounded.  The kernel itself is held to the plain
version on the card by ``chip_smoke.py``."""

import re

from _torch_decode_wgmma import emulate_wgmma
import jax.numpy as jnp
import numpy as np
import pytest
from repro_torch.kernels import decode_attention_lse_ref
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.sharding.comm import merge_parts
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.models.layers import gqa_attention as jax_gqa_attention

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SOURCE = CSRC / "decode_attention.cu"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def both(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _wgmma_kernel_text():
    text = SOURCE.read_text()
    start = text.index("decode_wgmma_kernel(const __grid_constant__")
    return text[start:text.index("struct MapSlot", start)]


# (group, D, S, lengths, rows_per_split, SMs): GQA groups 1, 2, 3, 4, 7 and 8,
# every head size, the kernel's cut (the SMs give one to eight blocks a head)
# and the caller's, a length of 0 and lengths at tile edges
EMULATION_CASES = [
    (1, 64, 320, [320, 0, 65, 64], None, 2),
    (2, 112, 256, [256, 1, 200], 64, 132),
    (3, 128, 192, [192, 63, 0], None, 3),
    (4, 256, 192, [129, 192, 64], 32, 2),
    (7, 128, 320, [300, 97, 0, 320], None, 12),
    (8, 64, 256, [255, 128, 17], 128, 132),
    (7, 112, 704, [704, 200], None, 132),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d,s,lens,rows,sms", EMULATION_CASES)
def test_emulated_kernel_matches_the_jax_decode_kernel(group, d, s, lens, rows, sms, dtype):
    """The kernel's tiles, P rounding and merge against the JAX package's
    Pallas decode kernel (interpret mode, 64-row blocks: its arithmetic is
    one unit's), at 2e-5 in fp32 and 2e-2 in bf16; cache_len 0 gives zeros."""
    rng = np.random.default_rng(group * 1000 + d)
    b, g = len(lens), 2
    h = g * group
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = f32(emulate_wgmma(tq, tk, tv, cl, rows_per_split=rows, sm_count=sms))
    pallas = f32(jax_decode_attention(jq, jk, jv, jnp.asarray(lens, jnp.int32), block_k=64,
                                      interpret=True))
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], pallas[live], rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[~live].any()


def test_emulation_cases_cover_one_block_and_merges():
    """The cases above hold sequences one block reads alone, and sequences
    whose blocks merge: two to eight of them, with the kernel's cut and with
    the caller's rows (several units a block)."""
    merged, alone, strided = set(), 0, 0
    for group, d, s, lens, rows, sms in EMULATION_CASES:
        plan = decode_ops.wgmma_plan(len(lens), s, 2 * group, 2, d, rows, sms)
        for n in lens:
            active = plan.active(n, lens)
            alone += active == 1
            if active > 1:
                merged.add(active)
            strided += plan.cut(n, lens)[2] > plan.units
    assert alone and strided and min(merged) == 2 and max(merged) >= 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,d,window,softcap", [
    (2, 128, 64, 50.0), (7, 64, 100, None), (4, 256, 65, 30.0), (1, 112, None, 30.0)])
def test_emulated_window_and_softcap_match_jax_gqa(group, d, window, softcap, dtype):
    """A sliding window (tiles from the window's first live row) and a
    softcap (tanh on the fp32 scores) against the JAX model path's
    gqa_attention for the query at position n - 1."""
    rng = np.random.default_rng(7 * group + d)
    s, lens = 260, [1, 63, 64, 65, 200, 260, 0]
    b, g = len(lens), 2
    h = g * group
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    kw = dict(softcap=softcap, scale=144.0 ** -0.5)
    got = f32(emulate_wgmma(tq, tk, tv, cl, window=window, sm_count=3, **kw))
    oracle = f32(jax_gqa_attention(jq[:, None], jk, jv, causal=True, window=window,
                                   q_positions=jnp.asarray(lens)[:, None] - 1, **kw))[:, 0]
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], oracle[live], rtol=TOL[dtype], atol=TOL[dtype])
    assert not got[~live].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,window", [(3, None), (7, 90), (8, None)])
def test_emulated_slices_merge_to_the_jax_result(group, window, dtype):
    """The slice kernel's rows (a row offset, the window from the whole
    length): each slice's output and log-sum-exp against the port's plain
    version, and the slices merged across ranks (``merge_parts``) against
    the JAX oracle of the whole cache."""
    rng = np.random.default_rng(31 + group)
    s, d, g, lens = 300, 64, 2, [300, 157, 0, 40]
    b, h = len(lens), 2 * group
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    cuts = [(0, 117), (117, 230), (230, 300), (300, 364)]
    parts = []
    for lo, hi in cuts:
        ks = tk[:, lo:hi] if hi <= s else torch.zeros((b, hi - lo, g, d), dtype=tk.dtype)
        vs = tv[:, lo:hi] if hi <= s else torch.zeros((b, hi - lo, g, d), dtype=tv.dtype)
        o, lse = emulate_wgmma(tq, ks, vs, cl, row_offset=lo, window=window, sm_count=2)
        ro, rl = decode_attention_lse_ref(tq, ks, vs, cl, row_offset=lo, window=window)
        dead = torch.isneginf(rl)
        assert torch.equal(torch.isneginf(lse), dead)
        np.testing.assert_allclose(f32(o), f32(ro), rtol=TOL[dtype], atol=TOL[dtype])
        np.testing.assert_allclose(f32(lse[~dead]), f32(rl[~dead]), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        parts.append((o, lse))
    whole = f32(merge_parts(torch.stack([o for o, _ in parts]),
                            torch.stack([lse for _, lse in parts])))
    oracle = f32(jax_gqa_attention(jq[:, None], jk, jv, causal=True, window=window,
                                   q_positions=jnp.asarray(lens)[:, None] - 1))[:, 0]
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(whole[live], oracle[live], rtol=TOL[dtype], atol=TOL[dtype])
    assert not whole[~live].any()


@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 2048])
def test_work_map_covers_every_live_row_once(s, group):
    """The blocks of a (batch row, KV head) read every live row exactly once
    and nothing below the window or at and past the length; every block
    below ``active`` holds rows and none above it; a (batch row, KV head)
    has at most the cluster's ``units`` blocks, 1 to 8, chosen from shapes
    alone; with the kernel's cut a block holds one unit, and the call's
    blocks with rows stay within ``target`` where the cut allows it."""
    b, g, d = 3, 2, 128
    h = g * group
    lengths = sorted({0, 1, 63, 64, 65, s - 1, s, s + 5} - {-1})
    for sms in (132, 4):
        for rows in (None, 32, 64, 128):
            for window in (None, 1, 64, 100):
                plan = decode_ops.wgmma_plan(b, s, h, g, d, rows, sms, window)
                room = decode_ops.estimated_room(d, sms)
                assert plan.units == decode_ops.units_for(b, g, s, room, window or 0)
                assert 1 <= plan.units <= decode_ops.MAX_UNITS_A_HEAD == 8
                assert plan.target == room(1)
                assert plan.rows == (0 if rows is None else -(-rows // 64) * 64)
                # no block lacks a tile for want of rows in the cache
                live_cap = min(s, window or s)
                assert plan.units == 1 or -(-live_cap // 64) >= 2 * (plan.units - 1)
                for batch in (lengths[:b], lengths[-b:], [0] * b):
                    busy = 0
                    for n in batch:
                        lo, end = plan.span(n)
                        assert (lo, end) == ((max(0, min(n, s) - window) if window else 0,
                                              min(n, s)) if n > 0 else (0, 0))
                        seen = [r for rank in range(plan.units)
                                for t in plan.block_tiles(rank, n, batch)
                                for r in plan.tile_rows(t, n)]
                        assert sorted(seen) == list(range(lo, end))
                        assert len(seen) == len(set(seen))
                        active = plan.active(n, batch)
                        busy += active * g
                        assert active <= plan.units
                        for rank in range(plan.units):
                            tiles = plan.block_tiles(rank, n, batch)
                            assert bool(tiles) == (rank < active)
                            # a box starts at the first live row plus whole tiles
                            assert all(plan.tile_rows(t, n).start == lo + 64 * t for t in tiles)
                        if rows is None:
                            _, per, units = plan.cut(n, batch)
                            assert units == active
                            assert units <= 1 or per >= plan.unit_tiles(batch) or \
                                units == plan.units
                    if rows is None and plan.target > 2 * b * g:
                        assert busy <= plan.target


def test_the_cut_follows_the_call():
    """The kernel's cut is chosen per call from all the lengths: one live
    sequence of 801 rows in llama3.2-3b's pool is read by 7 blocks a KV head
    (two tiles each), as among the ragged call's seven others; with every
    slot full by 5 of 7 tiles each, which keeps the call's blocks with rows
    within the target; gemma2-27b's one live sequence past its 4096-row
    window by 8 blocks a KV head of 8 tiles each."""
    llama = decode_ops.wgmma_plan(8, 2048, 24, 8, 128, cluster_room=lambda c: 396 // c)
    llama = llama._replace(units=8)
    one = [0, 0, 801, 0, 0, 0, 0, 0]
    assert llama.unit_tiles(one) == 2 and llama.active(801, one) == 7
    ragged = [97, 1056, 540, 801, 333, 1000, 650, 128]
    assert llama.active(801, ragged) == 7
    assert sum(llama.active(n, ragged) for n in ragged) * 8 <= llama.target
    full = [2048] * 8
    assert llama.unit_tiles(full) == 7 and llama.active(2048, full) == 5
    assert sum(llama.active(n, full) for n in full) * 8 <= llama.target
    gemma2 = decode_ops.wgmma_plan(8, 6144, 32, 16, 128, window=4096,
                                   cluster_room=lambda c: 396 // c)._replace(units=8)
    one = [0, 0, 0, 0, 0, 5120, 0, 0]
    assert gemma2.cut(5120, one) == (64, 8, 8)


def test_the_cut_at_qwen2vls_ragged_call():
    """qwen2-vl-7b's ragged call (B 8, G 4, group 7) gets 8 blocks a (batch
    row, KV head) on 132 SMs of three blocks each: its 1056-row sequence (17
    tiles) is read by 6 blocks of at most 3 tiles where the parent kernel
    read it in one unit."""
    plan = decode_ops.wgmma_plan(8, 2048, 28, 4, 128)
    assert plan.units == 8 and plan.group == 7
    lens = [97, 1056, 540, 801, 333, 1000, 650, 128]
    assert plan.cut(1056, lens) == (17, 3, 6) and plan.active(1056, lens) == 6
    assert max(len(plan.block_tiles(r, n, lens)) for n in lens for r in range(8)) == 3
    assert decode_ops.wgmma_plan(1, 100, 24, 8, 128).units == 1     # two tiles of rows at most


def test_a_group_past_the_packed_tile_is_refused():
    """A bf16 group of 65 query heads a KV head does not fit the 64 rows of
    the product tile: the plan, which the wrapper makes before any launch,
    raises ValueError; 64 fits."""
    with pytest.raises(ValueError, match="64 query heads"):
        decode_ops.wgmma_plan(1, 128, 65, 1, 128)
    with pytest.raises(ValueError, match="64 query heads"):
        decode_ops.wgmma_plan(2, 128, 130, 2, 64)
    assert decode_ops.wgmma_plan(1, 128, 128, 2, 128).group == 64


def test_wrapper_constants_match_the_source():
    consts = {name: int(val) for name, val in
              re.findall(r"constexpr int (W_\w+) = (\d+);", SOURCE.read_text())}
    assert consts["W_TILE"] == decode_ops.TILE_ROWS == 64
    assert consts["W_MAX_UNITS"] == decode_ops.MAX_UNITS_A_HEAD
    assert consts["W_MAX_GROUP"] == decode_ops.MAX_GROUP
    assert consts["W_MIN_UNIT_TILES"] == decode_ops.MIN_UNIT_TILES
    assert consts["W_PACKED"] == decode_ops.MAX_GROUP


def test_the_bf16_kernel_loads_by_tma_and_multiplies_on_wgmma():
    """The bf16 kernel's loads are TMA boxes (q's 3-d box, K and V 4-d
    boxes): no per-lane cp.async, and no 1-d bulk copy, whose start off 16
    bytes would be an illegal instruction; both products are wgmma, P V's A
    from registers; a consumer waits on a tile's barrier before its
    product reads it."""
    body = _wgmma_kernel_text()
    assert "cp_async" not in body and "cp.async.cg" not in body
    assert "tma_load_1d" not in body and "bulk_load" not in body
    assert body.count("tma_load_3d(") == 1 and body.count("tma_load(") == 2
    assert "wgmma_ss(" in body and "wgmma_rs(" in body
    k_wait = body.index("mbar_wait(k_full(st), lap & 1);")
    assert k_wait < body.index("wgmma_ss(s,")
    v_wait = body.index("mbar_wait(v_full(st), lap & 1);")
    assert v_wait < body.index("wgmma_rs(acc[cb]")
    assert body.index("q_full, 0);") < k_wait


def test_the_fp32_kernel_keeps_its_fma_body():
    """fp32 keeps the FMA kernel (2e-5 rules out TF32): its lane groups,
    cp.async ring and per-call R are still the fp32 path's."""
    text = SOURCE.read_text()
    assert "return launch_d<float>(D, hpb, q, k, v, cache_len, out, lse, scratch" in text
    assert "launch_d<__nv_bfloat16>" not in text
    assert "cp_async16(ring_base + 16 * ck, kp + col, ok);" in text
