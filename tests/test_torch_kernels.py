"""The port's attention functions against the JAX package's, on the CPU.

The same numpy inputs (made from a seed) go through the port's plain
versions (which its wrappers take for CPU tensors), the JAX oracles, and
the Pallas kernels in interpret mode.  Tolerances: 2e-5 (fp32) and 2e-2
(bf16), rtol = atol, the JAX package's own for these kernels; the CUDA
kernels themselves are held to the plain versions on the card by
``chip_smoke.py``."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention_ref as jax_attention_ref
from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels import decode_attention_ref as jax_decode_attention_ref
from repro.kernels import flash_attention as jax_flash_attention
from repro.models.layers import gqa_attention as jax_gqa_attention
# the port
from repro_torch.configs import get_arch
from repro_torch.configs import reduce_for_smoke
from repro_torch.core import orchestrator as port_orch
from repro_torch.core.orchestrator import CacheOrchestrator
from repro_torch.core.orchestrator import FLASH_TILE_ROWS
from repro_torch.core.orchestrator import hopper_pin_budget_bytes
from repro_torch.kernels import attention_ref
from repro_torch.kernels import decode_attention
from repro_torch.kernels import decode_attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels import kernels_built
from repro_torch.kernels import launch_counts
from repro_torch.kernels import reset_launch_counts
from repro_torch.kernels.build import CSRC
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import init_params
from repro_torch.models import layers as port_layers
from repro_torch.serve import Request
from repro_torch.serve import ServeEngine

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def both(rng, shape, dtype):
    """One numpy draw as a JAX array and as a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FLASH_CASES = [
    # (B, Sq, Sk, H, G, D, causal, softcap, pinned, dtype)
    (1, 256, 256, 4, 4, 128, True, None, 0, "float32"),
    (2, 256, 256, 8, 2, 128, True, None, 0, "bfloat16"),
    (1, 128, 512, 4, 1, 128, False, None, 0, "float32"),
    (1, 256, 256, 4, 2, 128, True, 50.0, 0, "float32"),
    (2, 256, 256, 4, 2, 64, True, None, 128, "float32"),      # pinned prefix
    (1, 384, 384, 2, 2, 128, True, None, 256, "bfloat16"),    # mostly pinned
    (1, 128, 128, 4, 4, 128, True, None, 128, "bfloat16"),    # fully pinned
    (1, 256, 256, 4, 4, 112, True, None, 128, "float32"),     # zamba2-7b's head size
    (1, 256, 256, 4, 4, 112, True, None, 256, "bfloat16"),
]


@pytest.mark.parametrize("b,sq,sk,h,g,d,causal,softcap,pinned,dtype", FLASH_CASES)
def test_flash_attention_matches_jax(b, sq, sk, h, g, d, causal, softcap, pinned, dtype):
    rng = np.random.default_rng(0)
    jq, tq = both(rng, (b, sq, h, d), dtype)
    jk, tk = both(rng, (b, sk, g, d), dtype)
    jv, tv = both(rng, (b, sk, g, d), dtype)
    port = f32(flash_attention(tq, tk, tv, causal=causal, softcap=softcap,
                               pinned_rows=pinned))
    assert np.array_equal(port, f32(attention_ref(tq, tk, tv, causal=causal,
                                                  softcap=softcap)))
    tol = TOL[dtype]
    oracle = f32(jax_attention_ref(jq, jk, jv, causal=causal, softcap=softcap))
    np.testing.assert_allclose(port, oracle, rtol=tol, atol=tol)
    pallas = f32(jax_flash_attention(jq, jk, jv, causal=causal, softcap=softcap,
                                     pinned_rows=pinned, interpret=True))
    np.testing.assert_allclose(port, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,h,g,d", [(17, 6, 2, 64), (100, 4, 4, 128), (23, 24, 8, 128),
                                     (23, 4, 4, 112)])
def test_flash_attention_ragged_lengths_match_jax_gqa(s, h, g, d):
    """Prompt lengths that are no multiple of any tile (the serving launcher
    draws 4 to 23 tokens): the port takes them, the Pallas wrapper would not,
    so the oracle is the JAX model path's own gqa_attention."""
    rng = np.random.default_rng(1)
    jq, tq = both(rng, (2, s, h, d), "float32")
    jk, tk = both(rng, (2, s, g, d), "float32")
    jv, tv = both(rng, (2, s, g, d), "float32")
    port = f32(flash_attention(tq, tk, tv, causal=True, pinned_rows=s))
    np.testing.assert_allclose(port, f32(jax_gqa_attention(jq, jk, jv, causal=True)),
                               rtol=2e-5, atol=2e-5)


FLASH_256_CASES = [
    # (S, H, G, pinned, dtype) at gemma-7b's head size, causal: pinned 0, one
    # 64-row tile, and the whole prompt where the kernel holds it (fp32: at
    # most 8 rows)
    (128, 4, 4, 0, "float32"),
    (128, 4, 4, 0, "bfloat16"),
    (128, 4, 4, 64, "bfloat16"),
    (64, 4, 4, 64, "bfloat16"),
    (8, 4, 4, 8, "float32"),
    (128, 8, 2, 64, "bfloat16"),
]


@pytest.mark.parametrize("s,h,g,pinned,dtype", FLASH_256_CASES)
def test_flash_attention_at_head_dim_256_matches_jax(s, h, g, pinned, dtype):
    """The wrapper at head_dim 256 against the JAX oracle and the Pallas
    kernel in interpret mode, at the same pinned prefix (Pallas blocks of
    min(S, 64) rows, so that a 64-row pin is block-aligned there too)."""
    rng = np.random.default_rng(8)
    jq, tq = both(rng, (1, s, h, 256), dtype)
    jk, tk = both(rng, (1, s, g, 256), dtype)
    jv, tv = both(rng, (1, s, g, 256), dtype)
    port = f32(flash_attention(tq, tk, tv, causal=True, pinned_rows=pinned))
    assert np.array_equal(port, f32(attention_ref(tq, tk, tv, causal=True)))
    tol = TOL[dtype]
    np.testing.assert_allclose(port, f32(jax_attention_ref(jq, jk, jv, causal=True)),
                               rtol=tol, atol=tol)
    block = min(s, 64)
    pallas = f32(jax_flash_attention(jq, jk, jv, causal=True, pinned_rows=pinned,
                                     block_q=block, block_k=block, interpret=True))
    np.testing.assert_allclose(port, pallas, rtol=tol, atol=tol)


def test_pinned_rows_at_head_dim_256_are_validated_on_every_device():
    """At head_dim 256 a bf16 block holds one 64-row tile of K and V beside
    the ring and Q's buffer, an fp32 block 8 rows beside its tiles: a larger
    prefix is refused before any launch."""
    q = torch.zeros(1, 300, 4, 256, dtype=torch.bfloat16)
    for good in (0, 64):
        assert flash_attention(q, q, q, pinned_rows=good).shape == q.shape
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention(q, q, q, pinned_rows=128)
    short = q[:, :65]                      # two tiles, once rounded up
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention(short, short, short, pinned_rows=65)
    q32 = torch.zeros(1, 300, 4, 256)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention(q32, q32, q32, pinned_rows=64)
    assert flash_attention(q32[:, :8], q32[:, :8], q32[:, :8], pinned_rows=8).shape[1] == 8


DECODE_CASES = [
    # (B, S, H, G, D, dtype)
    (1, 512, 4, 4, 128, "float32"),
    (2, 1024, 8, 2, 128, "bfloat16"),
    (2, 512, 4, 1, 64, "float32"),
    (1, 2048, 16, 4, 128, "bfloat16"),
    (2, 512, 4, 4, 112, "float32"),         # zamba2-7b's head size (MHA)
    (2, 512, 4, 4, 112, "bfloat16"),
    (2, 512, 4, 4, 256, "float32"),         # gemma-7b's head size (MHA)
    (2, 512, 4, 4, 256, "bfloat16"),
    (2, 512, 8, 2, 256, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,g,d,dtype", DECODE_CASES)
def test_decode_attention_matches_jax(b, s, h, g, d, dtype):
    rng = np.random.default_rng(3)
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    port = f32(decode_attention(tq, tk, tv, torch.from_numpy(lens)))
    assert np.array_equal(port, f32(decode_attention_ref(tq, tk, tv,
                                                         torch.from_numpy(lens))))
    tol = TOL[dtype]
    oracle = f32(jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
    np.testing.assert_allclose(port, oracle, rtol=tol, atol=tol)
    pallas = f32(jax_decode_attention(jq, jk, jv, jnp.asarray(lens), block_k=256,
                                      interpret=True))
    np.testing.assert_allclose(port, pallas, rtol=tol, atol=tol)


def test_decode_attention_dead_rows_never_counted():
    """Rows at or past cache_len must not affect the result, whatever they
    hold; and the result agrees with the Pallas kernel on the same poison."""
    rng = np.random.default_rng(4)
    jq, tq = both(rng, (1, 4, 64), "float32")
    jk, tk = both(rng, (1, 512, 2, 64), "float32")
    jv, tv = both(rng, (1, 512, 2, 64), "float32")
    lens = torch.tensor([300], dtype=torch.int32)
    out1 = decode_attention(tq, tk, tv, lens)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 300:] = 1e4
    tv2[:, 300:] = -1e4
    out2 = decode_attention(tq, tk2, tv2, lens)
    np.testing.assert_allclose(f32(out1), f32(out2), rtol=1e-6, atol=1e-6)
    tv2[:, 300:] = float("nan")
    assert torch.isfinite(decode_attention(tq, tk2, tv2, lens)).all()
    pallas = jax_decode_attention(jq, jk.at[:, 300:].set(1e4), jv.at[:, 300:].set(-1e4),
                                  jnp.asarray([300], jnp.int32), interpret=True,
                                  block_k=256)
    np.testing.assert_allclose(f32(out2), f32(pallas), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,lens", [(333, [333, 1, 200]), (7, [7, 3, 0])])
def test_decode_attention_ragged_cache_matches_jax_gqa(s, lens):
    _decode_ragged_matches_jax_gqa(s, lens, 64)


@pytest.mark.parametrize("s,lens", [(333, [333, 1, 200]), (7, [7, 3, 0])])
def test_decode_attention_ragged_cache_at_head_dim_112_matches_jax_gqa(s, lens):
    _decode_ragged_matches_jax_gqa(s, lens, 112)


@pytest.mark.parametrize("s,lens", [(333, [333, 1, 200]), (7, [7, 3, 0])])
def test_decode_attention_ragged_cache_at_head_dim_256_matches_jax_gqa(s, lens):
    _decode_ragged_matches_jax_gqa(s, lens, 256)


def _decode_ragged_matches_jax_gqa(s, lens, d):
    """Any cache capacity S >= 1, and cache_len 0 gives zeros (the kernel's
    ``acc / max(l, 1e-30)`` with nothing accumulated)."""
    rng = np.random.default_rng(5)
    jq, tq = both(rng, (3, 6, d), "float32")
    jk, tk = both(rng, (3, s, 2, d), "float32")
    jv, tv = both(rng, (3, s, 2, d), "float32")
    port = f32(decode_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32)))
    qpos = jnp.asarray(lens)[:, None] - 1
    oracle = f32(jax_gqa_attention(jq[:, None], jk, jv, causal=True,
                                   q_positions=qpos))[:, 0]
    for i, n in enumerate(lens):
        if n == 0:
            assert not port[i].any()
        else:
            np.testing.assert_allclose(port[i], oracle[i], rtol=2e-5, atol=2e-5)


def test_pinned_rows_is_validated_on_every_device():
    q = torch.zeros(1, 300, 4, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 300, 2, 128, dtype=torch.bfloat16)
    for bad in (-1, 100, 301, 320):
        with pytest.raises(ValueError):
            flash_attention(q, k, k, pinned_rows=bad)
    for good in (0, 64, 256, 300):
        assert flash_attention(q, k, k, pinned_rows=good).shape == q.shape
    big = torch.zeros(1, 1024, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention(torch.zeros(1, 1024, 4, 128, dtype=torch.bfloat16), big, big,
                        pinned_rows=1024)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q[:, :100], k, k, causal=True)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(torch.zeros(1, 300, 3, 128), torch.zeros(1, 300, 2, 128),
                        torch.zeros(1, 300, 2, 128))


def test_orchestrated_split_is_consistent():
    """The port's counterpart of the JAX package's orchestrated-kernel test:
    splits shrink with the budget, and every split equals the oracle."""
    seq, d, g = 512, 128, 2
    pins = []
    for budget in (64 * 1024, hopper_pin_budget_bytes(d, 2), 4 * 2**20):
        orch = CacheOrchestrator(vmem_budget_bytes=budget)
        pinned, streamed = orch.plan_kv_split(seq, FLASH_TILE_ROWS, 2 * d * 2)
        assert pinned + streamed == seq and pinned % FLASH_TILE_ROWS == 0
        pins.append(pinned)
    assert pins[0] <= pins[1] <= pins[2] == seq
    rng = np.random.default_rng(6)
    jq, tq = both(rng, (1, seq, 4, d), "bfloat16")
    jk, tk = both(rng, (1, seq, g, d), "bfloat16")
    jv, tv = both(rng, (1, seq, g, d), "bfloat16")
    oracle = f32(jax_attention_ref(jq, jk, jv, causal=True))
    for pinned in sorted(set(pins[:2])):
        out = f32(flash_attention(tq, tk, tv, causal=True, pinned_rows=pinned))
        np.testing.assert_allclose(out, oracle, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("head_dim", [64, 112, 128, 256])
def test_planned_splits_fit_the_kernels_shared_memory(head_dim, itemsize):
    """Whatever the prompt length, the pinned prefix the engine's planner
    grants (budget ``hopper_pin_budget_bytes``, rows of
    ``flash_kv_row_bytes``) fits the 227 KB a block may take, so the launch
    never returns -2.  At head_dim 112 in bf16 this needs the padded pitch:
    rows counted at their 224 data bytes would grant a whole prefix of
    321-326 rows, which needs more.  At head_dim 256 the budget holds a
    whole prompt of up to 58 rows in bf16 and no 64-row tile of a longer one
    (Q's own buffer takes 32 KB), and up to 7 rows in fp32."""
    orch = CacheOrchestrator(vmem_budget_bytes=hopper_pin_budget_bytes(head_dim, itemsize))
    row = port_orch.flash_kv_row_bytes(head_dim, itemsize)
    for seq in range(1, 2049):
        pinned, streamed = orch.plan_kv_split(seq, FLASH_TILE_ROWS, row)
        assert pinned + streamed == seq
        assert pinned == seq or pinned % FLASH_TILE_ROWS == 0
        assert (port_orch.flash_smem_bytes(pinned, head_dim, itemsize)
                <= port_orch.H100_SMEM_PER_BLOCK), (seq, pinned)
        flash_ops.check_pinned_rows(pinned, seq, head_dim, itemsize)
    if head_dim == 112 and itemsize == 2:
        unpadded, _ = orch.plan_kv_split(321, FLASH_TILE_ROWS, 2 * head_dim * itemsize)
        assert unpadded == 321
        assert port_orch.flash_smem_bytes(321, 112, 2) > port_orch.H100_SMEM_PER_BLOCK
    if head_dim == 256:
        whole = {2: 58, 4: 7}[itemsize]
        assert orch.plan_kv_split(whole, FLASH_TILE_ROWS, row) == (whole, 0)
        assert orch.plan_kv_split(whole + 1, FLASH_TILE_ROWS, row) == (0, whole + 1)
        assert orch.plan_kv_split(2048, FLASH_TILE_ROWS, row) == (0, 2048)


def test_cpu_calls_launch_no_kernel():
    reset_launch_counts()
    q = torch.zeros(1, 8, 2, 64)
    flash_attention(q, q, q)
    decode_attention(q[:, 0], q, q, torch.tensor([3], dtype=torch.int32))
    assert launch_counts() == {"decode_attention": 0, "flash_attention": 0,
                               "flash_attention_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert not kernels_built()


def _flash_source_constants():
    text = (CSRC / "flash_attention.cu").read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


@pytest.mark.parametrize("head_dim", [64, 112, 128, 256])
def test_flash_layout_constants_match_the_source(head_dim):
    """The planner's budget describes the kernel's shared memory: the KV tile,
    the ring of streamed bf16 tiles (rows of 2 * D bytes rounded up to 128:
    no pad at 64, 128 and 256, 224 bytes staged at 256 at 112), Q's own
    buffer above Q_REG_DIM (four warps' 16 rows at head_dim 256), and a bf16
    block's warps."""
    c = _flash_source_constants()
    assert c["BK"] == c["BQ"] == FLASH_TILE_ROWS
    assert c["STAGES"] == port_orch.FLASH_STAGES
    assert c["MAX_WARPS"] == flash_ops.MAX_WARPS
    assert c["MAX_WARPS_Q_SMEM"] == flash_ops.MAX_WARPS_Q_SMEM
    assert c["Q_REG_DIM"] == port_orch.FLASH_Q_REG_DIM
    assert 16 * c["MAX_WARPS_Q_SMEM"] == port_orch.FLASH_Q_BUFFER_ROWS
    assert c["SMEM_LIMIT"] == port_orch.H100_SMEM_PER_BLOCK
    # the row layout's helpers live in the header the forward includes
    text = (CSRC / "flash_attention.cu").read_text() + (CSRC / "bf16_tiles.cuh").read_text()
    align = port_orch.FLASH_ROW_ALIGN
    assert f"return (2 * D + {align - 1}) / {align} * {align};" in text
    assert "constexpr int ROWB = row_bytes<D>();" in text
    assert ("(2ll * pin_alloc + STAGES * 2ll * BK) * row_bytes<D>() + q_buffer_bytes<D>()"
            in text)
    assert "return D > Q_REG_DIM ? MAX_WARPS_Q_SMEM * 16 * row_bytes<D>() : 0;" in text
    row = {64: 128, 112: 256, 128: 256, 256: 512}[head_dim]   # bf16 bytes a staged row
    q_buffer = 16 * c["MAX_WARPS_Q_SMEM"] * row if head_dim > c["Q_REG_DIM"] else 0
    assert port_orch.flash_smem_row_words(head_dim, 2) * 4 == row
    assert port_orch.flash_kv_row_bytes(head_dim, 2) == 2 * row
    assert (port_orch.flash_smem_work_bytes(head_dim, 2)
            == c["STAGES"] * 2 * c["BK"] * row + q_buffer)
    for pinned in (0, 17, 64, 300):
        whole_tiles = -(-pinned // c["BK"]) * c["BK"]
        assert (port_orch.flash_smem_bytes(pinned, head_dim, 2)
                == 2 * whole_tiles * row + c["STAGES"] * 2 * c["BK"] * row + q_buffer)
    # fp32 keeps one pad word a row and the probability tile
    words = head_dim + 1
    assert port_orch.flash_smem_bytes(64, head_dim, 4) == (
        4 * (2 * 64 * words + 3 * c["BQ"] * words) + 4 * c["BQ"] * (c["BK"] + 1))


@pytest.mark.parametrize("group,rows", [(1, 64), (2, 64), (3, 32), (4, 32), (5, 16),
                                        (8, 16), (12, 16)])
def test_q_tile_rows_fill_a_block_with_whole_heads(group, rows):
    """A bf16 block holds every head of a pass, one warp per 16 query rows of
    each, within MAX_WARPS; fp32 keeps its 64-row tile."""
    assert flash_ops.q_tile_rows(group, 2, 128) == rows
    passes = -(-group // flash_ops.MAX_WARPS)
    assert -(-group // passes) * rows // 16 <= flash_ops.MAX_WARPS
    assert flash_ops.q_tile_rows(group, 4, 128) == FLASH_TILE_ROWS


@pytest.mark.parametrize("group,rows", [(1, 64), (2, 32), (3, 16), (4, 16), (8, 16),
                                        (16, 16)])
def test_q_tile_rows_at_head_dim_256_fill_a_block_of_four_warps(group, rows):
    """At head_dim 256 a bf16 block has four warps at most (Q's buffer holds
    their 64 rows), so heads go in passes of four; fp32 keeps its 64-row
    tile.  gemma-7b (MHA, 16 heads): 64-row tiles, two a chunk at 1024
    tokens, 128 blocks, as deepseek-moe-16b at head_dim 128."""
    assert flash_ops.max_warps(256) == flash_ops.MAX_WARPS_Q_SMEM == 4
    assert flash_ops.max_warps(128) == flash_ops.MAX_WARPS
    assert flash_ops.q_tile_rows(group, 2, 256) == rows
    passes = -(-group // 4)
    assert -(-group // passes) * rows // 16 <= 4
    assert flash_ops.q_tile_rows(group, 4, 256) == FLASH_TILE_ROWS
    if group == 1:
        assert flash_ops.tiles_per_chunk_for(1, 16, 1024, 132, rows) == 2
        assert 16 * -(-1024 // (2 * rows)) == 128


def test_serving_shape_chunks_pair_the_causal_tiles():
    """llama3.2-3b (8 KV heads, group 3) on 132 SMs: 1024 tokens give 16 chunks
    of two 32-row tiles a KV head (a heavy one with a light one), 256 tokens
    64 blocks of one tile."""
    rows = flash_ops.q_tile_rows(3, 2, 128)
    assert flash_ops.tiles_per_chunk_for(1, 8, 1024, 132, rows) == 2
    assert flash_ops.tiles_per_chunk_for(1, 8, 256, 132, rows) == 1
    assert 8 * -(-256 // rows) == 64


def test_bf16_rows_must_sit_on_16_bytes():
    """The bf16 kernel copies 16 bytes a lane: views whose rows are not on 16
    bytes are refused before any launch; fp32 needs 4-byte words only."""
    base = torch.zeros(1, 10, 2, 136, dtype=torch.bfloat16)
    flash_ops.check_rows_aligned("k", base[..., :128])          # strides 2720, 136
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.check_rows_aligned("k", base[..., 4:132])     # pointer off by 8 bytes
    odd = torch.zeros(1, 10, 2, 132, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.check_rows_aligned("k", odd[..., :128])       # head stride 132
    with pytest.raises(ValueError, match="stride 1"):
        flash_ops.check_rows_aligned("q", torch.zeros(1, 4, 2, 64,
                                                      dtype=torch.bfloat16).transpose(2, 3))
    flash_ops.check_rows_aligned("q", torch.zeros(1, 10, 2, 132)[..., 1:129])  # fp32
    # on the CPU the wrapper still returns the plain version for such a view
    q = odd[:, :, :, :128]
    out = flash_attention(q, q, q, causal=True)
    assert torch.equal(out, attention_ref(q, q, q, causal=True))


def test_main_path_tensors_meet_the_alignment_rule(monkeypatch):
    """Every q, k and v that the serving path hands the flash kernel (fresh
    projections, slices of the slot pool) passes the bf16 rule."""
    cfg = reduce_for_smoke(get_arch("llama3.2-3b"))
    params = init_params(cfg, seed=0, device="cpu")
    seen = []
    real = port_layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_layers, "flash_attention", spy)
    engine = ServeEngine(cfg, params, max_batch=2, max_seq=48, device="cpu")
    for uid, n in enumerate((13, 30)):
        engine.add_request(Request(uid=uid, prompt=np.arange(2, 2 + n, dtype=np.int32),
                                   max_new_tokens=1))
    engine.run_to_completion(max_steps=10)
    assert len(seen) == 2 * cfg.n_layers
    for q, k, v in seen:
        assert q.dtype == k.dtype == v.dtype == torch.bfloat16
        assert k.stride(1) == cfg.n_kv_heads * cfg.head_dim     # a slice of the pool
        for name, t in (("q", q), ("k", k), ("v", v)):
            flash_ops.check_rows_aligned(name, t)


# --- the decode kernel's work partition and merge (csrc/decode_attention.cu) ---

def _decode_source_constants():
    text = (CSRC / "decode_attention.cu").read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_decode_wrapper_constants_match_the_source():
    c = _decode_source_constants()
    assert c["THREADS"] // c["LANES_PER_ROW"] * c["ROWS_PER_GROUP"] == decode_ops.STEP_ROWS
    assert c["MAX_HPB"] == decode_ops.MAX_HPB
    assert c["MAX_HPB_WIDE"] == decode_ops.MAX_HPB_WIDE
    assert c["BLOCKS_PER_SM"] == decode_ops.BLOCKS_PER_SM
    assert c["MAX_UNITS"] == decode_ops.MAX_UNITS
    assert c["MIN_ROWS"] == decode_ops.MIN_ROWS == decode_ops.decode_plan(
        1, 2048, 8, 2, 128).min_rows
    assert c["ITEMS_PER_SM"] == decode_ops.ITEMS_PER_SM <= decode_ops.BLOCKS_PER_SM
    assert decode_ops.MIN_ROWS % decode_ops.STEP_ROWS == 0 and c["MERGE_LOADS"] >= 1


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", decode_ops.HEAD_DIMS)
def test_decode_lanes_own_every_chunk_of_a_row_once(d, itemsize):
    """The 8 lanes of a lane group share a row's 16-byte chunks as the
    kernel's ``Ring`` deals them (NCH chunks at most, the last one for TAIL
    lanes only): every chunk has one owner, at head_dim 112 too, where 8
    lanes do not divide the row's 14 (bf16) or 28 (fp32) chunks."""
    c = _decode_source_constants()
    assert c["LANES_PER_ROW"] == decode_ops.LANES_PER_ROW
    text = (CSRC / "decode_attention.cu").read_text()
    assert "if (D == 112) return launch_hpb<T, 112>" in text
    chunks = decode_ops.lane_chunks(d, itemsize)
    row = d * itemsize // 16
    assert sorted(ch for lane in chunks for ch in lane) == list(range(row))
    nch = -(-row // 8)
    tail = row - (nch - 1) * 8
    assert [len(lane) for lane in chunks] == [nch] * tail + [nch - 1] * (8 - tail)
    if d == 112:
        assert tail == (6 if itemsize == 2 else 4)


def test_decode_plan_at_zamba2s_shapes():
    """zamba2-7b's pool (8 slots x 2048 rows, 32 heads, MHA, head_dim 112):
    one query head a block, scratch for head_dim 112."""
    plan = decode_ops.decode_plan(8, 2048, 32, 32, 112)
    assert plan.hpb == 1 and plan.head_blocks == 32
    assert plan.scratch_floats == 8 * 32 * plan.units * (112 + 2)
    lens = [97, 1056, 540, 801, 333, 1000, 650, 128]
    items = plan.items(lens)
    assert len(items) <= plan.target
    for b, n in enumerate(lens):
        rows = plan.rows_for(lens)
        seen = [r for u in range(plan.live_units(n, rows))
                for r in plan.unit_rows(u, n, rows)]
        assert seen == list(range(n))


def test_decode_plan_at_gemma7bs_shapes():
    """gemma-7b's pool (8 slots x 2048 rows, 16 heads, MHA, head_dim 256):
    one query head a block, as at any group above head_dim 128 (csrc's
    max_hpb), scratch for head_dim 256, and the R that deepseek-moe-16b's
    pool of the same heads gets at head_dim 128."""
    text = (CSRC / "decode_attention.cu").read_text()
    assert "if (D == 256) return launch_hpb<T, 256>" in text
    assert "return D > 128 ? MAX_HPB_WIDE : MAX_HPB;" in text
    for group in range(1, 9):
        assert decode_ops.heads_per_block(group, 256) == 1
        assert decode_ops.heads_per_block(group, 128) == decode_ops.decode_plan(
            1, 512, 2 * group, 2, 128).hpb
    assert decode_ops.decode_plan(1, 512, 8, 2, 256).hpb == 1
    plan = decode_ops.decode_plan(8, 2048, 16, 16, 256)
    assert plan.hpb == 1 and plan.head_blocks == 16
    assert plan.scratch_floats == 8 * 16 * plan.units * (256 + 2)
    lens = [97, 1056, 540, 801, 333, 1000, 650, 128]
    rows = plan.rows_for(lens)
    assert rows == decode_ops.decode_plan(8, 2048, 16, 16, 128).rows_for(lens) == 544
    assert len(plan.items(lens)) <= plan.target
    for n in lens:
        seen = [r for u in range(plan.live_units(n, rows)) for r in plan.unit_rows(u, n, rows)]
        assert seen == list(range(n))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", decode_ops.HEAD_DIMS)
def test_decode_ring_holds_two_steps_at_every_head_size(d, itemsize):
    """The kernel's ``Ring``: a step is 32 rows of each lane's chunks of K and
    V; the ring is RING_BYTES (64 KB) and holds 2 to MAX_STAGES steps, but
    for fp32 at head_dim 256, where one step is 64 KB and the ring grows to
    two (128 KB); the merge's weights fit every ring."""
    c = _decode_source_constants()
    text = (CSRC / "decode_attention.cu").read_text()
    assert "constexpr int RING_BYTES = 64 * 1024;" in text
    assert "2 * STEP_BYTES > RING_BYTES ? 2 * STEP_BYTES : RING_BYTES;" in text
    nch = -(-(d * itemsize // 16) // c["LANES_PER_ROW"])
    step = c["ROWS_PER_GROUP"] * 2 * nch * c["THREADS"] * 16
    ring = max(64 * 1024, 2 * step)
    stages = min(ring // step, c["MAX_STAGES"])
    assert stages >= 2 and stages * step >= 2 * c["MAX_HPB"] * c["MAX_UNITS"] * 4
    assert (ring == 128 * 1024 and stages == 2) if (d, itemsize) == (256, 4) else (
        ring == 64 * 1024)


R = 128   # a unit length the edge cases straddle


@pytest.mark.parametrize("group", range(1, 9))
@pytest.mark.parametrize("s", [1, R - 1, R, R + 1, 2048])
def test_decode_partition_covers_every_live_row_once(s, group):
    """Every row below cache_len lies in exactly one work item, a row of the
    batch with cache_len 0 has one item (its zeros), the grid, scratch and
    counters follow from the shapes alone, and the rows chosen per call give
    every block one item at most, whether R is chosen or fixed at R."""
    b, g, d = 3, 2, 128
    h = g * group
    lengths = sorted({0, 1, R - 1, R, R + 1, s - 1, s, s + 5} - {-1})
    for sms in (132, 2):
        for fixed in (None, R):
            plan = decode_ops.decode_plan(b, s, h, g, d, fixed, sm_count=sms)
            step = decode_ops.STEP_ROWS
            assert plan.min_rows == (fixed or decode_ops.MIN_ROWS)
            assert plan.units == -(-s // plan.min_rows)
            assert group % plan.hpb == 0 and 1 <= plan.hpb <= decode_ops.MAX_HPB
            assert plan.hpb == min(group, 4) or group % min(group, 4)
            assert plan.head_blocks == g * group // plan.hpb
            assert plan.blocks == min(b * plan.head_blocks * plan.units,
                                      decode_ops.ITEMS_PER_SM * sms)
            assert plan.scratch_floats == b * h * plan.units * (d + 2)
            assert plan.counters == b * plan.head_blocks
            assert plan.target == decode_ops.ITEMS_PER_SM * sms
            for batch in (lengths[:b], lengths[-b:], [0] * b):
                rows = plan.rows_for(batch)
                assert rows % step == 0 and rows >= plan.min_rows
                assert fixed is None or rows == fixed
                items = plan.items(batch)
                assert len(items) <= b * plan.head_blocks * plan.units
                if fixed is None and plan.target > b * plan.head_blocks:
                    assert len(items) <= plan.target              # the SMs evenly loaded
                for bi, length in enumerate(batch):
                    for hb in range(plan.head_blocks):
                        units = [u for b2, hb2, u in items if (b2, hb2) == (bi, hb)]
                        assert units == list(range(max(plan.live_units(length, rows), 1)))
                        seen = [r for u in units for r in plan.unit_rows(u, length, rows)]
                        assert seen == list(range(min(length, s)))
                        assert all(len(plan.unit_rows(u, length, rows)) <= rows
                                   for u in units)
                        assert plan.merges(length, rows) == (len(units) > 1)


def test_decode_rows_per_split_must_be_whole_steps():
    for bad in (0, -32, decode_ops.STEP_ROWS + 1, 100):
        with pytest.raises(ValueError, match="rows_per_split"):
            decode_ops.decode_plan(1, 256, 8, 2, 128, bad)
    assert decode_ops.decode_plan(1, 256, 8, 2, 128, 32).units == 8
    assert decode_ops.decode_plan(1, 256, 8, 2, 128, 512).units == 1
    with pytest.raises(ValueError, match="units"):
        decode_ops.decode_plan(1, 32 * decode_ops.MAX_UNITS + 1, 8, 2, 128, 32)
    # R chosen per call: its least value grows with S to keep the units bounded
    big = decode_ops.decode_plan(1, 128 * decode_ops.MAX_UNITS + 1, 8, 2, 128)
    assert big.min_rows == 160 and big.units <= decode_ops.MAX_UNITS


def emulate_decode(q, k, v, cache_len, rows_per_split=None, sm_count=132, window=None,
                   softcap=None):
    """The kernel's arithmetic in torch: per work item (a unit of live rows), 16
    lane groups scoring 2 rows a step (rows start + 32 t + 16 r + lane group;
    each of a group's 8 lanes sums over the chunks of the row it owns)
    in log2 units with one max and one rescale a step; lane groups merged into
    warps (4 each), warps into the unit; a unit alone writes ``out``, several
    write partials that the last of them merges with the weights
    2^(m_i - M) / max(sum_i l_i 2^(m_i - M), 1e-30).  With a softcap, q is
    scaled by scale / softcap and a lane group's sum s becomes
    tanh(s) * softcap * log2(e)."""
    b, h, d = q.shape
    _, s, g, _ = k.shape
    plan = decode_ops.decode_plan(b, s, h, g, d, rows_per_split, sm_count, window)
    step, lanes, hpb = decode_ops.STEP_ROWS, 16, plan.hpb
    vec = 16 // q.element_size()
    lane_cols = [torch.tensor([ch * vec + e for ch in owned for e in range(vec)],
                              dtype=torch.long)
                 for owned in decode_ops.lane_chunks(d, q.element_size()) if owned]
    neg = torch.tensor(-1e30)
    log2e = 1.4426950408889634
    qf = q.float() * (1.0 / d ** 0.5) * (1.0 / softcap if softcap else log2e)
    out = torch.zeros((b, h, d), dtype=torch.float32)
    lens = [int(n) for n in cache_len]
    rows_per_unit = plan.rows_for(lens)

    def combine(m, den, acc, dim):
        mx = m.amax(dim=dim, keepdim=True)
        w = torch.exp2(m - mx)
        return mx.squeeze(dim), (den * w).sum(dim), (acc * w[..., None]).sum(dim)

    partials = {}
    for bi, hb, u in plan.items(lens):
        kv = hb // ((h // g) // hpb)
        heads = slice(hb * hpb, (hb + 1) * hpb)
        if lens[bi] == 0:
            continue                                              # zeros
        rows = plan.unit_rows(u, lens[bi], rows_per_unit)
        m = torch.full((lanes, hpb), -1e30)
        den = torch.zeros((lanes, hpb))
        acc = torch.zeros((lanes, hpb, d))
        for t in range(-(-len(rows) // step)):
            idx = (rows.start + t * step + 16 * torch.arange(2)[:, None]
                   + torch.arange(lanes)[None, :])                # (2, lanes)
            valid = idx < rows.stop
            kk = k[bi, idx.clamp(max=s - 1), kv].float() * valid[..., None]
            vv = v[bi, idx.clamp(max=s - 1), kv].float() * valid[..., None]
            # each lane's dot product over the chunks it owns, then the 8 lanes'
            dots = sum(torch.einsum("rjd,hd->rjh", kk[..., cols], qf[bi, heads][..., cols])
                       for cols in lane_cols)
            if softcap:
                dots = torch.tanh(dots) * (softcap * log2e)
            sc = torch.where(valid[..., None], dots, neg)
            m_new = torch.maximum(m, sc.amax(0))
            alpha = torch.exp2(m - m_new)
            p = torch.where(valid[..., None], torch.exp2(sc - m_new), torch.tensor(0.0))
            den = den * alpha + p.sum(0)
            acc = acc * alpha[..., None] + torch.einsum("rjh,rjd->jhd", p, vv)
            m = m_new
        m, den, acc = combine(m.view(4, 4, hpb), den.view(4, 4, hpb),
                              acc.view(4, 4, hpb, d), 1)          # lane groups -> warps
        partials.setdefault((bi, heads.start), []).append(combine(m, den, acc, 0))
    for (bi, h0), parts in partials.items():
        m, den, acc = (torch.stack(x) for x in zip(*parts))     # (units, hpb, ...)
        if len(parts) == 1:                                      # the unit writes out
            out[bi, h0:h0 + hpb] = acc[0] / den[0].clamp_min(1e-30)[..., None]
            continue
        w = torch.exp2(m - m.amax(0))                            # the last unit merges
        w = w / (den * w).sum(0).clamp_min(1e-30)
        out[bi, h0:h0 + hpb] = (acc * w[..., None]).sum(0)
    return out.to(q.dtype)


@pytest.mark.parametrize("lens,rows,dtype", [
    ([97, 300, 0, 255, 129], None, "float32"),
    ([0, 0, 300, 0, 0], None, "bfloat16"),               # one position group live
    ([R - 1, R, R + 1, 300, 1], None, "float32"),
    ([0, 0, 0, 0, 33], 32, "float32"),
    ([300, 64, 0, 200, 31], 64, "bfloat16"),
    ([300, 299, 1, 0, 160], 96, "float32"),
])
def test_decode_partial_merge_matches_plain_and_jax(lens, rows, dtype):
    """The kernel's partition and merge, emulated on the CPU, against the
    port's plain version and the JAX package's oracle (rtol = atol = 2e-5 in
    fp32, 2e-2 in bf16)."""
    rng = np.random.default_rng(12)
    b, s, h, g, d = 5, 300, 12, 4, 64
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = f32(emulate_decode(tq, tk, tv, cl, rows))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, f32(decode_attention_ref(tq, tk, tv, cl)),
                               rtol=tol, atol=tol)
    oracle = f32(jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens, jnp.int32)))
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], oracle[live], rtol=tol, atol=tol)
    assert not got[~live].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_merge_at_head_dim_112_matches_plain_and_jax(dtype):
    """The emulated partition, lane ownership and merge at zamba2-7b's head
    size (MHA: one head a block), ragged lengths with one of 0."""
    rng = np.random.default_rng(14)
    b, s, h, g, d = 4, 300, 4, 4, 112
    lens = [300, 0, 129, 33]
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    tol = TOL[dtype]
    for rows in (None, 32):
        got = f32(emulate_decode(tq, tk, tv, cl, rows))
        np.testing.assert_allclose(got, f32(decode_attention_ref(tq, tk, tv, cl)),
                                   rtol=tol, atol=tol)
        oracle = f32(jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens, jnp.int32)))
        live = np.asarray(lens) > 0
        np.testing.assert_allclose(got[live], oracle[live], rtol=tol, atol=tol)
        assert not got[~live].any()


@pytest.mark.parametrize("h,g", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_partial_merge_at_head_dim_256_matches_plain_and_jax(h, g, dtype):
    """The emulated partition, lane ownership (4 chunks a lane in bf16, 8 in
    fp32) and merge at gemma-7b's head size: one head a block, MHA and
    GQA, ragged lengths with one of 0, R chosen and fixed."""
    rng = np.random.default_rng(15)
    b, s, d = 4, 300, 256
    lens = [300, 0, 129, 33]
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    tol = TOL[dtype]
    oracle = f32(jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens, jnp.int32)))
    live = np.asarray(lens) > 0
    for rows in (None, 32):
        got = f32(emulate_decode(tq, tk, tv, cl, rows))
        np.testing.assert_allclose(got, f32(decode_attention_ref(tq, tk, tv, cl)),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(got[live], oracle[live], rtol=tol, atol=tol)
        assert not got[~live].any()


@pytest.mark.parametrize("sm_count,lens", [
    (24, [300, 300, 300, 300, 300]),     # R 224: two units of 160 rows a sequence
    (8, [300, 12, 0, 299, 64]),          # no block to spare: one unit each
])
def test_decode_rows_chosen_per_call_match_plain_and_jax(sm_count, lens):
    """Units longer than one step, as a call with more rows than blocks gets
    them, emulated on the CPU against the plain version and the JAX oracle."""
    rng = np.random.default_rng(13)
    b, s, h, g, d = 5, 300, 12, 4, 64
    jq, tq = both(rng, (b, h, d), "float32")
    jk, tk = both(rng, (b, s, g, d), "float32")
    jv, tv = both(rng, (b, s, g, d), "float32")
    plan = decode_ops.decode_plan(b, s, h, g, d, sm_count=sm_count)
    assert plan.rows_for(lens) > decode_ops.STEP_ROWS
    cl = torch.tensor(lens, dtype=torch.int32)
    got = f32(emulate_decode(tq, tk, tv, cl, sm_count=sm_count))
    np.testing.assert_allclose(got, f32(decode_attention_ref(tq, tk, tv, cl)),
                               rtol=TOL["float32"], atol=TOL["float32"])
    oracle = f32(jax_decode_attention_ref(jq, jk, jv, jnp.asarray(lens, jnp.int32)))
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], oracle[live], rtol=TOL["float32"],
                               atol=TOL["float32"])



# --- gemma2: a sliding window in both kernels, a softcap in the decode kernel ---

W = 64   # the window of reduce_for_smoke(gemma2-27b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [W - 3, 2 * W + 3])
@pytest.mark.parametrize("window", [1, W - 1, W, W + 1])
def test_flash_window_matches_jax_gqa(window, s, dtype):
    """The plain version (what the wrapper computes on the CPU) with a
    window, on both sides of it, against the JAX model path's gqa_attention
    with gemma2's softcap and scale."""
    _flash_window_matches_jax_gqa(window, s, dtype, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [W - 1, W + 1])
def test_flash_window_and_softcap_at_head_dim_256_match_jax_gqa(window, dtype):
    _flash_window_matches_jax_gqa(window, 2 * W + 3, dtype, 256)


def _flash_window_matches_jax_gqa(window, s, dtype, d):
    rng = np.random.default_rng(20)
    jq, tq = both(rng, (2, s, 4, d), dtype)
    jk, tk = both(rng, (2, s, 2, d), dtype)
    jv, tv = both(rng, (2, s, 2, d), dtype)
    kw = dict(causal=True, softcap=50.0, scale=144.0 ** -0.5)
    port = f32(flash_attention(tq, tk, tv, window=window, **kw))
    assert np.array_equal(port, f32(attention_ref(tq, tk, tv, window=window, **kw)))
    oracle = f32(jax_gqa_attention(jq, jk, jv, window=window, **kw))
    np.testing.assert_allclose(port, oracle, rtol=TOL[dtype], atol=TOL[dtype])
    wide = f32(flash_attention(tq, tk, tv, **kw))
    assert np.array_equal(port[:, :window], wide[:, :window])
    assert (s <= window) == np.array_equal(port, wide)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, 1, W - 1, W, W + 1])
def test_decode_window_and_softcap_match_jax_gqa(window, softcap, dtype):
    """One query at position n - 1 of each sequence against a cache of 2W + 3
    rows, lengths on both sides of the window and 0, against gqa_attention;
    poisoned rows below the window and at or past cache_len change nothing."""
    _decode_window_and_softcap_match_jax_gqa(window, softcap, dtype, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("window", [None, W + 1])
def test_decode_window_and_softcap_at_head_dim_256_match_jax_gqa(window, softcap, dtype):
    _decode_window_and_softcap_match_jax_gqa(window, softcap, dtype, 256)


def _decode_window_and_softcap_match_jax_gqa(window, softcap, dtype, d):
    rng = np.random.default_rng(21)
    s, lens = 2 * W + 3, [1, W - 1, W, W + 1, 2 * W + 3, 0]
    b = len(lens)
    jq, tq = both(rng, (b, 6, d), dtype)
    jk, tk = both(rng, (b, s, 2, d), dtype)
    jv, tv = both(rng, (b, s, 2, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    kw = dict(softcap=softcap, scale=144.0 ** -0.5)
    port = f32(decode_attention(tq, tk, tv, cl, window=window, **kw))
    oracle = f32(jax_gqa_attention(jq[:, None], jk, jv, causal=True, window=window,
                                   q_positions=jnp.asarray(lens)[:, None] - 1, **kw))[:, 0]
    for i, n in enumerate(lens):
        if n == 0:
            assert not port[i].any()
        else:
            np.testing.assert_allclose(port[i], oracle[i], rtol=TOL[dtype], atol=TOL[dtype])
    tk2, tv2 = tk.clone(), tv.clone()
    for i, n in enumerate(lens):
        lo = max(0, n - window) if window else 0
        tk2[i, :lo], tv2[i, :lo] = 1e4, float("nan")
        tk2[i, n:], tv2[i, n:] = -1e4, float("inf")
    np.testing.assert_array_equal(
        f32(decode_attention(tq, tk2, tv2, cl, window=window, **kw)), port)


@pytest.mark.parametrize("window", [None, 1, W - 1, W, W + 1, 4096])
@pytest.mark.parametrize("q_rows", [16, 32, 64])
def test_flash_kv_tiles_walk_exactly_the_visible_tiles(q_rows, window):
    """For every Q tile, the KV tiles the kernel walks (``kv_tiles``, the
    mirror of ``first_kv_tile`` and the causal end) are exactly those holding
    a key that some row of the tile may see: none wholly older than every
    row's window, none missing; and the source walks them so."""
    for sk in (1, 17, W, 5 * W + 7, 4160):
        for q_lo in range(0, sk, q_rows):
            rows = np.arange(q_lo, min(sk, q_lo + q_rows))[:, None]
            cols = np.arange(sk)[None, :]
            seen = (cols <= rows) & ((cols > rows - window) if window else True)
            need = sorted({c // FLASH_TILE_ROWS for c in np.nonzero(seen.any(0))[0]})
            assert list(flash_ops.kv_tiles(q_lo, q_rows, sk, window=window)) == need
    text = (CSRC / "flash_attention.cu").read_text()
    assert "return window > 0 ? max(0, q_lo - window + 1) / BK : 0;" in text
    assert text.count("first_kv_tile(q_lo, window)") == 2          # fp32 and bf16 loops


@pytest.mark.parametrize("window", [1, W - 1, W, W + 1, 4096])
def test_decode_partition_with_a_window_reads_only_live_rows(window):
    """``DecodePlan`` on windowed lengths, R chosen and fixed: every row of
    [max(0, n - window), n) is read by exactly one unit, no row below it or
    at n and beyond is requested, and R is chosen from the live rows only."""
    lens_sets = ([97, 1056, 540, 801, 4160, 5120, 650, 128],
                 [0, 0, 0, 0, 0, 5120, 0, 0], [window - 1, window, window + 1, 0])
    for fixed in (None, 128):
        for lens in lens_sets:
            lens = [max(0, n) for n in lens]
            plan = decode_ops.decode_plan(len(lens), 6144, 32, 16, 128, fixed, window=window)
            wide = decode_ops.decode_plan(len(lens), 6144, 32, 16, 128, fixed)
            rows = plan.rows_for(lens)
            live = [min(n, window) for n in lens]
            if fixed is None:
                assert rows == wide.rows_for(live)
                assert len(plan.items(lens)) <= plan.target
            for n in lens:
                assert plan.first_live(n) == max(0, n - window)
                seen = [r for u in range(plan.live_units(n, rows))
                        for r in plan.unit_rows(u, n, rows)]
                assert seen == list(range(max(0, n - window), n))
    text = (CSRC / "decode_attention.cu").read_text()
    assert "return window > 0 && len > window ? len - window : 0;" in text
    assert "const int start = lo + unit * R;" in text


@pytest.mark.parametrize("lens,rows,window,softcap,dtype", [
    ([97, 300, 0, 255, 129], None, 64, None, "float32"),
    ([97, 300, 0, 255, 129], 32, 100, 30.0, "float32"),
    ([0, 0, 300, 0, 0], None, 65, 50.0, "bfloat16"),
    ([R - 1, R, R + 1, 300, 1], 64, R, 20.0, "float32"),
    ([300, 299, 1, 0, 160], None, None, 10.0, "float32"),
])
def test_decode_partition_with_window_and_softcap_matches_plain_and_jax(
        lens, rows, window, softcap, dtype):
    """The kernel's windowed partition and softcapped scores, emulated on the
    CPU, against the plain version and the JAX model path's gqa_attention."""
    rng = np.random.default_rng(22)
    b, s, h, g, d = 5, 300, 12, 4, 64
    jq, tq = both(rng, (b, h, d), dtype)
    jk, tk = both(rng, (b, s, g, d), dtype)
    jv, tv = both(rng, (b, s, g, d), dtype)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = f32(emulate_decode(tq, tk, tv, cl, rows, window=window, softcap=softcap))
    tol = TOL[dtype]
    plain = decode_attention_ref(tq, tk, tv, cl, window=window, softcap=softcap)
    np.testing.assert_allclose(got, f32(plain), rtol=tol, atol=tol)
    oracle = f32(jax_gqa_attention(jq[:, None], jk, jv, causal=True, window=window,
                                   softcap=softcap,
                                   q_positions=jnp.asarray(lens)[:, None] - 1))[:, 0]
    live = np.asarray(lens) > 0
    np.testing.assert_allclose(got[live], oracle[live], rtol=tol, atol=tol)
    assert not got[~live].any()


def test_window_and_softcap_are_validated_on_every_device():
    q = torch.zeros(1, 80, 4, 64)
    k = torch.zeros(1, 80, 2, 64)
    for bad in (0, -1, 2.5, True, "64"):
        with pytest.raises(ValueError, match="window"):
            flash_attention(q, k, k, window=bad)
        with pytest.raises(ValueError, match="window"):
            decode_attention(q[:, 0], k, k, torch.tensor([5], dtype=torch.int32), window=bad)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, k, causal=False, window=8)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="softcap"):
            decode_attention(q[:, 0], k, k, torch.tensor([5], dtype=torch.int32), softcap=bad)
    assert flash_attention(q, k, k, window=8).shape == q.shape


@pytest.mark.parametrize("name,mod", [("dco_flash_attention", flash_ops),
                                      ("dco_decode_attention", decode_ops)])
def test_wrapper_argtypes_match_the_c_interface(name, mod):
    """The wrappers' ctypes signatures follow the sources' ``extern "C"``
    interfaces parameter for parameter (pointers, ints, floats), the window
    and the softcap included."""
    source = (CSRC / (name[4:] + ".cu")).read_text()
    params = [" ".join(p.split()) for p in re.search(
        r'extern "C" int ' + name + r"\(([^)]*)\)", source).group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
             else ctypes.c_int for p in params]
    assert kinds == mod.ARGTYPES
    assert "int window" in params and "float softcap" in params
