"""FlashAttention-2 GQA and tiled-MatMul dataflows, expressed on the IR.

These re-express the original hand-written trace builders (paper §VI-C
group allocations, Fig. 2(a) matmul) as :class:`DataflowSpec` builders.
``tests/test_dataflow_ir.py`` pins them bit-identical — tensor layout,
step schedules, simulator counters, and analytical counts — to the frozen
pre-refactor implementations in ``tests/_reference_builders.py``; the
public ``repro_torch.core`` entry points (``build_fa2_trace`` etc.) are thin
wrappers over these specs.
"""

from __future__ import annotations

from typing import Dict
from typing import List
from typing import Tuple

from ..core.workloads import AttnWorkload
from ..core.workloads import TEMPORAL
from .ir import DataflowSpec
from .ir import SpecBuilder


def _kv_extent(wl: AttnWorkload, q_tile: int) -> int:
    if not wl.causal:
        return wl.n_kv_tiles
    return min(q_tile + 1, wl.n_kv_tiles)


def _decl_kv(b: SpecBuilder, wl: AttnWorkload, batch: int, head: int,
             n_acc: int, sharers: int) -> Tuple[str, str]:
    size = wl.seq_len * wl.head_dim * wl.dtype_bytes
    names = []
    for kind in ("K", "V"):
        names.append(b.tensor(
            f"{kind}.b{batch}.g{head}", size_bytes=size,
            tile_bytes=wl.kv_tile_bytes, n_acc=n_acc, operand_id=1,
            epoch=batch, sharers=sharers))
    return names[0], names[1]


def _decl_qo(b: SpecBuilder, wl: AttnWorkload, kind: str, batch: int,
             head: int, operand_id: int) -> str:
    size = wl.seq_len * wl.head_dim * wl.dtype_bytes
    return b.tensor(f"{kind}.b{batch}.h{head}", size_bytes=size,
                    tile_bytes=wl.q_tile_bytes, n_acc=1,
                    operand_id=operand_id, bypass=True, epoch=batch)


def fa2_spec(wl: AttnWorkload, n_cores: int = 16) -> DataflowSpec:
    """FlashAttention-2 GQA dataflow (temporal or spatial group
    allocation, §VI-C), optionally multi-batch (§VI-F)."""
    if wl.group_alloc == TEMPORAL:
        return _fa2_temporal_spec(wl, n_cores)
    return _fa2_spatial_spec(wl, n_cores)


def _fa2_temporal_spec(wl: AttnWorkload, n_cores: int) -> DataflowSpec:
    """Group dimension entirely in the time domain: each KV-head group is
    owned by one core; assigned groups interleave at Q-tile granularity so
    every live head's K/V stream stays concurrent (the long-reuse-distance
    thrashing regime); batches are strictly sequential (§VI-F)."""
    b = SpecBuilder(f"{wl.name}-temporal", n_cores, workload=wl)
    n_acc = wl.n_q_tiles
    per_core: List[List[Tuple[int, int]]] = [[] for _ in range(n_cores)]
    for bt in range(wl.n_batches):
        for g in range(wl.n_kv_heads):
            per_core[g % n_cores].append((bt, g))

    for c in range(n_cores):
        items = []
        for (bt, g) in per_core[c]:
            kv = _decl_kv(b, wl, bt, g, n_acc, sharers=1)
            q_names, o_names = [], []
            for m in range(wl.group_size):
                h = g * wl.group_size + m
                q_names.append(_decl_qo(b, wl, "Q", bt, h, operand_id=0))
                o_names.append(_decl_qo(b, wl, "O", bt, h, operand_id=2))
            items.append((bt, kv, q_names, o_names))

        half = wl.flops_per_inner_step() * wl.group_size / 2
        for bt in range(wl.n_batches):
            batch_items = [it for it in items if it[0] == bt]
            for i in range(wl.n_q_tiles):
                for (_, kv, q_names, o_names) in batch_items:
                    b.step(c, loads=[(q, i) for q in q_names])
                    for j in range(_kv_extent(wl, i)):
                        # FA2 inner iteration: K tile → QK^T, V tile → PV
                        b.step(c, loads=[(kv[0], j)], flops=half)
                        b.step(c, loads=[(kv[1], j)], flops=half)
                    b.step(c, stores=[(o, i) for o in o_names])
    return b.build()


def _fa2_spatial_spec(wl: AttnWorkload, n_cores: int) -> DataflowSpec:
    """Group dimension (partially) across cores: group members stream the
    same K/V in lockstep (same-round requests merge in the MSHRs) except
    the last rank, which lags one round so its reuses ride LLC *storage*
    — the population blind bypassing destroys (§IV-E)."""
    b = SpecBuilder(f"{wl.name}-spatial", n_cores, workload=wl)
    gs = wl.group_size
    sharers = min(gs, n_cores)
    # every group member reads each K/V tile once per Q tile; when the
    # group is wider than the machine the extra members run in later
    # waves on the same cores, so reads scale with gs, not sharers
    # (declaring n_acc from sharers understated it 'gs/n_cores'-fold and
    # retired tiles with readers remaining — caught by DCO101)
    n_acc = wl.n_q_tiles * gs
    n_waves = (wl.n_q_heads + n_cores - 1) // n_cores
    b.set_groups(
        [c // gs if gs <= n_cores else 0 for c in range(n_cores)],
        [(c % gs != gs - 1) if gs <= n_cores else (c != n_cores - 1)
         for c in range(n_cores)])

    kv_names: Dict[Tuple[int, int], Tuple[str, str]] = {}
    for bt in range(wl.n_batches):
        for g in range(wl.n_kv_heads):
            kv_names[(bt, g)] = _decl_kv(b, wl, bt, g, n_acc, sharers)
    qo_names: Dict[Tuple[int, int], Tuple[str, str]] = {}
    for bt in range(wl.n_batches):
        for h in range(wl.n_q_heads):
            qo_names[(bt, h)] = (_decl_qo(b, wl, "Q", bt, h, operand_id=0),
                                 _decl_qo(b, wl, "O", bt, h, operand_id=2))

    half = wl.flops_per_inner_step() / 2
    for bt in range(wl.n_batches):
        for i in range(wl.n_q_tiles):
            kv_hi = _kv_extent(wl, i)
            for w in range(n_waves):
                for c in range(n_cores):
                    h = w * n_cores + c
                    if h >= wl.n_q_heads:
                        b.pad(c, 2 * kv_hi + 2)   # idle wave slot, lockstep
                        continue
                    kv = kv_names[(bt, h // gs)]
                    q, o = qo_names[(bt, h)]
                    rank = (h % gs) if gs <= n_cores else c
                    last_rank = (gs - 1) if gs <= n_cores else (n_cores - 1)
                    lag = 1 if rank == last_rank else 0
                    b.step(c, loads=[(q, i)])
                    for jj in range(kv_hi):
                        j = (jj - lag) % kv_hi
                        b.step(c, loads=[(kv[0], j)], flops=half)
                        b.step(c, loads=[(kv[1], j)], flops=half)
                    b.step(c, stores=[(o, i)])
    return b.build()


# ---------------------------------------------------------------------------
def matmul_spec(m: int, n: int, k: int, tile: int = 128,
                n_cores: int = 16, dtype_bytes: int = 1) -> DataflowSpec:
    """C[M,N] = A[M,K] @ B[K,N] of Fig. 2(a), C-tiles round-robin over
    cores; nAcc registered at the dataflow level as the paper does."""
    if m % tile or n % tile or k % tile:
        raise ValueError("dims must be tile-aligned")
    mt, nt, kt = m // tile, n // tile, k // tile
    tile_bytes = tile * tile * dtype_bytes
    b = SpecBuilder(f"matmul-{m}x{n}x{k}", n_cores)
    A = b.tensor("A", size_bytes=mt * kt * tile_bytes,
                 tile_bytes=tile_bytes, n_acc=nt, operand_id=0)
    B = b.tensor("B", size_bytes=kt * nt * tile_bytes,
                 tile_bytes=tile_bytes, n_acc=mt, operand_id=1)
    C = b.tensor("C", size_bytes=mt * nt * tile_bytes,
                 tile_bytes=tile_bytes, n_acc=1, operand_id=2, bypass=True)
    emit_matmul_rounds(b, A, B, C, mt, kt, nt,
                       2.0 * tile * tile * tile)
    return b.build()


def emit_matmul_rounds(b: SpecBuilder, A: str, B_: str, C: str,
                       mt: int, kt: int, nt: int, flops: float) -> None:
    """Emit one tiled matmul's rounds (C-tiles round-robin over cores) —
    shared by ``matmul_spec`` and the multi-op scenario builders."""
    for idx, (i, j) in enumerate((i, j) for i in range(mt)
                                 for j in range(nt)):
        core = idx % b.n_cores
        for kk in range(kt):
            b.step(core, loads=[(A, i * kt + kk), (B_, kk * nt + j)],
                   flops=flops)
        b.step(core, stores=[(C, i * nt + j)])
