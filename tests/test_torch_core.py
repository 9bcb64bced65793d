"""The port's own copies of the numpy-only modules (TMU, cache orchestrator,
slot scheduler, configs) give results identical to the JAX package's on
seeded random call sequences.  Tolerance: exact."""

import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core.orchestrator import CacheOrchestrator as RefOrchestrator
from repro.core.tmu import TMU as RefTMU
from repro.core.tmu import TensorMeta as RefTensorMeta
from repro.serve.scheduler import ServeTruncation as RefTruncation
from repro.serve.scheduler import SlotScheduler as RefScheduler
# the port
from repro_torch import configs as port_configs
from repro_torch.core import orchestrator as port_orch
from repro_torch.core.orchestrator import CacheOrchestrator
from repro_torch.core.tmu import TMU
from repro_torch.core.tmu import TensorMeta
from repro_torch.serve.scheduler import ServeTruncation
from repro_torch.serve.scheduler import SlotScheduler


@pytest.mark.parametrize("name", sorted(ref_configs._ALIASES))
def test_configs_match(name):
    ref, port = ref_configs.get_arch(name), port_configs.get_arch(name)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert (dataclasses.asdict(ref_configs.reduce_for_smoke(ref))
            == dataclasses.asdict(port_configs.reduce_for_smoke(port)))


def _metas(rng, cls, n):
    out = []
    for i in range(n):
        tile = int(rng.choice([512, 1024, 4096]))
        out.append(dict(tensor_id=i, base_addr=i << 24,
                        size_bytes=tile * int(rng.integers(1, 40)),
                        tile_bytes=tile, n_acc=int(rng.integers(1, 6))))
    return [cls(**m) for m in out]


@pytest.mark.parametrize("seed", range(4))
def test_tmu_matches_on_random_call_sequence(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefTMU(tensor_entries=6), TMU(tensor_entries=6)
    metas_r = _metas(np.random.default_rng(seed + 100), RefTensorMeta, 6)
    metas_p = _metas(np.random.default_rng(seed + 100), TensorMeta, 6)
    for mr, mp in zip(metas_r, metas_p):
        ref.register(mr)
        port.register(mp)
    for _ in range(3000):
        op = rng.random()
        m = metas_r[int(rng.integers(len(metas_r)))]
        if op < 0.9:
            tile = int(rng.integers(m.num_tiles))
            last_line = rng.random() < 0.7
            addr = m.base_addr + tile * m.tile_bytes + (m.tile_bytes - 64 if last_line else 0)
            core = int(rng.integers(4))
            assert ref.on_access(addr, core) == port.on_access(addr, core)
            assert ref.is_dead(addr) == port.is_dead(addr)
            assert ref.priority(addr) == port.priority(addr)
        elif op < 0.95:
            ref.clear(m.tensor_id)
            port.clear(m.tensor_id)
        assert ref.live_tiles == port.live_tiles
    assert ref.stats == port.stats


@pytest.mark.parametrize("seed", range(3))
def test_orchestrator_plan_matches(seed):
    rng = np.random.default_rng(seed)
    budget = int(rng.integers(1 << 16, 1 << 22))
    ref, port = RefOrchestrator(budget), CacheOrchestrator(budget)
    ref.register_many(_metas(np.random.default_rng(seed), RefTensorMeta, 7))
    port.register_many(_metas(np.random.default_rng(seed), TensorMeta, 7))
    a, b = ref.plan(), port.plan()
    assert a.pinned_bytes == b.pinned_bytes and a.pinned_fraction == b.pinned_fraction
    assert ({k: dataclasses.astuple(e) for k, e in a.entries.items()}
            == {k: dataclasses.astuple(e) for k, e in b.entries.items()})


@pytest.mark.parametrize("budget", [32 << 10, 116736, 165888, 1 << 20])
def test_plan_kv_split_matches(budget):
    ref, port = RefOrchestrator(budget), CacheOrchestrator(budget)
    for seq in (1, 17, 64, 283, 300, 1000, 1024, 2048, 8192):
        for tile in (64, 128):
            for row in (256, 512, 1024):
                assert ref.plan_kv_split(seq, tile, row) == port.plan_kv_split(seq, tile, row)


@pytest.mark.parametrize("head_dim,itemsize", [(64, 2), (64, 4), (128, 2), (128, 4)])
def test_every_planned_split_fits_the_flash_kernel(head_dim, itemsize):
    """A split planned against the Hopper pin budget is a prefix the kernel
    accepts: whole, or a multiple of its KV tile, and within a block's
    shared memory with the kernel's padded rows."""
    budget = port_orch.hopper_pin_budget_bytes(head_dim, itemsize)
    assert 0 < budget < port_orch.H100_SMEM_PER_BLOCK
    orch = CacheOrchestrator(vmem_budget_bytes=budget)
    for seq in list(range(1, 700, 7)) + [1000, 1024, 2048, 4096]:
        pinned, streamed = orch.plan_kv_split(seq, port_orch.FLASH_TILE_ROWS,
                                              2 * head_dim * itemsize)
        assert pinned + streamed == seq
        assert pinned == seq or pinned % port_orch.FLASH_TILE_ROWS == 0
        assert (port_orch.flash_smem_bytes(pinned, head_dim, itemsize)
                <= port_orch.H100_SMEM_PER_BLOCK)


@pytest.mark.parametrize("seed", range(3))
def test_scheduler_matches_on_random_call_sequence(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefScheduler(3), SlotScheduler(3)
    uid = 0
    for _ in range(500):
        op = rng.random()
        if op < 0.4:
            ref.add(uid)
            port.add(uid)
            uid += 1
        elif op < 0.7:
            assert ref.admit() == port.admit()
        else:
            active = ref.active_slots()
            assert active == port.active_slots()
            if active:
                slot = int(rng.choice(active))
                assert ref.release(slot) == port.release(slot)
        assert (ref.n_active, ref.n_queued, ref.drained) == (
            port.n_active, port.n_queued, port.drained)
        assert ref.slots == port.slots and ref.queue == port.queue


def test_scheduler_errors_match():
    for cls in (RefScheduler, SlotScheduler):
        with pytest.raises(ValueError):
            cls(0)
        with pytest.raises(ValueError):
            cls(2).release(1)
    assert str(RefTruncation(5, 2, 1)) == str(ServeTruncation(5, 2, 1))
