"""The port's roofline module (``repro_torch/launch/roofline.py``) against the
JAX package's: ``param_count``, ``model_flops`` and ``model_bytes`` equal
the reference's exactly for every arch and shape; the hardware constants are
an H100 SXM's and no TPU constant is left; a cell that was not run carries
no collective term.

The reference's ``param_count`` is approximate (it leaves out the norms,
the SSM's conv weights, ``dt_bias``, ``a_log``, ``d_skip`` and the MoE
router): it sits below the element count of ``init_params(cfg,
device="meta")`` by 0.0015% (gemma2-27b) to 0.079% (mamba2-2.7b).
``test_param_count_sits_just_below_the_meta_tree`` records that bound and
does not change the count."""

from pathlib import Path
import re

import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_arch
from repro.launch import roofline as jax_rl
# the port
from repro_torch.configs import ARCH_NAMES
from repro_torch.configs import SHAPES
from repro_torch.configs import get_arch
from repro_torch.launch import roofline as rl
from repro_torch.models import init_params
from repro_torch.tree import leaves


SOURCE = Path(rl.__file__).read_text()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_counts_equal_the_reference(arch, shape):
    cfg, ref = get_arch(arch), jax_arch(arch)
    assert rl.param_count(cfg) == jax_rl.param_count(ref)
    assert rl.param_count(cfg, active_only=True) == jax_rl.param_count(ref, active_only=True)
    assert rl.model_flops(cfg, SHAPES[shape]) == jax_rl.model_flops(ref, JAX_SHAPES[shape])
    assert rl.model_bytes(cfg, SHAPES[shape]) == jax_rl.model_bytes(ref, JAX_SHAPES[shape])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_sits_just_below_the_meta_tree(arch):
    cfg = get_arch(arch)
    n = sum(t.numel() for t in leaves(init_params(cfg, device="meta")))
    short = (n - rl.param_count(cfg)) / n
    assert 0 < short < 1e-3, short


def test_the_constants_are_an_h100s():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    for tpu in (r"197e12", r"819e9", r"(?<![\d.])50e9", r"ICI_BW", r"TPU v5e"):
        assert not re.search(tpu, SOURCE), tpu
    assert jax_rl.PEAK_FLOPS != rl.PEAK_FLOPS and jax_rl.HBM_BW != rl.HBM_BW


def _entry(**kw):
    base = dict(arch="llama3p2_3b", shape="decode_32k", mesh="16x16", chips=256,
                flops_per_chip=1e12, bytes_per_chip=4e9, coll_bytes_per_chip=None,
                coll_breakdown=None, peak_memory_bytes=None, model_flops_global=2.56e14,
                model_bytes_global=1.024e12)
    base.update(kw)
    return rl.RooflineEntry(**base)


def test_an_entry_without_collective_bytes_has_no_collective_term():
    d = _entry().to_dict()
    assert d["t_collective"] is None and d["coll_bytes_per_chip"] is None
    assert d["t_compute"] == 1e12 / 989e12 and d["t_memory"] == 4e9 / 3.35e12
    assert d["bottleneck"] == "memory"
    assert d["roofline_fraction"] == pytest.approx(1.0)


def test_measured_collective_bytes_take_the_nvlink_rate():
    e = _entry(coll_bytes_per_chip=9e9, coll_breakdown={"all-gather": 9e9})
    assert e.t_collective == 9e9 / 450e9
    assert e.bottleneck == "collective"
    assert e.roofline_fraction == pytest.approx(e.t_memory / e.t_collective)
