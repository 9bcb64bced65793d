"""The port's synthetic LM data against the JAX package's: the same seed,
step and shard give the same tokens (both draw them with numpy's PCG64
keyed by ``SeedSequence(entropy=seed, spawn_key=(step, shard))``)."""

import numpy as np
import pytest

from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import make_batch as jax_make_batch
# the port
from repro_torch.data import SyntheticLM
from repro_torch.data import make_batch


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("n_shards,shard", [(1, 0), (4, 0), (4, 3)])
def test_stream_equals_reference(seed, n_shards, shard):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=seed, n_shards=n_shards,
              shard=shard)
    ours, ref = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 1, 17, 1000):
        np.testing.assert_array_equal(ours.batch(step), ref.batch(step))
    it = iter(ours)
    for step, want in zip(range(3), ref):
        np.testing.assert_array_equal(next(it), want)


@pytest.mark.parametrize("vocab", [512, 128256])
def test_make_batch_equals_reference(vocab):
    got = make_batch(vocab, 4, 32, step=3, seed=2)
    assert got.dtype == np.int32 and got.shape == (4, 32)
    np.testing.assert_array_equal(got, jax_make_batch(vocab, 4, 32, step=3, seed=2))
    assert (got[:, 0] == 1).all()                 # BOS


def test_data_deterministic_and_sharded():
    d1 = SyntheticLM(1000, 128, 16, seed=7, n_shards=4, shard=2)
    d2 = SyntheticLM(1000, 128, 16, seed=7, n_shards=4, shard=2)
    np.testing.assert_array_equal(d1.batch(5), d2.batch(5))
    assert d1.batch(5).shape == (4, 128)
    d3 = SyntheticLM(1000, 128, 16, seed=7, n_shards=4, shard=3)
    assert not np.array_equal(d1.batch(5), d3.batch(5))
    assert (d1.batch(0) < 1000).all() and (d1.batch(0) >= 0).all()


def test_uneven_shards_are_refused():
    with pytest.raises(ValueError, match="shards"):
        SyntheticLM(100, 8, 10, n_shards=4)
