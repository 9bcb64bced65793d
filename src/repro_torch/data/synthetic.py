"""Deterministic synthetic LM data pipeline.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy
only): the same seeds give the same token stream in both packages.

Tokens are generated from a counter-based PRNG keyed by (seed, step,
shard) so that (a) every restart reproduces the same stream (checkpoint
resume sees identical batches), and (b) each data-parallel host generates
only its own shard — no host ever materializes the global batch
(mandatory at global_batch 256 × seq 4k).

The generated stream is a Zipf-ish mixture with Markov structure rather
than uniform noise, so the training loss has real signal to descend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def __post_init__(self) -> None:
        if self.global_batch % self.n_shards:
            raise ValueError("global_batch must divide evenly over shards")
        self.local_batch = self.global_batch // self.n_shards

    def _rng(self, step: int) -> np.random.Generator:
        seq = np.random.SeedSequence(
            entropy=self.seed, spawn_key=(step, self.shard))
        return np.random.Generator(np.random.PCG64(seq))

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len) int32 tokens for this shard at `step`."""
        rng = self._rng(step)
        b, s, v = self.local_batch, self.seq_len, self.vocab
        # zipf-weighted unigram pool + first-order repetition structure
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        tok = (base - 1) % v
        rep = rng.random((b, s)) < 0.3
        shifted = np.roll(tok, 1, axis=1)
        tok = np.where(rep, shifted, tok)
        tok[:, 0] = 1                      # BOS
        return tok.astype(np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch(vocab: int, batch: int, seq: int, step: int = 0,
               seed: int = 0) -> np.ndarray:
    return SyntheticLM(vocab, seq, batch, seed=seed).batch(step)
