"""Synthetic token pipeline for LM-arch training/serving.

Deterministic, seekable, shardable — the properties a production input
pipeline needs for fault-tolerant restart (resume from step k reproduces
the same batch k) and for multi-host sharding (each data-parallel group
reads its own slice). A copy of `repro.data.tokens`: the same seed and
step give the same NumPy batch in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0      # data-parallel shard
    shard_count: int = 1

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.shard_count:
            raise ValueError(
                f"global_batch {self.global_batch} does not split over "
                f"{self.shard_count} shards")
        return self.global_batch // self.shard_count

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Deterministic batch for `step` — restart-safe by construction."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 131 + self.shard_index)
        tokens = rng.integers(
            0, self.vocab_size,
            size=(self.local_batch, self.seq_len), dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        return tokens, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def synthetic_token_batches(vocab: int, seq: int, batch: int, steps: int,
                            seed: int = 0):
    pipe = TokenPipeline(vocab, seq, batch, seed)
    for s in range(steps):
        yield pipe.batch_at(s)
