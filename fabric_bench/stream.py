"""The benchmark's seeded batches of token ids.

Ids are uniform over the vocabulary in fixed-length rows; row ``i`` of
step ``s`` depends on the seed and ``s`` alone, so the program and the
reference read the same batches, and every step's rows are new.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    """Global batches ``{"tokens", "labels"}`` of ``batch`` rows of
    ``seq_len`` ids (labels: the ids shifted by one)."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = seed % 2 ** 64

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        ids = rng.integers(0, self.vocab, size=(self.batch, self.seq_len + 1),
                           dtype=np.int64)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
