"""Deterministic synthetic data (port of ``repro/data/pipeline.py:27-89``).

  * :class:`MarkovLM` — a learnable token stream sampled from a fixed
    random first-order Markov chain.  Its transition table is
    ``vocab x vocab`` floats on the host: at a full vocabulary (151,936
    for qwen3) that is about 185 GB, so full-width runs use
    ``learnable=False``.
  * :class:`SyntheticLMStream` — step-seeded batches: the batch at step k
    is a pure function of (seed, k, host).

Pure numpy, bit for bit the reference's streams.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


class MarkovLM:
    """First-order Markov chain over ``vocab`` tokens, peaked transitions."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.5,
                 topk: int = 16):
        rng = np.random.RandomState(seed)
        k = min(topk, vocab)
        self.vocab = vocab
        # sparse transition structure: each token has k successors
        self.succ = np.argsort(rng.rand(vocab, vocab), axis=1)[:, :k]
        logits = rng.gumbel(size=(vocab, k)) / concentration
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.probs = p / p.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.RandomState, batch: int, seq: int
               ) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.randint(0, self.vocab, batch)
        for t in range(seq):
            cur = out[:, t]
            # vectorized categorical draw over the k successors of each token
            cdf = np.cumsum(self.probs[cur], axis=1)
            u = rng.rand(batch, 1)
            idx = (u > cdf).sum(axis=1)
            out[:, t + 1] = self.succ[cur, idx]
        return out


@dataclasses.dataclass
class SyntheticLMStream:
    """Step-seeded LM batches: {'tokens': (B,S), 'labels': (B,S)}.

    ``batch`` is the *per-host* batch.  Deterministic per (seed, step,
    host_index): restart from a checkpoint at step k reproduces the exact
    remaining stream, which the checkpoint-resume tests rely on.
    """
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    start_step: int = 0
    learnable: bool = True

    def __post_init__(self):
        self._chain = MarkovLM(self.vocab, seed=self.seed) if self.learnable else None

    def batch_at(self, step: int) -> dict:
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 97 + self.host_index) % (2**31 - 1))
        if self._chain is not None:
            toks = self._chain.sample(rng, self.batch, self.seq_len)
        else:
            toks = rng.randint(0, self.vocab,
                               (self.batch, self.seq_len + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = self.start_step
        while True:
            yield self.batch_at(step)
            step += 1
