"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

  * :class:`MarkovLM` — a learnable token stream sampled from a fixed
    random first-order Markov chain.  Its transition table is
    ``vocab x vocab`` floats on the host: at a full vocabulary (151,936
    for qwen3) that is about 185 GB, so full-width runs use
    ``learnable=False``.
  * :class:`SyntheticLMStream` — step-seeded batches: the batch at step k
    is a pure function of (seed, k, host).
  * :class:`Prefetcher` — background-thread prefetch over any iterator.
  * :class:`ClassificationTask` / :func:`make_cluster_task` — Gaussian
    cluster classification, the accuracy harness's tasks.

Pure numpy, bit for bit the reference's streams and samples.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
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


class Prefetcher:
    """Background-thread prefetch over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)
            self._q.put(StopIteration)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is StopIteration:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


@dataclasses.dataclass
class ClassificationTask:
    """Gaussian-cluster classification with controllable difficulty."""
    num_classes: int
    dim: int
    centers: np.ndarray          # (C, dim)
    noise: float
    seed: int

    def sample(self, rng: np.random.RandomState, n: int):
        y = rng.randint(0, self.num_classes, n)
        x = self.centers[y] + rng.randn(n, self.dim) * self.noise
        return x.astype(np.float32), y.astype(np.int32)

    def batches(self, batch: int, seed_offset: int = 0):
        step = 0
        while True:
            rng = np.random.RandomState(self.seed + seed_offset + step)
            yield self.sample(rng, batch)
            step += 1


def make_cluster_task(num_classes: int, dim: int = 64, *,
                      hard: bool = False, seed: int = 0) -> ClassificationTask:
    """Easy regime: well-separated clusters (the CIFAR-10 analogue).
    Hard regime: superclass centers with tightly packed subclasses (the
    CIFAR-100 analogue), where the classifier head must resolve
    small-margin distinctions that sign-only updates lose.
    """
    rng = np.random.RandomState(seed)
    if not hard:
        centers = rng.randn(num_classes, dim) * 2.0
        return ClassificationTask(num_classes, dim, centers, noise=1.0,
                                  seed=seed)
    n_super = max(num_classes // 10, 1)
    supers = rng.randn(n_super, dim) * 2.0
    centers = np.stack([supers[i % n_super] + rng.randn(dim) * 0.35
                        for i in range(num_classes)])
    return ClassificationTask(num_classes, dim, centers, noise=0.55, seed=seed)
