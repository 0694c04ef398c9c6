"""Deterministic synthetic data (port of ``repro/data/pipeline.py``).

  * :class:`MarkovLM` — a learnable token stream sampled from a fixed
    random first-order Markov chain.  The reference draws a ``vocab x
    vocab`` float64 matrix to choose each token's successors (185 GB at
    qwen3's 151,936 tokens); this port draws the same numbers a block of
    rows at a time and keeps only each row's successors, so a full
    vocabulary needs ``vocab x topk`` integers and one block.
  * :class:`SyntheticLMStream` — step-seeded batches: the batch at step k
    is a pure function of (seed, k, host).
  * :class:`FramesStream` — a token stream's batches with an
    encoder-decoder's stub ``frames`` added, seeded by the step.
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


#: float64 draws held at once while choosing successors (128 MiB)
SUCCESSOR_BLOCK = 2 ** 24


def _successors(rng: np.random.RandomState, vocab: int, k: int) -> np.ndarray:
    """``np.argsort(rng.rand(vocab, vocab), axis=1)[:, :k]``, drawn in
    blocks of rows: ``rand`` fills row-major from one stream, so the
    blocks hold the same numbers; each row keeps the indices of its k
    smallest (``argpartition``), ordered by value."""
    succ = np.empty((vocab, k), np.intp)
    rows = max(1, SUCCESSOR_BLOCK // vocab)
    for r0 in range(0, vocab, rows):
        block = rng.rand(min(rows, vocab - r0), vocab)
        part = np.argpartition(block, k - 1, axis=1)[:, :k]
        order = np.argsort(np.take_along_axis(block, part, axis=1), axis=1)
        succ[r0:r0 + len(block)] = np.take_along_axis(part, order, axis=1)
    return succ


class MarkovLM:
    """First-order Markov chain over ``vocab`` tokens, peaked transitions."""

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.5,
                 topk: int = 16):
        rng = np.random.RandomState(seed)
        k = min(topk, vocab)
        self.vocab = vocab
        # sparse transition structure: each token has k successors
        self.succ = _successors(rng, vocab, k)
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


class FramesStream:
    """A token stream whose batches also carry an encoder-decoder's stub
    ``frames`` (B, ``frames``, ``width``) float32, drawn from a numpy
    RandomState keyed on the step (whisper's conv frontend is a stub in
    the reference too, fed precomputed frame embeddings)."""

    def __init__(self, tokens, frames: int, width: int):
        self.tokens, self.frames, self.width = tokens, frames, width

    def batch_at(self, step: int) -> dict:
        batch = self.tokens.batch_at(step)
        rng = np.random.RandomState(1_000 + step)
        batch["frames"] = rng.randn(len(batch["tokens"]), self.frames,
                                    self.width).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict]:
        step = 0
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

