"""Seeded weights, made where the model lives, in a few large draws.

The leaves are taken in the order of their sorted paths and drawn as
one flat sequence of standard normals, ``CHUNK`` at a time, from one
``torch.Generator`` seeded with the run's seed on the leaves' device.
Each leaf's part is scaled by its rule (:func:`init_rule`) and rounded
into the leaf's dtype.  The program's parameters and the reference's
get the same values by filling trees of the same paths and shapes from
the same seed; :func:`change_norms` draws the sequence again to measure
how far each leaf has moved, without holding a second copy.
"""
from __future__ import annotations

import math
import re

import torch

CHUNK = 1 << 26


def init_rule(path: str, shape) -> tuple[float, float]:
    """(mean, std) of a leaf: norm scales 1 + N(0, 0.1^2), the token
    embedding and the qkv biases N(0, 0.02^2), every matrix N(0, 1/fan_in)
    with its input dimension the second to last."""
    name = path.rsplit("/", 1)[-1]
    if name == "scale":
        return 1.0, 0.1
    if name == "tok" or re.fullmatch(r"b[qkv]", name):
        return 0.0, 0.02
    return 0.0, 1.0 / math.sqrt(shape[-2])


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 64)


def _draws(leaves: dict, seed: int):
    """For each draw: the standard normals and the leaves' parts it
    covers, as ``(path, tensor, lo, hi, offset in the draw)``."""
    items = sorted(leaves.items())
    device = items[0][1].device
    gen = _generator(seed, device)
    sizes = [t.numel() for _, t in items]
    total, start = sum(sizes), 0
    i, done = 0, 0          # leaf index, elements of it already covered
    while start < total:
        n = min(CHUNK, total - start)
        buf = torch.randn(n, generator=gen, device=device,
                          dtype=torch.float32)
        parts, off = [], 0
        while off < n:
            path, t = items[i]
            take = min(sizes[i] - done, n - off)
            parts.append((path, t, done, done + take, off))
            off += take
            done += take
            if done == sizes[i]:
                i, done = i + 1, 0
        yield buf, parts
        start += n


@torch.no_grad()
def fill(leaves: dict, seed: int) -> None:
    """Write the seeded weights into ``leaves`` (path -> tensor), in
    place."""
    for buf, parts in _draws(leaves, seed):
        for path, t, lo, hi, off in parts:
            mean, std = init_rule(path, t.shape)
            t.view(-1)[lo:hi].copy_(buf[off:off + hi - lo] * std + mean)


@torch.no_grad()
def change_norms(leaves: dict, seed: int) -> dict:
    """Each leaf's L2 distance from the seeded weights, in float32."""
    acc = {}
    for buf, parts in _draws(leaves, seed):
        for path, t, lo, hi, off in parts:
            mean, std = init_rule(path, t.shape)
            start = (buf[off:off + hi - lo] * std + mean).to(t.dtype)
            d = t.view(-1)[lo:hi].to(torch.float32) - start.to(torch.float32)
            s = torch.sum(d * d, dtype=torch.float64)
            acc[path] = acc[path] + s if path in acc else s
    return {p: math.sqrt(float(s)) for p, s in acc.items()}
