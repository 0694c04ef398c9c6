"""Serving runtime: the decode step and the cache-filling prefill.

Port of ``repro/runtime/serve.py`` on one device (``mesh=None``, the
serving engine's and the tests' path).  Serving has no gradient
traffic, so the fabric's modes do not enter here.  The reference's
GSPMD layouts (:func:`serve_shardings`, :func:`build_prefill`, a
``mesh``) place the cache's batch or sequence over a mesh; they raise
here (ROADMAP queue 1 item 7).

``donate=True`` mirrors the reference's donated cache: the step writes
into the cache it is given (the KV tensors in place; the recurrent
states come back as new tensors, see
:func:`~repro_torch.models.decode_step`).  ``donate=False`` works on a
copy of the whole tree and leaves the caller's cache as it was.  Every
family decodes here, the recurrent and encoder-decoder ones too; the
paged engine (:mod:`repro_torch.serve`) takes only the attention
families, as the reference's does.
"""
from __future__ import annotations

import torch

from ..core import tree as T
from ..models import ModelConfig, decode_step

__all__ = ["build_cached_prefill", "build_prefill", "build_serve_step",
           "serve_shardings"]


def _no_mesh(what: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what} on a mesh: the reference's GSPMD serving layouts (the "
            f"batch over the data axes, or the cache's sequence for a batch "
            f"of 1) are still to port (ROADMAP queue 1 item 7); pass "
            f"mesh=None for the one-device path")


def _own(cache: dict, donate: bool) -> dict:
    """The cache itself, or a copy of the whole tree (an xLSTM's is a
    list of per-block state dicts)."""
    return cache if donate else T.map_leaves(torch.Tensor.clone, cache)


def serve_shardings(cfg: ModelConfig, mesh, *, batch: int, max_seq: int,
                    dp_axes=("data",)) -> dict:
    """The reference's input and output shardings of a decode step on a
    mesh: still to port."""
    _no_mesh("serve_shardings", mesh or "mesh")


def build_serve_step(cfg: ModelConfig, mesh=None, *, batch: int,
                     max_seq: int, dp_axes=("data",), donate: bool = True):
    """(params, token, cache, position) -> (logits, cache), and the
    shardings dict (``None`` entries on one device).

    ``position`` is a Python int or a (B,) integer tensor (continuous
    batching, see :func:`repro_torch.models.decode_step`); ``batch`` and
    ``max_seq`` size the step's cache, as in the reference."""
    _no_mesh("build_serve_step", mesh)

    def step(params, token, cache, position):
        return decode_step(params, cfg, token, _own(cache, donate), position)

    return step, {"token": None, "cache": None, "params": None,
                  "shard_seq": False}


def build_cached_prefill(cfg: ModelConfig, mesh=None, *, dp_axes=("data",),
                         donate: bool = True):
    """(params, tokens, length, cache) -> (last_logits, cache).

    Feeds ``tokens[:, :length]`` (B, P integers, anything past
    ``length``) through :func:`~repro_torch.models.decode_step` one
    position at a time, as the reference's ``fori_loop`` does, so the
    prefilled cache and the logits are the decode path's own bits.
    Returns the logits at the last prompt position and the cache filled
    at ``[0, length)``, ready for decode at ``length``."""
    _no_mesh("build_cached_prefill", mesh)

    def run(params, tokens, length, cache):
        cache = _own(cache, donate)
        logits = None
        for i in range(max(1, int(length))):
            logits, cache = decode_step(params, cfg, tokens[:, i:i + 1],
                                        cache, i)
        return logits, cache

    return run


def build_prefill(cfg: ModelConfig, mesh, *, dp_axes=("data",)):
    """The reference's GSPMD prefill (a forward with the batch over the
    data axes): still to port."""
    _no_mesh("build_prefill", mesh or "mesh")
