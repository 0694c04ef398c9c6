"""Layer-wise low-bit/FP32 cosine-alignment diagnostics (paper Table 5).

Port of ``repro/core/diagnostics.py``.  During FP32 calibration steps
both aggregates are at hand: the FP32 mean gradient (the update) and the
low-bit direction it would have produced.  Their cosine, accumulated per
layer group, is the admission signal: near 1 the low-bit signal keeps
the update direction, near 0 it is nearly orthogonal.

Everything is computed in float32 on the aggregates' device, the 2-of-3
gate included (a host-built gate over a full embedding table costs
seconds a step).  Signs follow ``jnp.sign``.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from . import tree as T
from .lowbit import _flat_index_gate, signum


_KEYS = ("num_b", "num_t", "gg", "bb", "tt")


def _accumulate(acc: dict, group: str, g: torch.Tensor, ubin: torch.Tensor,
                gate_phase: int, gate: torch.Tensor | None = None) -> None:
    if gate is None:
        gate = _flat_index_gate(g.shape, gate_phase, device=g.device)
    uter = ubin * gate
    d = acc.setdefault(group, {k: [] for k in _KEYS})
    d["num_b"].append(torch.sum(ubin * g))
    d["num_t"].append(torch.sum(uter * g))
    d["gg"].append(torch.sum(g * g))
    d["bb"].append(torch.sum(ubin * ubin))
    d["tt"].append(torch.sum(uter * uter))


def _finish(acc: dict) -> dict:
    out = {}
    for group, d in acc.items():
        gg = torch.sqrt(sum(d["gg"]))
        out[group] = {
            "gbinary": sum(d["num_b"]) / (gg * torch.sqrt(sum(d["bb"]))
                                          + 1e-12),
            "gternary": sum(d["num_t"]) / (gg * torch.sqrt(sum(d["tt"]))
                                           + 1e-12),
        }
    return out


def group_cosines_from_mean(grads_mean: Any, groups: Any,
                            gate_phase: int = 0, shards=None) -> dict:
    """Per-group cosine between the FP32 mean aggregate and its low-bit
    image ``sign(mean)``, the controller-visible proxy of the majority
    direction during FP32 phases.

    ``shards`` (one entry a leaf: None, or the
    :class:`~repro_torch.runtime.shardings.ShardView` of a
    tensor-parallel leaf's block) makes the sums the whole leaves': a
    block's sums, with the gate at its global flat indices, are added
    over the model group in one all-reduce, a replicated leaf counts once.
    Returns ``{group: {'gbinary': cos, 'gternary': cos}}`` of 0-d tensors.
    """
    acc: dict = {}
    part: dict = {}
    leaves, names = T.leaves(grads_mean), T.leaves(groups)
    for leaf, group, sh in zip(leaves, names, shards or [None] * len(leaves)):
        g = leaf.to(torch.float32)
        if sh is None:
            g = g.reshape(-1)
            _accumulate(acc, group, g, signum(g), gate_phase)
        else:
            gate = sh.gate(gate_phase, device=g.device).reshape(-1)
            g = g.reshape(-1)
            _accumulate(part, group, g, signum(g), gate_phase, gate)
            model_group = sh.group
    if part:
        order = [(grp, k) for grp in sorted(part) for k in _KEYS]
        sums = model_group.all_reduce(torch.stack(
            [sum(part[grp][k]) for grp, k in order]))
        for (grp, k), x in zip(order, sums.unbind(0)):
            acc.setdefault(grp, {kk: [] for kk in _KEYS})[k].append(x)
    return _finish(acc)


def group_cosines_from_workers(worker_grads: Any, groups: Any,
                               gate_phase: int = 0) -> dict:
    """The exact Table-5 diagnostic from stacked ``(W, ...)`` per-worker
    gradients: the true majority vote (not the sign-of-mean proxy)
    against the FP32 mean."""
    acc: dict = {}
    for leaf, group in zip(T.leaves(worker_grads), T.leaves(groups)):
        w = leaf.shape[0]
        g = torch.mean(leaf.to(torch.float32), dim=0).reshape(-1)
        votes = torch.sum((leaf > 0).to(torch.int32), dim=0).reshape(-1)
        ubin = torch.sign(2 * votes - w).to(torch.float32)
        _accumulate(acc, group, g, ubin, gate_phase)
    return _finish(acc)


def cosines_to_host(cosines: Mapping[str, Mapping[str, torch.Tensor]]
                    ) -> dict:
    """Device scalars -> plain floats for the Commander."""
    return {g: {k: float(v) for k, v in d.items()}
            for g, d in cosines.items()}
