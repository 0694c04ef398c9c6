"""Tensor parallelism over a model group: the collectives GSPMD implies
for the reference's ``param_pspecs``, as autograd functions.

The reference shards parameters over the ``"model"`` mesh axis and lets
GSPMD place the collectives (``repro/models/transformer.py:194-236``,
``layers.py:119-127``): Q and O split over heads with K and V replicated,
the MLP column- then row-parallel, the embedding (and so the tied head)
split over the vocabulary.  Here each rank holds its blocks and the
model's forward calls the collectives itself, Megatron-style:

  * :meth:`TensorParallel.copy` — identity forward, all-reduce backward:
    where a replicated tensor enters a sharded computation (the layer's
    input; a replicated weight such as ``wk`` or ``q_norm``'s scale used
    by this rank's heads only, whose gradient is partial);
  * :meth:`TensorParallel.reduce` — all-reduce forward, identity
    backward: the row-parallel outputs, the vocab-parallel lookup and
    the cross-entropy's sums;
  * :meth:`TensorParallel.embed` and :meth:`TensorParallel.cross_entropy`
    — the vocab-parallel lookup (mask, gather, all-reduce) and the float32
    cross-entropy from vocab-sharded logits (max, sum-exp and target logit
    reduced over the group).

The forward all-reduce is a custom operator (``repro_torch::
tp_all_reduce``) so that a selective-checkpoint policy sees it and can
save its output: under ``remat_policy="dots"`` the recompute runs no
collective (:func:`repro_torch.models.transformer._remat`).  Every
collective goes through the group's :class:`~repro_torch.core.
collectives.DistributedGroup`, which counts it in ``calls_by_op``.
"""
from __future__ import annotations

import torch

#: model groups by the id the custom operator carries
_GROUPS: dict[int, object] = {}


@torch.library.custom_op("repro_torch::tp_all_reduce", mutates_args=())
def _tp_all_reduce(x: torch.Tensor, group_id: int) -> torch.Tensor:
    return _GROUPS[group_id].all_reduce(x)


@_tp_all_reduce.register_fake
def _(x, group_id):
    # ``meta`` tensors reach this, not the operator's body: the launch
    # dry-run's abstract step, whose group still counts the call
    if x.device.type == "meta":
        return _GROUPS[group_id].all_reduce(x)
    return torch.empty_like(x)


def _identity_backward(ctx, grad):
    return grad, None


_tp_all_reduce.register_autograd(_identity_backward)

#: the operator a selective-checkpoint policy saves
TP_ALL_REDUCE = torch.ops.repro_torch.tp_all_reduce.default


class _Copy(torch.autograd.Function):
    """Identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous()), None


class TensorParallel:
    """This rank's place in a model group of ``M`` ranks (a
    :class:`~repro_torch.core.collectives.DistributedGroup`; its rank is
    the model index ``m``).  A dimension of ``full`` elements is split
    over the group iff ``M`` divides it, as the reference's
    ``sanitize_spec`` decides; rank ``m`` holds block ``m``."""

    def __init__(self, group):
        self.group = group
        self.size = group.size
        self.index = group.rank()[0]
        self._id = len(_GROUPS)
        _GROUPS[self._id] = group

    def split(self, local: int, full: int, what: str) -> bool:
        """Is a dimension of ``full`` elements, of which this rank holds
        ``local``, split over the group?  Raises when the block is
        neither the whole nor one M-th."""
        if local == full and (self.size == 1 or full % self.size):
            return False
        if full % self.size == 0 and local * self.size == full:
            return self.size > 1
        raise ValueError(f"{what}: a block of {local} of {full} elements "
                         f"is not the layout of a model axis of "
                         f"{self.size}")

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient is summed over the group."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group; the gradient passes unchanged."""
        return _tp_all_reduce(x.contiguous(), self._id)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group, outside autograd."""
        return self.group.all_reduce(x.detach(), "max")

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of a vocab-sharded ``table`` (this rank's ``V / M`` rows)
        for ``tokens``: each rank gathers the tokens it holds, zeros the
        others, and the sum over the group is the lookup."""
        rows = table.shape[0]
        local = tokens - self.index * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
        return self.reduce(x)

    def cross_entropy(self, logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """Per-token ``logsumexp(logits) - logits[label]`` (float32) from
        vocab-sharded ``logits`` (..., V / M): the max over the group
        (held out of autograd; the gradient does not depend on it), then
        the sum of ``exp(logits - max)`` and the target's logit, both
        summed over the group in one all-reduce."""
        rows = logits.shape[-1]
        top = self.max(logits.amax(dim=-1))
        sumexp = torch.exp(logits - top[..., None]).sum(dim=-1)
        local = labels - self.index * rows
        inside = (local >= 0) & (local < rows)
        gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])
        gold = torch.where(inside, gold[..., 0],
                           torch.zeros((), dtype=logits.dtype,
                                       device=logits.device))
        sumexp, gold = self.reduce(torch.stack([sumexp, gold])).unbind(0)
        return torch.log(sumexp) + top - gold

    def __repr__(self) -> str:
        return f"TensorParallel(m={self.index} of {self.size})"
