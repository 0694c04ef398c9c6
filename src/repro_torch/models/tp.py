"""Tensor parallelism over a model group: the collectives GSPMD implies
for the reference's ``param_pspecs``, as autograd functions.

The reference shards parameters over the ``"model"`` mesh axis and lets
GSPMD place the collectives (``repro/models/transformer.py:194-236``,
``layers.py:119-127``, ``:435-442``): Q's columns and O's rows split
evenly (whole heads or not) with K and V replicated, the MLP column- then
row-parallel, the experts of a MoE layer over the group, the embedding
(and so the tied head) split over the vocabulary, the VLM's
``patch_proj`` and whisper's ``frame_proj`` over their output columns,
the recurrent blocks' projections around a scan that runs whole on
every rank (xLSTM) or on this rank's channels (Hymba's Mamba head,
``repro/models/transformer.py:85-98``, ``:205-219``).  Here each rank
holds its blocks and the model's forward calls the collectives itself,
Megatron-style:

  * :meth:`TensorParallel.copy` — identity forward, all-reduce backward:
    where a replicated tensor enters a sharded computation (the layer's
    input; a replicated weight such as ``wk`` or ``q_norm``'s scale used
    by this rank's heads only, whose gradient is partial);
  * :meth:`TensorParallel.reduce` — all-reduce forward, identity
    backward: the row-parallel outputs, the vocab-parallel lookup and
    the cross-entropy's sums;
  * :meth:`TensorParallel.gather` — all-gather forward (every rank's
    block, concatenated), and backward this rank's block of the
    gradient, summed over the group first where each rank's consumers
    of the whole tensor differ (a reduce-scatter, as an all-reduce and a
    slice): the query columns of attention whose heads the group does
    not split whole, and the VLM's column-parallel ``patch_proj``;
  * :meth:`TensorParallel.scatter` — this rank's block of a tensor every
    rank holds whole forward, the all-gather of the blocks' gradients
    backward (Megatron's ``scatter_to_tensor_model_parallel_region``):
    a replicated scan's output into a row-parallel product;
  * :meth:`TensorParallel.embed` and :meth:`TensorParallel.cross_entropy`
    — the vocab-parallel lookup (mask, gather, all-reduce) and the float32
    cross-entropy from vocab-sharded logits (max, sum-exp and target logit
    reduced over the group).

The forward all-reduce and all-gather are custom operators
(``repro_torch::tp_all_reduce``, ``tp_all_gather``) so that a
selective-checkpoint policy sees them and can save their outputs: under ``remat_policy="dots"`` the recompute runs no
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



@torch.library.custom_op("repro_torch::tp_all_gather", mutates_args=())
def _tp_all_gather(x: torch.Tensor, group_id: int, dim: int,
                   partial: bool) -> torch.Tensor:
    return _GROUPS[group_id].all_gather_dim(x, dim).contiguous()


@_tp_all_gather.register_fake
def _(x, group_id, dim, partial):
    group = _GROUPS[group_id]
    if x.device.type == "meta":       # the dry-run's call, as above
        return group.all_gather_dim(x, dim).contiguous()
    shape = list(x.shape)
    shape[dim] *= group.size
    return x.new_empty(shape)


def _gather_context(ctx, inputs, output):
    x, ctx.group_id, ctx.dim, ctx.partial = inputs
    ctx.rows = x.shape[ctx.dim]


def _gather_backward(ctx, grad):
    group = _GROUPS[ctx.group_id]
    if ctx.partial:
        grad = group.all_reduce(grad.contiguous())
    k = group.rank()[0]
    return grad.narrow(ctx.dim, k * ctx.rows, ctx.rows), None, None, None


_tp_all_gather.register_autograd(_gather_backward,
                                 setup_context=_gather_context)

#: the operators a selective-checkpoint policy saves
TP_ALL_REDUCE = torch.ops.repro_torch.tp_all_reduce.default
TP_ALL_GATHER = torch.ops.repro_torch.tp_all_gather.default


class _Copy(torch.autograd.Function):
    """Identity forward, sum over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous()), None


class _Scatter(torch.autograd.Function):
    """This rank's block forward, the blocks' gradients gathered
    backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        rows = x.shape[dim] // group.size
        return x.narrow(dim, group.rank()[0] * rows, rows)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_gather_dim(grad.contiguous(), ctx.dim), None, \
            None


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

    def gather(self, x: torch.Tensor, dim: int, *,
               partial: bool = True) -> torch.Tensor:
        """Every rank's block ``x`` concatenated along ``dim``, in rank
        order.  The gradient is this rank's block of the whole one's,
        summed over the group first when ``partial`` (each rank's
        consumers of the whole tensor differ, so each holds a part of
        its gradient); with ``partial=False`` the consumers are
        replicated, every rank holds the whole gradient, and the
        backward runs no collective."""
        return _tp_all_gather(x.contiguous(), self._id, dim % x.dim(),
                              partial)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x``, which every rank holds whole, along
        ``dim``; the gradient is every rank's block's, gathered (the
        inverse of ``gather(..., partial=False)``)."""
        return _Scatter.apply(x, self.group, dim % x.dim())

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
