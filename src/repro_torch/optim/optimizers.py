"""Optimizers (port of ``repro/optim/optimizers.py:25-118``).

The aggregate the fabric returns (an FP32 mean or a {-1, 0, +1}
direction) goes to an unmodified AdamW / SGD-momentum, with float32
moments.  The learning-rate schedule and ``b ** step`` are computed in
float32 tensors, as the reference computes them.

Unlike the reference's pure ``apply``, the port updates parameters and
moments in place (the parameter copy is the model's own, and a second
copy of a full model's moments would double their memory); ``apply``
returns the new :class:`OptState`, whose moment tensors are the old ones.

ZeRO-1 (:class:`Zero1`, from :func:`optimizer_state_pspecs`, the
reference's ``optimizer_state_pspecs``): each data rank keeps the moments
of one slice of every leaf that has a dimension the data group divides,
updates that slice of the parameter, and the slices are all-gathered
over the data group.  The update is elementwise, so the parameters are
bit-identical to the unsharded update's; GSPMD implies the same gather
in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..core import tree as T


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any                 # first moment / momentum (tree)
    nu: Any                 # second moment (tree; None for SGD)


def lr_schedule(step, *, peak_lr: float, warmup_steps: int = 100,
                total_steps: int = 10000, min_ratio: float = 0.1):
    """Linear warmup + cosine decay to ``min_ratio * peak`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)


def optimizer_state_pspecs(param_pspecs: Any, params_abstract: Any,
                           dp_axes=("pod", "data"), dp_size: int = 1,
                           zero1: bool = True) -> dict:
    """ZeRO-1 partition specs of the optimizer's moments: each leaf's
    parameter spec with its first unsharded dimension that ``dp_size``
    divides sharded over the data axes ``dp_axes`` (one axis as its
    name, as ``PartitionSpec`` holds it); a leaf with no such dimension
    (or a 0-d one) stays as it is, padded to its rank.  Specs are tuples
    (:mod:`repro_torch.runtime.shardings`)."""
    dp = _dp_entry(dp_axes)

    def spec(ps, p):
        shape = tuple(p.shape)
        if not zero1 or not shape:
            return tuple(ps) if ps is not None else ()
        entries = list(ps or ()) + [None] * (len(shape) - len(ps or ()))
        for i, (e, dim) in enumerate(zip(entries, shape)):
            if e is None and dim % max(dp_size, 1) == 0 and dim >= dp_size:
                entries[i] = dp
                break
        return tuple(entries)

    return T.unflatten([(path, spec(ps, p)) for (path, p), ps in zip(
        T.flatten(params_abstract), T.leaves(param_pspecs))])


def _dp_entry(dp_axes):
    dp = tuple(dp_axes)
    return dp[0] if len(dp) == 1 else dp


class Zero1:
    """ZeRO-1 over a data group (a :class:`~repro_torch.core.
    collectives.DistributedGroup`): ``dims`` gives, leaf by leaf in the
    tree's order, the dimension whose slices the data ranks own (None: the
    leaf's moments stay whole on every rank).  Rank ``k`` of ``W`` owns
    slice ``k`` of ``W`` equal slices."""

    def __init__(self, group, dims):
        self.group = group
        self.size = group.size
        self.index = group.rank()[0]
        self.dims = tuple(dims)

    @classmethod
    def from_specs(cls, group, opt_specs: Any, dp_axes) -> "Zero1":
        dp = _dp_entry(dp_axes)
        return cls(group, [next((d for d, e in enumerate(s) if e == dp),
                                None) for s in T.leaves(opt_specs)])

    def part(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf ``i`` (a view)."""
        d = self.dims[i]
        if d is None:
            return x
        n = x.shape[d] // self.size
        return x.narrow(d, self.index * n, n)

    def gather(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` whole from every rank's slice ``x``."""
        d = self.dims[i]
        return x if d is None else self.group.all_gather_dim(x, d)


def _zeros(tree: Any, zero: Zero1 | None = None) -> dict:
    return T.unflatten([
        (path, torch.zeros((zero.part(p, i) if zero else p).shape,
                           dtype=torch.float32, device=p.device))
        for i, (path, p) in enumerate(T.flatten(tree))])


def _leaves(params, grads, zero: Zero1 | None):
    """(leaf index, parameter, its slice, the gradient's slice) a leaf."""
    for i, (p, g) in enumerate(zip(T.leaves(params), T.leaves(grads))):
        if zero is None:
            yield i, p, p, g
        else:
            yield i, p, zero.part(p, i), zero.part(g, i)


def _store(p: torch.Tensor, new: torch.Tensor, i: int,
           zero: Zero1 | None) -> None:
    p.copy_(new if zero is None else zero.gather(new, i))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.0

    def init(self, params: Any, zero: Zero1 | None = None) -> OptState:
        raise NotImplementedError

    def apply(self, params: Any, grads: Any, state: OptState,
              zero: Zero1 | None = None) -> OptState:
        raise NotImplementedError

    @property
    def has_nu(self) -> bool:
        """Does this optimizer's state carry a second moment (nu)?  Read
        off the state ``init`` builds (:func:`state_has_nu`), not the
        class name, so subclasses and new adaptive optimizers answer
        right; a subclass may override it where probing ``init`` is
        unwanted.  A legacy step's ``state_shardings`` give ``nu`` the
        moments' specs where it is True."""
        return state_has_nu(self)

    def _lr(self, step):
        return lr_schedule(step, peak_lr=self.peak_lr,
                           warmup_steps=self.warmup_steps,
                           total_steps=self.total_steps)


def state_has_nu(optimizer) -> bool:
    """Probe an optimizer's ``init`` state on a one-element float32
    tensor on the CPU for a second-moment (nu) buffer: the one
    implementation behind :attr:`Optimizer.has_nu`, and the answer for
    any object with ``init(params)``."""
    state = optimizer.init(torch.zeros((1,), dtype=torch.float32))
    return getattr(state, "nu", None) is not None


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Any, zero: Zero1 | None = None) -> OptState:
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=_zeros(params, zero), nu=_zeros(params, zero))

    @torch.no_grad()
    def apply(self, params, grads, state, zero: Zero1 | None = None):
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        dev = T.leaves(params)[0].device
        # the scalars move to the device once per step, not once per leaf
        lr, c1, c2 = torch.stack([self._lr(step), 1 - torch.pow(b1, stepf),
                                  1 - torch.pow(b2, stepf)]).to(dev)
        for (i, p, ps, g), m, v in zip(_leaves(params, grads, zero),
                                       T.leaves(state.mu),
                                       T.leaves(state.nu)):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * ps.to(torch.float32)
            _store(p, (ps.to(torch.float32) - lr * delta).to(p.dtype), i,
                   zero)
        return OptState(step=step, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class SgdMomentum(Optimizer):
    momentum: float = 0.9
    nesterov: bool = False

    def init(self, params: Any, zero: Zero1 | None = None) -> OptState:
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=_zeros(params, zero), nu=None)

    @torch.no_grad()
    def apply(self, params, grads, state, zero: Zero1 | None = None):
        step = state.step + 1
        lr = self._lr(step).to(T.leaves(params)[0].device)
        for (i, p, ps, g), m in zip(_leaves(params, grads, zero),
                                    T.leaves(state.mu)):
            g = g.to(torch.float32)
            if self.weight_decay:
                g = g + self.weight_decay * ps.to(torch.float32)
            m.copy_(self.momentum * m + g)
            d = g + self.momentum * m if self.nesterov else m
            _store(p, (ps.to(torch.float32) - lr * d).to(p.dtype), i, zero)
        return OptState(step=step, mu=state.mu, nu=None)
