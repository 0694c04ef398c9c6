"""Optimizers (port of ``repro/optim/optimizers.py:25-118``).

The aggregate the fabric returns (an FP32 mean or a {-1, 0, +1}
direction) goes to an unmodified AdamW / SGD-momentum, with float32
moments.  The learning-rate schedule and ``b ** step`` are computed in
float32 tensors, as the reference computes them.

Unlike the reference's pure ``apply``, the port updates parameters and
moments in place (the parameter copy is the model's own, and a second
copy of a full model's moments would double their memory); ``apply``
returns the new :class:`OptState`, whose moment tensors are the old ones.
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


def _zeros(tree: Any) -> dict:
    return T.map_leaves(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), tree)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.0

    def init(self, params: Any) -> OptState:
        raise NotImplementedError

    def apply(self, params: Any, grads: Any, state: OptState) -> OptState:
        raise NotImplementedError

    def _lr(self, step):
        return lr_schedule(step, peak_lr=self.peak_lr,
                           warmup_steps=self.warmup_steps,
                           total_steps=self.total_steps)


@dataclasses.dataclass(frozen=True)
class AdamW(Optimizer):
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Any) -> OptState:
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=_zeros(params), nu=_zeros(params))

    @torch.no_grad()
    def apply(self, params, grads, state):
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        dev = T.leaves(params)[0].device
        # the scalars move to the device once per step, not once per leaf
        lr, c1, c2 = torch.stack([self._lr(step), 1 - torch.pow(b1, stepf),
                                  1 - torch.pow(b2, stepf)]).to(dev)
        for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                              T.leaves(state.mu), T.leaves(state.nu)):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return OptState(step=step, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class SgdMomentum(Optimizer):
    momentum: float = 0.9
    nesterov: bool = False

    def init(self, params: Any) -> OptState:
        return OptState(step=torch.zeros((), dtype=torch.int32),
                        mu=_zeros(params), nu=None)

    @torch.no_grad()
    def apply(self, params, grads, state):
        step = state.step + 1
        lr = self._lr(step).to(T.leaves(params)[0].device)
        for p, g, m in zip(T.leaves(params), T.leaves(grads),
                           T.leaves(state.mu)):
            g = g.to(torch.float32)
            if self.weight_decay:
                g = g + self.weight_decay * p.to(torch.float32)
            m.copy_(self.momentum * m + g)
            d = g + self.momentum * m if self.nesterov else m
            p.copy_((p.to(torch.float32) - lr * d).to(p.dtype))
        return OptState(step=step, mu=state.mu, nu=None)
