"""Collectives over data-parallel workers: the port's stand-in for the
``jax.lax`` collectives under ``vmap(axis_name=...)`` / ``shard_map``.

A group is seen by the schedules through one interface:

  * inputs carry the group's *local ranks* on a leading axis
    (``rank()`` lists them);
  * reductions (``psum``, ``all_reduce_mean``) and ``all_gather`` return
    the replicated result once, without that axis, since every rank
    holds the same value;
  * ``all_to_all`` maps ``(local, W, ...)`` chunks addressed to each
    destination to ``(local, W, ...)`` chunks received from each source.

:class:`VirtualGroup` holds all W workers on one device, so its local
ranks are ``0..W-1`` and its collectives are sums, views and reshapes.
:class:`LocalGroup` is the host-local session of one worker (the
reference's ``Fabric()`` with no data-parallel axes): every collective is
the identity on a leading local-rank axis of one, and ``host_local``
tells the schedules that no collective separates their stages.  A
``torch.distributed``/NCCL group with one local rank per process fits
the same interface (ROADMAP queue 1), without touching the schedules.
"""
from __future__ import annotations

import torch


class VirtualGroup:
    """W virtual data-parallel workers held on one device."""

    host_local = False

    def __init__(self, num_workers: int):
        if num_workers < 1:
            raise ValueError(f"a group needs at least one worker, "
                             f"got {num_workers}")
        self.size = int(num_workers)

    def rank(self) -> tuple[int, ...]:
        """The ranks whose data sits on the leading axis, in order."""
        return tuple(range(self.size))

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.size:
            raise ValueError(f"expected a leading axis of {self.size} "
                             f"workers, got shape {tuple(x.shape)}")
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over workers (integer inputs sum in their own dtype)."""
        return self._local(x).sum(dim=0, dtype=x.dtype)

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over workers, as ``pmean``: the sum divided by W."""
        return self._local(x).sum(dim=0) / self.size

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(src, dst, ...) -> (dst, src, ...): a view, no copy."""
        self._local(x)
        if x.shape[1] != self.size:
            raise ValueError(f"all_to_all needs {self.size} chunks per "
                             f"worker, got shape {tuple(x.shape)}")
        return x.transpose(0, 1)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(W, rows, ...) -> (W * rows, ...), concatenated in rank order."""
        return self._local(x).reshape(-1, *x.shape[2:])

    def __repr__(self) -> str:
        return f"VirtualGroup({self.size})"


class LocalGroup(VirtualGroup):
    """The host-local group: one worker, no data-parallel axis.

    Inputs still carry a leading local-rank axis of one; reductions hand
    back its single entry unchanged (no sum is taken, so even -0.0 and
    NaN bits pass through, as ``psum`` over no axes gives them).
    """

    host_local = True

    def __init__(self):
        super().__init__(1)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._local(x)[0]

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        return self._local(x)[0]

    def __repr__(self) -> str:
        return "LocalGroup()"
