"""Collectives over data-parallel workers: the port's stand-in for the
``jax.lax`` collectives under ``vmap(axis_name=...)`` / ``shard_map``.

A group is seen by the schedules through one interface:

  * inputs carry the group's *local ranks* on a leading axis
    (``rank()`` lists them);
  * reductions (``psum``, ``all_reduce_mean``) and ``all_gather`` return
    the replicated result once, without that axis, since every rank
    holds the same value;
  * ``all_to_all`` maps ``(local, W, ...)`` chunks addressed to each
    destination to ``(local, W, ...)`` chunks received from each source;
  * ``hop_groups(h)`` gives the worker groups of each hop of an
    ``h``-hop route (:mod:`repro_torch.fabric.hierarchy`): for each hop a
    tuple of groups, one for each block of this process's local ranks,
    in order.  Hop 0 reduces over the innermost data axis and hop ``i``
    over the axis ``i`` from it; each group's replicated result is one
    local rank of the next hop.  A one-hop route runs over the whole
    group.

:class:`VirtualGroup` holds all W workers on one device, so its local
ranks are ``0..W-1`` and its collectives are sums, views and reshapes.
:class:`LocalGroup` is the host-local session of one worker (the
reference's ``Fabric()`` with no data-parallel axes): every collective is
the identity on a leading local-rank axis of one, and ``host_local``
tells the schedules that no collective separates their stages.
:class:`DistributedGroup` is one rank per process over a
``torch.distributed`` process group (NCCL on the card, gloo on the
CPU): the reference's ``shard_map`` over its data-parallel mesh axes.
:class:`ProcessMesh` lays ranks out on the reference's ``(data, model)``
(or ``(pod, data, model)``) mesh and holds a data group and a model
group for this rank; :class:`VirtualMesh` is the same mesh with a model
axis of 1 on virtual workers in one process.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

#: callables ``fn(group, op, x)`` told of each collective a
#: :class:`DistributedGroup` makes, with the tensor it counts: the launch
#: dry-run's collective inventory (:mod:`repro_torch.launch.analysis`)
COLLECTIVE_OBSERVERS: list = []


class VirtualGroup:
    """W virtual data-parallel workers held on one device.

    ``VirtualGroup(W)`` has one data axis; ``VirtualGroup((outer,
    inner))`` (any number of extents, outermost first) lays its
    ``W = outer * inner`` workers out row-major over the axes, as the
    reference's nested ``vmap`` (``Fabric(dp_axes=("outer", "inner"))``):
    worker ``o * inner + i`` sits at ``(o, i)``.  Its collectives span
    all W workers; :meth:`hop_groups` splits them by axis.
    """

    host_local = False

    def __init__(self, num_workers):
        shape = tuple(int(s) for s in num_workers) \
            if isinstance(num_workers, (tuple, list)) else (int(num_workers),)
        if not shape or min(shape) < 1:
            raise ValueError(f"a group needs at least one worker on each "
                             f"axis, got {num_workers}")
        self.shape = shape
        self.size = math.prod(shape)

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

    def hop_groups(self, hops: int) -> list[tuple]:
        """Each hop's groups: hop ``h`` reduces over axis ``-1 - h``, one
        :class:`VirtualGroup` of its extent for every index of the axes
        outside it (row-major); a one-hop route takes the whole group."""
        if hops == 1:
            return [(self,)]
        if hops != len(self.shape):
            raise ValueError(_axes_error(hops, len(self.shape)))
        return [(VirtualGroup(self.shape[-1 - h]),)
                * math.prod(self.shape[:-1 - h]) for h in range(hops)]

    def __repr__(self) -> str:
        if len(self.shape) > 1:
            return f"VirtualGroup({self.shape})"
        return f"VirtualGroup({self.size})"


def _axes_error(hops: int, axes: int) -> str:
    return (f"a {hops}-hop route needs one data-parallel axis a hop, and "
            f"the group has {axes}; map one axis per hop (the innermost "
            f"is hop 0) or use a 1-hop plan")


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

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` (no leading rank axis) over the one rank: ``x`` itself
        (the model group of a :class:`VirtualMesh`)."""
        return x

    def hop_groups(self, hops: int) -> list[tuple]:
        """Every hop runs as its local round trip on this one worker."""
        return [(self,)] * hops

    def __repr__(self) -> str:
        return "LocalGroup()"


class DistributedGroup:
    """One data-parallel rank per process over a ``torch.distributed``
    process group (the default group when ``process_group`` is None).

    Inputs carry a leading local-rank axis of one.  ``psum`` and
    ``all_reduce_mean`` reduce into a buffer of their own and never
    write to their input (a float32 ``g.to(torch.float32)`` is the
    caller's gradient itself); ``all_reduce_mean`` is the sum divided by
    the world size, as :class:`VirtualGroup` takes it (gloo has no
    ``AVG``).  ``all_to_all`` sends the contiguous ``(W, rw, LANE)``
    chunks, so the owner shards come back contiguous, ``(1, W, rw,
    LANE)``.  Sums of ranks keep the sign of a zero sum (-0.0 + -0.0 is
    -0.0), where a virtual sum starts from +0.0.

    ``host_local`` is False at every world size: the reference's
    one-device mesh with ``dp_axes=("data",)`` still runs the collective
    chain.  Tensors must lie on ``device``; the group never moves one,
    and an NCCL group refuses CPU tensors.  ``calls_by_op`` and
    ``bytes_by_op`` count each collective and the bytes handed to it
    (``reset_counts()`` clears them): an instrument for the structure of
    a step's traffic, not a timer.

    ``axis_groups`` is None for a group with one data axis; on the data
    group of a ``(pod, data, model)`` :class:`ProcessMesh` it holds this
    rank's group along each data axis, outermost first, which
    :meth:`hop_groups` hands to the hops.
    """

    host_local = False

    def __init__(self, process_group=None, *, device):
        if not dist.is_initialized():
            raise RuntimeError("DistributedGroup needs an initialised "
                               "torch.distributed process group")
        self.process_group = process_group
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = str(dist.get_backend(process_group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group runs on a CUDA device, "
                             f"got {self.device}")
        self.size = dist.get_world_size(process_group)
        self._rank = dist.get_rank(process_group)
        self.calls_by_op: dict[str, int] = {}
        self.bytes_by_op: dict[str, int] = {}
        self.axis_groups: tuple | None = None

    def rank(self) -> tuple[int, ...]:
        """This process's rank, the one local rank."""
        return (self._rank,)

    def hop_groups(self, hops: int) -> list[tuple]:
        """Each hop's group: hop ``h`` runs over ``axis_groups[-1 - h]``;
        a one-hop route runs over this whole group."""
        if hops == 1:
            return [(self,)]
        axes = self.axis_groups or (self,)
        if hops != len(axes):
            raise ValueError(_axes_error(hops, len(axes)))
        return [(axes[-1 - h],) for h in range(hops)]

    def reset_counts(self) -> None:
        self.calls_by_op.clear()
        self.bytes_by_op.clear()

    def _count(self, op: str, x: torch.Tensor) -> None:
        self.calls_by_op[op] = self.calls_by_op.get(op, 0) + 1
        self.bytes_by_op[op] = (self.bytes_by_op.get(op, 0)
                                + x.numel() * x.element_size())
        for fn in COLLECTIVE_OBSERVERS:
            fn(self, op, x)

    def _on_device(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            raise ValueError(f"{self!r} holds tensors on {self.device}, "
                             f"got one on {x.device}")
        return x

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 0 or x.shape[0] != 1:
            raise ValueError(f"expected a leading axis of 1 local rank, "
                             f"got shape {tuple(x.shape)}")
        return self._on_device(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (integer inputs sum in their own dtype)."""
        return self.all_reduce(self._local(x)[0])

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` (no leading rank axis) reduced over the ranks by ``op``
        (``"sum"`` or ``"max"``) into a new tensor."""
        out = self._on_device(x).clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", out)
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.process_group)
        return out

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over ranks, as ``pmean``: the sum divided by W."""
        return self.psum(x) / self.size

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(1, W, ...) chunks addressed to each rank -> (1, W, ...) chunks
        received from each rank, in a contiguous buffer."""
        self._local(x)
        if x.dim() < 2 or x.shape[1] != self.size:
            raise ValueError(f"all_to_all needs {self.size} chunks per "
                             f"rank, got shape {tuple(x.shape)}")
        send = x[0].contiguous()
        out = torch.empty_like(send)
        self._count("all_to_all", send)
        dist.all_to_all_single(out, send, group=self.process_group)
        return out.unsqueeze(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(1, rows, ...) -> (W * rows, ...), concatenated in rank order."""
        send = self._local(x)[0].contiguous()
        out = torch.empty((self.size * send.shape[0], *send.shape[1:]),
                          dtype=send.dtype, device=send.device)
        self._count("all_gather", send)
        # all_gather_into_tensor, not its successor all_gather_single,
        # which torch 2.11 lacks
        dist.all_gather_into_tensor(out, send, group=self.process_group)
        return out

    def all_gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` (no leading rank axis) concatenated along
        ``dim``, in rank order."""
        out = self.all_gather(x.movedim(dim, 0)[None])
        return out.movedim(0, dim)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite ``x`` (no leading rank axis) with the value of the
        group's rank ``src``, in place; returns ``x``."""
        self._count("broadcast", self._on_device(x))
        if self.process_group is not None:
            src = dist.get_global_rank(self.process_group, src)
        dist.broadcast(x, src=src, group=self.process_group)
        return x

    def barrier(self) -> None:
        """Return once every rank has reached this call: a one-element
        all-reduce on the group's device, read back on the host."""
        flag = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._count("barrier", flag)
        dist.all_reduce(flag, group=self.process_group)
        flag.item()

    def __repr__(self) -> str:
        return (f"DistributedGroup(rank={self._rank}, size={self.size}, "
                f"backend={self.backend}, device={self.device})")


class ProcessMesh:
    """One rank a process on the reference's device mesh.

    ``shape`` gives the extents of ``("data", "model")`` (two entries) or
    ``("pod", "data", "model")`` (three), and the world size must be
    their product.  Rank ``r`` sits at the row-major coordinates of
    ``r`` (``r = d * M + m`` on two axes), the order in which
    ``jax.make_mesh`` lays out devices.  The data axes are every axis but
    ``"model"``: ``data_group`` holds the ``W = P * D`` ranks that share
    this rank's model index (the gradient aggregation's workers, ranked
    by their data index ``p * D + d``), ``model_group`` the ``M`` ranks
    that share its data coordinates (the tensor-parallel shards, ranked
    by ``m``), and ``world`` every rank.  On three axes ``axis_groups``
    adds this rank's group along each data axis: ``"pod"`` (the ``P``
    ranks that share its data and model indices) and ``"data"`` (the
    ``D`` ranks that share its pod and model indices), which the hops of
    a hop plan run over (hop 0 over ``data``, hop 1 over ``pod``, as the
    reference's ``dp_axes == ("pod", "data")`` places them).  Every rank
    creates every group, in one order, as ``dist.new_group`` requires.
    """

    def __init__(self, shape, *, device):
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"a mesh is (data, model) or (pod, data, "
                             f"model), got {shape}")
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group")
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, "
                             f"the process group {world}")
        self.axis_names = names
        self.extents = dict(zip(names, shape))
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        self.model_size = self.extents["model"]
        self.data_axes = names[:-1]
        self.data_size = world // self.model_size
        self.data_index = self.rank // self.model_size
        self.model_index = self.coords["model"]
        m = self.model_size
        data_groups = [dist.new_group(list(range(k, world, m)))
                       for k in range(m)]
        model_groups = [dist.new_group(list(range(k * m, (k + 1) * m)))
                        for k in range(self.data_size)]
        self.data_group = DistributedGroup(data_groups[self.model_index],
                                           device=device)
        self.model_group = DistributedGroup(model_groups[self.data_index],
                                            device=device)
        self.world = DistributedGroup(device=device)
        self.axis_groups: dict[str, DistributedGroup] = {}
        if len(shape) == 3:
            pods, dsize = shape[0], shape[1]
            at = self.coords
            along = {
                "pod": {(d, k): [(p * dsize + d) * m + k
                                 for p in range(pods)]
                        for d in range(dsize) for k in range(m)},
                "data": {(p, k): [(p * dsize + d) * m + k
                                  for d in range(dsize)]
                         for p in range(pods) for k in range(m)}}
            mine = {"pod": (at["data"], at["model"]),
                    "data": (at["pod"], at["model"])}
            for name in self.data_axes:
                groups = {key: dist.new_group(ranks)
                          for key, ranks in along[name].items()}
                self.axis_groups[name] = DistributedGroup(
                    groups[mine[name]], device=device)
            self.data_group.axis_groups = tuple(
                self.axis_groups[n] for n in self.data_axes)

    def coords_of(self, rank: int) -> dict:
        """The row-major coordinates of ``rank``."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.extents[name])
        return {n: out[n] for n in self.axis_names}

    def shard_view(self, spec, shape):
        """This rank's :class:`~repro_torch.runtime.shardings.ShardView`
        of a model-sharded leaf whose block has ``shape``."""
        from ..runtime.shardings import ShardView
        return ShardView(spec, shape, self.extents, self.coords,
                         self.model_group)

    def reset_counts(self) -> None:
        for g in (self.data_group, self.model_group, self.world,
                  *self.axis_groups.values()):
            g.reset_counts()

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.extents.items())
        return f"ProcessMesh({dims}; rank {self.rank} at {self.coords})"


class VirtualMesh:
    """The reference's ``(data, model)`` or ``(pod, data, model)`` mesh
    with a model axis of 1, its data axes held by virtual workers on one
    device (the reference's mesh of ``jax.make_mesh(shape)`` in one
    process).

    ``data_group`` is a :class:`VirtualGroup` of the data extents and
    ``model_group`` the one-rank :class:`LocalGroup`, so a session on it
    (``Fabric(mesh=VirtualMesh((W, 1)))``) resolves its policies with the
    partition specs as on a :class:`ProcessMesh` of the same shape, and
    a leaf specced over ``"model"`` keeps a launch of its own.  A model
    axis above 1 needs one rank a process: a :class:`ProcessMesh`.
    """

    def __init__(self, shape):
        shape = tuple(int(s) for s in shape)
        if len(shape) not in (2, 3) or shape[-1] != 1:
            raise ValueError(f"a virtual mesh is (data, 1) or (pod, data, "
                             f"1), got {shape}; a model axis above 1 runs "
                             f"one rank a process on a ProcessMesh")
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        self.axis_names = names
        self.extents = dict(zip(names, shape))
        self.coords = dict.fromkeys(names, 0)
        self.model_size, self.model_index = 1, 0
        self.data_axes = names[:-1]
        self.data_group = VirtualGroup(shape[:-1])
        self.data_size = self.data_group.size
        self.model_group = LocalGroup()
        self.world = self.data_group

    def shard_view(self, spec, shape):
        """The :class:`~repro_torch.runtime.shardings.ShardView` of a leaf
        specced over the model axis: its whole, on the one model rank."""
        from ..runtime.shardings import ShardView
        return ShardView(spec, shape, self.extents, self.coords,
                         self.model_group)

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in self.extents.items())
        return f"VirtualMesh({dims})"
