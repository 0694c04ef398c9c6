"""Partition specs over a process mesh: divisibility-safe specs, shard
shapes and the blocks each rank holds.

Port of ``repro/runtime/shardings.py``, with the port's own helpers.  A
spec is a tuple with one entry per leading dimension of a leaf: ``None``
(replicated), a mesh axis name (``"model"``) or a tuple of names
(``("pod", "data")``, the ZeRO-1 moments), as the reference's
``PartitionSpec`` holds them; ``()`` is fully replicated.  A mesh is
named by its extents, a mapping ``{axis: size}``, and a rank by its
coordinates ``{axis: index}``.

Block ``k`` of a dimension sharded over axes ``(a, b)`` is the ``k``-th
of ``|a| * |b|`` equal slices, ``k = i_a * |b| + i_b`` (row-major over
the entry's axes): the slice ``jax.shard_map`` hands the device at those
coordinates.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from ..core import tree as T

Spec = tuple


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(extents: Mapping[str, int], entry) -> int:
    """The number of blocks a spec entry cuts its dimension into."""
    n = 1
    for a in _axes(entry):
        n *= int(extents[a])
    return n


def sanitize_spec(spec, shape, extents: Mapping[str, int]) -> Spec:
    """A spec with every entry that does not divide its dimension
    replaced by None (replication), padded with None to ``len(shape)``;
    None stands for ``()``."""
    if spec is None:
        return ()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(e if e is not None and dim % axis_size(extents, e) == 0
                 else None for e, dim in zip(entries, shape))


def sanitize_pspecs(spec_tree: Any, like_tree: Any,
                    extents: Mapping[str, int]) -> dict:
    """Spec tree + tree of shaped leaves -> divisibility-safe spec tree
    (path -> spec, nested as ``like_tree``; a spec tuple is a leaf of
    :mod:`repro_torch.core.tree`)."""
    items = T.flatten(like_tree)
    specs = T.leaves(spec_tree)
    if len(specs) != len(items):
        raise ValueError(f"spec tree mismatch: {len(specs)} specs vs "
                         f"{len(items)} leaves")
    return T.unflatten([(p, sanitize_spec(s, tuple(x.shape), extents))
                        for (p, x), s in zip(items, specs)])


def dim_of(spec, axis: str) -> int | None:
    """The dimension a spec shards over ``axis`` (alone or with other
    axes), or None."""
    for d, e in enumerate(spec or ()):
        if e is not None and axis in _axes(e):
            return d
    return None


def local_shape(shape, spec, extents: Mapping[str, int]) -> tuple:
    """The shape of one rank's block of a leaf of ``shape``."""
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    out = []
    for e, dim in zip(entries, shape):
        n = 1 if e is None else axis_size(extents, e)
        if dim % n:
            raise ValueError(f"spec {spec} does not divide shape "
                             f"{tuple(shape)} on {dict(extents)}")
        out.append(dim // n)
    return tuple(out)


def block_index(entry, extents: Mapping[str, int],
                coords: Mapping[str, int]) -> int:
    """The block of a dimension sharded by ``entry`` that ``coords``
    hold: row-major over the entry's axes."""
    k = 0
    for a in _axes(entry):
        k = k * int(extents[a]) + int(coords[a])
    return k


def block_slices(shape, spec, extents: Mapping[str, int],
                 coords: Mapping[str, int]) -> tuple:
    """Per-dimension slices of the block ``coords`` hold."""
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    out = []
    for e, dim in zip(entries, shape):
        if e is None:
            out.append(slice(None))
            continue
        n = dim // axis_size(extents, e)
        k = block_index(e, extents, coords)
        out.append(slice(k * n, (k + 1) * n))
    return tuple(out)


def shard_of(full, spec, extents: Mapping[str, int],
             coords: Mapping[str, int]):
    """The block of ``full`` (a tensor or array) that ``coords`` hold: a
    view."""
    return full[block_slices(tuple(full.shape), spec, extents, coords)]


def place(full, block, spec, extents: Mapping[str, int],
          coords: Mapping[str, int]):
    """The inverse of :func:`shard_of`: write ``block`` where ``coords``'
    block of ``full`` lies (in place); returns ``full``."""
    full[block_slices(tuple(full.shape), spec, extents, coords)] = block
    return full


def global_shape(shape, spec, extents: Mapping[str, int]) -> tuple:
    """The whole leaf's shape from one block's."""
    entries = list(spec or ()) + [None] * (len(shape) - len(spec or ()))
    return tuple(dim * (1 if e is None else axis_size(extents, e))
                 for e, dim in zip(entries, shape))


class ShardView:
    """One rank's block of a leaf sharded over the model axis, as the
    schedules that work on the whole (GSPMD) leaf see it: the 2-of-3
    gate at the block's *global* flat indices, and means over the whole
    leaf, summed over the model group.

    ``spec`` is the leaf's sanitized spec, ``shape`` its block's shape;
    ``group`` the model group (a
    :class:`~repro_torch.core.collectives.DistributedGroup`).
    """

    def __init__(self, spec, shape, extents: Mapping[str, int],
                 coords: Mapping[str, int], group):
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.extents, self.coords = dict(extents), dict(coords)
        self.global_shape = global_shape(self.shape, self.spec, extents)
        self.group = group
        self.numel = 1
        for s in self.global_shape:
            self.numel *= s

    def gate(self, phase: int, dtype=torch.float32,
             device="cpu") -> torch.Tensor:
        """``((flat + phase) % 3) != 2`` at the global flat index of every
        element of the block, in the block's shape."""
        sl = block_slices(self.global_shape, self.spec, self.extents,
                          self.coords)
        total = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        nd = len(self.shape)
        for d in reversed(range(nd)):
            idx = torch.arange(sl[d].start or 0,
                               (sl[d].start or 0) + self.shape[d],
                               device=device)
            term = (idx % 3) * (stride % 3) % 3
            total = total + term.reshape((-1,) + (1,) * (nd - 1 - d))
            stride *= self.global_shape[d]
        return (((total + phase) % 3) != 2).to(dtype)

    def block(self, full):
        """This rank's block of a whole-leaf tensor or array."""
        return shard_of(full, self.spec, self.extents, self.coords)

    def mean_abs(self, x: torch.Tensor) -> torch.Tensor:
        """``mean|x|`` over the whole leaf for each local rank's row of
        ``x`` (``(L, *shape)``): the block's sums added over the model
        group, divided by the leaf's element count."""
        part = x.abs().reshape(x.shape[0], -1).sum(dim=1)
        return self.group.psum(part[None]) / self.numel
