"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  The port's mesh is a
:class:`~repro_torch.core.ProcessMesh`, one rank a process, which needs a
process group of the mesh's size; without one these functions return the
mesh's extents ``{axis: size}``.  The launch dry-run
(:mod:`repro_torch.launch.dryrun`) plays rank 0 of a 256- or 512-rank
mesh under a fake process group, on ``meta`` tensors.
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _mesh(shape: tuple, axes: tuple, device):
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        from ..core import ProcessMesh
        return ProcessMesh(shape, device=device)
    return dict(zip(axes, shape))


def make_production_mesh(*, multi_pod: bool = False, device="meta"):
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: ('data', 'model') single-pod; ('pod', 'data', 'model') multi-pod.
    The 'pod' axis is outer data-parallelism across the (thin) inter-pod
    links, the boundary where NEURON-Fabric's low-bit gradient
    aggregation buys the most (DESIGN.md §4).  A ProcessMesh on
    ``device`` when a process group of that size is up, else the
    extents.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), device="cpu"):
    """A small ``(data, model)`` or ``(pod, data, model)`` mesh: a
    ProcessMesh on ``device`` under a process group of its size, else its
    extents."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return _mesh(tuple(shape), names, device)


def dp_axes_of(mesh) -> tuple:
    """The data-parallel (gradient aggregation) axes of a mesh: every
    axis but 'model' (of a ProcessMesh, or of its extents)."""
    names = getattr(mesh, "axis_names", None) or tuple(mesh)
    return tuple(a for a in names if a != "model")
