"""The reference's examples (``examples/*.py``), ported: each runs as
``python -m repro_torch.examples.<name>`` and prints what the
reference's prints, with its assertions.

Each takes ``--device`` (``cuda`` by default; ``cpu`` on the CPU) and
its ``main()`` takes the reference's step and batch sizes as keyword
defaults, so that a caller may run fewer steps.  ``quickstart``,
``train_lm`` and ``serve_lm`` run on the reference's (data 4) x (model
2) mesh, one rank a process, under ``torchrun``:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.examples.serve_lm --device cpu

``--device cuda`` gives each rank the card ``cuda:LOCAL_RANK`` and NCCL;
``--device cuda:0`` puts every rank on that one card, over gloo (what a
machine with one card runs).  The others run in one process.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch

__all__ = ["init_mesh", "lead"]

#: how long a collective may wait for the other ranks before it fails
GROUP_TIMEOUT = timedelta(seconds=120)


def lead() -> bool:
    """Is this the process that prints (rank 0, or no torchrun)?"""
    return os.environ.get("RANK", "0") == "0"


def init_mesh(shape, device: str):
    """``(mesh, device)``: this process's rank of a
    :class:`~repro_torch.core.ProcessMesh` of ``shape`` under
    ``torchrun``, its process group initialised (NCCL when each rank has
    a card of its own, else gloo)."""
    import torch.distributed as dist

    from ..core import ProcessMesh, rank_device, resolve_device

    world = os.environ.get("WORLD_SIZE")
    n = 1
    for s in shape:
        n *= s
    if world is None or int(world) != n:
        raise SystemExit(
            f"a {tuple(shape)} mesh runs one rank a process: start it under "
            f"torchrun --standalone --nproc-per-node {n} (WORLD_SIZE is "
            f"{world})")
    own = torch.device(device)
    dev = rank_device(device) if own.index is None else resolve_device(own)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" and own.index is None else "gloo"
    dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
    return ProcessMesh(shape, device=dev), dev
