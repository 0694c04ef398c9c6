"""Device selection for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for and absent; there is no
    silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device, and none is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def rank_device(device="cuda") -> torch.device:
    """This process's device in a one-rank-per-process job: the card
    ``cuda:LOCAL_RANK`` (the local rank ``torchrun`` sets; 0 without
    one), or the CPU when the caller asks for it.  Raises when that card
    is absent, as :func:`resolve_device` does."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local} names a card this machine "
                           f"lacks: it has {torch.cuda.device_count()}")
    return torch.device("cuda", local)
