"""Hopper kernel: pack gradient signs into 32-bit word planes.

Replaces ``repro/kernels/sign_pack.py::sign_pack`` (the Pallas kernel
``_sign_pack_kernel``).  The CUDA source is ``csrc/sign_pack.cu``; its
note gives the design and the bound.  On a CPU tensor the wrapper runs
the plain twin :func:`sign_pack_plain`; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import build
from .ref import LANE, PACK
from .ref import sign_pack as sign_pack_plain  # the plain twin

_SYMBOL = {torch.float32: "sign_pack_f32", torch.bfloat16: "sign_pack_bf16"}


def sign_pack(plane: torch.Tensor) -> torch.Tensor:
    """Value plane (..., M, LANE) -> sign words (..., M // 32, LANE) int32.

    Leading axes (the W workers of a bucket) are packed in one launch.
    """
    if build.on_cpu(plane):
        return sign_pack_plain(plane)
    if plane.dtype not in _SYMBOL:
        raise TypeError(f"sign_pack takes float32 or bfloat16, "
                        f"got {plane.dtype}")
    if plane.dim() < 2 or plane.shape[-1] != LANE or plane.shape[-2] % PACK:
        raise ValueError(f"sign_pack needs (..., 32k, {LANE}) planes, "
                         f"got {tuple(plane.shape)}")
    if not plane.is_contiguous():
        raise ValueError("sign_pack needs a contiguous plane")
    out = torch.empty(plane.shape[:-2] + (plane.shape[-2] // PACK, LANE),
                      dtype=torch.int32, device=plane.device)
    if build.meta_call("sign_pack", (plane,), out):
        return out
    fn = build.bind("sign_pack", _SYMBOL[plane.dtype], 2, 1)
    build.check(fn(plane.data_ptr(), out.data_ptr(), out.numel(),
                   build.stream_ptr(plane.device)), "sign_pack")
    sign_pack.launches += 1
    return out


sign_pack.launches = 0
