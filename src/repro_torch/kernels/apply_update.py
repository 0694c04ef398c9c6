"""Hopper kernel: decode a ternary packed pair to {-1, 0, +1} values.

Replaces ``repro/kernels/apply_update.py::unpack_ternary`` (the Pallas
kernel ``_unpack_ternary_kernel``).  The CUDA source is
``csrc/unpack_ternary.cu``.  ``apply_sign_update`` (the module's other
TPU kernel) has no caller on the main path and is still to port (ROADMAP
queue 2).
"""
from __future__ import annotations

import torch

from . import build
from .ref import LANE, PACK
from .ref import unpack_ternary as unpack_ternary_plain  # the plain twin


def unpack_ternary(sign_words: torch.Tensor,
                   mask_words: torch.Tensor) -> torch.Tensor:
    """Ternary packed pair (..., R, LANE) -> float32 plane (..., 32R, LANE)."""
    if build.on_cpu(sign_words, mask_words):
        return unpack_ternary_plain(sign_words, mask_words)
    for t in (sign_words, mask_words):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("unpack_ternary takes contiguous int32 words")
    if sign_words.shape != mask_words.shape or sign_words.shape[-1] != LANE:
        raise ValueError(f"unpack_ternary needs two (..., R, {LANE}) word "
                         f"planes, got {tuple(sign_words.shape)} and "
                         f"{tuple(mask_words.shape)}")
    out = torch.empty(sign_words.shape[:-2]
                      + (sign_words.shape[-2] * PACK, LANE),
                      dtype=torch.float32, device=sign_words.device)
    fn = build.bind("unpack_ternary", "unpack_ternary_f32", 3, 1)
    build.check(fn(sign_words.data_ptr(), mask_words.data_ptr(),
                   out.data_ptr(), out.numel(),
                   build.stream_ptr(sign_words.device)), "unpack_ternary")
    unpack_ternary.launches += 1
    return out


unpack_ternary.launches = 0
