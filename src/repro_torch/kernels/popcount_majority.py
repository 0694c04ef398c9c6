"""Hopper kernels: the staged vote's PopCount and majority stages.

Replaces ``repro/kernels/popcount_majority.py`` (the Pallas kernels
``_popcount_stack_kernel`` and ``_majority_decode_kernel``).  The CUDA
sources are ``csrc/popcount_stack.cu`` and ``csrc/majority_decode.cu``;
their notes give the design and the bound.  These two run only on the
staged chain (``Fabric(fused_kernels=False)``), which writes the int32
counts between them; the fused chain's ``vote_combine`` does both in
registers.  On CPU tensors the wrappers run the plain twins; on CUDA
tensors they launch the kernels or raise.
"""
from __future__ import annotations

import torch

from . import build
from .ref import LANE, PACK
from .ref import majority_decode as majority_decode_plain  # the plain twin
from .ref import popcount_stack as popcount_stack_plain    # the plain twin


def popcount_stack(packed: torch.Tensor) -> torch.Tensor:
    """Sign words (W, R, LANE) or (B, W, R, LANE) -> int32 vote counts
    (32R, LANE) or (B, 32R, LANE).

    The owner (B) and worker (W) axes may have any stride, so the
    transposed view a virtual all_to_all returns is taken as it is.
    """
    if build.on_cpu(packed):
        return popcount_stack_plain(packed)
    p4 = packed if packed.dim() == 4 else packed.unsqueeze(0)
    if p4.dim() != 4 or p4.shape[-1] != LANE:
        raise ValueError(f"popcount_stack needs (B, W, R, {LANE}) words, "
                         f"got {tuple(packed.shape)}")
    if p4.dtype != torch.int32:
        raise TypeError("popcount_stack takes int32 words")
    if p4.stride(3) != 1 or p4.stride(2) != LANE:
        raise ValueError("popcount_stack needs rows and lanes contiguous")
    b, w, r, _ = p4.shape
    counts = torch.empty((b, r * PACK, LANE), dtype=torch.int32,
                         device=p4.device)
    if build.meta_call("popcount_stack", (p4,), counts):
        return counts if packed.dim() == 4 else counts[0]
    fn = build.bind("popcount_stack", "popcount_stack_u32", 2, 5)
    build.check(fn(p4.data_ptr(), counts.data_ptr(), b, w, r, p4.stride(0),
                   p4.stride(1), build.stream_ptr(p4.device)),
                "popcount_stack")
    popcount_stack.launches += 1
    return counts if packed.dim() == 4 else counts[0]


popcount_stack.launches = 0


def majority_decode(counts: torch.Tensor, gate_words: torch.Tensor, *,
                    num_workers: int):
    """Vote counts (..., 32R, LANE) + gate (..., R, LANE) -> ternary
    packed pair ``(sign_words, mask_words)``, each shaped like the gate.

    a = 2c - W in int32; sign bit = a > 0; mask bit = (a != 0) & gate.
    """
    if build.on_cpu(counts, gate_words):
        return majority_decode_plain(counts, num_workers, gate_words)
    if counts.dtype != torch.int32 or gate_words.dtype != torch.int32:
        raise TypeError("majority_decode takes int32 counts and gate words")
    if (counts.dim() < 2 or counts.shape[-1] != LANE
            or counts.shape[:-2] != gate_words.shape[:-2]
            or counts.shape[-2] != gate_words.shape[-2] * PACK
            or gate_words.shape[-1] != LANE):
        raise ValueError(f"majority_decode shapes disagree: counts "
                         f"{tuple(counts.shape)}, gate "
                         f"{tuple(gate_words.shape)}")
    if not (counts.is_contiguous() and gate_words.is_contiguous()):
        raise ValueError("majority_decode needs contiguous operands")
    sign = torch.empty_like(gate_words)
    mask = torch.empty_like(gate_words)
    if build.meta_call("majority_decode", (counts, gate_words),
                       (sign, mask)):
        return sign, mask
    fn = build.bind("majority_decode", "majority_decode_u32", 4, 2)
    build.check(fn(counts.data_ptr(), gate_words.data_ptr(), sign.data_ptr(),
                   mask.data_ptr(), gate_words.numel(), num_workers,
                   build.stream_ptr(counts.device)), "majority_decode")
    majority_decode.launches += 1
    return sign, mask


majority_decode.launches = 0
