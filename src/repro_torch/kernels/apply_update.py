"""Hopper kernels: decode a ternary packed pair, and apply it to a plane.

Replaces ``repro/kernels/apply_update.py``: :func:`unpack_ternary` (the
Pallas kernel ``_unpack_ternary_kernel``, CUDA ``csrc/unpack_ternary.cu``)
and :func:`apply_sign_update` (``_apply_sign_update_kernel``, CUDA
``csrc/apply_sign_update.cu``), which reads a parameter plane once and
writes ``param - scale * u`` without materialising u.  Both move 16
bytes an access: unpack_ternary gives a thread 4 lanes of one word row
and walks its 32 rows, apply_sign_update gives a thread 8 lanes of one
row and finds its words in cache.  The scale of ``apply_sign_update``
reaches its kernel by value or through a device pointer, so no call
synchronises.  Neither package calls ``apply_sign_update`` from its training path; it
is here for parity with the reference's kernel set.
"""
from __future__ import annotations

import torch

from . import build
from .ref import LANE, PACK
from .ref import apply_sign_update as apply_sign_update_plain  # the twins
from .ref import unpack_ternary as unpack_ternary_plain


_UNPACK_SYMBOL = {torch.float32: "unpack_ternary_f32",
                  torch.bfloat16: "unpack_ternary_bf16"}


def unpack_ternary(sign_words: torch.Tensor, mask_words: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Ternary packed pair (..., R, LANE) -> plane (..., 32R, LANE) of
    {-1, 0, +1} in ``dtype`` (float32 or bfloat16; both hold the three
    values exactly, so the bits equal a float32 decode cast to ``dtype``)."""
    if dtype not in _UNPACK_SYMBOL:
        raise TypeError(f"unpack_ternary decodes to float32 or bfloat16, "
                        f"got {dtype}")
    if build.on_cpu(sign_words, mask_words):
        return unpack_ternary_plain(sign_words, mask_words, dtype)
    for t in (sign_words, mask_words):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("unpack_ternary takes contiguous int32 words")
        if t.data_ptr() % 16:
            raise ValueError("unpack_ternary needs 16-byte aligned words")
    if sign_words.shape != mask_words.shape or sign_words.shape[-1] != LANE:
        raise ValueError(f"unpack_ternary needs two (..., R, {LANE}) word "
                         f"planes, got {tuple(sign_words.shape)} and "
                         f"{tuple(mask_words.shape)}")
    out = torch.empty(sign_words.shape[:-2]
                      + (sign_words.shape[-2] * PACK, LANE),
                      dtype=dtype, device=sign_words.device)
    if build.meta_call("unpack_ternary", (sign_words, mask_words), out):
        return out
    fn = build.bind("unpack_ternary", _UNPACK_SYMBOL[dtype], 3, 1)
    build.check(fn(sign_words.data_ptr(), mask_words.data_ptr(),
                   out.data_ptr(), sign_words.numel(),
                   build.stream_ptr(sign_words.device)), "unpack_ternary")
    unpack_ternary.launches += 1
    unpack_ternary.launches_by_dtype[dtype] += 1
    return out


unpack_ternary.launches = 0
#: the same launches split by output dtype (the two kernels of the source)
unpack_ternary.launches_by_dtype = dict.fromkeys(_UNPACK_SYMBOL, 0)


_PARAM_SYMBOL = {torch.float32: "apply_sign_update_f32",
                 torch.bfloat16: "apply_sign_update_bf16"}


def apply_sign_update(param_plane: torch.Tensor, sign_words: torch.Tensor,
                      mask_words: torch.Tensor, scale) -> torch.Tensor:
    """``param - scale * decode(sign, mask)`` over a value plane (M, LANE)
    of float32 or bfloat16, in float32 and rounded once to the plane's
    dtype.  ``scale`` is a float, rounded to float32 as
    ``torch.tensor(scale, dtype=torch.float32)`` rounds it, or a
    one-element tensor on the plane's device, read as float32.

    On the card neither kind waits for the device: a float goes to the
    kernel by value, and the kernel reads a tensor through its pointer
    (a float32 tensor is passed as it is, another dtype is cast on the
    stream first)."""
    tensor_scale = isinstance(scale, torch.Tensor)
    operands = (param_plane, sign_words, mask_words) + (
        (scale,) if tensor_scale else ())
    if build.on_cpu(*operands):
        return apply_sign_update_plain(param_plane, sign_words, mask_words,
                                       scale)
    if param_plane.dtype not in _PARAM_SYMBOL:
        raise TypeError(f"apply_sign_update takes float32 or bfloat16 "
                        f"parameters, got {param_plane.dtype}")
    m = param_plane.shape[0] if param_plane.dim() == 2 else -1
    if (m < 0 or param_plane.shape[1] != LANE or m % PACK
            or sign_words.shape != (m // PACK, LANE)
            or mask_words.shape != sign_words.shape
            or (tensor_scale and scale.numel() != 1)):
        raise ValueError(f"apply_sign_update shapes disagree: param "
                         f"{tuple(param_plane.shape)}, words "
                         f"{tuple(sign_words.shape)} and "
                         f"{tuple(mask_words.shape)}, scale "
                         f"{tuple(scale.shape) if tensor_scale else ()}")
    for t in (param_plane, sign_words, mask_words):
        if not t.is_contiguous():
            raise ValueError("apply_sign_update needs contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError("apply_sign_update needs 16-byte aligned "
                             "operands")
    if sign_words.dtype != torch.int32 or mask_words.dtype != torch.int32:
        raise TypeError("apply_sign_update takes int32 words")
    if tensor_scale:
        scale = scale.to(torch.float32)
        scale_ptr, value = scale.data_ptr(), 0.0
    else:
        scale_ptr, value = None, float(scale)
    out = torch.empty_like(param_plane)
    if build.meta_call("apply_sign_update", (param_plane, sign_words,
                                             mask_words) + (
            (scale,) if tensor_scale else ()), out):
        return out
    fn = build.bind("apply_sign_update", _PARAM_SYMBOL[param_plane.dtype],
                    5, 1, 1)
    build.check(fn(param_plane.data_ptr(), sign_words.data_ptr(),
                   mask_words.data_ptr(), scale_ptr, out.data_ptr(),
                   out.numel(), value, build.stream_ptr(param_plane.device)),
                "apply_sign_update")
    apply_sign_update.launches += 1
    return out


apply_sign_update.launches = 0
