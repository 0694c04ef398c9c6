"""Extension codecs beyond the paper, registered through the public seam.

Port of ``repro/fabric/extra_codecs.py``.  Both ride the ``psum`` mean
transport, fuse into 32 MiB buckets and show up in the traffic model
without an edit to a schedule backend:

  * ``int4`` — symmetric 4-bit quantized mean (absmax scale, round half
    to even): 8x payload reduction against FP32 with a mean update.
  * ``topk`` — magnitude top-k sparsified mean: each worker keeps its
    ``fraction`` largest |g| (ties at the threshold too), accounted at
    ``fraction * 64`` bits/element (a 32-bit value and index per entry).

Statistics are per worker, as the reference's ``encode`` under ``vmap``
computes them: ``encode(ctx, g)`` gets ``(W, ...)`` and reduces over
every axis but the first.  The granularity is the collective payload
(the leaf per leaf, the bucket when bucketed), so the two paths agree
in meaning, not bit for bit.  Each ``encode`` is its kernel set's
(:class:`~repro_torch.kernels.fused.Int4KernelSet`,
:class:`~repro_torch.kernels.fused.TopKKernelSet`): the ``int4_quant``
and ``threshold_mask`` kernels on the card, their plain twins on the CPU.
"""
from __future__ import annotations

import functools

import torch

from .codecs import CodecLane, GradientCodec, register_codec

__all__ = ["Int4Codec", "TopKCodec"]


@functools.lru_cache(maxsize=None)
def _int4_kernels(levels: float):
    from ..kernels.fused import Int4KernelSet
    return Int4KernelSet(levels=levels)


@functools.lru_cache(maxsize=None)
def _topk_kernels(fraction: float):
    from ..kernels.fused import TopKKernelSet
    return TopKKernelSet(fraction)


@register_codec("int4")
class Int4Codec(GradientCodec):
    """Symmetric absmax int4 quantization of each worker's payload.

    ``encode`` returns the dequantized values: the wire carries the 4-bit
    codes and one scale, and the mean of the dequantized payloads is the
    aggregate those codes decode to.
    """

    name = "int4"
    bits_per_element = 4.0
    lane = CodecLane("int4_dense", fused=True)
    default_schedule = "psum"
    kv_cache = True

    #: symmetric int4 code range: {-7, ..., +7}
    levels = 7.0

    def kernel_set(self):
        return _int4_kernels(self.levels)

    def encode(self, ctx, g):
        return self.kernel_set().encode_flat(
            g.reshape(g.shape[0], -1)).reshape(g.shape)

    def kv_encode(self, block):
        """Per-block absmax int4 quantization of a KV-cache block (a
        tensor, or anything ``torch.as_tensor`` takes), idempotent: a
        block already on the int4 grid comes back as is.

        The block is quantized where it lies, without a host sync: the
        scale is the reference's ``float(max|x|) / 7`` in float64, taken
        to float32 for the division and the product as numpy takes the
        Python float.  Decode and pricing are the base class's
        (``kv_bytes`` is the 4-bit payload)."""
        block = torch.as_tensor(block)
        f = block.to(torch.float32)
        scale = f.abs().amax().to(torch.float64) / self.levels
        s32 = scale.to(torch.float32)
        q = torch.clamp(torch.round(f / s32), -self.levels, self.levels)
        return torch.where(scale <= 0.0, block, (q * s32).to(block.dtype))


@register_codec("topk")
class TopKCodec(GradientCodec):
    """Magnitude top-k sparsified mean (each worker keeps its largest |g|).

    ``fraction`` of each worker's payload survives, plus any ties at the
    threshold.  Parameterized variants register as instances:
    ``register_codec("top1pct")(TopKCodec(0.01, name="top1pct"))``.
    """

    lane = CodecLane("sparse_topk", fused=True)
    default_schedule = "psum"

    def __init__(self, fraction: float = 1 / 16, name: str = "topk"):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.name = str(name)

    def kernel_set(self):
        return _topk_kernels(self.fraction)

    @property
    def bits_per_element(self) -> float:
        # 32-bit value + 32-bit index per kept entry
        return 64.0 * self.fraction

    def encode(self, ctx, g):
        return self.kernel_set().encode_flat(
            g.reshape(g.shape[0], -1)).reshape(g.shape)
