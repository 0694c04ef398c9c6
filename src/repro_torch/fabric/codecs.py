"""Gradient-codec registry: *what bits go on the wire*.

Port of ``repro/fabric/codecs.py``.  A codec owns the payload contract:
per-worker encode, reduction kind (``"mean"`` or ``"vote"``),
post-reduction decode, the zero gate and error-feedback capability
flags, and bits/element accounting.  Schedule backends
(:mod:`repro_torch.fabric.registry`) are the transport and ask the codec
instead of branching on a mode enum.

The reference's ``pallas_kernels()`` hook is named :meth:`GradientCodec.
kernel_set` here: it returns the codec's fused
:class:`~repro_torch.kernels.fused.KernelSet` (hand-written CUDA kernels),
whose signature (``kernel_signature()``) keys the session's built steps.
Each codec declares its simulator lane (:class:`CodecLane`), which
:class:`~repro_torch.sim.datapath.FlitPipeline` times.  The KV-cache
capability (``kv_cache``, ``kv_encode`` / ``kv_decode`` / ``kv_bytes``)
is what :mod:`repro_torch.serve` stores and prices cache blocks with.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.modes import AggregationMode, codec_name
from ..core.registry import Registry

__all__ = [
    "Codec", "CodecLane", "GradientCodec", "MaskGate", "available_codecs",
    "get_codec", "register_codec", "resolve_leaf_gate_mask",
    "ring_wire_bytes", "unregister_codec",
]


@dataclasses.dataclass(frozen=True)
class CodecLane:
    """Sim-datapath lane descriptor for one codec.

    The :class:`~repro_torch.sim.datapath.FlitPipeline` resolves a
    launch's lane from its codec, so a registered codec times in the
    simulator without a lane table.
    """
    name: str
    #: flits issued per initiation interval slot (usually 1).
    initiation_interval: float = 1.0
    #: extra stall cycles charged per flit (gate fetch, bypass hazards).
    stall_cycles_per_flit: float = 0.0
    #: the lane's stages run as one fused pipeline; an unfused lane
    #: re-fills the pipeline once per staged pass
    #: (:attr:`repro_torch.sim.datapath.FlitPipeline.unfused_passes`).
    fused: bool = False


class MaskGate:
    """Bucket zero gate carrying an explicit host keep mask."""

    def __init__(self, keep):
        self.keep = keep                 # host-side boolean (N,) array

    def mask(self) -> np.ndarray:
        return np.asarray(self.keep, bool)

    def vector(self, dtype, device="cpu") -> torch.Tensor:
        return torch.from_numpy(self.mask()).to(device=device, dtype=dtype)


_UNGATED_MASK_ERROR = (
    "codec {0!r} returned a leaf gate mask but declares gated=False; the "
    "vote transports only apply gates of gated codecs — set gated = True "
    "on the codec so the declared keep pattern actually takes effect")


def resolve_leaf_gate_mask(codec: "Codec", shape: Any, gate_phase: int):
    """A codec's per-leaf keep mask, validated against its ``gated`` flag."""
    mask = codec.leaf_gate_mask(shape, gate_phase)
    if mask is not None and not getattr(codec, "gated", False):
        raise ValueError(_UNGATED_MASK_ERROR.format(codec.name))
    return mask


def ring_wire_bytes(payload_bytes: float, num_workers: int,
                    trips: float = 2.0) -> float:
    """Ring-collective bytes/device for a payload (2 trips = all-reduce)."""
    if num_workers <= 1:
        return 0.0
    return trips * (num_workers - 1) / num_workers * payload_bytes


@runtime_checkable
class Codec(Protocol):
    """Structural protocol: ``name`` and ``bits_per_element``."""

    name: str
    bits_per_element: float


class GradientCodec:
    """Base codec: FP32-bypass defaults, hooks for every contract axis.

    ``reduction``        — ``"mean"`` or ``"vote"``.
    ``gated``            — the codec zero-gates the majority output.
    ``threads_ef``       — the codec consumes error-feedback residuals.
    ``lane``             — :class:`CodecLane` timing of the sim's flit
                           pipeline.
    ``default_schedule`` — transport used when a plan names none.
    """

    name: str = "identity"
    bits_per_element: float = 32.0
    reduction: str = "mean"
    gated: bool = False
    threads_ef: bool = False
    lane: CodecLane = CodecLane("fp32_bypass", fused=True)
    default_schedule: str = "psum"

    # -- mean-reduction hooks --------------------------------------------
    def encode(self, ctx: Any, g: Any) -> Any:
        """Per-worker wire representation of the gradient payload."""
        return g

    def decode(self, ctx: Any, u: Any) -> Any:
        """Post-reduction decode of the averaged payload."""
        return u

    # -- vote-reduction hooks --------------------------------------------
    def bucket_gate(self, bucket: Any):
        """Zero gate for a fused bucket (None when ungated).

        Gated codecs concatenate per-leaf :meth:`leaf_gate_mask` patterns,
        falling back per leaf to the 2-of-3 flat-index gate at the
        bucket's phase (each leaf restarting at its own index 0).
        """
        from ..core.buckets import BucketGate
        phase = bucket.key.gate_phase
        masks = [self.leaf_gate_mask(s.shape, phase) for s in bucket.slots]
        if not self.gated:
            if any(m is not None for m in masks):
                raise ValueError(_UNGATED_MASK_ERROR.format(self.name))
            return None
        if all(m is None for m in masks):
            return BucketGate(segments=tuple((s.size, phase)
                                             for s in bucket.slots))
        parts = []
        for slot, m in zip(bucket.slots, masks):
            if m is None:
                m = BucketGate(segments=((slot.size, phase),)).mask()
            parts.append(np.asarray(m, bool).reshape(-1))
        return MaskGate(np.concatenate(parts))

    def leaf_gate_mask(self, shape: Any, gate_phase: int):
        """Explicit keep mask for one leaf (None: the built-in 2-of-3)."""
        return None

    # -- fused kernels (the codec-owned kernel capability) ---------------
    def kernel_set(self):
        """The codec's fused :class:`~repro_torch.kernels.fused.KernelSet`
        (None when it brings none); the reference's ``pallas_kernels``."""
        return None

    def kernel_signature(self) -> str | None:
        """Step-cache key component for the codec's kernel set (or None)."""
        ks = self.kernel_set()
        return None if ks is None else ks.signature()

    # -- accounting ------------------------------------------------------
    def payload_bytes(self, n_elements: int) -> float:
        return n_elements * self.bits_per_element / 8.0

    # -- KV-cache capability (serving) -----------------------------------
    #: the codec can represent KV-cache blocks; sign-vote codecs cannot
    #: carry activations and stay False, mean-family codecs (the FP32
    #: bypass, quantizers) opt in and the serving engine routes every
    #: cache block through ``kv_encode`` / ``kv_decode``.
    kv_cache: bool = False

    def kv_encode(self, block: Any) -> Any:
        """Stored representation of one KV-cache block (a tensor on the
        engine's device, or a numpy array).  Lossy codecs return the
        dequantized values their wire codes decode to, as :meth:`encode`
        does; :meth:`kv_bytes` prices the codes."""
        return block

    def kv_decode(self, block: Any) -> Any:
        """Inverse of :meth:`kv_encode` (the identity for functional
        codecs)."""
        return block

    def kv_bytes(self, n_elements: int) -> float:
        """Resident or transferred bytes of ``n_elements`` cache values."""
        return self.payload_bytes(n_elements)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(name={self.name!r}, "
                f"bits={self.bits_per_element:.3g}, {self.reduction})")


def _prepare_codec(obj: Any, keys) -> Codec:
    codec = obj() if isinstance(obj, type) else obj
    if not isinstance(codec, Codec):
        raise TypeError(
            f"codec {keys[0]!r} must define 'name' and "
            f"'bits_per_element' (subclass GradientCodec)")
    return codec


_REGISTRY = Registry("codec", key_fn=codec_name, prepare=_prepare_codec,
                     register_hint="@register_codec({key!r})")


def register_codec(name: Any, *aliases: Any, override: bool = False):
    """Class/instance decorator registering a codec under ``name``."""
    return _REGISTRY.register(name, *aliases, override=override)


def unregister_codec(name: Any) -> None:
    """Remove a codec and every alias bound to the same instance."""
    _REGISTRY.unregister(name)


def get_codec(name: Any) -> Codec:
    """Resolve a codec name (str or AggregationMode enum) to its codec."""
    return _REGISTRY.get(name)


def available_codecs() -> tuple[str, ...]:
    return _REGISTRY.available()


# ---------------------------------------------------------------------------
# built-in codecs (the paper's Table 2 representations)
# ---------------------------------------------------------------------------

@register_codec(AggregationMode.FP32)
class Fp32Codec(GradientCodec):
    """Full-precision mean — warm-up / calibration / recovery bypass."""
    name = "fp32"
    bits_per_element = 32.0
    kv_cache = True           # serving: full-precision KV blocks


@register_codec(AggregationMode.IDENTITY)
class IdentityCodec(GradientCodec):
    """Original bytes (functional read-back checks only); FP32 accounting."""
    name = "identity"
    bits_per_element = 32.0
    kv_cache = True           # serving: passthrough KV blocks


@register_codec(AggregationMode.G_BINARY)
class GBinaryCodec(GradientCodec):
    """Majority sign aggregate, u = sgn(2c - W); 1 wire bit/element."""
    name = "gbinary"
    bits_per_element = 1.0
    reduction = "vote"
    threads_ef = True
    lane = CodecLane("sign_count", fused=True)
    default_schedule = "vote_psum"

    def kernel_set(self):
        from ..kernels.fused import vote_kernel_set
        return vote_kernel_set()


@register_codec(AggregationMode.G_TERNARY)
class GTernaryCodec(GradientCodec):
    """Gated ternary aggregate, u = m * sgn(2c - W), 2-of-3 zero gate.

    Counted at log2(3) bits/element (the paper's Table 6 accounting).
    """
    name = "gternary"
    bits_per_element = math.log2(3.0)
    reduction = "vote"
    gated = True
    threads_ef = True
    lane = CodecLane("ternary_gated", stall_cycles_per_flit=1.0, fused=True)
    default_schedule = "vote_psum"

    def kernel_set(self):
        # one kernel set: gbinary and gternary differ only in the gate
        from ..kernels.fused import vote_kernel_set
        return vote_kernel_set()
