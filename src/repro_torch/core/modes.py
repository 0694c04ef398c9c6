"""Aggregation modes (codec names), schedules, and payload-bit accounting.

Port of ``repro/core/modes.py``.  A mode is a codec name; the codecs live
in the registry of :mod:`repro_torch.fabric.codecs`.
:class:`AggregationMode` names the four built-in codecs (its values are
their registry names):

  * ``identity`` — original bytes (functional read-back checks only).
  * ``fp32``     — full-precision mean aggregate (bypass path).
  * ``gbinary``  — majority sign aggregate, u = sgn(2c - W).
  * ``gternary`` — u = m * sgn(2c - W) with the fixed 2-of-3 zero gate.

Payload ratios count the bits of the communicated representation per
element, normalized to FP32 (paper Section 4); G-Ternary counts log2(3).
"""
from __future__ import annotations

import enum


class AggregationMode(str, enum.Enum):
    """The four built-in codecs, by registry name."""
    IDENTITY = "identity"
    FP32 = "fp32"
    G_BINARY = "gbinary"
    G_TERNARY = "gternary"


def codec_name(mode) -> str:
    """Canonical codec-registry key for a mode given as enum or string."""
    return mode.value if isinstance(mode, enum.Enum) else str(mode)


def canonical_mode(mode):
    """Built-in codec names to their enum member, anything else to str."""
    try:
        return AggregationMode(mode)
    except ValueError:
        return str(mode)


def bits_per_element(mode) -> float:
    """Communicated payload bits per gradient element, per codec."""
    from ..fabric.codecs import get_codec
    return get_codec(mode).bits_per_element


def traffic_ratio(mode) -> float:
    """Payload ratio against the FP32 baseline of the same transport
    (paper Section 4): ``bits_per_element(mode) / 32``."""
    return bits_per_element(mode) / 32.0


class Schedule(str, enum.Enum):
    """Collective schedule that carries a codec across the workers."""
    #: FP32 mean (all-reduce).
    PSUM = "psum"
    #: dense sign votes, one integer all-reduce, majority.
    VOTE_PSUM = "vote_psum"
    #: the controller schedule: pack -> all_to_all -> PopCount/majority
    #: kernel on the owner -> all_gather of the packed pair.
    PACKED_A2A = "packed_a2a"


def schedule_name(schedule) -> str:
    """Canonical registry key for a schedule given as enum or string."""
    return schedule.value if isinstance(schedule, enum.Enum) else str(schedule)


#: built-in schedules that only carry sign-vote payloads
_VOTE_ONLY_SCHEDULES = frozenset(
    {Schedule.VOTE_PSUM.value, Schedule.PACKED_A2A.value})


def wire_schedule(mode, schedule) -> str:
    """Schedule name actually used for a (codec, schedule) pair.

    Mean codecs planned on a vote schedule ride ``psum`` (the paper's
    bypass); vote codecs planned on ``psum`` ride ``vote_psum``; a
    hierarchical codec (a registered
    :class:`~repro_torch.fabric.hierarchy.HopPlan`) planned on any of the
    three rides ``hierarchical``, since its hops fix their own
    transports; a local-accumulation codec (``reduction == "local"``,
    the zero-wire ``local`` codec of :mod:`repro_torch.elastic.
    strategies`) planned on any of the three rides ``local_accum``, since
    a 0-bit payload on a real collective would ship FP32 bytes the
    traffic model prices at zero.  Any other schedule, registered custom
    backends included, is used as named.
    """
    from ..fabric.codecs import get_codec
    reduction = get_codec(mode).reduction
    name = schedule_name(schedule)
    routed = {"hierarchical": "hierarchical", "local": "local_accum"}
    if reduction in routed:
        if name in _VOTE_ONLY_SCHEDULES or name == Schedule.PSUM.value:
            return routed[reduction]
        return name
    votes = reduction == "vote"
    if not votes and name in _VOTE_ONLY_SCHEDULES:
        return Schedule.PSUM.value
    if votes and name == Schedule.PSUM.value:
        return Schedule.VOTE_PSUM.value
    return name
