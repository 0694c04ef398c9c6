"""Gradient-traffic accounting (port of ``repro/core/traffic.py:29-88``).

  * Payload accounting (paper Section 4 / Table 6): bits of the
    communicated representation per element, normalized to FP32.
  * Wire bytes per device under a concrete schedule (ring model), priced
    by the schedule backend itself so accounting and dispatch agree.
"""
from __future__ import annotations

from typing import Mapping

from .buckets import AdmissionPlan
from .modes import AggregationMode, Schedule, bits_per_element, wire_schedule


def payload_bytes(n_elements: int, mode: AggregationMode | str) -> float:
    """Communicated payload bytes for one aggregation of n elements."""
    return n_elements * bits_per_element(mode) / 8.0


def plan_traffic_ratio(sizes: Mapping[str, int], plan: AdmissionPlan) -> float:
    """Traffic vs FP32 for an admission plan over the given group sizes."""
    total = sum(sizes.values())
    if total == 0:
        return 1.0
    lowbit = sum(n * bits_per_element(plan.policy_for(g).mode)
                 for g, n in sizes.items())
    return lowbit / (32.0 * total)


def wire_bytes_per_device(n_elements: int, mode: AggregationMode | str,
                          schedule: Schedule | str, num_workers: int) -> float:
    """Ring-model bytes per device for one aggregation of n elements.

    psum       : 2 (W-1)/W * codec bytes
    vote_psum  : 2 (W-1)/W * 1N          (the paper's 1-byte vote)
    packed_a2a : (W-1)/W * (N/8 + N/4)   (packed signs out, pair back)
    """
    if num_workers <= 1:
        return 0.0
    from ..fabric import get_schedule
    backend = get_schedule(wire_schedule(mode, schedule))
    fn = getattr(backend, "wire_bytes_per_device", None)
    if fn is None:
        raise ValueError(f"schedule {schedule!r} has no wire-byte model; "
                         f"give its backend a wire_bytes_per_device method")
    return fn(n_elements, mode, num_workers)
