"""Gradient-traffic accounting and communication-time models.

Port of ``repro/core/traffic.py``.  Two views, kept apart as in the paper:

  * Payload accounting (paper Section 4 / Table 6): bits of the
    communicated representation per element, normalized to FP32.
  * Wire bytes per device under a concrete schedule (ring model), priced
    by the schedule backend itself so accounting and dispatch agree, and
    the modeled communication time on interconnect constants
    (:class:`IciModel`, :class:`MultiHopModel`).  The constants are the
    reference's modeled defaults, carried over as written so the modeled
    times equal the reference's to the bit; they describe no card of
    this port, and their times are model outputs, not measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from .buckets import AdmissionPlan, BucketLayout
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


def hop_wire_bytes_per_device(n_elements: int, mode: AggregationMode | str,
                              schedule: Schedule | str,
                              num_workers: int) -> tuple:
    """Per-hop wire bytes per device: one entry per route leg.

    A flat schedule is one leg (the :func:`wire_bytes_per_device`
    figure); a hierarchical codec (a registered
    :class:`~repro_torch.fabric.hierarchy.HopPlan`) reports one leg per
    hop, each priced by that hop backend's ring model at the hop's group
    size.  The legs always sum to :func:`wire_bytes_per_device`.
    """
    from ..fabric import get_schedule
    backend = get_schedule(wire_schedule(mode, schedule))
    fn = getattr(backend, "hop_wire_bytes_per_device", None)
    if fn is not None:
        return tuple(float(b) for b in fn(n_elements, mode, num_workers))
    return (wire_bytes_per_device(n_elements, mode, schedule, num_workers),)


# ---------------------------------------------------------------------------
# modeled communication time (paper Fig 7)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IciModel:
    """Ring-interconnect constants, the reference's modeled defaults as
    written in ``repro/core/traffic.py::IciModel`` (its TPU-v5e-like
    ICI); no speed of a card of this port."""
    #: bytes/s per link direction
    link_bytes_per_s: float = 50e9
    #: effective links usable by the collective
    links_per_chip: float = 1.0
    #: per-step latency of a ring stage
    hop_latency_s: float = 1e-6
    #: fixed dispatch cost per collective launch
    launch_overhead_s: float = 20e-6

    def collective_time(self, per_device_bytes: float, num_workers: int,
                        num_launches: int = 1) -> float:
        """Bandwidth term + per-launch latency (ring hops + dispatch);
        each of ``num_launches`` separate collectives pays the latency,
        the term bucket fusion amortizes."""
        bw = self.link_bytes_per_s * self.links_per_chip
        steps = max(2 * (num_workers - 1), 1)
        per_launch = steps * self.hop_latency_s + self.launch_overhead_s
        return per_device_bytes / bw + num_launches * per_launch


def modeled_comm_time(n_elements: int, mode: AggregationMode,
                      schedule: Schedule, num_workers: int,
                      ici: IciModel | None = None,
                      num_launches: int = 1) -> float:
    """One-aggregation communication time under the ring model."""
    ici = ici or IciModel()
    b = wire_bytes_per_device(n_elements, mode, schedule, num_workers)
    return ici.collective_time(b, num_workers, num_launches=num_launches)


def modeled_layout_comm_time(layout: BucketLayout, num_workers: int,
                             ici: IciModel | None = None) -> float:
    """Modeled comm time of one aggregation pass under a bucket layout:
    over every launch (a bucket or an unfused leaf), the bandwidth term
    of its route's summed legs and one launch latency."""
    ici = ici or IciModel()
    total = 0.0
    for key, n in layout.launches():
        legs = hop_wire_bytes_per_device(n, key.mode, key.schedule,
                                         num_workers)
        total += ici.collective_time(sum(legs), num_workers)
    return total


@dataclasses.dataclass(frozen=True)
class MultiHopModel:
    """Analytic counterpart of the sim's ``multihop`` topology, with the
    reference's modeled defaults as written in
    ``repro/core/traffic.py::MultiHopModel``: every route leg crosses its
    own link at ``link_bytes_per_s``, each leg adds one ``hop_latency_s``
    and each launch one ``launch_overhead_s``."""
    #: bytes/s per inter-hop link
    link_bytes_per_s: float = 25e9
    #: per-leg store-and-forward latency
    hop_latency_s: float = 2e-6
    #: fixed dispatch cost per launch
    launch_overhead_s: float = 5e-6

    def route_time(self, hop_bytes: Sequence[float],
                   num_launches: int = 1) -> float:
        """Serialized service of every leg + per-launch latency."""
        legs = [float(b) for b in hop_bytes]
        per_launch = (len(legs) * self.hop_latency_s
                      + self.launch_overhead_s)
        return (sum(legs) / self.link_bytes_per_s
                + num_launches * per_launch)


def modeled_layout_multihop_time(layout: BucketLayout, num_workers: int,
                                 model: MultiHopModel | None = None) -> float:
    """Modeled multihop comm time of one aggregation pass: each launch's
    legs (:func:`hop_wire_bytes_per_device`) through
    :meth:`MultiHopModel.route_time`."""
    model = model or MultiHopModel()
    return sum(
        model.route_time(
            hop_wire_bytes_per_device(n, key.mode, key.schedule,
                                      num_workers))
        for key, n in layout.launches())


#: Payload sizes of the paper's Fig 7 positioning experiment.
GPT2_XL_PARAMS = 1_557_611_200       # GPT-2 XL ~1.56B parameters
BERT_LARGE_PARAMS = 340_000_000
GPT3_PARAMS = 175_000_000_000
