"""Pluggable interconnect topologies for the fabric simulator.

Port of ``repro/sim/topology.py``. Every link rate and latency below is
the reference's modeled default, carried over as written; none is the
speed of a card of this port. A topology maps one collective *launch*
(wire bytes per device, worker count) to a :class:`Route`: an ordered
tuple of :class:`Hop` link occupancies plus a fixed (non-serialized)
latency. The trace driver walks the hops through shared
:class:`~repro_torch.sim.engine.Resource` objects, so two launches
routed over the same link name queue — the behaviour the closed-form
:class:`repro_torch.core.traffic.IciModel` cannot express.

Topologies register under a string name with :func:`register_topology`
(the same extension idiom as ``repro_torch.fabric.register_schedule`` and
``register_controller``).  Built-ins:

  * ``"cxl_direct"``   — each step's launches share one direct-attach
    CXL link to the fabric memory device (the paper's baseline).
  * ``"cxl_switched"`` — host uplink -> switch crossbar -> device, a
    CXL shared-memory pool as in CXL-CCL (arXiv 2602.22457).
  * ``"ici_ring"``     — ring collectives on the reference's modeled
    ICI constants (:class:`repro_torch.core.traffic.IciModel`), so on a
    single queue-free launch the simulated collective time equals
    ``IciModel.collective_time`` exactly.
  * ``"multihop"``     — h-hop hierarchical all-reduce with per-hop
    payload compression, as in DynamiQ (arXiv 2602.08923).
"""
from __future__ import annotations

import dataclasses

from ..core.registry import Registry
from ..core.traffic import IciModel


@dataclasses.dataclass(frozen=True)
class Hop:
    """One serialized occupancy of a named link."""
    link: str
    hold_s: float          # serialization time (bytes / link bandwidth)
    bytes: float = 0.0     # payload crossing this link (reporting only)


@dataclasses.dataclass(frozen=True)
class Route:
    """A launch's path through the fabric: hops + fixed latency."""
    hops: tuple            # tuple[Hop], traversed in order
    latency_s: float = 0.0  # propagation / dispatch time, never queued

    @property
    def service_s(self) -> float:
        """Total link-serialization time (the bandwidth term)."""
        return sum(h.hold_s for h in self.hops)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: backed by the shared generic :class:`repro_torch.core.registry.Registry`
#: (same helper as the codec/schedule/controller seams), which brings
#: this registry the alias + ``override=True`` sweep semantics the
#: hand-rolled version lacked.  Stores *factories*: :func:`get_topology`
#: calls the registered object with its kwargs.
_TOPOLOGIES = Registry("topology", key_fn=str,
                       describe=lambda f: getattr(f, "__name__",
                                                  type(f).__name__),
                       format_available=", ".join)


def register_topology(name: str, *aliases: str, override: bool = False):
    """Class/factory decorator: register a topology under ``name``.

    The registered object is called with the ``get_topology`` kwargs and
    must return an instance exposing
    ``route(wire_bytes, num_workers, index) -> Route``.  ``aliases``
    register the same factory under extra names; re-registering raises
    unless ``override=True`` (which also sweeps stale aliases of the
    replaced factory).
    """
    return _TOPOLOGIES.register(name, *aliases, override=override)


def unregister_topology(name: str) -> None:
    """Remove a topology factory and all its aliases."""
    _TOPOLOGIES.unregister(name)


def available_topologies() -> tuple[str, ...]:
    return _TOPOLOGIES.available()


def get_topology(name_or_topology, **kwargs):
    """Resolve a topology by registered name (or pass one through)."""
    if not isinstance(name_or_topology, str):
        if kwargs:
            raise TypeError("factory kwargs are only valid with a "
                            "registered topology name")
        return name_or_topology
    return _TOPOLOGIES.get(name_or_topology)(**kwargs)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_topology("cxl_direct")
@dataclasses.dataclass(frozen=True)
class CxlDirect:
    """Direct-attach CXL: every launch crosses one shared device link.

    The fixed latency is two memory round-trips (gradient write +
    aggregate read-back — the paper's fixed CXL access latency) plus the
    launch dispatch overhead.
    """
    name: str = "cxl_direct"
    link_bytes_per_s: float = 64e9       # CXL 3.x x8-ish payload rate
    mem_access_latency_s: float = 400e-9
    launch_overhead_s: float = 2e-6

    def route(self, wire_bytes: float, num_workers: int,
              index: int = 0) -> Route:
        return Route(
            hops=(Hop("cxl", wire_bytes / self.link_bytes_per_s,
                      bytes=wire_bytes),),
            latency_s=2 * self.mem_access_latency_s + self.launch_overhead_s)


@register_topology("cxl_switched")
@dataclasses.dataclass(frozen=True)
class CxlSwitched:
    """CXL shared-memory pool behind a switch (CXL-CCL-style).

    Launches serialize twice — host uplink, then the switch crossbar to
    the pooled device — and pay the switch traversal both ways.
    """
    name: str = "cxl_switched"
    uplink_bytes_per_s: float = 64e9
    crossbar_bytes_per_s: float = 128e9  # switch fabric is wider
    switch_latency_s: float = 250e-9
    mem_access_latency_s: float = 400e-9
    launch_overhead_s: float = 2e-6

    def route(self, wire_bytes: float, num_workers: int,
              index: int = 0) -> Route:
        return Route(
            hops=(Hop("cxl_up", wire_bytes / self.uplink_bytes_per_s,
                      bytes=wire_bytes),
                  Hop("xbar", wire_bytes / self.crossbar_bytes_per_s,
                      bytes=wire_bytes)),
            latency_s=(2 * (self.switch_latency_s
                            + self.mem_access_latency_s)
                       + self.launch_overhead_s))


@register_topology("ici_ring")
@dataclasses.dataclass(frozen=True)
class IciRing:
    """Ring collectives on :class:`IciModel`'s modeled constants.

    One launch holds the shared ``ici`` link for the bandwidth term and
    pays ``2(W-1)`` ring-stage hops plus dispatch as fixed latency —
    term-for-term :meth:`IciModel.collective_time`, so the queue-free
    single-launch simulation matches the analytic model exactly.
    """
    name: str = "ici_ring"
    ici: IciModel = dataclasses.field(default_factory=IciModel)

    def route(self, wire_bytes: float, num_workers: int,
              index: int = 0) -> Route:
        bw = self.ici.link_bytes_per_s * self.ici.links_per_chip
        steps = max(2 * (num_workers - 1), 1)
        return Route(
            hops=(Hop("ici", wire_bytes / bw, bytes=wire_bytes),),
            latency_s=(steps * self.ici.hop_latency_s
                       + self.ici.launch_overhead_s))


@register_topology("multihop")
@dataclasses.dataclass(frozen=True)
class MultiHop:
    """Hierarchical h-hop all-reduce with progressive compression.

    DynamiQ-style: each hop re-quantizes, shrinking the payload by
    ``compression`` before the next stage.  Hops serialize on distinct
    per-stage links (``hop0 .. hop{h-1}``), so concurrent launches
    pipeline across stages while same-stage transfers queue.
    """
    name: str = "multihop"
    hops: int = 4
    link_bytes_per_s: float = 25e9
    hop_latency_s: float = 2e-6
    launch_overhead_s: float = 5e-6
    compression: float = 0.5

    def route(self, wire_bytes: float, num_workers: int,
              index: int = 0) -> Route:
        hops = []
        b = float(wire_bytes)
        for k in range(max(1, self.hops)):
            hops.append(Hop(f"hop{k}", b / self.link_bytes_per_s, bytes=b))
            b *= self.compression
        return Route(hops=tuple(hops),
                     latency_s=(len(hops) * self.hop_latency_s
                                + self.launch_overhead_s))

    def route_hops(self, hop_bytes, num_workers: int,
                   index: int = 0) -> Route:
        """Route a launch whose per-leg bytes are already known.

        Hierarchical launches (a :class:`~repro_torch.fabric.hierarchy.HopPlan`
        codec) carry their own per-hop wire bytes — each hop's codec
        fixes its leg's payload — so the topology's geometric
        ``compression``/``hops`` defaults are bypassed and the legs map
        onto the per-stage links directly.  Term for term this is
        :meth:`repro_torch.core.traffic.MultiHopModel.route_time`, so the
        queue-free single-launch simulation matches the analytic per-hop
        model exactly.
        """
        hops = tuple(
            Hop(f"hop{k}", float(b) / self.link_bytes_per_s, bytes=float(b))
            for k, b in enumerate(hop_bytes))
        return Route(hops=hops,
                     latency_s=(len(hops) * self.hop_latency_s
                                + self.launch_overhead_s))
