"""Trace driver: compile a bucket layout into a simulated step timeline.

Port of ``repro/sim/trace.py``. This is the top of the simulator stack:
it turns a :class:`~repro_torch.core.buckets.BucketLayout` (or a hand-
built list of :class:`LaunchSpec`) plus a compute-time profile into per-
launch events on a :class:`~repro_torch.sim.engine.Engine`, routes every
launch through the chosen topology, models the fabric datapath
occupancy, and returns a typed :class:`SimReport`.

Semantics per launch:

  * the launch becomes *ready* when backward compute emits its bucket
    (``ready_times``, default: evenly spaced across ``compute_time_s``);
  * its route's hops are traversed store-and-forward through shared
    FIFO link resources — concurrent launches queue, which is the
    behaviour the closed-form models cannot express;
  * the fabric datapath (a shared resource) processes the launch's
    flits for ``t_agg`` seconds starting when its first hop starts
    transmitting; up to ``overlap_fraction`` of the launch's own
    service path (transfer window plus fixed route latency) hides
    datapath time, and the remainder is *exposed* — on a queue-free
    single launch this reduces exactly to ``ExposureModel``'s
    ``max(0, t_agg - overlap * t_service)`` with the route latency as
    ``extra_service_s``.

The step finishes when compute and every launch (delivery + exposed
datapath tail) have finished.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core.buckets import BucketLayout
from ..core.modes import AggregationMode, codec_name, schedule_name
from ..core.traffic import hop_wire_bytes_per_device
from .datapath import FlitPipeline, datapath_time
from .engine import Engine, ResourcePool
from .topology import get_topology


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One collective launch to simulate (a fused bucket or a leaf).

    ``mode`` is a codec name (built-in enum member or any registered
    codec) — the datapath resolves its lane/flit timing from the codec.
    ``hop_bytes`` carries the per-leg wire bytes of a hierarchical
    launch (None for flat single-hop launches); topologies exposing
    ``route_hops`` (e.g. ``multihop``) replay those legs on their
    per-stage links instead of applying their own payload profile.
    """
    name: str
    mode: AggregationMode | str
    schedule: str
    n_elements: int
    wire_bytes: float
    ready_s: float = 0.0
    hop_bytes: tuple | None = None


@dataclasses.dataclass
class LaunchRecord:
    """Simulated timeline of one launch."""
    index: int
    name: str
    mode: str
    schedule: str
    n_elements: int
    wire_bytes: float
    ready_s: float
    start_s: float = 0.0        # first link grant
    queue_delay_s: float = 0.0  # summed FIFO wait across hops
    service_s: float = 0.0      # summed link serialization (bandwidth term)
    latency_s: float = 0.0      # fixed route latency (hops + dispatch)
    t_agg_s: float = 0.0        # datapath occupancy for this launch
    dp_start_s: float = 0.0
    dp_end_s: float = 0.0
    exposed_s: float = 0.0      # datapath time beyond the hidden window
    end_s: float = 0.0          # delivery + exposed tail
    links: tuple = ()

    @property
    def hidden_s(self) -> float:
        """Datapath time absorbed by the transfer window."""
        return self.t_agg_s - self.exposed_s

    @property
    def collective_s(self) -> float:
        """Launch-local collective completion time (ready -> delivered)."""
        return self.end_s - self.ready_s

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        d["links"] = list(self.links)
        d["hidden_s"] = self.hidden_s
        d["collective_s"] = self.collective_s
        return d


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Typed result of one simulated training step."""
    topology: str
    num_workers: int
    overlap_fraction: float
    compute_time_s: float
    launches: tuple            # tuple[LaunchRecord]
    step_time_s: float
    exposed_s: float
    exposed_pct: float         # of step time — the paper's reporting basis
    hidden: bool
    link_utilization: dict
    critical_path: tuple       # ((segment, seconds), ...) of the last launch
    events_processed: int

    @property
    def num_launches(self) -> int:
        return len(self.launches)

    @property
    def comm_time_s(self) -> float:
        """Span from the first launch start to the last delivery."""
        if not self.launches:
            return 0.0
        return (max(l.end_s for l in self.launches)
                - min(l.start_s for l in self.launches))

    @property
    def wire_bytes_total(self) -> float:
        """Per-device bytes crossing links, summed over all launches."""
        return float(sum(l.wire_bytes for l in self.launches))

    def telemetry(self, step: int, loss: float, **kwargs):
        """Adapt this report into a runtime Telemetry record.

        The simulated step time rides the same ``step_time_s`` channel a
        wall-clock-measured step would, so controllers (and their CUSUM
        statistics) can be exercised against simulated scenarios.
        """
        from ..fabric.control import Telemetry
        return Telemetry(step=int(step), loss=float(loss),
                         step_time_s=self.step_time_s, **kwargs)

    def to_jsonable(self) -> dict:
        return {
            "topology": self.topology,
            "num_workers": self.num_workers,
            "overlap_fraction": self.overlap_fraction,
            "compute_time_s": self.compute_time_s,
            "num_launches": self.num_launches,
            "step_time_s": self.step_time_s,
            "comm_time_s": self.comm_time_s,
            "wire_bytes_total": self.wire_bytes_total,
            "exposed_s": self.exposed_s,
            "exposed_pct": self.exposed_pct,
            "hidden": self.hidden,
            "link_utilization": dict(self.link_utilization),
            "critical_path": [list(seg) for seg in self.critical_path],
            "events_processed": self.events_processed,
            "launches": [l.to_jsonable() for l in self.launches],
        }

    def summary(self) -> dict:
        """Compact scalars for dry-run reports / benchmark JSON."""
        d = self.to_jsonable()
        d.pop("launches")
        return d


def simulate_launches(specs: Sequence[LaunchSpec], num_workers: int, *,
                      topology: Any = "ici_ring",
                      datapath: Any | None = None,
                      overlap_fraction: float = 1.0,
                      compute_time_s: float = 0.0,
                      **topology_kwargs) -> SimReport:
    """Run the discrete-event simulation for an explicit launch list.

    ``topology`` is a registered name (resolved with ``topology_kwargs``)
    or an instance; ``datapath`` is any ``t_agg`` model (default: the
    5-stage :class:`FlitPipeline`), or None to simulate pure transport
    with a zero-cost datapath.
    """
    topo = get_topology(topology, **topology_kwargs)
    topo_name = getattr(topo, "name", type(topo).__name__)
    engine = Engine()
    links = ResourcePool(engine)
    dp_resource = links["datapath"] if datapath is not None else None

    def make_launch(rec: LaunchRecord, route, t_agg: float):
        """Per-launch closure: hop chain -> finish, no shared loop state."""

        def begin(start: float) -> None:
            rec.start_s = start
            if dp_resource is not None:
                dps, dpe = dp_resource.request(start, t_agg,
                                               lambda s, e: None)
                rec.dp_start_s, rec.dp_end_s = dps, dpe

        def start_hop(k: int, t_arrive: float) -> None:
            if not route.hops:        # pure-latency route (custom topology)
                begin(t_arrive)
                finish(t_arrive)
                return
            if k >= len(route.hops):
                finish(t_arrive)
                return
            hop = route.hops[k]

            def granted(start: float, end: float, k=k) -> None:
                if k == 0:
                    begin(start)
                engine.at(end, lambda: start_hop(k + 1, end))

            # FIFO wait at this hop is observable from the grant window
            start, _end = links[hop.link].request(t_arrive, hop.hold_s,
                                                 granted)
            rec.queue_delay_s += start - t_arrive

        def finish(t_service_end: float) -> None:
            # the hideable window is the launch's own service path —
            # transfer (incl. inter-hop waits) plus the fixed route
            # latency — times overlap_fraction, mirroring
            # ExposureModel.exposed(..., extra_service_s=latency)
            transfer = max(0.0, t_service_end - rec.start_s)
            hide_end = rec.start_s + overlap_fraction * (transfer
                                                         + rec.latency_s)
            if rec.t_agg_s > 0.0:
                rec.exposed_s = max(0.0, rec.dp_end_s - hide_end)
            rec.end_s = t_service_end + rec.latency_s + rec.exposed_s

        return start_hop

    records: list[LaunchRecord] = []
    for i, spec in enumerate(specs):
        route_hops = getattr(topo, "route_hops", None)
        if spec.hop_bytes is not None and route_hops is not None:
            route = route_hops(spec.hop_bytes, num_workers, i)
        else:
            route = topo.route(spec.wire_bytes, num_workers, i)
        t_agg = (0.0 if datapath is None else
                 datapath_time(datapath, spec.n_elements, num_workers,
                               spec.mode))
        rec = LaunchRecord(
            index=i, name=spec.name, mode=codec_name(spec.mode),
            schedule=schedule_name(spec.schedule),
            n_elements=int(spec.n_elements),
            wire_bytes=float(spec.wire_bytes), ready_s=float(spec.ready_s),
            latency_s=route.latency_s, service_s=route.service_s,
            t_agg_s=t_agg, links=tuple(h.link for h in route.hops))
        records.append(rec)
        start_hop = make_launch(rec, route, t_agg)
        engine.at(spec.ready_s,
                  lambda t=spec.ready_s, fn=start_hop: fn(0, t))

    engine.run()

    last_end = max((r.end_s for r in records), default=0.0)
    step_time = max(float(compute_time_s), last_end)
    exposed = sum(r.exposed_s for r in records)
    crit: tuple = ()
    if records:
        tail = max(records, key=lambda r: r.end_s)
        crit = (("compute_until_ready", tail.ready_s),
                ("queue", tail.queue_delay_s),
                ("service", tail.service_s),
                ("latency", tail.latency_s),
                ("exposed_datapath", tail.exposed_s))
    return SimReport(
        topology=topo_name, num_workers=int(num_workers),
        overlap_fraction=float(overlap_fraction),
        compute_time_s=float(compute_time_s),
        launches=tuple(records), step_time_s=step_time,
        exposed_s=exposed,
        exposed_pct=(100.0 * exposed / step_time if step_time > 0 else 0.0),
        hidden=exposed == 0.0,
        link_utilization=links.utilization(step_time),
        critical_path=crit,
        events_processed=engine.events_processed)


def layout_launch_specs(layout: BucketLayout, num_workers: int, *,
                        compute_time_s: float = 0.0,
                        ready_times: Sequence[float] | None = None,
                        ) -> list[LaunchSpec]:
    """BucketLayout -> simulatable launch list (wire bytes per launch).

    Launches appear in layout order (fused buckets first, then unfused
    leaves); ``ready_times`` overrides the default evenly-spaced
    emission of buckets across the backward pass (``compute_time_s``).
    """
    entries = [(f"bucket:{i}:{codec_name(b.key.mode)}", b.key, b.size)
               for i, b in enumerate(layout.buckets)]
    entries += [(f"leaf:{u.name}", u.key, u.size) for u in layout.unfused]
    n = len(entries)
    if ready_times is None:
        ready_times = [compute_time_s * (i + 1) / n for i in range(n)] \
            if n else []
    if len(ready_times) != n:
        raise ValueError(
            f"{len(ready_times)} ready times for {n} launches (the layout "
            f"implies {len(layout.buckets)} fused buckets plus "
            f"{len(layout.unfused)} unfused leaves)")
    specs = []
    for (name, key, size), ready in zip(entries, ready_times):
        legs = hop_wire_bytes_per_device(size, key.mode, key.schedule,
                                         num_workers)
        specs.append(LaunchSpec(
            name=name, mode=key.mode, schedule=key.schedule,
            n_elements=size, wire_bytes=float(sum(legs)),
            ready_s=float(ready),
            # only hierarchical (multi-leg) launches pin their own route
            # legs; flat launches keep the topology's payload profile
            hop_bytes=legs if len(legs) > 1 else None))
    return specs


def timeline_launch_specs(steps: Sequence[Any], *,
                          step_compute_s: float = 0.0,
                          mode: Any = "fp32",
                          schedule: str = "paged_kv") -> list[LaunchSpec]:
    """Per-step traffic records -> simulatable launch list.

    The serving-side counterpart of :func:`layout_launch_specs`: instead
    of a backward pass emitting buckets, a decode loop emits one fabric
    transaction per engine step (KV gather + scatter + spill traffic).
    Each entry of ``steps`` is a mapping with ``wire_bytes`` plus
    optional ``name`` / ``mode`` / ``schedule`` / ``n_elements`` /
    ``ready_s`` overrides; step ``i`` defaults to becoming ready at
    ``i * step_compute_s`` (the model-forward time separating decode
    steps).
    """
    specs = []
    for i, entry in enumerate(steps):
        d = dict(entry)
        specs.append(LaunchSpec(
            name=str(d.get("name", f"step:{i}")),
            mode=d.get("mode", mode),
            schedule=str(d.get("schedule", schedule)),
            n_elements=int(d.get("n_elements", 0)),
            wire_bytes=float(d["wire_bytes"]),
            ready_s=float(d.get("ready_s", i * step_compute_s))))
    return specs


def simulate_layout(layout: BucketLayout, num_workers: int, *,
                    topology: Any = "ici_ring",
                    datapath: Any | None = None,
                    overlap_fraction: float = 1.0,
                    compute_time_s: float = 0.0,
                    ready_times: Sequence[float] | None = None,
                    **topology_kwargs) -> SimReport:
    """Simulate one aggregation pass of a bucket layout.

    The scenario engine entry point: replay any
    ``BucketLayout`` (hence any ``AdmissionPlan``) against any
    registered topology.  ``datapath`` defaults to the 5-stage
    :class:`FlitPipeline`.
    """
    if datapath is None:
        datapath = FlitPipeline()
    specs = layout_launch_specs(layout, num_workers,
                                compute_time_s=compute_time_s,
                                ready_times=ready_times)
    return simulate_launches(specs, num_workers, topology=topology,
                             datapath=datapath,
                             overlap_fraction=overlap_fraction,
                             compute_time_s=compute_time_s,
                             **topology_kwargs)
