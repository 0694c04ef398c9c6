"""Offline replay of an elastic schedule through the simulator (port of
``repro/elastic/replay.py`` over :mod:`repro_torch.sim`).

The same :class:`~repro_torch.elastic.membership.Membership` schedule and
fault models that drive a live ElasticTrainer run replay here without
touching a device: the step range splits into maximal **phases** of
constant ``(worker view, straggler inflation, bandwidth scale)``, each
phase simulates the plan's bucket layout once under its effective fleet
size / compute time / link rate, and the report aggregates per-phase
exposed communication time — the paper's reporting basis — across the
whole scenario.  This is how a crash→rejoin or link-degrade scenario is
priced before (or instead of) running it.  Every time is the simulator's
model under the reference's constants, not a measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from ..core import AdmissionPlan
from ..fabric import Fabric
from ..sim import get_topology, simulate_layout
from .faults import (FaultModel, combined_bandwidth_scale,
                     combined_step_time_scale, resolve_faults)
from .membership import Membership, MembershipEvent, view_trace

__all__ = ["ReplayPhase", "ReplayReport", "replay_schedule",
           "BANDWIDTH_KWARGS"]

#: which constructor kwarg scales each built-in topology's bottleneck
#: link; custom topologies pass ``bandwidth_kwarg=`` explicitly.
BANDWIDTH_KWARGS = {
    "cxl_direct": "link_bytes_per_s",
    "cxl_switched": "uplink_bytes_per_s",
    "multihop": "link_bytes_per_s",
}


@dataclasses.dataclass(frozen=True)
class ReplayPhase:
    """One maximal run of steps with a constant elastic regime."""
    start: int
    stop: int
    epoch: int
    num_workers: int
    straggler_scale: float
    bandwidth_scale: float
    step_time_s: float
    exposed_s: float
    exposed_pct: float
    hidden: bool

    @property
    def steps(self) -> int:
        return self.stop - self.start

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    """Per-phase exposed-time accounting for one elastic scenario."""
    topology: str
    num_steps: int
    phases: tuple[ReplayPhase, ...]

    @property
    def total_time_s(self) -> float:
        return sum(p.steps * p.step_time_s for p in self.phases)

    @property
    def total_exposed_s(self) -> float:
        return sum(p.steps * p.exposed_s for p in self.phases)

    @property
    def exposed_pct(self) -> float:
        t = self.total_time_s
        return 100.0 * self.total_exposed_s / t if t > 0 else 0.0

    def summary(self) -> dict:
        return {"topology": self.topology, "num_steps": self.num_steps,
                "num_phases": len(self.phases),
                "total_time_s": self.total_time_s,
                "total_exposed_s": self.total_exposed_s,
                "exposed_pct": self.exposed_pct}

    def to_jsonable(self) -> dict:
        return {**self.summary(),
                "phases": [p.to_jsonable() for p in self.phases]}


def _scenario_events(membership: Membership | int,
                     faults: Sequence[FaultModel]) -> tuple:
    """Static event list: the ledger's schedule plus fault-caused ones."""
    events: list[MembershipEvent] = []
    if isinstance(membership, Membership):
        events.extend(membership.schedule)
        initial = membership.view.workers
    else:
        initial = tuple(range(membership))
    for f in faults:
        events.extend(f.scheduled_events())
    return initial, tuple(sorted(events, key=lambda e: e.step))


def replay_schedule(params_like: Any, plan: AdmissionPlan,
                    membership: Membership | int,
                    num_steps: int, *,
                    faults: Sequence = (),
                    topology: str = "cxl_direct",
                    compute_time_s: float = 1e-3,
                    overlap_fraction: float = 1.0,
                    bandwidth_kwarg: str | None = None,
                    rules=None,
                    **topology_kwargs) -> ReplayReport:
    """Replay an elastic scenario offline; returns per-phase exposure.

    ``membership`` is a fresh ledger (its deterministic schedule is
    read, not consumed) or an initial worker count; ``faults`` accepts
    the same specs as the ElasticTrainer.  Per phase, the fleet's
    compute time inflates by the worst live straggler factor (lock-step
    steps serialize behind the slowest worker) and the topology's
    bottleneck-link rate scales by the tightest ``link_degrade`` cut.
    """
    faults = resolve_faults(faults)
    initial, events = _scenario_events(membership, faults)
    kwarg = bandwidth_kwarg or BANDWIDTH_KWARGS.get(topology)
    base_bw = (getattr(get_topology(topology, **topology_kwargs), kwarg)
               if kwarg is not None else None)

    fabric = Fabric(num_workers=len(initial), rules=rules)
    layout = fabric.layout_for(params_like, plan)

    # per-step regime, then coalesce into maximal constant phases
    views = {}
    for start, stop, view in view_trace(initial, events, num_steps):
        for s in range(start, stop):
            views[s] = view
    regimes = []
    for s in range(num_steps):
        view = views[s]
        straggler = max(
            [combined_step_time_scale(faults, s, w) for w in view.workers],
            default=1.0)
        bw = combined_bandwidth_scale(faults, s)
        regimes.append((view, straggler, bw))

    phases: list[ReplayPhase] = []
    start = 0
    for s in range(1, num_steps + 1):
        boundary = (s == num_steps or
                    (regimes[s][0].epoch, regimes[s][1], regimes[s][2])
                    != (regimes[start][0].epoch, regimes[start][1],
                        regimes[start][2]))
        if not boundary:
            continue
        view, straggler, bw = regimes[start]
        kwargs = dict(topology_kwargs)
        if bw != 1.0:
            if kwarg is None:
                raise ValueError(
                    f"link_degrade on topology {topology!r} needs "
                    f"bandwidth_kwarg= (no entry in BANDWIDTH_KWARGS)")
            kwargs[kwarg] = base_bw * bw
        rep = simulate_layout(layout, view.num_workers, topology=topology,
                              compute_time_s=compute_time_s * straggler,
                              overlap_fraction=overlap_fraction, **kwargs)
        phases.append(ReplayPhase(
            start=start, stop=s, epoch=view.epoch,
            num_workers=view.num_workers, straggler_scale=straggler,
            bandwidth_scale=bw, step_time_s=rep.step_time_s,
            exposed_s=rep.exposed_s, exposed_pct=rep.exposed_pct,
            hidden=rep.hidden))
        start = s
    return ReplayReport(topology=str(topology), num_steps=num_steps,
                        phases=tuple(phases))
