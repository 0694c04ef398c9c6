"""Discrete-event simulation engine: event heap + clocked resources.

Port of ``repro/sim/engine.py``. The engine is deliberately tiny and
generic — a time-ordered event heap (:class:`Engine`) plus FIFO single-
occupancy :class:`Resource` objects with occupancy / queue-delay
statistics. Everything fabric-specific (the datapath pipeline,
topologies, the launch timeline) lives in the sibling modules and drives
this engine through ``Engine.at`` and ``Resource.request``.

Times are seconds as floats.  Determinism: events at the same timestamp
fire in scheduling order (a monotone sequence number breaks ties), and
resources grant requests strictly in request order, so a simulation is
a pure function of its inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable


class Engine:
    """Time-ordered event loop.

    ``at(t, fn)`` schedules ``fn()`` at absolute time ``t`` (clamped to
    the current time — events cannot fire in the past); ``run()`` drains
    the heap.  ``now`` is the current simulation time and ``horizon``
    the largest time any event has fired at.
    """

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.now = 0.0
        self.horizon = 0.0
        self.events_processed = 0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn()`` at absolute time ``t`` (>= now)."""
        heapq.heappush(self._heap, (max(float(t), self.now), self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn()`` ``delay`` seconds from now."""
        self.at(self.now + max(0.0, float(delay)), fn)

    def run(self, until: float | None = None) -> float:
        """Drain the event heap (optionally stopping at ``until``)."""
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            self.horizon = max(self.horizon, t)
            self.events_processed += 1
            fn()
        return self.horizon


@dataclasses.dataclass
class ResourceStats:
    """Aggregate occupancy statistics for one resource."""
    grants: int = 0
    busy_s: float = 0.0
    queue_delay_s: float = 0.0
    max_queue_delay_s: float = 0.0
    last_free_s: float = 0.0

    def utilization(self, horizon_s: float) -> float:
        """Busy fraction of the simulated interval ``[0, horizon_s]``."""
        return self.busy_s / horizon_s if horizon_s > 0 else 0.0


class Resource:
    """A FIFO, single-occupancy clocked resource (a link, the datapath).

    ``request(t_ready, hold_s, cb)`` asks to occupy the resource for
    ``hold_s`` seconds no earlier than ``t_ready``; the callback fires
    *at the grant time* as ``cb(start_s, end_s)``.  Grants are strictly
    in request order (FIFO), so contention shows up as queue delay —
    exactly the term the closed-form models cannot express.
    """

    def __init__(self, name: str, engine: Engine) -> None:
        self.name = name
        self.engine = engine
        self._free_at = 0.0
        self.stats = ResourceStats()

    def request(self, t_ready: float, hold_s: float,
                cb: Callable[[float, float], None]) -> tuple[float, float]:
        """Reserve ``[start, start + hold_s)``; returns the window."""
        t_ready = max(0.0, float(t_ready))
        hold_s = max(0.0, float(hold_s))
        start = max(t_ready, self._free_at)
        end = start + hold_s
        self._free_at = end
        delay = start - t_ready
        st = self.stats
        st.grants += 1
        st.busy_s += hold_s
        st.queue_delay_s += delay
        st.max_queue_delay_s = max(st.max_queue_delay_s, delay)
        st.last_free_s = end
        self.engine.at(start, lambda: cb(start, end))
        return start, end


class ResourcePool:
    """Lazy name -> :class:`Resource` map for one simulation run."""

    def __init__(self, engine: Engine) -> None:
        self.engine = engine
        self._resources: dict[str, Resource] = {}

    def __getitem__(self, name: str) -> Resource:
        if name not in self._resources:
            self._resources[name] = Resource(name, self.engine)
        return self._resources[name]

    def items(self):
        return self._resources.items()

    def utilization(self, horizon_s: float) -> dict[str, float]:
        return {n: r.stats.utilization(horizon_s)
                for n, r in sorted(self._resources.items())}
