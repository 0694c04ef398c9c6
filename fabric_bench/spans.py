"""The port's spans and counters laid over a traced window.

:func:`record` traces steps of the port's Trainer as
:func:`fabric_bench.trace.record` does (CUDA activity alone), with the
port's span recorder (``repro_torch.core.spans``) on, and keeps what the
span readers in ``metrics/`` need besides the :class:`~fabric_bench.
trace.Trace` fields: the program's :class:`Record` and each device
event's share of the spans.

**Attribution.**  A device event belongs to every span open, on any
thread, when the runtime call that enqueued it ran; the call is found
by the profiler's correlation id.  So a kernel the backward launches
from autograd's device thread falls under the main thread's
``fabric.backward``, and under ``model.attention`` where autograd's
thread recomputes a layer.  A span name's inclusive device time is the
time of the events under any span of that name; its self time leaves
out the events under one of its children.  Spans and runtime calls
share the host's epoch clock (``time.time_ns()``): the recorder shifts
its monotonic stamps onto it.

The idle gaps are named by the innermost span open at their midpoint
(the latest opened, on any thread), then by the runtime call running
through it as :mod:`fabric_bench.trace` names it.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

from .counts.port_kernels import port_kernel
from .trace import LAUNCH_CALLS, Trace, _innermost, _union

#: the step's phases: every device operation of a step should fall under
#: one, and their device times add up to the step's
PHASES = ("fabric.forward", "fabric.backward", "fabric.grad_stack",
          "fabric.aggregate", "fabric.agg_norm", "optim.apply")
NO_SPAN = "no span"


@dataclasses.dataclass
class SpanTrace(Trace):
    record: object = None        # the program's spans.Record
    inclusive: dict = dataclasses.field(default_factory=dict)  # name -> s
    self_time: dict = dataclasses.field(default_factory=dict)  # name -> s
    covered_s: float = 0.0       # device time (union) under a phase span
    port_in_aggregate: tuple = (0, 0)   # port kernels under the aggregate, all
    loop_idle_s: float = 0.0     # device idle with no trainer.step open


class Segments:
    """The spans open at each instant: the record's span boundaries cut
    the time line into segments, each holding one set of open spans."""

    def __init__(self, spans):
        self.spans = spans
        cuts = {}
        for i, s in enumerate(spans):
            if s.end_ns is None:
                continue
            cuts.setdefault(s.start_ns, []).append((1, i))
            cuts.setdefault(s.end_ns, []).append((-1, i))
        self.times, self.open = [], []
        now: set = set()
        for t in sorted(cuts):
            for d, i in cuts[t]:
                (now.add if d > 0 else now.discard)(i)
            self.times.append(t)
            self.open.append(frozenset(now))

    def at(self, t: int) -> frozenset:
        """The spans open at ``t`` (a span holds ``[start, end)``)."""
        k = bisect.bisect_right(self.times, t) - 1
        return self.open[k] if k >= 0 else frozenset()

    def innermost(self, t: int) -> str:
        open_ = self.at(t)
        if not open_:
            return NO_SPAN
        return self.spans[max(open_, key=lambda i: (
            self.spans[i].start_ns, i))].name


def attribute(spans, calls: dict, events) -> tuple[dict, dict, list]:
    """Device seconds by span name, inclusive and self, and each event's
    set of span names (None where no runtime call carries its
    correlation id).

    ``spans`` are the record's spans, ``calls`` maps a correlation id to
    the start of its runtime call, ``events`` are ``(start_ns, end_ns,
    correlation id)`` of device operations."""
    seg = Segments(spans)
    names_of: dict = {}
    inclusive, self_time, under = {}, {}, []
    for a, b, corr in events:
        t = calls.get(corr)
        if t is None:
            under.append(None)
            continue
        open_ = seg.at(t)
        got = names_of.get(open_)
        if got is None:
            names = frozenset(spans[i].name for i in open_)
            parents = {spans[spans[i].parent].name for i in open_
                       if spans[i].parent is not None}
            got = names_of[open_] = (names, names - parents)
        names, own = got
        s = (b - a) * 1e-9
        for n in names:
            inclusive[n] = inclusive.get(n, 0.0) + s
        for n in own:
            self_time[n] = self_time.get(n, 0.0) + s
        under.append(names)
    return inclusive, self_time, under


def idle_gaps(busy, seg: Segments, host, top: int = 10) -> list:
    """The ``top`` longest gaps between the merged ``busy`` intervals,
    longest first, as ``(name, seconds)``: the innermost span open at the
    gap's midpoint, then the runtime call in ``host`` running through it
    (``"span > call"``)."""
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return [(f"{seg.innermost((a + b) // 2)} > "
             f"{_innermost(host, (a + b) // 2)}", (b - a) * 1e-9)
            for a, b in gaps]


def idle_outside(busy, spans, name: str, w0: int, w1: int) -> int:
    """Nanoseconds of ``[w0, w1]`` in which the device is idle (outside
    the merged ``busy`` intervals) and no span ``name`` is open."""
    cover = _union([(max(a, w0), min(b, w1)) for a, b in busy if b > w0
                    and a < w1] + [(max(s.start_ns, w0), min(s.end_ns, w1))
                                   for s in spans if s.name == name
                                   and s.end_ns is not None
                                   and s.end_ns > w0 and s.start_ns < w1])
    return (w1 - w0) - sum(b - a for a, b in cover)


def record(trainer, cell, steps: int, device_kind: str, on_card: bool,
           top: int = 10) -> SpanTrace:
    """Trace ``steps`` more steps of ``trainer`` with the recorder on and
    lay the spans over the device's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import spans as recorder
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
    recorder.take()
    recorder.enable()
    try:
        with profile(activities=acts) as prof:
            w0, t0 = time.time_ns(), time.perf_counter()
            start = trainer.state.step
            trainer.run(start + steps)
            if on_card:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            w1 = time.time_ns()
    finally:
        recorder.disable()
    rec = recorder.take()
    dev, host, calls, kernels, port, launches = [], [], {}, {}, {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type().name == "CUDA":
            dev.append((a, b, e.correlation_id(), name))
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + (b - a) * 1e-9, n + 1)
            k = port_kernel(name)
            if k is not None:
                s, n = port.get(k, (0.0, 0))
                port[k] = (s + (b - a) * 1e-9, n + 1)
        else:
            host.append((a, b, name))
            calls[e.correlation_id()] = a
            launches += name.startswith(LAUNCH_CALLS)
    inclusive, self_time, under = attribute(
        rec.spans, calls, [(a, b, c) for a, b, c, _ in dev])
    busy = _union([(a, b) for a, b, _, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    covered = _union([(a, b) for (a, b, _, _), names in zip(dev, under)
                      if names and not names.isdisjoint(PHASES)])
    agg = [names is not None and "fabric.aggregate" in names
           for (_, _, _, n), names in zip(dev, under)
           if port_kernel(n) is not None]
    return SpanTrace(
        cell=cell, steps=steps, window_s=window_s, busy_s=busy_s,
        kernels=kernels, port=port, launch_calls=launches,
        idle_gaps=idle_gaps(busy, Segments(rec.spans), host, top),
        device_kind=device_kind, record=rec, inclusive=inclusive,
        self_time=self_time,
        covered_s=sum(b - a for a, b in covered) * 1e-9,
        port_in_aggregate=(sum(agg), len(agg)),
        loop_idle_s=(idle_outside(busy, rec.spans, "trainer.step", w0, w1)
                     * 1e-9 if dev else 0.0))


def phase_ms(t, name: str, own: bool = False):
    """A span name's device milliseconds a step, inclusive or self; None
    where the trace has no spans or none of the name held device time."""
    times = getattr(t, "self_time" if own else "inclusive", None)
    if not times or name not in times:
        return None
    return times[name] / t.steps * 1e3
