"""Spans and counters of the train step, kept in memory.

The recorder is off by default: :func:`span` then hands back one shared
no-op context manager and :func:`count` / :func:`count_device` return at
once, so an instrumented step allocates nothing, launches nothing and
never synchronises the device.  :func:`enable` turns it on::

    spans.enable()
    trainer.run(n)
    rec = spans.take()          # the spans and counters, cleared
    spans.disable()

On, a span appends ``(name, start_ns, end_ns, thread, parent, step)``
(:class:`Span`) when it opens.  Stamps are read from the monotonic
``time.perf_counter_ns()`` and kept on the epoch clock of
``torch.profiler``'s host events, shifted by an offset to
``time.time_ns()`` taken once in :func:`enable`, so a device trace taken
at the same time can be laid over the spans.  ``parent`` is the innermost span open
on the same thread (autograd runs a CUDA backward on a thread of its
own, where a recomputed layer's spans have none) and ``step`` the
Trainer step set by :func:`at_step`.  :func:`count` adds a host integer
under the innermost open span; :func:`count_device` adds a device
scalar into an accumulator on its device without a sync, read once, by
:func:`take`.  While on, the recorder also counts every collective a
group reports to :data:`~repro_torch.core.collectives.
COLLECTIVE_OBSERVERS`, as ``collective.<op>.calls`` and
``collective.<op>.bytes`` (one rank's input bytes).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import torch

from . import collectives


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None      # None while it is still open
    thread: int             # the native id of the thread that opened it
    parent: int | None      # index of the parent span in the record
    step: int | None        # the Trainer step it belongs to


class Count(NamedTuple):
    name: str
    value: int
    span: int | None        # index of the innermost open span


@dataclasses.dataclass
class Record:
    """What :func:`take` hands back."""
    spans: list             # [Span], in the order they opened
    counts: list            # [Count], host counters by innermost span
    device: dict            # device counter name -> its total

    def under(self, i: int | None, name: str) -> bool:
        """Is span ``i`` (an index, or None) one named ``name`` or nested
        in one on its thread?"""
        while i is not None:
            if self.spans[i].name == name:
                return True
            i = self.spans[i].parent
        return False

    def counter(self, name: str, under: str | None = None) -> int:
        """A counter's total (host and device); with ``under``, only the
        host counts made inside a span of that name."""
        host = sum(c.value for c in self.counts if c.name == name
                   and (under is None or self.under(c.span, under)))
        return host if under is not None else host + self.device.get(name, 0)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_on = False
_offset = 0                 # time.time_ns() - time.perf_counter_ns()
_step: int | None = None
_spans: list = []           # [name, start, end, thread, parent, step, index]
_counts: dict = {}          # (name, index of the innermost open span) -> n
_device: dict = {}          # (name, device) -> accumulator tensor
_lock = threading.Lock()
_local = threading.local()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn the recorder on (what it holds is kept)."""
    global _on, _offset
    if not _on:
        _offset = time.time_ns() - time.perf_counter_ns()
        _on = True
        collectives.COLLECTIVE_OBSERVERS.append(_observe)


def disable() -> None:
    """Turn the recorder off; spans open now still close into it."""
    global _on
    if _on:
        _on = False
        collectives.COLLECTIVE_OBSERVERS.remove(_observe)


def at_step(step: int | None) -> None:
    """The Trainer step that spans opened from now on belong to."""
    global _step
    _step = step


def begin(name: str, start_ns: int):
    """Open a span stamped ``start_ns`` (``time.perf_counter_ns()``);
    returns its handle for :func:`end` (None while the recorder is
    off)."""
    if not _on:
        return None
    stack = _stack()
    with _lock:
        rec = [name, start_ns + _offset, None, threading.get_native_id(),
               stack[-1][6] if stack else None, _step, len(_spans)]
        _spans.append(rec)
    stack.append(rec)
    return rec


def end(rec, end_ns: int) -> None:
    """Close the span ``rec`` (from :func:`begin`) stamped ``end_ns``
    (``time.perf_counter_ns()``)."""
    if rec is None:
        return
    rec[2] = end_ns + _offset
    stack = _stack()
    if stack and stack[-1] is rec:
        stack.pop()
    elif rec in stack:
        stack.remove(rec)


class _Open:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = begin(self.name, time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        end(self.rec, time.perf_counter_ns())
        return False


def span(name: str):
    """A context manager timing its block as the span ``name``."""
    return _Open(name) if _on else _NOOP


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name``, under the
    innermost span open on this thread."""
    if not _on:
        return
    stack = _stack()
    key = (name, stack[-1][6] if stack else None)
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)


def count_device(name: str, x: torch.Tensor) -> None:
    """Add the device scalar ``x`` to the counter ``name`` without a
    sync: it is read in :func:`take`."""
    if not _on:
        return
    key = (name, x.device)
    with _lock:
        acc = _device.get(key)
        if acc is None:
            acc = _device[key] = torch.zeros(
                (), device=x.device, dtype=torch.float64
                if x.is_floating_point() else torch.int64)
        acc.add_(x.detach())


def _observe(group, op: str, x: torch.Tensor) -> None:
    count(f"collective.{op}.calls", 1)
    count(f"collective.{op}.bytes", x.numel() * x.element_size())


def take() -> Record:
    """The spans and counters recorded so far, cleared from the
    recorder; the device counters are read here (a sync).  Take it
    with no span open: one open now closes into the record taken."""
    global _spans, _counts, _device
    with _lock:
        spans, counts, device = _spans, _counts, _device
        _spans, _counts, _device = [], {}, {}
    totals: dict = {}
    for (name, _), acc in device.items():
        totals[name] = totals.get(name, 0) + acc.item()
    return Record(spans=[Span(*r[:6]) for r in spans],
                  counts=[Count(name, n, i)
                          for (name, i), n in counts.items()],
                  device=totals)
