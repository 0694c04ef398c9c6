"""Fault-tolerance utilities: failure injection, straggler watchdog.

Port of ``repro/runtime/fault.py``.  On a real multi-node job a node
failure surfaces as a collective timeout or a process exit, and the
restart goes through the checkpoint path.  The Trainer exercises that
path: :class:`FailureInjector` raises at configured steps, and the
Trainer restores the latest atomic checkpoint and replays the
deterministic data stream.  The failure is host-side: under a process
group every rank's injector fires at the same step, so all ranks restore
together (a rank that really dies takes the group with it).

Straggler mitigation in a synchronous data-parallel job is a scheduling
concern: the watchdog detects persistent slow steps (EWMA outliers) and
reports them; its hook can then rebalance or mark the host for
replacement at the next checkpoint boundary.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

from ..core import spans


class SimulatedFailure(RuntimeError):
    """Stands in for a node crash / collective abort."""


@dataclasses.dataclass
class FailureInjector:
    """Raise SimulatedFailure at the given steps (each fires once)."""
    at_steps: Sequence[int] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ewma_s: float


class StragglerWatchdog:
    """EWMA-based step-time outlier detector with a mitigation hook.

    Step times differ by rank, so under a process group each rank's
    watchdog sees its own; nothing a watchdog reports feeds a collective
    or a controller's decision.
    """

    def __init__(self, threshold: float = 3.0, alpha: float = 0.1,
                 warmup: int = 3,
                 on_straggler: Optional[Callable[[StragglerEvent],
                                                 None]] = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.ewma: Optional[float] = None
        self.events: list[StragglerEvent] = []
        self._seen = 0

    def observe(self, step: int, duration_s: float) -> bool:
        self._seen += 1
        if self.ewma is None:
            self.ewma = duration_s
            return False
        is_straggler = (self._seen > self.warmup
                        and duration_s > self.threshold * self.ewma)
        if is_straggler:
            ev = StragglerEvent(step, duration_s, self.ewma)
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(ev)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration_s
        return is_straggler


class StepTimer:
    """Host wall time of a ``with`` block, in ``duration`` (seconds),
    and the recorder's ``trainer.step`` span while it is on: both from
    the same two ``time.perf_counter_ns()`` stamps
    (:mod:`repro_torch.core.spans`)."""

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self._span = spans.begin("trainer.step", self.t0)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        spans.end(self._span, t1)
        self.duration = (t1 - self.t0) * 1e-9
