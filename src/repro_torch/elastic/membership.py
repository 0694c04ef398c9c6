"""Membership ledger: epoch-numbered worker views over a dynamic fleet
(port of ``repro/elastic/membership.py``, plain Python).

The unit of truth for *who is training* is the :class:`WorkerView` — an
immutable, epoch-numbered snapshot of the live worker-id set.  Every
membership change (graceful ``join``/``leave``, involuntary ``crash``)
bumps the epoch, and everything keyed on the live fleet — bucket
layouts, jitted steps (``Fabric.step_for``), EF state shapes — re-keys
on ``(num_workers, epoch)`` so stale artifacts can never be served
after a re-plan.

A :class:`Membership` ledger owns the current view plus an optional
*deterministic event schedule*: a step-stamped list of events applied at
step boundaries, so a scripted crash→rejoin run is exactly replayable
(and replayable offline through :mod:`repro_torch.elastic.replay`).
Fault models (:mod:`repro_torch.elastic.faults`) inject further events at run time through the
same :meth:`Membership.apply` path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

__all__ = ["MembershipEvent", "WorkerView", "Membership", "view_trace"]

EVENT_KINDS = ("join", "leave", "crash")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership change: ``worker`` does ``kind`` at ``step``.

    ``join``/``leave`` are graceful (step-boundary re-plan, no rollback);
    ``crash`` is involuntary (the ElasticTrainer rolls back to the last
    durable checkpoint and replays under the shrunken view).
    """
    step: int
    kind: str
    worker: int

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown membership event kind {self.kind!r}; "
                             f"expected one of {EVENT_KINDS}")

    def to_jsonable(self) -> dict:
        return {"step": int(self.step), "kind": self.kind,
                "worker": int(self.worker)}


@dataclasses.dataclass(frozen=True)
class WorkerView:
    """Immutable epoch-numbered snapshot of the live worker-id set."""
    epoch: int
    workers: tuple[int, ...]

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    def index_of(self, worker: int) -> int:
        """Dense slot of ``worker`` in this view (EF/batch leading axis)."""
        return self.workers.index(worker)

    def to_jsonable(self) -> dict:
        return {"epoch": int(self.epoch),
                "workers": [int(w) for w in self.workers]}


class Membership:
    """Epoch-numbered membership ledger with a deterministic schedule.

    ``Membership(4)`` starts with workers ``(0, 1, 2, 3)`` at epoch 0.
    Scheduled events (``schedule=``) fire when the driving loop calls
    :meth:`step_events`; ad-hoc events (fault models, external signals)
    go straight through :meth:`apply`.  The full ``(event, view)`` log
    is kept for replay and reporting.
    """

    def __init__(self, initial: int | Iterable[int], *,
                 schedule: Sequence[MembershipEvent] = ()):
        workers = (tuple(range(initial)) if isinstance(initial, int)
                   else tuple(sorted(int(w) for w in initial)))
        if not workers:
            raise ValueError("membership needs at least one initial worker")
        if len(set(workers)) != len(workers):
            raise ValueError(f"duplicate worker ids in {workers}")
        self.view = WorkerView(epoch=0, workers=workers)
        self.schedule = tuple(sorted(schedule, key=lambda e: e.step))
        self._pending = list(self.schedule)
        self.log: list[tuple[MembershipEvent, WorkerView]] = []

    # -- event application ----------------------------------------------

    def apply(self, event: MembershipEvent) -> WorkerView:
        """Apply one event; returns the new (epoch-bumped) view.

        Joining a live worker or removing an absent one is a schedule
        bug, not a state to paper over — both raise.
        """
        live = set(self.view.workers)
        if event.kind == "join":
            if event.worker in live:
                raise ValueError(f"worker {event.worker} is already live "
                                 f"(epoch {self.view.epoch})")
            live.add(event.worker)
        else:                                       # leave / crash
            if event.worker not in live:
                raise ValueError(f"worker {event.worker} is not live "
                                 f"(epoch {self.view.epoch})")
            live.remove(event.worker)
        if not live:
            raise ValueError(f"event {event} would empty the fleet")
        self.view = WorkerView(epoch=self.view.epoch + 1,
                               workers=tuple(sorted(live)))
        self.log.append((event, self.view))
        return self.view

    def step_events(self, step: int) -> tuple[MembershipEvent, ...]:
        """Pop (without applying) all *scheduled* events due at ``step``.

        Events scheduled before ``step`` that were never polled fire too
        (a recovered run resumes polling mid-schedule); each scheduled
        event fires exactly once.
        """
        due = [e for e in self._pending if e.step <= step]
        self._pending = [e for e in self._pending if e.step > step]
        return tuple(due)

    def to_jsonable(self) -> dict:
        return {"view": self.view.to_jsonable(),
                "schedule": [e.to_jsonable() for e in self.schedule],
                "log": [{"event": e.to_jsonable(), "view": v.to_jsonable()}
                        for e, v in self.log]}


def view_trace(initial: int | Iterable[int],
               events: Sequence[MembershipEvent],
               num_steps: int) -> list[tuple[int, int, WorkerView]]:
    """Pure offline expansion of a schedule into ``(start, stop, view)``.

    Walks steps ``0..num_steps`` applying every event at its stamped
    step (crashes count as leaves — the replayer does not model the
    rollback window, only the view each step runs under) and returns the
    maximal constant-view phases.  Used by :mod:`repro_torch.elastic.replay`.
    """
    ledger = Membership(initial, schedule=events)
    phases: list[tuple[int, int, WorkerView]] = []
    current, start = ledger.view, 0
    for step in range(num_steps):
        due = ledger.step_events(step)
        for ev in due:
            ledger.apply(ev)
        if due and ledger.view.epoch != current.epoch:
            if step > start:
                phases.append((start, step, current))
            current, start = ledger.view, step
    phases.append((start, num_steps, current))
    return phases
