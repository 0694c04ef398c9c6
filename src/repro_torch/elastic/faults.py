"""Pluggable fault models: what goes wrong, expressed once for two paths
(port of ``repro/elastic/faults.py``, plain Python).

A fault model is a small object describing one failure scenario through
three hooks, each a pure function of the step number:

  * :meth:`FaultModel.membership_events` — membership changes the fault
    causes (a ``crash`` removes a worker; its optional rejoin adds it
    back), consumed live by the ElasticTrainer and statically by the
    offline replayer (:mod:`repro_torch.elastic.replay`);
  * :meth:`FaultModel.step_time_scale` — per-worker step-time inflation
    (``straggler``), feeding the detector and the replayer's per-phase
    compute time;
  * :meth:`FaultModel.bandwidth_scale` — fleet-wide link-bandwidth cuts
    (``link_degrade``), scaling the replayed topology's link rate.

Models are registered on the shared
:class:`repro_torch.core.registry.Registry`
machinery under string names (``@register_fault``), same contract as
schedule backends / codecs / controllers / topologies / serve policies:
``make_fault("crash", worker=3, step=8)`` anywhere a spec is stringly
typed, instances anywhere code is in charge.
"""
from __future__ import annotations

from typing import Any, Sequence

from ..core.registry import Registry
from .membership import MembershipEvent

__all__ = ["FaultModel", "Crash", "Straggler", "LinkDegrade",
           "register_fault", "unregister_fault", "get_fault", "make_fault",
           "available_faults", "resolve_faults",
           "combined_step_time_scale", "combined_bandwidth_scale"]


class FaultModel:
    """Base fault model: no-op hooks, one-shot membership-event firing.

    Subclasses override :meth:`scheduled_events` (static event list, used
    by the offline replayer) and/or the scale hooks.  The live-path
    :meth:`membership_events` derives from :meth:`scheduled_events` with
    exactly-once firing, so checkpoint-rollback replay through the same
    step numbers cannot re-fire a crash.
    """

    name = "fault"

    def __init__(self):
        self._fired: set[MembershipEvent] = set()

    def scheduled_events(self) -> tuple[MembershipEvent, ...]:
        """All membership events this fault will ever cause (static)."""
        return ()

    def membership_events(self, step: int) -> tuple[MembershipEvent, ...]:
        """Events due at ``step`` that have not fired yet (live path)."""
        due = tuple(e for e in self.scheduled_events()
                    if e.step <= step and e not in self._fired)
        self._fired.update(due)
        return due

    def step_time_scale(self, step: int, worker: int) -> float:
        """Multiplier on ``worker``'s step time at ``step`` (1.0 = none)."""
        return 1.0

    def bandwidth_scale(self, step: int) -> float:
        """Multiplier on link bandwidth at ``step`` (1.0 = none)."""
        return 1.0

    def reset(self) -> None:
        """Forget firing state (fresh run over the same schedule)."""
        self._fired.clear()

    def to_jsonable(self) -> dict:
        return {"name": self.name,
                "events": [e.to_jsonable() for e in self.scheduled_events()]}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _describe(obj: Any) -> str:
    return getattr(obj, "__name__", type(obj).__name__)


_FAULTS = Registry("fault model", key_fn=str, describe=_describe,
                   register_hint="@register_fault({key!r})",
                   format_available=", ".join)


def register_fault(name: str, *aliases: str, override: bool = False):
    """Class/factory decorator: register a fault model under ``name``.

    The registered object is called with ``make_fault``'s kwargs and must
    return a :class:`FaultModel`-shaped instance (the three hooks above).
    """
    return _FAULTS.register(name, *aliases, override=override)


def unregister_fault(name: str) -> None:
    _FAULTS.unregister(name)


def get_fault(name: str):
    """The registered factory (class) for ``name``."""
    return _FAULTS.get(name)


def make_fault(name: str, **kwargs) -> FaultModel:
    """Instantiate a registered fault model: ``make_fault("crash", ...)``."""
    return _FAULTS.get(name)(**kwargs)


def available_faults() -> tuple[str, ...]:
    return tuple(_FAULTS.available())


def resolve_faults(specs: Sequence) -> tuple[FaultModel, ...]:
    """Normalize a mixed fault spec list into instances.

    Accepts instances, ``(name, kwargs)`` pairs, and ``{"name": ...,
    **kwargs}`` dicts — the shapes a JSON scenario file produces.
    """
    out = []
    for spec in specs:
        if isinstance(spec, tuple):
            name, kwargs = spec
            out.append(make_fault(name, **kwargs))
        elif isinstance(spec, dict):
            kwargs = dict(spec)
            out.append(make_fault(kwargs.pop("name"), **kwargs))
        else:
            out.append(spec)
    return tuple(out)


# ---------------------------------------------------------------------------
# built-ins
# ---------------------------------------------------------------------------

@register_fault("crash")
class Crash(FaultModel):
    """Worker ``worker`` crashes at ``step``; optionally rejoins later.

    The crash is involuntary — the ElasticTrainer rolls back to the last
    durable checkpoint and replays under the shrunken view.  The rejoin
    (if any) is graceful: a step-boundary re-plan with no rollback.
    """

    name = "crash"

    def __init__(self, worker: int, step: int, rejoin_step: int | None = None):
        super().__init__()
        if rejoin_step is not None and rejoin_step <= step:
            raise ValueError(f"rejoin_step {rejoin_step} must come after "
                             f"the crash step {step}")
        self.worker, self.step, self.rejoin_step = worker, step, rejoin_step

    def scheduled_events(self) -> tuple[MembershipEvent, ...]:
        events = [MembershipEvent(self.step, "crash", self.worker)]
        if self.rejoin_step is not None:
            events.append(MembershipEvent(self.rejoin_step, "join",
                                          self.worker))
        return tuple(events)


@register_fault("straggler")
class Straggler(FaultModel):
    """Worker ``worker`` runs ``factor``x slow on steps [start, stop)."""

    name = "straggler"

    def __init__(self, worker: int, start: int, stop: int,
                 factor: float = 4.0):
        super().__init__()
        if factor < 1.0:
            raise ValueError(f"straggler factor {factor} must be >= 1")
        self.worker, self.start, self.stop = worker, start, stop
        self.factor = float(factor)

    def step_time_scale(self, step: int, worker: int) -> float:
        if worker == self.worker and self.start <= step < self.stop:
            return self.factor
        return 1.0

    def to_jsonable(self) -> dict:
        return {"name": self.name, "worker": self.worker,
                "start": self.start, "stop": self.stop,
                "factor": self.factor}


@register_fault("link_degrade")
class LinkDegrade(FaultModel):
    """Fleet-wide link bandwidth drops to ``factor``x on [start, stop)."""

    name = "link_degrade"

    def __init__(self, start: int, stop: int, factor: float = 0.25):
        super().__init__()
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"link_degrade factor {factor} must be in "
                             f"(0, 1]")
        self.start, self.stop, self.factor = start, stop, float(factor)

    def bandwidth_scale(self, step: int) -> float:
        return self.factor if self.start <= step < self.stop else 1.0

    def to_jsonable(self) -> dict:
        return {"name": self.name, "start": self.start, "stop": self.stop,
                "factor": self.factor}


def combined_step_time_scale(faults: Sequence[FaultModel], step: int,
                             worker: int) -> float:
    """Max over models — concurrent slowdowns do not stack multiplicatively."""
    return max([f.step_time_scale(step, worker) for f in faults],
               default=1.0)


def combined_bandwidth_scale(faults: Sequence[FaultModel],
                             step: int) -> float:
    """Min over models — the tightest cut governs the link."""
    return min([f.bandwidth_scale(step) for f in faults], default=1.0)
