"""Schedule-backend registry: the Fabric extension seam.

Port of ``repro/fabric/registry.py``.  A *schedule backend* owns the
algorithm that carries a codec across the workers (psum, dense votes,
packed all_to_all, ...).  Backends register under a string name and are
resolved by :func:`get_schedule`; dispatch never hardcodes a schedule::

    @register_schedule("my_sched")
    class MySched:
        name = "my_sched"
        def aggregate(self, ctx, g, policy, ef=None):
            return my_collective(g, ctx.group), ef
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

from ..core.modes import schedule_name
from ..core.registry import Registry


@dataclasses.dataclass(frozen=True)
class AggregationContext:
    """Session facts a backend needs to run its collective.

    ``group``         — the worker group (:mod:`repro_torch.core.collectives`);
    ``num_workers``   — its size, the paper's W;
    ``fused_kernels`` — run vote codecs' fused kernel sets; False pins
                        the staged four-kernel chain (the session's
                        ``fused_kernels=False`` A/B switch; same bits);
    ``mesh``          — the :class:`~repro_torch.core.collectives.
                        ProcessMesh` of a session on a mesh (its model
                        group serves the schedules that see a leaf
                        with a ``model_spec`` whole), else None.
    """
    group: Any = None
    num_workers: int = 1
    fused_kernels: bool = True
    mesh: Any = None


@runtime_checkable
class ScheduleBackend(Protocol):
    """Protocol every registered schedule backend implements.

    ``aggregate(ctx, g, policy, ef)`` takes per-worker gradients (local
    ranks on the leading axis) and returns ``(aggregate, new_ef)``, the
    aggregate replicated without that axis.  Backends that set
    ``fusable = True`` also implement ``aggregate_flat(ctx, flat, codec,
    *, gate=None)`` over a (ranks, N) bucket payload; ``threads_ef =
    True`` lets the bucket layer inject/update EF per leaf around it.
    ``wire_bytes_per_device(n, mode, num_workers)`` prices
    the schedule for the traffic model.
    """

    name: str

    def aggregate(self, ctx: AggregationContext, g: Any, policy: Any,
                  ef: Any | None = None) -> tuple[Any, Any | None]: ...


def _prepare_schedule(obj: Any, keys) -> ScheduleBackend:
    return obj() if isinstance(obj, type) else obj


_REGISTRY = Registry("schedule backend", key_fn=schedule_name,
                     prepare=_prepare_schedule,
                     register_hint="@register_schedule({key!r})")


def register_schedule(name: Any, *aliases: Any, override: bool = False):
    """Class/instance decorator registering a backend under ``name``."""
    return _REGISTRY.register(name, *aliases, override=override)


def unregister_schedule(name: Any) -> None:
    """Remove a backend and every alias bound to the same instance."""
    _REGISTRY.unregister(name)


def get_schedule(name: Any) -> ScheduleBackend:
    """Resolve a schedule name (str or Schedule enum) to its backend."""
    return _REGISTRY.get(name)


def available_schedules() -> tuple[str, ...]:
    return _REGISTRY.available()
