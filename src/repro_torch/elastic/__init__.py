"""Elastic membership, fault injection and async strategies (port of
``repro.elastic``).

The paper's premise is a fabric-resident aggregation path that training
sessions attach to and detach from; this package makes the fleet
dynamic while everything underneath stays the registry-driven stack:

  * :mod:`membership` — epoch-numbered :class:`WorkerView` ledger with
    deterministic join/leave/crash schedules;
  * :mod:`faults`    — ``@register_fault`` registry (built-ins
    ``crash``, ``straggler``, ``link_degrade``) driving both live runs
    and offline replays from one scenario description;
  * :mod:`detector`  — per-worker step-time spike detection feeding
    ``Telemetry``, plus the ``straggler_aware`` admission controller;
  * :mod:`trainer`   — :class:`ElasticTrainer`: re-plans buckets and
    rebuilds the step on every membership epoch, rolls back to the last
    durable checkpoint on a crash (controller state included);
  * :mod:`strategies` — DeMoSim-style local-SGD expressed purely
    through the public codec/schedule/controller seams (``local``
    codec, ``local_accum`` transport, ``local_sgd`` controller);
  * :mod:`replay`    — the same schedule priced offline, per-phase
    exposed-time reporting through :mod:`repro_torch.sim`.

Importing the package registers the built-in fault models, the
``straggler_aware``/``local_sgd`` controllers, the ``local`` codec, and
the ``local_accum`` schedule backend.
"""
from .detector import StepTimeStats, StragglerAwareController, StragglerDetector
from .faults import (Crash, FaultModel, LinkDegrade, Straggler,
                     available_faults, combined_bandwidth_scale,
                     combined_step_time_scale, get_fault, make_fault,
                     register_fault, resolve_faults, unregister_fault)
from .membership import Membership, MembershipEvent, WorkerView, view_trace
from .replay import (BANDWIDTH_KWARGS, ReplayPhase, ReplayReport,
                     replay_schedule)
from .strategies import (LocalAccumBackend, LocalAccumCodec,
                         LocalSgdController, local_plan)
from .trainer import ElasticConfig, ElasticFailure, ElasticTrainer

__all__ = [
    "BANDWIDTH_KWARGS", "Crash", "ElasticConfig", "ElasticFailure",
    "ElasticTrainer", "FaultModel", "LinkDegrade", "LocalAccumBackend",
    "LocalAccumCodec", "LocalSgdController", "Membership",
    "MembershipEvent", "ReplayPhase", "ReplayReport", "StepTimeStats",
    "Straggler", "StragglerAwareController", "StragglerDetector",
    "WorkerView", "available_faults", "combined_bandwidth_scale",
    "combined_step_time_scale", "get_fault", "local_plan", "make_fault",
    "register_fault", "replay_schedule", "resolve_faults",
    "unregister_fault", "view_trace",
]
