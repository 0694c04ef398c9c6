"""Straggler/spike detection from per-worker step-time statistics (port
of ``repro/elastic/detector.py``, plain Python).

The ElasticTrainer times every step per worker (wall time on the live
path, fault-scaled nominal time on deterministic runs) and feeds the
mapping to a :class:`StragglerDetector`, which flags workers whose step
time spikes relative to the fleet median.  The resulting
:class:`StepTimeStats` ride into :class:`repro_torch.fabric.control.Telemetry`
(``worker_step_times`` / ``stragglers``), where any controller can react
— the built-in ``straggler_aware`` controller demotes the backbone to a
low-bit plan under sustained straggler pressure (shrinking the exposed
communication the slow worker serializes behind) and recovers to FP32
once membership and step times have been stable for a window.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from ..core import AdmissionPlan
from ..core.admission import ControlEvent
from ..fabric.control import (Telemetry, plan_from_jsonable, plan_presets,
                              plan_to_jsonable, register_controller)

__all__ = ["StepTimeStats", "StragglerDetector", "StragglerAwareController"]


@dataclasses.dataclass(frozen=True)
class StepTimeStats:
    """One step of fleet timing: who is slow, and by how much."""
    step: int
    times: Mapping[int, float]          # worker id -> step time (s)
    median_s: float
    max_s: float
    stragglers: tuple[int, ...]         # flagged worker ids, sorted

    @property
    def slowdown(self) -> float:
        """Fleet exposure ratio: slowest worker over the median."""
        return self.max_s / self.median_s if self.median_s > 0 else 1.0


class StragglerDetector:
    """Median-relative spike detector over per-worker EWMA step times.

    A worker is flagged when its smoothed step time exceeds
    ``threshold`` times the fleet median of smoothed times.  EWMA
    (``alpha``) absorbs one-off jitter (GC pauses, first-step compile)
    without missing a sustained slowdown; ``warmup`` steps are observed
    but never flagged, since compile-heavy early steps are all spikes.
    """

    def __init__(self, threshold: float = 2.0, alpha: float = 0.3,
                 warmup: int = 1):
        if threshold <= 1.0:
            raise ValueError(f"threshold {threshold} must be > 1")
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self._ewma: dict[int, float] = {}
        self._seen = 0

    def observe(self, step: int,
                times: Mapping[int, float]) -> StepTimeStats:
        for w, t in times.items():
            prev = self._ewma.get(w)
            self._ewma[w] = (float(t) if prev is None
                             else self.alpha * float(t)
                             + (1 - self.alpha) * prev)
        # drop departed workers so a shrunken fleet's median is honest
        self._ewma = {w: v for w, v in self._ewma.items() if w in times}
        self._seen += 1
        smoothed = sorted(self._ewma.values())
        n = len(smoothed)
        median = (smoothed[n // 2] if n % 2 == 1
                  else 0.5 * (smoothed[n // 2 - 1] + smoothed[n // 2]))
        flagged: tuple[int, ...] = ()
        if self._seen > self.warmup and median > 0:
            flagged = tuple(sorted(
                w for w, v in self._ewma.items()
                if v > self.threshold * median))
        return StepTimeStats(step=int(step), times=dict(times),
                             median_s=median,
                             max_s=max(times.values(), default=0.0),
                             stragglers=flagged)

    def state_dict(self) -> dict:
        return {"ewma": {str(w): v for w, v in self._ewma.items()},
                "seen": self._seen}

    def load_state_dict(self, state: dict) -> None:
        self._ewma = {int(w): float(v) for w, v in state["ewma"].items()}
        self._seen = int(state["seen"])


@register_controller("straggler_aware")
class StragglerAwareController:
    """Demote to low-bit under straggler pressure; recover when stable.

    Reads only the elastic Telemetry fields (``stragglers``,
    ``membership_epoch``) — never raw timings — and latches one of two
    plans: ``fp32_plan`` nominally, ``lowbit_plan`` after
    ``demote_after`` consecutive straggler-flagged steps.  Recovery to
    FP32 requires ``recover_after`` consecutive *stable* steps, where a
    step is stable only when no straggler is flagged **and** the
    membership epoch did not change — a churning fleet keeps the cheap
    plan until it settles.
    """

    name = "straggler_aware"
    wants_diagnostics = False

    def __init__(self, lowbit_plan: AdmissionPlan | str = "gbin_vote",
                 fp32_plan: AdmissionPlan | str = "fp32",
                 demote_after: int = 2, recover_after: int = 8):
        presets = plan_presets(error_feedback=True)
        if isinstance(lowbit_plan, str):
            lowbit_plan = presets[lowbit_plan]
        if isinstance(fp32_plan, str):
            fp32_plan = presets[fp32_plan]
        self.lowbit_plan, self.fp32_plan = lowbit_plan, fp32_plan
        self.demote_after = int(demote_after)
        self.recover_after = int(recover_after)
        self.plan = fp32_plan
        self.phase = "fp32"
        self.events: list[ControlEvent] = []
        self._pressure = 0
        self._stable = 0
        self._last_epoch: int | None = None

    def observe(self, telemetry: Telemetry) -> AdmissionPlan:
        epoch = telemetry.membership_epoch
        epoch_changed = (self._last_epoch is not None
                         and epoch is not None
                         and epoch != self._last_epoch)
        self._last_epoch = epoch if epoch is not None else self._last_epoch
        if telemetry.stragglers:
            self._pressure += 1
            self._stable = 0
        else:
            self._pressure = 0
            self._stable = 0 if epoch_changed else self._stable + 1
        if self.phase == "fp32" and self._pressure >= self.demote_after:
            self.phase, self.plan = "lowbit", self.lowbit_plan
            self._stable = 0
            self.events.append(ControlEvent(telemetry.step, "demoted",
                                            self.plan.signature()))
        elif self.phase == "lowbit" and self._stable >= self.recover_after:
            self.phase, self.plan = "fp32", self.fp32_plan
            self._pressure = 0
            self.events.append(ControlEvent(telemetry.step, "recovered",
                                            self.plan.signature()))
        return self.plan

    def state_dict(self) -> dict:
        return {"phase": self.phase,
                "plan": plan_to_jsonable(self.plan),
                "pressure": self._pressure, "stable": self._stable,
                "last_epoch": self._last_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.phase = state["phase"]
        self.plan = plan_from_jsonable(state["plan"])
        self._pressure = int(state["pressure"])
        self._stable = int(state["stable"])
        self._last_epoch = state["last_epoch"]
