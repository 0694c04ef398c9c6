"""Admission control plane: Predictor, Commander and Supervisor.

Port of ``repro/core/admission.py``.  The paper's Section 3
organizes policy into three roles:

  * **Commander** — proposes a mode per layer group from the cosine
    diagnostics (the Section 8 ladder: the lowest-traffic mode whose
    alignment passes; sensitive groups stay on FP32).
  * **Supervisor** — the training-health guard: a one-sided CUSUM on the
    loss trend (Page, 1954) triggers recovery to FP32, enforces a
    cooldown, and allows re-admission afterwards.
  * **Predictor** — forecasts collective pressure (gradient volume,
    wire bytes, all-reduce time) on the reference's modeled ring
    constants (:class:`~repro_torch.core.traffic.IciModel`); it never
    observes gradients, weights or the loss.

This module holds the math of the roles; the control loop that
sequences them is :mod:`repro_torch.fabric.control`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from .buckets import AdmissionPlan, GroupPolicy
from .modes import AggregationMode, Schedule
from .traffic import IciModel, plan_traffic_ratio, wire_bytes_per_device


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Predictor:
    """Communication-pressure forecasts from the traffic model.

    The times are :class:`~repro_torch.core.traffic.IciModel` outputs
    under the reference's modeled constants, not measurements.
    """
    num_workers: int
    ici: IciModel = dataclasses.field(default_factory=IciModel)

    def forecast(self, group_sizes: Mapping[str, int],
                 plan: AdmissionPlan) -> dict:
        grad_volume = sum(group_sizes.values()) * 4  # FP32 bytes produced
        per_group = {}
        total_time = 0.0
        total_bytes = 0.0
        for g, n in group_sizes.items():
            pol = plan.policy_for(g)
            b = wire_bytes_per_device(n, pol.mode, pol.resolved_schedule(),
                                      self.num_workers)
            t = self.ici.collective_time(b, self.num_workers)
            per_group[g] = {"wire_bytes": b, "time_s": t}
            total_time += t
            total_bytes += b
        return {
            "gradient_volume_bytes": grad_volume,
            "allreduce_time_s": total_time,
            "wire_bytes_per_device": total_bytes,
            "traffic_ratio": plan_traffic_ratio(group_sizes, plan),
            "per_group": per_group,
        }


# ---------------------------------------------------------------------------
# Commander (deterministic admission ladder)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Commander:
    """Maps per-group cosine diagnostics to the lowest-traffic passing mode.

    Ladder (paper Section 8): G-Binary if its alignment passes, else
    G-Ternary, else FP32.  Groups in ``always_fp32`` (norms by default)
    are never admitted.  ``binary_mode`` / ``ternary_mode`` are the
    codecs the two rungs admit; the diagnostics stay keyed ``"gbinary"``
    / ``"gternary"`` whatever codec realizes them.
    """
    tau_binary: float = 0.35
    tau_ternary: float = 0.30
    always_fp32: tuple = ("norms",)
    schedule: Schedule | None = None
    error_feedback: bool = False
    binary_mode: AggregationMode | str = AggregationMode.G_BINARY
    ternary_mode: AggregationMode | str = AggregationMode.G_TERNARY

    def propose(self, cosines: Mapping[str, Mapping[str, float]]
                ) -> AdmissionPlan:
        """cosines: group -> {'gbinary': cos, 'gternary': cos}."""
        policies = {}
        for g, c in cosines.items():
            if g in self.always_fp32:
                policies[g] = GroupPolicy(AggregationMode.FP32)
            elif c.get("gbinary", 0.0) >= self.tau_binary:
                policies[g] = GroupPolicy(self.binary_mode,
                                          self.schedule, self.error_feedback)
            elif c.get("gternary", 0.0) >= self.tau_ternary:
                policies[g] = GroupPolicy(self.ternary_mode,
                                          self.schedule, self.error_feedback)
            else:
                policies[g] = GroupPolicy(AggregationMode.FP32)
        return AdmissionPlan.from_dict(
            policies, default=GroupPolicy(AggregationMode.FP32))


# ---------------------------------------------------------------------------
# Supervisor (CUSUM training-health guard)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CusumGuard:
    """One-sided CUSUM on the loss trend (Page 1954).

    s_t = max(0, s_{t-1} + (loss_t - mu_t - kappa)); trigger when s_t > h.
    mu_t is an EWMA of the loss kept while healthy, so the statistic
    accumulates only sustained loss growth, not single-step noise.  A
    non-finite loss always triggers.
    """
    kappa: float = 0.01
    h: float = 0.25
    ewma: float = 0.05
    mu: float | None = None
    s: float = 0.0

    def update(self, loss: float) -> bool:
        loss = float(loss)
        if not math.isfinite(loss):
            return True
        if self.mu is None:
            self.mu = loss
            return False
        self.s = max(0.0, self.s + (loss - self.mu - self.kappa))
        triggered = self.s > self.h
        if not triggered:
            self.mu = (1 - self.ewma) * self.mu + self.ewma * loss
        return triggered

    def reset(self) -> None:
        self.mu, self.s = None, 0.0

    def state_dict(self) -> dict:
        return {"mu": self.mu, "s": self.s}

    def load_state_dict(self, state: dict) -> None:
        self.mu = None if state["mu"] is None else float(state["mu"])
        self.s = float(state["s"])


@dataclasses.dataclass
class Supervisor:
    """Keeps or recovers to FP32 when training-health telemetry is unsafe."""
    guard: CusumGuard = dataclasses.field(default_factory=CusumGuard)
    cooldown_steps: int = 50
    _cooldown_left: int = 0

    def observe(self, loss: float) -> bool:
        """True when a recovery to FP32 must happen now."""
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self.guard.update(loss)  # keep mu tracking during cooldown
            return False
        if self.guard.update(loss):
            self._cooldown_left = self.cooldown_steps
            self.guard.reset()
            return True
        return False

    @property
    def in_cooldown(self) -> bool:
        return self._cooldown_left > 0

    def state_dict(self) -> dict:
        return {"cooldown_left": self._cooldown_left,
                "guard": self.guard.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._cooldown_left = int(state["cooldown_left"])
        self.guard.load_state_dict(state["guard"])


# ---------------------------------------------------------------------------
# control events (the mode latch's audit trail)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ControlEvent:
    step: int
    kind: str            # warmup_end | admitted | recovery | readmitted
    plan_signature: str
