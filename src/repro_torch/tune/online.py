"""Online re-ranking: the tuned shortlist as a runtime controller.

Port of ``repro/tune/online.py``.

The offline tuner certifies its ranking against the simulator; the
``"tuned"`` controller closes the loop against reality.  It starts on
the :class:`~repro_torch.tune.artifact.TunedPlan`'s winner and watches live
:class:`~repro_torch.fabric.control.Telemetry` step times.  While the
observed EWMA stays within ``tolerance`` of the sim's prediction the
latch never moves — the offline decision stands.  When observations
breach the band for ``patience`` consecutive steps (the sim mispriced
this machine: different link rates, a noisy neighbor, a slow NIC), the
controller re-ranks the artifact's *sim-certified* entries by observed
time where it has observations and predicted time where it does not,
latches the new best, and emits a ``"retune"`` control event.

Only entries sharing the winner's ``bucket_bytes`` are eligible: the
bucket budget is a session/compile-time knob (it changes the layout the
step cache is keyed on), not a per-step latch — switching it mid-run is
a recompile, which is the offline tuner's job, not a controller's.

Registered as ``"tuned"`` on ``repro_torch.tune`` import, so
``fabric.attach_controller("tuned", tuned=artifact)`` works exactly
like attaching ``"paper"`` or ``"static"``.
"""
from __future__ import annotations

from typing import Mapping

from ..core.admission import ControlEvent
from ..core.buckets import AdmissionPlan
from ..fabric.control import Telemetry, register_controller
from .artifact import TunedPlan

__all__ = ["TunedPlanController"]


@register_controller("tuned")
class TunedPlanController:
    """Latch a TunedPlan's winner; re-rank its shortlist on live misses.

    ``tuned``     — a :class:`TunedPlan` or a path to a saved artifact.
    ``patience``  — consecutive out-of-band steps before a re-rank.
    ``tolerance`` — relative band around the predicted step time
                    (0.25 = switch only when >25% slower than the sim
                    said).
    ``alpha``     — EWMA smoothing for observed step times.
    """

    name = "tuned"
    wants_diagnostics = False

    def __init__(self, tuned: TunedPlan | str, *, patience: int = 5,
                 tolerance: float = 0.25, alpha: float = 0.3):
        if isinstance(tuned, str):
            tuned = TunedPlan.load(tuned)
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.tuned = tuned
        self.patience = int(patience)
        self.tolerance = float(tolerance)
        self.alpha = float(alpha)
        # eligible latch targets: the winner plus every sim-certified
        # runner-up at the same bucket budget, keyed by candidate name
        self._entries: dict[str, tuple[AdmissionPlan, float]] = {
            tuned.name: (tuned.plan, float(tuned.score.step_time_s))}
        for r in tuned.runners_up:
            if r.score is not None and r.bucket_bytes == tuned.bucket_bytes:
                self._entries.setdefault(
                    r.name, (r.plan, float(r.score.step_time_s)))
        self._active = tuned.name
        self._ewma: dict[str, float] = {}
        self._strikes = 0
        self.events: list[ControlEvent] = []

    # -- Controller surface ----------------------------------------------

    @property
    def plan(self) -> AdmissionPlan:
        return self._entries[self._active][0]

    @property
    def active(self) -> str:
        """Name of the currently latched shortlist entry."""
        return self._active

    def predicted(self, name: str | None = None) -> float:
        """The sim-predicted step time for an entry (default: active)."""
        return self._entries[name or self._active][1]

    def _expected(self, name: str) -> float:
        """Observed EWMA where we have one, sim prediction where not."""
        return self._ewma.get(name, self._entries[name][1])

    def observe(self, telemetry: Telemetry) -> AdmissionPlan:
        t = telemetry.step_time_s
        if t is None:
            return self.plan
        prev = self._ewma.get(self._active)
        self._ewma[self._active] = (
            float(t) if prev is None
            else self.alpha * float(t) + (1.0 - self.alpha) * prev)
        band = self._entries[self._active][1] * (1.0 + self.tolerance)
        if self._ewma[self._active] > band:
            self._strikes += 1
        else:
            self._strikes = 0
        if self._strikes >= self.patience:
            self._strikes = 0
            best = min(self._entries, key=lambda n: (self._expected(n), n))
            if best != self._active:
                self._active = best
                self.events.append(ControlEvent(
                    telemetry.step, "retune", self.plan.signature()))
        return self.plan

    # -- persistence -------------------------------------------------------

    def state_dict(self) -> dict:
        return {"tuned": self.tuned.to_jsonable(),
                "active": self._active,
                "ewma": dict(self._ewma),
                "strikes": self._strikes,
                "events": [[e.step, e.kind, e.plan_signature]
                           for e in self.events]}

    def load_state_dict(self, state: Mapping) -> None:
        self.tuned = TunedPlan.from_jsonable(state["tuned"])
        self._entries = {
            self.tuned.name: (self.tuned.plan,
                              float(self.tuned.score.step_time_s))}
        for r in self.tuned.runners_up:
            if (r.score is not None
                    and r.bucket_bytes == self.tuned.bucket_bytes):
                self._entries.setdefault(
                    r.name, (r.plan, float(r.score.step_time_s)))
        if state["active"] not in self._entries:
            raise ValueError(
                f"checkpointed active entry {state['active']!r} not in "
                f"this artifact's shortlist ({sorted(self._entries)})")
        self._active = state["active"]
        self._ewma = {k: float(v) for k, v in state["ewma"].items()}
        self._strikes = int(state["strikes"])
        self.events = [ControlEvent(int(s), k, sig)
                       for s, k, sig in state["events"]]
