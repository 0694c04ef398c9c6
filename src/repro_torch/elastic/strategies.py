"""Local-SGD / async gradient strategies through the public seams (port
of ``repro/elastic/strategies.py``).

DeMoSim's ``TrainNode`` carries a pluggable ``gradient_strategy``; here
the same idea decomposes onto the three seams this repo already has —
no edits inside ``fabric/backends.py`` dispatch:

  * a **codec** (``local``) whose wire payload is zero bits — nothing
    crosses the fabric on a local step, and ``plan_traffic_ratio``
    prices it honestly at 0;
  * a **schedule backend** (``local_accum``) that skips the collective
    entirely and banks the step's gradient into the error-feedback
    residual (``e' = e + g``), returning a zero aggregate — the
    optimizer still runs (LR schedules and momentum decay advance), but
    parameters only move on sync steps;
  * a **controller** (``local_sgd``) alternating ``H - 1`` local
    plan-latches with one sync latch whose codec threads EF, so the
    banked sum ``Σg`` is injected as ``g_eff = g + e`` at the sync
    step and voted fleet-wide (DeMoSim's sign-of-accumulated-gradient
    exchange).

Because each piece is independently registered, every existing surface
composes for free: the plan signature keys the jit cache, the sim
prices the sync step's wire bytes and the local step at zero, and the
ElasticTrainer re-plans the whole strategy across membership changes.

In the port a gradient leaf reaches a backend with the group's local
ranks on its leading axis, ``(L, *shape)``, and its EF residual rows
alike; the aggregate leaves replicated, ``(*shape)``.
"""
from __future__ import annotations

import torch

from ..core import AdmissionPlan, GroupPolicy
from ..core.admission import ControlEvent
from ..fabric.codecs import CodecLane, GradientCodec, register_codec
from ..fabric.control import (Telemetry, plan_from_jsonable, plan_presets,
                              plan_to_jsonable, register_controller)
from ..fabric.registry import AggregationContext, register_schedule

__all__ = ["LocalAccumCodec", "LocalAccumBackend", "LocalSgdController",
           "local_plan"]


@register_codec("local")
class LocalAccumCodec(GradientCodec):
    """Zero-wire codec for local (no-communication) steps.

    ``bits_per_element = 0`` makes the traffic model price local steps
    at zero; ``threads_ef`` lets the bucket layer hand the residual to
    the ``local_accum`` transport, which is where the accumulation
    actually lives.  ``reduction = "local"`` canonicalizes any built-in
    collective a policy might nominally name onto ``local_accum``
    (``core.modes.wire_schedule``): a zero-bit payload riding a real
    psum would ship FP32 bytes the traffic model prices at zero.
    """

    name = "local"
    bits_per_element = 0.0
    reduction = "local"
    threads_ef = True
    lane = CodecLane("fp32_bypass", fused=True)  # zero-wire: nothing to stage
    default_schedule = "local_accum"


@register_schedule("local_accum")
class LocalAccumBackend:
    """No-collective transport: bank the gradient, emit a zero update.

    Deliberately **not fusable**: the fused bucket path hardcodes the
    EF-signSGD residual update after scatter, while this transport *is*
    its own EF rule (pure accumulation).  Per-leaf dispatch keeps full
    control of the residual.  Requires ``error_feedback=True`` on the
    policy — without a residual there is nowhere to bank the step and
    the gradient would be silently dropped.
    """

    name = "local_accum"
    fusable = False
    threads_ef = True

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        if ef is None:
            raise ValueError(
                "local_accum requires error_feedback=True on the policy: "
                "the EF residual is the local accumulator")
        return (torch.zeros(g.shape[1:], dtype=g.dtype, device=g.device),
                (ef + g).to(ef.dtype))

    def wire_bytes_per_device(self, n_elements: int, mode, num_workers: int,
                              dtype_bytes: int = 4) -> float:
        return 0.0


def local_plan() -> AdmissionPlan:
    """Every group on the zero-wire local-accumulation path."""
    return AdmissionPlan(
        default=GroupPolicy("local", "local_accum", error_feedback=True))


@register_controller("local_sgd")
class LocalSgdController:
    """Sync-every-H strategy: H-1 zero-wire steps, then one EF sync.

    ``sync_plan`` must thread EF on **every** group — the local plan
    banks all groups' gradients into the residual, and only groups whose
    sync policy injects EF ever release them (a backbone-only sync plan
    would silently never train the head).  The default votes on
    ``sign(g + Σg_local)`` fleet-wide, the DeMoSim-style low-bit
    exchange of the accumulated direction; the residual then carries
    the quantization error forward per standard EF-signSGD.
    ``observe`` latches the plan for the *next* step, so with
    ``sync_every=H`` steps ``H-1, 2H-1, ...`` are sync steps.
    """

    name = "local_sgd"
    wants_diagnostics = False

    def __init__(self, sync_every: int = 8,
                 sync_plan: AdmissionPlan | str | None = None,
                 local: AdmissionPlan | None = None):
        if sync_every < 2:
            raise ValueError(f"sync_every {sync_every} must be >= 2")
        if sync_plan is None:
            sync_plan = AdmissionPlan.lowbit_all(
                "gbinary", schedule="vote_psum", error_feedback=True)
        elif isinstance(sync_plan, str):
            sync_plan = plan_presets(error_feedback=True)[sync_plan]
        self.sync_every = int(sync_every)
        self.sync_plan = sync_plan
        self.local_plan = local if local is not None else local_plan()
        self.observed = 0
        self.plan = self.local_plan
        self.events: list[ControlEvent] = []

    def observe(self, telemetry: Telemetry) -> AdmissionPlan:
        self.observed += 1
        nxt = ((self.observed + 1) % self.sync_every == 0)
        plan = self.sync_plan if nxt else self.local_plan
        if plan is not self.plan:
            self.events.append(ControlEvent(
                telemetry.step, "sync" if nxt else "local",
                plan.signature()))
        self.plan = plan
        return self.plan

    def state_dict(self) -> dict:
        return {"observed": self.observed,
                "plan": plan_to_jsonable(self.plan)}

    def load_state_dict(self, state: dict) -> None:
        self.observed = int(state["observed"])
        self.plan = plan_from_jsonable(state["plan"])
