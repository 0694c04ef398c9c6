"""The admission control plane: telemetry, plan presets, the phase
program and the controller registry.

Port of ``repro/fabric/control.py``.  The paper's headline mechanism is
its control interface (Sections 3 and 8): warm-up on FP32, layer-aware
admission to G-Binary/G-Ternary, guarded recovery, re-admission.

  * :class:`Telemetry` — the typed per-step record a controller observes
    (step, loss, per-group cosines, traffic ratio, step time).
  * :func:`plan_presets` — the named plans every launcher shares, plus
    the ones registered at run time (:func:`register_plan_preset`).
  * :class:`PolicyProgram` — a declarative phase machine that owns the
    mode latch and the control-event log.
  * :class:`Controller` and ``@register_controller`` — policies by name:
    ``"paper"`` (alias ``"adaptive"``, the Commander/Supervisor ladder),
    ``"static"`` and ``"fp32"``; importing :mod:`repro_torch.tune` adds
    ``"tuned"`` (:class:`~repro_torch.tune.TunedPlanController`).

Controllers read telemetry and write mode metadata (an
:class:`~repro_torch.core.buckets.AdmissionPlan`), never gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Protocol, Sequence, \
    runtime_checkable

from ..core.admission import Commander, ControlEvent, Supervisor
from ..core.buckets import AdmissionPlan, GroupPolicy
from ..core.modes import (AggregationMode, Schedule, canonical_mode,
                          codec_name, schedule_name)
from ..core.registry import Registry

__all__ = [
    "Controller", "ControlEvent", "FP32Controller", "PaperController",
    "Phase", "PolicyProgram", "StaticController", "Telemetry",
    "available_controllers", "get_controller", "make_controller",
    "plan_from_jsonable", "plan_presets", "plan_to_jsonable",
    "register_controller", "register_plan_preset",
    "unregister_controller", "unregister_plan_preset",
]


# ---------------------------------------------------------------------------
# Telemetry: the typed per-step record controllers observe
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Telemetry:
    """One step of training-runtime telemetry, as the controller sees it.

    ``cosines`` is ``group -> {"gbinary": cos, "gternary": cos}`` when the
    step ran with diagnostics (calibration), else None.  The record is
    the only channel between the runtime and a controller.

    Under a process group every rank runs its own controller, so a
    decision may read only replicated values: ``step``, ``loss`` (the
    mean over ranks), the ``cosines`` of the replicated aggregate,
    ``traffic_ratio``, ``restart``, ``plan_signature`` and
    ``step_time_s``, which the Trainer reduces to the slowest rank's
    wall time (an all-reduce with ``max``) before a controller sees it.
    Ranks that latched different plans would run collectives that no
    longer match, and hang.

    The elastic fields (:mod:`repro_torch.elastic`): each worker's step
    time by worker id, the detector's flagged stragglers and the
    membership epoch the step ran under; None and () on a run of fixed
    membership, so other controllers never see them.
    """
    step: int
    loss: float
    cosines: Mapping[str, Mapping[str, float]] | None = None
    traffic_ratio: float | None = None
    step_time_s: float | None = None
    restart: bool = False
    plan_signature: str | None = None
    worker_step_times: Mapping[int, float] | None = None
    stragglers: tuple = ()
    membership_epoch: int | None = None

    @staticmethod
    def from_metrics(step: int, metrics: Mapping[str, Any], *,
                     step_time_s: float | None = None,
                     restart: bool = False) -> "Telemetry":
        """Adapt one step's metrics dict into a Telemetry record: the one
        place where ``cos/{group}/{mode}`` keys are parsed."""
        cosines: dict[str, dict[str, float]] = {}
        for k, v in metrics.items():
            if k.startswith("cos/"):
                _, group, mode = k.split("/", 2)
                cosines.setdefault(group, {})[mode] = float(v)
        tr = metrics.get("traffic_ratio")
        return Telemetry(step=int(step), loss=float(metrics["loss"]),
                         cosines=cosines or None,
                         traffic_ratio=None if tr is None else float(tr),
                         step_time_s=step_time_s, restart=restart,
                         plan_signature=metrics.get("plan"))


# ---------------------------------------------------------------------------
# plan (de)serialization: controllers checkpoint their latched plans
# ---------------------------------------------------------------------------

_PLAN_TAG = "__admission_plan__"
_TUPLE_TAG = "__tuple__"


def plan_to_jsonable(plan: AdmissionPlan) -> dict:
    """AdmissionPlan -> JSON-serializable dict (the reference's format)."""
    def enc(p: GroupPolicy) -> dict:
        return {"mode": codec_name(p.mode),
                "schedule": (None if p.schedule is None
                             else schedule_name(p.schedule)),
                "error_feedback": bool(p.error_feedback)}
    return {_PLAN_TAG: {
        "policies": [[g, enc(p)] for g, p in plan.policies],
        "default": enc(plan.default)}}


def plan_from_jsonable(obj: dict) -> AdmissionPlan:
    """Inverse of :func:`plan_to_jsonable`; signature-preserving."""
    body = obj[_PLAN_TAG]

    def dec(d: dict) -> GroupPolicy:
        sched = d["schedule"]
        if sched is not None:
            try:                       # a built-in enum if it is one, else
                sched = Schedule(sched)  # a registered custom-backend name
            except ValueError:
                pass
        return GroupPolicy(canonical_mode(d["mode"]), sched,
                           bool(d["error_feedback"]))

    return AdmissionPlan(
        policies=tuple((g, dec(p)) for g, p in body["policies"]),
        default=dec(body["default"]))


def _payload_to_jsonable(plan: Any) -> Any:
    """Latch payload -> JSON: an AdmissionPlan, or a tuple such as the
    experiments harness's (backbone, head) rule-name pair."""
    if isinstance(plan, AdmissionPlan):
        return plan_to_jsonable(plan)
    if isinstance(plan, tuple):
        return {_TUPLE_TAG: list(plan)}
    return plan


def _payload_from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict) and _PLAN_TAG in obj:
        return plan_from_jsonable(obj)
    if isinstance(obj, dict) and _TUPLE_TAG in obj:
        return tuple(obj[_TUPLE_TAG])
    return obj


def _sig(plan: Any) -> str:
    return plan.signature() if hasattr(plan, "signature") else repr(plan)


_FP32_SIG = AdmissionPlan.fp32_all().signature()


# ---------------------------------------------------------------------------
# named plan presets
# ---------------------------------------------------------------------------

def plan_presets(error_feedback: bool = False) -> dict[str, AdmissionPlan]:
    """Canonical named plans, one source for every launcher.

    ``gbin_vote``/``gter_vote`` pin the dense vote schedule; ``*_packed``
    pin the packed controller schedule; ``gbin_packed_embed`` also admits
    the embedding table while head and norms stay on FP32.  The
    ``*_backbone`` presets leave the schedule to the codec's default.
    ``int4_backbone`` / ``topk_backbone`` name the extension codecs
    (``psum``); they ignore ``error_feedback``, since neither codec
    threads EF. The ``hier_*`` presets put the backbone on the built-in
    hop plans (:mod:`repro_torch.fabric.hierarchy`): an intra-node FP32
    mean, then the named codec across the nodes; ``hier_fp32_int4``
    ignores ``error_feedback`` as ``int4_backbone`` does. Presets
    registered with :func:`register_plan_preset` merge last under their
    own names, as concrete plans.
    """
    ef = error_feedback
    packed = Schedule.PACKED_A2A
    return {
        "fp32": AdmissionPlan.fp32_all(),
        "gbin_backbone": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, error_feedback=ef),
        "gbin_vote": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, schedule=Schedule.VOTE_PSUM,
            error_feedback=ef),
        "gbin_packed": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, schedule=packed, error_feedback=ef),
        "gter_backbone": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, error_feedback=ef),
        "gter_vote": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, schedule=Schedule.VOTE_PSUM,
            error_feedback=ef),
        "lowbit_all": AdmissionPlan.lowbit_all(
            AggregationMode.G_BINARY, error_feedback=ef),
        "gbin_packed_all": AdmissionPlan.lowbit_all(
            AggregationMode.G_BINARY, schedule=packed, error_feedback=ef),
        "gbin_packed_embed": AdmissionPlan.from_dict(
            {"backbone": GroupPolicy(AggregationMode.G_BINARY, packed, ef),
             "embed": GroupPolicy(AggregationMode.G_BINARY, packed, ef)},
            default=GroupPolicy(AggregationMode.FP32)),
        "int4_backbone": AdmissionPlan.lowbit_backbone("int4"),
        "topk_backbone": AdmissionPlan.lowbit_backbone("topk"),
        "hier_fp32_gbinary": AdmissionPlan.lowbit_backbone(
            "hier_fp32_gbinary", error_feedback=ef),
        "hier_fp32_gternary": AdmissionPlan.lowbit_backbone(
            "hier_fp32_gternary", error_feedback=ef),
        "hier_fp32_int4": AdmissionPlan.lowbit_backbone("hier_fp32_int4"),
        **_EXTRA_PRESETS,
    }


#: presets registered at run time, merged into every plan_presets() call
_EXTRA_PRESETS: dict[str, AdmissionPlan] = {}

#: the built-in names, which register_plan_preset never shadows
_BUILTIN_PRESET_NAMES = frozenset(plan_presets())


def register_plan_preset(name: str, plan: AdmissionPlan, *,
                         override: bool = False) -> None:
    """Register a named plan so :func:`plan_presets` resolves it.

    Built-in names are never overridable; re-registering an extra name
    raises unless ``override=True``.
    """
    name = str(name)
    if name in _BUILTIN_PRESET_NAMES:
        raise ValueError(f"cannot replace built-in plan preset {name!r}; "
                         f"pick another name")
    if name in _EXTRA_PRESETS and not override:
        raise ValueError(f"plan preset {name!r} already registered; pass "
                         f"override=True to replace it")
    if not isinstance(plan, AdmissionPlan):
        raise TypeError(f"expected an AdmissionPlan, got "
                        f"{type(plan).__name__}")
    _EXTRA_PRESETS[name] = plan


def unregister_plan_preset(name: str) -> None:
    """Remove a registered preset (built-ins cannot be removed)."""
    if name in _BUILTIN_PRESET_NAMES:
        raise ValueError(f"cannot unregister built-in plan preset {name!r}")
    if name not in _EXTRA_PRESETS:
        raise KeyError(f"no registered plan preset {name!r}; extras: "
                       f"{tuple(sorted(_EXTRA_PRESETS))}")
    del _EXTRA_PRESETS[name]


# ---------------------------------------------------------------------------
# the PolicyProgram phase machine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Phase:
    """One named phase of a :class:`PolicyProgram`.

    ``plan``       — the latch payload in this phase: a value, a callable
                     ``(telemetry, program) -> payload``, or None to keep
                     the previous latch.
    ``transition`` — ``(telemetry, program) -> next phase name | None``;
                     None means the phase never advances by itself (it
                     can still be left through :meth:`PolicyProgram.enter`).
    ``latch``      — a callable plan is evaluated once on entry (True) or
                     on every advance (False: a live payload).
    ``event``      — the control-event kind emitted on entry (default:
                     the phase name).
    """
    name: str
    plan: Any = None
    transition: Callable[["Telemetry", "PolicyProgram"],
                         str | None] | None = None
    latch: bool = True
    event: str | None = None


class PolicyProgram:
    """Declarative phase machine owning the mode latch and the event log.

    ``events`` logs one :class:`ControlEvent` per phase entered after the
    start phase.  ``advance(telemetry)`` evaluates the current phase's
    transition, chaining through transitions that fire on the same
    telemetry, and returns the latched plan for the next step;
    ``enter(name, telemetry)`` jumps to a phase (how the Supervisor's
    recovery interrupt composes with the nominal flow).
    """

    def __init__(self, phases: Sequence[Phase], *, start: str | None = None,
                 plan: Any = None):
        if not phases:
            raise ValueError("PolicyProgram needs at least one phase")
        self.phases: dict[str, Phase] = {}
        for p in phases:
            if p.name in self.phases:
                raise ValueError(f"duplicate phase name {p.name!r}")
            self.phases[p.name] = p
        self.phase = start if start is not None else phases[0].name
        if self.phase not in self.phases:
            raise ValueError(f"unknown start phase {self.phase!r}; have "
                             f"{sorted(self.phases)}")
        first = self.phases[self.phase]
        if first.plan is not None and not callable(first.plan):
            plan = first.plan
        self.plan = plan
        # a latched callable on the start phase is evaluated on the first
        # advance, which brings the telemetry it needs
        self._entry_pending = (first.plan is not None
                               and callable(first.plan) and first.latch)
        self.entered_step = 0
        self.events: list[ControlEvent] = []

    def enter(self, name: str, telemetry: Telemetry | None = None) -> None:
        """Jump into phase ``name`` and emit its entry event.

        ``telemetry`` may be omitted only for a phase whose plan is not
        callable.
        """
        try:
            ph = self.phases[name]
        except KeyError:
            raise KeyError(f"unknown phase {name!r}; have "
                           f"{sorted(self.phases)}") from None
        if callable(ph.plan) and telemetry is None:
            raise ValueError(
                f"entering phase {name!r} requires telemetry: its plan is "
                f"computed from the telemetry record")
        self.phase = name
        self._entry_pending = False
        if telemetry is not None:
            self.entered_step = telemetry.step
        if ph.plan is not None:
            self.plan = (ph.plan(telemetry, self) if callable(ph.plan)
                         else ph.plan)
        self.events.append(ControlEvent(self.entered_step,
                                        ph.event or ph.name,
                                        _sig(self.plan)))

    def advance(self, telemetry: Telemetry) -> Any:
        """One step of policy; returns the latched plan for the next step."""
        first = True
        for _ in range(len(self.phases) + 1):
            ph = self.phases[self.phase]
            # a live plan re-evaluates every advance, a start phase's
            # latched callable on the first; a phase just entered through
            # enter() was evaluated there
            if (first and ph.plan is not None and callable(ph.plan)
                    and (not ph.latch or self._entry_pending)):
                self.plan = ph.plan(telemetry, self)
            self._entry_pending = first = False
            nxt = ph.transition(telemetry, self) if ph.transition else None
            if nxt is None or nxt == self.phase:
                return self.plan
            self.enter(nxt, telemetry)
        raise RuntimeError(
            f"phase transitions did not settle after visiting every phase "
            f"once (cycle through {sorted(self.phases)}?)")

    @staticmethod
    def staged(stages: Sequence[tuple[str, Any, int | None]]
               ) -> "PolicyProgram":
        """Linear step-bounded program: ``[(name, plan, until_step), ...]``.

        Each stage latches ``plan`` and advances to the next at the first
        telemetry with ``step >= until_step`` (None: terminal), e.g. the
        paper's "head on FP32 after step N"::

            PolicyProgram.staged([
                ("all_lowbit", lowbit_all_plan, 200),
                ("head_fp32", lowbit_backbone_plan, None)])
        """
        names = [s[0] for s in stages]
        phases = []
        for i, (name, plan, until) in enumerate(stages):
            transition = None
            if until is not None and i + 1 < len(stages):
                def transition(t, p, _until=until, _next=names[i + 1]):
                    return _next if t.step >= _until else None
            phases.append(Phase(name, plan=plan, transition=transition))
        return PolicyProgram(phases)

    # -- persistence -----------------------------------------------------

    def state_dict(self) -> dict:
        return {"phase": self.phase,
                "entered_step": self.entered_step,
                "plan": _payload_to_jsonable(self.plan),
                "events": [[e.step, e.kind, e.plan_signature]
                           for e in self.events]}

    def load_state_dict(self, state: dict) -> None:
        if state["phase"] not in self.phases:
            raise ValueError(f"checkpointed phase {state['phase']!r} not in "
                             f"this program ({sorted(self.phases)})")
        self.phase = state["phase"]
        self._entry_pending = False       # the latch itself was restored
        self.entered_step = int(state["entered_step"])
        self.plan = _payload_from_jsonable(state["plan"])
        self.events = [ControlEvent(int(s), k, sig)
                       for s, k, sig in state["events"]]


# ---------------------------------------------------------------------------
# Controller protocol + registry
# ---------------------------------------------------------------------------

@runtime_checkable
class Controller(Protocol):
    """What every registered controller implements.

    ``observe`` consumes one :class:`Telemetry` record and returns the
    :class:`AdmissionPlan` to latch for the next step; ``plan`` is the
    current latch.  Optional: ``wants_diagnostics`` (run the step with
    cosine diagnostics while True), ``state_dict()/load_state_dict()``
    and ``events``.
    """

    name: str
    plan: AdmissionPlan

    def observe(self, telemetry: Telemetry) -> AdmissionPlan: ...


#: controllers are stateful, so the registry holds factories and
#: make_controller constructs a fresh instance per call
_CONTROLLERS = Registry("controller", key_fn=str,
                        describe=lambda f: f.__name__,
                        register_hint="@register_controller({key!r})")


def register_controller(name: str, *aliases: str, override: bool = False):
    """Class/factory decorator registering a controller under ``name``
    (and ``aliases``); re-registering raises unless ``override=True``,
    which also sweeps the replaced factory's other aliases."""
    return _CONTROLLERS.register(name, *aliases, override=override)


def unregister_controller(name: str) -> None:
    """Remove a controller factory and all its aliases."""
    _CONTROLLERS.unregister(name)


def get_controller(name: str) -> Callable[..., Any]:
    """Resolve a controller name to its registered factory."""
    return _CONTROLLERS.get(name)


def make_controller(name: str, **kwargs) -> Any:
    """Construct a fresh controller instance from its registered name."""
    return get_controller(name)(**kwargs)


def available_controllers() -> tuple[str, ...]:
    return _CONTROLLERS.available()


# ---------------------------------------------------------------------------
# built-in controllers
# ---------------------------------------------------------------------------

@register_controller("static")
class StaticController:
    """Fixed-plan controller: always latches the plan it was built with
    (an :class:`AdmissionPlan` or a :func:`plan_presets` name).  Drives
    the Trainer down the controller path with the history of the static
    ``Trainer(..., plan=...)``."""

    name = "static"
    wants_diagnostics = False

    def __init__(self, plan: AdmissionPlan | str | None = None):
        if isinstance(plan, str):
            presets = plan_presets()
            if plan not in presets:
                raise KeyError(f"unknown plan preset {plan!r}; available: "
                               f"{tuple(sorted(presets))}")
            plan = presets[plan]
        self.plan = plan if plan is not None else AdmissionPlan.fp32_all()
        self.events: list[ControlEvent] = []

    def observe(self, telemetry: Telemetry) -> AdmissionPlan:
        return self.plan

    def state_dict(self) -> dict:
        return {"plan": plan_to_jsonable(self.plan)}

    def load_state_dict(self, state: dict) -> None:
        self.plan = plan_from_jsonable(state["plan"])


@register_controller("fp32")
class FP32Controller(StaticController):
    """Everything on the FP32 bypass path, forever (baseline runs)."""

    name = "fp32"

    def __init__(self):
        super().__init__(AdmissionPlan.fp32_all())


@register_controller("paper", "adaptive")
class PaperController:
    """The paper's Commander/Supervisor ladder as a controller.

    Phase program (Sections 3 and 8)::

        warmup --(warmup_steps observed)--> calibrate --(cosines)--> admitted
           admitted/readmitted --(CUSUM trigger)--> recovery
           recovery --(cooldown over)--> readmitted

    Admission retries while calibration cosines are pending, rather than
    being a one-shot window at ``step == warmup_steps``.  ``predictor`` is
    only stored, as in the reference.
    """

    name = "paper"

    def __init__(self, commander: Commander | None = None,
                 supervisor: Supervisor | None = None,
                 predictor: Any = None,
                 warmup_steps: int = 20):
        self.commander = commander or Commander()
        self.supervisor = supervisor or Supervisor()
        self.predictor = predictor
        self.warmup_steps = int(warmup_steps)
        self._observed = 0
        self._admitted_plan: AdmissionPlan | None = None
        self.program = PolicyProgram([
            Phase("warmup", plan=AdmissionPlan.fp32_all(),
                  transition=self._warmup_done),
            Phase("calibrate", transition=self._calibrated,
                  event="warmup_end"),
            Phase("admitted", plan=self._propose),
            Phase("recovery", plan=AdmissionPlan.fp32_all(),
                  transition=self._cooldown_over),
            Phase("readmitted", plan=self._repropose),
        ], plan=AdmissionPlan.fp32_all())

    # -- phase transitions / latches ------------------------------------

    def _warmup_done(self, t: Telemetry, prog: PolicyProgram) -> str | None:
        return "calibrate" if self._observed >= self.warmup_steps else None

    def _calibrated(self, t: Telemetry, prog: PolicyProgram) -> str | None:
        return "admitted" if t.cosines else None

    def _cooldown_over(self, t: Telemetry, prog: PolicyProgram) -> str | None:
        return None if self.supervisor.in_cooldown else "readmitted"

    def _propose(self, t: Telemetry, prog: PolicyProgram) -> AdmissionPlan:
        self._admitted_plan = self.commander.propose(t.cosines)
        return self._admitted_plan

    def _repropose(self, t: Telemetry, prog: PolicyProgram) -> AdmissionPlan:
        if t.cosines:              # recalibrate before re-admitting
            return self._propose(t, prog)
        return self._admitted_plan

    # -- Controller surface ---------------------------------------------

    @property
    def plan(self) -> AdmissionPlan:
        return self.program.plan

    @property
    def events(self) -> list[ControlEvent]:
        return self.program.events

    @property
    def wants_diagnostics(self) -> bool:
        """Keep the step emitting cosines until admission."""
        return self.program.phase in ("warmup", "calibrate")

    def observe(self, telemetry: Telemetry) -> AdmissionPlan:
        self._observed += 1
        recovering = self.supervisor.observe(telemetry.loss)
        if recovering and _sig(self.plan) != _FP32_SIG:
            self.program.enter("recovery", telemetry)
            return self.plan
        return self.program.advance(telemetry)

    # -- persistence ----------------------------------------------------

    def state_dict(self) -> dict:
        return {"observed": self._observed,
                "warmup_steps": self.warmup_steps,
                "admitted_plan": (None if self._admitted_plan is None
                                  else plan_to_jsonable(self._admitted_plan)),
                "supervisor": self.supervisor.state_dict(),
                "program": self.program.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._observed = int(state["observed"])
        # the checkpointed calibration window wins over the constructor's
        self.warmup_steps = int(state.get("warmup_steps",
                                          self.warmup_steps))
        ap = state["admitted_plan"]
        self._admitted_plan = None if ap is None else plan_from_jsonable(ap)
        self.supervisor.load_state_dict(state["supervisor"])
        self.program.load_state_dict(state["program"])
