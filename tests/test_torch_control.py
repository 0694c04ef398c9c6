"""The port's admission control plane against the reference's.

``repro_torch.fabric.control`` and ``repro_torch.core.admission`` driven
side by side with ``repro``'s on the same inputs:

  * the controller registry's round-trip and errors (as
    ``tests/test_control.py`` holds the reference's);
  * ``Telemetry.from_metrics``;
  * ``plan_to_jsonable`` equal to the reference's JSON for every preset
    both packages carry, and the ``register_plan_preset`` guards;
  * ``PolicyProgram``: staged phases, latched against live plans, and the
    state round-trip;
  * ``CusumGuard`` and ``Supervisor`` making the reference's decisions on
    seeded loss sequences, non-finite losses included;
  * the ``paper`` controller's event log (step, kind, signature) equal to
    the reference's on the scripted losses of ``tests/test_control.py``,
    and its state round-trip mid-cooldown;
  * ``Commander`` making the pilot's decisions with the reference's
    signature string.

Everything compared here is exact: decisions, event logs, signatures and
JSON, and the guard's statistics as Python floats.
"""
import json
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import Commander as JCommander  # noqa: E402
from repro.core import CusumGuard as JCusumGuard  # noqa: E402
from repro.core import Supervisor as JSupervisor  # noqa: E402
from repro.fabric import control as J  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode,  # noqa: E402
                              Commander, CusumGuard, Schedule, Supervisor)
from repro_torch.fabric.control import (Controller, FP32Controller,  # noqa: E402
                                        PaperController, Phase,
                                        PolicyProgram, StaticController,
                                        Telemetry, available_controllers,
                                        get_controller, make_controller,
                                        plan_from_jsonable, plan_presets,
                                        plan_to_jsonable, register_controller,
                                        register_plan_preset,
                                        unregister_controller,
                                        unregister_plan_preset)

COS = {"backbone": {"gbinary": 0.8, "gternary": 0.7},
       "head": {"gbinary": 0.1, "gternary": 0.1}}


def _t(step, loss, cosines=None, **kw):
    return Telemetry(step=step, loss=loss, cosines=cosines, **kw)


def _jt(step, loss, cosines=None, **kw):
    return J.Telemetry(step=step, loss=loss, cosines=cosines, **kw)


def _log(controller):
    return [(e.step, e.kind, e.plan_signature) for e in controller.events]


# ---------------------------------------------------------------------------
# registry contract
# ---------------------------------------------------------------------------

def test_builtin_controllers_registered():
    builtins = {"paper", "adaptive", "static", "fp32"}
    # importing the tune package registers "tuned", and the elastic
    # package "straggler_aware" and "local_sgd", as in the reference (a
    # test process may have imported either before this test)
    import repro_torch.elastic  # noqa: F401
    import repro_torch.tune  # noqa: F401
    assert set(available_controllers()) == builtins | {
        "tuned", "straggler_aware", "local_sgd"}
    assert builtins <= set(J.available_controllers())
    assert get_controller("adaptive") is get_controller("paper")
    assert isinstance(make_controller("paper", warmup_steps=3),
                      PaperController)
    assert isinstance(make_controller("fp32"), FP32Controller)
    static = make_controller("static", plan="gbin_packed")
    assert static.plan.signature() == plan_presets()["gbin_packed"].signature()
    for name in ("paper", "static", "fp32"):
        assert isinstance(make_controller(name), Controller)


def test_register_controller_roundtrip_and_errors():
    @register_controller("toy_main", "toy_alias")
    class Toy:
        name = "toy_main"

        def __init__(self, plan=None):
            self.plan = plan or AdmissionPlan.fp32_all()

        def observe(self, telemetry):
            return self.plan

    try:
        assert isinstance(make_controller("toy_alias"), Toy)
        assert isinstance(make_controller("toy_main"), Controller)
        with pytest.raises(ValueError, match="already registered"):
            register_controller("toy_main")(Toy)
    finally:
        unregister_controller("toy_main")
    # either key clears both, and the registration is repeatable
    assert "toy_alias" not in available_controllers()
    register_controller("toy_main", "toy_alias")(Toy)
    unregister_controller("toy_alias")
    assert "toy_main" not in available_controllers()

    with pytest.raises(KeyError, match="unknown controller 'nope'"):
        get_controller("nope")
    with pytest.raises(KeyError, match="register_controller"):
        make_controller("nope")
    with pytest.raises(ValueError, match="already registered"):
        register_controller("paper")(Toy)

    original = get_controller("static")

    @register_controller("static", override=True)
    class Replacement(StaticController):
        pass

    try:
        assert get_controller("static") is Replacement
    finally:
        register_controller("static", override=True)(original)
    assert get_controller("static") is original


# ---------------------------------------------------------------------------
# Telemetry and plan JSON
# ---------------------------------------------------------------------------

def test_telemetry_from_metrics_matches_reference():
    metrics = {"loss": 1.25, "agg_norm": 3.0, "traffic_ratio": 0.25,
               "plan": "sig", "cos/backbone/gbinary": 0.8,
               "cos/backbone/gternary": 0.7, "cos/head/gbinary": 0.1}
    t = Telemetry.from_metrics(7, metrics, step_time_s=0.5, restart=True)
    j = J.Telemetry.from_metrics(7, metrics, step_time_s=0.5, restart=True)
    for field in ("step", "loss", "cosines", "traffic_ratio", "step_time_s",
                  "restart", "plan_signature"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.cosines == {"backbone": {"gbinary": 0.8, "gternary": 0.7},
                         "head": {"gbinary": 0.1}}
    assert Telemetry.from_metrics(8, {"loss": 1.0}).cosines is None


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("name", sorted(plan_presets()))
def test_plan_json_matches_reference(name, error_feedback):
    plan = plan_presets(error_feedback=error_feedback)[name]
    jplan = J.plan_presets(error_feedback=error_feedback)[name]
    blob = json.dumps(plan_to_jsonable(plan), sort_keys=True)
    assert blob == json.dumps(J.plan_to_jsonable(jplan), sort_keys=True)
    back = plan_from_jsonable(json.loads(blob))
    assert back == plan and back.signature() == jplan.signature()


def test_plan_json_roundtrip_keeps_custom_names():
    plan = AdmissionPlan.lowbit_backbone(AggregationMode.G_BINARY,
                                         schedule="my_custom_sched")
    back = plan_from_jsonable(json.loads(json.dumps(plan_to_jsonable(plan))))
    assert back == plan
    assert back.policy_for("backbone").schedule == "my_custom_sched"
    assert plan_from_jsonable(plan_to_jsonable(plan_presets()["gbin_vote"])) \
        .policy_for("backbone").schedule is Schedule.VOTE_PSUM


def test_register_plan_preset_guards():
    plan = AdmissionPlan.lowbit_backbone(AggregationMode.G_TERNARY)
    register_plan_preset("my_tuned", plan)
    try:
        assert plan_presets()["my_tuned"] == plan
        assert plan_presets(error_feedback=True)["my_tuned"] == plan
        with pytest.raises(ValueError, match="already registered"):
            register_plan_preset("my_tuned", AdmissionPlan.fp32_all())
        register_plan_preset("my_tuned", AdmissionPlan.fp32_all(),
                             override=True)
        assert plan_presets()["my_tuned"] == AdmissionPlan.fp32_all()
        assert make_controller("static", plan="my_tuned").plan == \
            AdmissionPlan.fp32_all()
        with pytest.raises(TypeError, match="AdmissionPlan"):
            register_plan_preset("other", "gbin_packed")
    finally:
        unregister_plan_preset("my_tuned")
    assert "my_tuned" not in plan_presets()
    with pytest.raises(ValueError, match="built-in"):
        register_plan_preset("fp32", plan, override=True)
    with pytest.raises(ValueError, match="built-in"):
        unregister_plan_preset("fp32")
    with pytest.raises(KeyError):
        unregister_plan_preset("never_registered")
    with pytest.raises(KeyError, match="unknown plan preset"):
        StaticController("never_registered")


# ---------------------------------------------------------------------------
# PolicyProgram
# ---------------------------------------------------------------------------

def test_policy_program_staged_matches_reference():
    stages = [("warmup", ("fp32", "fp32"), 3),
              ("all_lowbit", ("gbinary", "gbinary"), 6),
              ("head_fp32", ("gbinary", "fp32"), None)]
    prog, jprog = PolicyProgram.staged(stages), J.PolicyProgram.staged(stages)
    latched = [prog.advance(_t(i, 1.0)) for i in range(9)]
    assert latched == [jprog.advance(_jt(i, 1.0)) for i in range(9)]
    assert latched[:3] == [("fp32", "fp32")] * 3
    assert latched[6:] == [("gbinary", "fp32")] * 3
    assert _log(prog) == _log(jprog)
    assert [e.kind for e in prog.events] == ["all_lowbit", "head_fp32"]


def test_policy_program_latch_vs_live_plans():
    def build(phase_cls, program_cls, calls):
        def latched_plan(t, p):
            calls["latched"] += 1
            return "L"

        def live_plan(t, p):
            calls["live"] += 1
            return "V"

        return program_cls([
            phase_cls("a", plan=latched_plan,
                      transition=lambda t, p: "b" if t.step >= 2 else None),
            phase_cls("b", plan=live_plan, latch=False),
        ], plan="init")

    calls, jcalls = {"latched": 0, "live": 0}, {"latched": 0, "live": 0}
    prog = build(Phase, PolicyProgram, calls)
    jprog = build(J.Phase, J.PolicyProgram, jcalls)
    assert prog.plan == jprog.plan == "init"
    got = [prog.advance(_t(i, 1.0)) for i in range(5)]
    assert got == [jprog.advance(_jt(i, 1.0)) for i in range(5)]
    assert got[0] == "L" and prog.plan == "V"
    assert calls == jcalls == {"latched": 1, "live": 3}
    one = PolicyProgram([Phase("go", plan=lambda t, p: ("gbinary", "fp32"))])
    assert one.advance(_t(0, 1.0)) == one.advance(_t(1, 1.0)) \
        == ("gbinary", "fp32")


def test_policy_program_state_roundtrip():
    stages = [("warmup", AdmissionPlan.fp32_all(), 2),
              ("admit", plan_presets()["gbin_packed"], None)]
    prog = PolicyProgram.staged(stages)
    jprog = J.PolicyProgram.staged(
        [("warmup", J.AdmissionPlan.fp32_all(), 2),
         ("admit", J.plan_presets()["gbin_packed"], None)])
    for i in range(4):
        prog.advance(_t(i, 1.0))
        jprog.advance(_jt(i, 1.0))
    blob = json.dumps(prog.state_dict(), sort_keys=True)
    assert blob == json.dumps(jprog.state_dict(), sort_keys=True)
    fresh = PolicyProgram.staged(stages)
    fresh.load_state_dict(json.loads(blob))
    assert fresh.phase == "admit"
    assert fresh.plan == plan_presets()["gbin_packed"]
    assert [e.kind for e in fresh.events] == ["admit"]
    # a tuple payload survives JSON as a tuple
    pair = PolicyProgram.staged([("all", ("gternary", "fp32"), None)])
    pair.advance(_t(0, 1.0))
    again = PolicyProgram.staged([("all", None, None)])
    again.load_state_dict(json.loads(json.dumps(pair.state_dict())))
    assert again.plan == ("gternary", "fp32")

    with pytest.raises(ValueError, match="not in this program"):
        PolicyProgram([Phase("only")]).load_state_dict(json.loads(blob))
    with pytest.raises(ValueError, match="at least one phase"):
        PolicyProgram([])
    with pytest.raises(ValueError, match="duplicate phase"):
        PolicyProgram([Phase("a"), Phase("a")])
    with pytest.raises(KeyError, match="unknown phase"):
        PolicyProgram([Phase("a")]).enter("nope")
    c = PaperController(warmup_steps=2)
    with pytest.raises(ValueError, match="requires telemetry"):
        c.program.enter("admitted")


# ---------------------------------------------------------------------------
# CusumGuard and Supervisor on seeded loss sequences
# ---------------------------------------------------------------------------

def _losses(seed, n=400):
    """A noisy decreasing loss with a drift window and, for odd seeds,
    non-finite values."""
    rng = np.random.RandomState(seed)
    x = 2.0 * np.exp(-np.arange(n) / 150.0) + 0.05 * rng.randn(n)
    t0 = rng.randint(50, n - 100)
    x[t0:t0 + 40] += np.linspace(0.0, 1.5 * rng.rand() + 0.2, 40)
    if seed % 2:
        for k in rng.randint(0, n, 3):
            x[k] = [math.nan, math.inf, -math.inf][k % 3]
    return [float(v) for v in x]


@pytest.mark.parametrize("seed", range(6))
def test_cusum_and_supervisor_make_the_reference_decisions(seed):
    losses = _losses(seed)
    kw = dict(kappa=0.02, h=0.3, ewma=0.1)
    g, jg = CusumGuard(**kw), JCusumGuard(**kw)
    got = [g.update(v) for v in losses]
    assert got == [jg.update(v) for v in losses]
    assert (g.mu, g.s) == (jg.mu, jg.s)
    for v in losses:
        if not math.isfinite(v):
            assert CusumGuard().update(v) is True

    sup = Supervisor(guard=CusumGuard(**kw), cooldown_steps=25)
    jsup = JSupervisor(guard=JCusumGuard(**kw), cooldown_steps=25)
    got = [sup.observe(v) for v in losses]
    assert got == [jsup.observe(v) for v in losses]
    assert any(got)
    assert sup.state_dict() == jsup.state_dict()


# ---------------------------------------------------------------------------
# the paper controller against the reference's
# ---------------------------------------------------------------------------

def _pair(**kw):
    """The same paper controller in both packages."""
    def build(mod, commander, supervisor, guard):
        args = dict(warmup_steps=kw.get("warmup_steps", 5))
        if "commander" in kw:
            args["commander"] = commander(**kw["commander"])
        if "guard" in kw or "cooldown" in kw:
            args["supervisor"] = supervisor(
                guard=guard(**kw.get("guard", {})),
                cooldown_steps=kw.get("cooldown", 50))
        return mod(**args)
    return (build(PaperController, Commander, Supervisor, CusumGuard),
            build(J.PaperController, JCommander, JSupervisor, JCusumGuard))


def _drive(pair, telemetry):
    c, jc = pair
    for step, loss, cos in telemetry:
        plan = c.observe(_t(step, loss, cos))
        jplan = jc.observe(_jt(step, loss, cos))
        assert plan.signature() == jplan.signature()
        assert c.wants_diagnostics == jc.wants_diagnostics
        assert c.program.phase == jc.program.phase
    assert _log(c) == _log(jc)
    return c


def test_paper_event_log_on_scripted_losses():
    """``test_paper_event_sequence_on_scripted_losses``'s curve: warm-up,
    admission retried while cosines are pending, CUSUM recovery, then
    re-admission."""
    pair = _pair(warmup_steps=5, guard=dict(kappa=0.0, h=0.3), cooldown=5)
    script = [(i, 1.0 - 0.01 * i, None) for i in range(4)]
    script += [(i, 0.95, None) for i in range(4, 7)]
    script += [(7, 0.9, COS)]
    script += [(s, 0.9 + 0.2 * (s - 7), None) for s in range(8, 12)]
    script += [(s, 0.5, None) for s in range(12, 30)]
    c = _drive(pair, script)
    assert [e.kind for e in c.events] == \
        ["warmup_end", "admitted", "recovery", "readmitted"]
    assert c.plan.policy_for("backbone").mode == AggregationMode.G_BINARY
    assert c.plan.policy_for("head").mode == AggregationMode.FP32


def test_paper_warmup_end_and_admission_share_a_step():
    c = _drive(_pair(warmup_steps=3, guard=dict(h=1e9)),
               [(i, 1.0, COS) for i in range(3)])
    assert [(e.step, e.kind) for e in c.events] == \
        [(2, "warmup_end"), (2, "admitted")]


def test_paper_trigger_during_warmup_emits_nothing():
    c = _drive(_pair(warmup_steps=50, guard=dict(kappa=0.0, h=0.01),
                     cooldown=5),
               [(i, 1.0 + 0.5 * i, None) for i in range(20)])
    assert c.events == []
    assert c.plan == AdmissionPlan.fp32_all()


def _paper(cooldown=20):
    return PaperController(
        warmup_steps=2, commander=Commander(tau_binary=-1.0),
        supervisor=Supervisor(guard=CusumGuard(kappa=0.0, h=0.3),
                              cooldown_steps=cooldown))


def test_paper_state_dict_roundtrip_mid_cooldown():
    c = _paper()
    step = 0
    for _ in range(2):
        c.observe(_t(step, 1.0, cosines=COS))
        step += 1
    assert c.program.phase == "admitted"
    while c.program.phase != "recovery":
        c.observe(_t(step, 1.0 + 0.5 * step))
        step += 1
    for _ in range(3):
        c.observe(_t(step, 0.5))
        step += 1
    assert c.supervisor.in_cooldown
    blob = json.dumps(c.state_dict())

    fresh = _paper()
    fresh.warmup_steps = 99
    fresh.load_state_dict(json.loads(blob))
    assert fresh.warmup_steps == 2
    assert fresh.program.phase == "recovery"
    assert fresh.supervisor._cooldown_left == c.supervisor._cooldown_left
    assert fresh._admitted_plan == c._admitted_plan
    assert _log(fresh) == _log(c)
    # the reference reads the port's state and re-admits in lockstep
    jfresh = J.PaperController(
        warmup_steps=2, commander=JCommander(tau_binary=-1.0),
        supervisor=JSupervisor(guard=JCusumGuard(kappa=0.0, h=0.3),
                               cooldown_steps=20))
    jfresh.load_state_dict(json.loads(blob))
    while c.program.phase != "readmitted":
        for twin in (c, fresh):
            twin.observe(_t(step, 0.5))
        jfresh.observe(_jt(step, 0.5))
        step += 1
    assert _log(c) == _log(fresh) == _log(jfresh)
    assert c.events[-1].kind == "readmitted"


# ---------------------------------------------------------------------------
# Commander
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [None, Schedule.PACKED_A2A])
def test_commander_reproduces_pilot_decisions(schedule):
    """``tests/test_codecs.py::test_shimmed_enum_reproduces_pilot_decisions``
    on both packages, and on the packed schedule; norms stay on FP32."""
    cosines = {"backbone": {"gbinary": 0.5},
               "embed": {"gbinary": 0.1, "gternary": 0.4},
               "head": {"gbinary": 0.0, "gternary": 0.0}}
    cmd = Commander(tau_binary=0.35, tau_ternary=0.30, schedule=schedule)
    jcmd = JCommander(tau_binary=0.35, tau_ternary=0.30,
                      schedule=None if schedule is None else schedule.value)
    plan = cmd.propose(cosines)
    assert plan.signature() == jcmd.propose(cosines).signature()
    assert plan.policy_for("backbone").mode == AggregationMode.G_BINARY
    assert plan.policy_for("embed").mode == AggregationMode.G_TERNARY
    assert plan.policy_for("head").mode == AggregationMode.FP32
    sched = "vote_psum" if schedule is None else "packed_a2a"
    assert plan.signature() == (f"backbone:gbinary:{sched}:0"
                                f"|embed:gternary:{sched}:0"
                                "|head:fp32:psum:0|*:fp32:psum:0")
    norms = {**cosines, "norms": {"gbinary": 0.9, "gternary": 0.9}}
    plan = cmd.propose(norms)
    assert plan.policy_for("norms").mode == AggregationMode.FP32
    assert plan.signature() == jcmd.propose(norms).signature()
