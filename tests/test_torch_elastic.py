"""``repro_torch.elastic`` against ``repro.elastic``.

``tests/test_elastic.py``'s checks on the port, and the port held to the
reference on the same scenarios (the reference's initial parameters
carried across with ``params_from_jax``; each reference scenario runs
once a module):

  * the membership ledger, the fault registry, the straggler detector,
    ``straggler_aware``, ``local_sgd`` and ``local_accum`` (its EF
    requirement and its wire schedule) behave as the reference's;
  * ``replay_schedule``'s ``ReplayReport`` JSON ``==`` the reference's;
  * ``Fabric.step_for``'s key carries the membership epoch, and a
    host-local or distributed session refuses another worker count;
  * a run with armed faults that never fire is bit-identical to a run
    with none;
  * crash -> rollback -> rejoin, and a restore into a fleet of another
    size that keeps the ``paper`` controller's phase: ``report()`` and
    every history field but the loss (and the cosines) ``==`` the
    reference's; the losses and cosines to rtol 1e-2.  A G-Binary vote
    flips where a worker's gradient element lies within float32
    summation-order noise of zero (ROADMAP queue 3, known differences),
    and a flipped vote moves the later losses of this 2-layer model by
    up to ~3e-3;
  * the straggler ladder of ``chip_smoke.py``'s run V' (W = 4, worker 1
    6x slow on steps 1-2, demote after 2 flagged steps, recover after 2
    stable ones): the events at the steps the reference's detector and
    controller give for the same synthetic times.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import elastic as JE  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import AggregationMode as JMode  # noqa: E402
from repro.core import Commander as JCommander  # noqa: E402
from repro.core import CusumGuard as JCusumGuard  # noqa: E402
from repro.core import Schedule as JSchedule  # noqa: E402
from repro.core import Supervisor as JSupervisor  # noqa: E402
from repro.data import SyntheticLMStream as JStream  # noqa: E402
from repro.fabric.control import PaperController as JPaper  # noqa: E402
from repro.fabric.control import Telemetry as JTelemetry  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import SgdMomentum as JSgd  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode,  # noqa: E402
                              Commander, CusumGuard, LocalGroup, Schedule,
                              Supervisor)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.modes import wire_schedule  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.elastic import (Crash, ElasticConfig,  # noqa: E402
                                 ElasticTrainer, FaultModel, LocalAccumBackend,
                                 LocalSgdController, Membership,
                                 MembershipEvent, StragglerAwareController,
                                 StragglerDetector, WorkerView,
                                 available_faults, make_fault, register_fault,
                                 replay_schedule, resolve_faults,
                                 unregister_fault)
from repro_torch.elastic.trainer import _resize_ef  # noqa: E402
from repro_torch.fabric import AggregationContext, Fabric  # noqa: E402
from repro_torch.fabric.control import PaperController  # noqa: E402
from repro_torch.models import (ModelConfig, init_params,  # noqa: E402
                                params_from_jax)
from repro_torch.optim import SgdMomentum  # noqa: E402

CFG = dict(name="el", family="dense", num_layers=2, d_model=32, num_heads=2,
           num_kv_heads=2, d_ff=64, vocab_size=128, dtype="float32",
           remat=False)
#: losses and cosines against the reference's (see the module docstring)
LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return ModelConfig(**CFG)


def _data(seed=0):
    return SyntheticLMStream(vocab=128, seq_len=16, batch=4, seed=seed)


def _ecfg(**kw):
    kw.setdefault("synthetic_step_time_s", 1e-3)
    kw.setdefault("log_interval", 10_000)
    return ElasticConfig(**kw)


_PLAN = AdmissionPlan.lowbit_backbone(AggregationMode.G_BINARY,
                                      schedule=Schedule.VOTE_PSUM,
                                      error_feedback=True)
_JPLAN = JPlan.lowbit_backbone(JMode.G_BINARY, schedule=JSchedule.VOTE_PSUM,
                               error_feedback=True)


def _trainer(*args, reference_params=True, **kw):
    """An ElasticTrainer on the CPU starting from the reference's seed-0
    parameters (the reference's ElasticTrainer draws them from
    ``PRNGKey(0)``)."""
    tr = ElasticTrainer(_cfg(), *args, device="cpu", **kw)
    if reference_params:
        host = jax.tree.map(np.asarray, j_init_params(
            jax.random.PRNGKey(0), JModelConfig(**CFG)))
        tr.init_state()
        with torch.no_grad():
            for t, a in zip(T.leaves(tr.state.model.tree()),
                            T.leaves(params_from_jax(host, device="cpu"))):
                t.copy_(a)
    return tr


def _paper(pkg):
    """The reference test's paper controller: admits at once (tau -1)
    after 3 warm-up steps, never demotes."""
    if pkg == "j":
        return JPaper(commander=JCommander(tau_binary=-1.0),
                      supervisor=JSupervisor(guard=JCusumGuard(h=1e9)),
                      warmup_steps=3)
    return PaperController(commander=Commander(tau_binary=-1.0),
                           supervisor=Supervisor(guard=CusumGuard(h=1e9)),
                           warmup_steps=3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's crash -> rejoin run and its restore across a
    change of W, once a module."""
    jcfg = JModelConfig(**CFG)
    jdata = JStream(vocab=128, seq_len=16, batch=4, seed=0)
    jecfg = dict(synthetic_step_time_s=1e-3, log_interval=10_000)
    crash = JE.ElasticTrainer(
        jcfg, JSgd(peak_lr=0.2, total_steps=60), jdata, 4, plan=_JPLAN,
        ckpt_dir=str(tmp_path_factory.mktemp("jcrash")),
        faults=[("crash", dict(worker=3, step=9, rejoin_step=14))],
        ecfg=JE.ElasticConfig(checkpoint_interval=4, **jecfg))
    crash.run(20)
    ckpt = str(tmp_path_factory.mktemp("jrestore"))
    ctrl_a, ctrl_b = _paper("j"), _paper("j")
    tr_a = JE.ElasticTrainer(jcfg, JSgd(peak_lr=0.1, total_steps=60), jdata,
                             4, controller=ctrl_a, ckpt_dir=ckpt,
                             ecfg=JE.ElasticConfig(checkpoint_interval=2,
                                                   **jecfg))
    tr_a.run(10)
    tr_b = JE.ElasticTrainer(jcfg, JSgd(peak_lr=0.1, total_steps=60), jdata,
                             3, controller=ctrl_b, ckpt_dir=ckpt,
                             ecfg=JE.ElasticConfig(checkpoint_interval=2,
                                                   **jecfg))
    tr_b.run(12)
    return {"crash": crash, "a": tr_a, "b": tr_b,
            "phase": (ctrl_a.program.phase, ctrl_b.program.phase)}


def _same_history(got, want):
    """Every field but the loss and the cosines ``==``; those to
    LOSS_RTOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        floats = {k for k in w if k == "loss" or k.startswith("cos/")}
        assert set(g) == set(w)
        assert {k: g[k] for k in g if k not in floats} == \
            {k: w[k] for k in w if k not in floats}
        for k in floats:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# membership ledger, fault registry, detector
# ---------------------------------------------------------------------------

def test_membership_ledger_epochs_and_validation():
    m = Membership(4, schedule=[MembershipEvent(3, "leave", 2),
                                MembershipEvent(7, "join", 2)])
    assert m.view == WorkerView(0, (0, 1, 2, 3))
    assert m.step_events(2) == ()
    (ev,) = m.step_events(3)
    assert m.apply(ev) == WorkerView(1, (0, 1, 3))
    with pytest.raises(ValueError):
        m.apply(MembershipEvent(4, "leave", 2))
    with pytest.raises(ValueError):
        m.apply(MembershipEvent(4, "join", 0))
    (ev,) = m.step_events(7)
    assert m.apply(ev) == WorkerView(2, (0, 1, 2, 3))
    assert [e.kind for e, _ in m.log] == ["leave", "join"]
    m2 = Membership(2, schedule=[MembershipEvent(1, "join", 5)])
    assert [e.worker for e in m2.step_events(4)] == [5]
    assert m2.step_events(4) == ()
    with pytest.raises(ValueError):
        Membership([7]).apply(MembershipEvent(0, "crash", 7))
    with pytest.raises(ValueError):
        MembershipEvent(0, "reboot", 1)
    # the ledger's JSON is the reference's
    jm = JE.Membership(4, schedule=[JE.MembershipEvent(3, "leave", 2)])
    pm = Membership(4, schedule=[MembershipEvent(3, "leave", 2)])
    jm.apply(jm.step_events(3)[0])
    pm.apply(pm.step_events(3)[0])
    assert pm.to_jsonable() == jm.to_jsonable()


def test_fault_registry_builtins_and_custom():
    assert {"crash", "straggler", "link_degrade"} <= set(available_faults())
    crash = make_fault("crash", worker=3, step=8, rejoin_step=14)
    assert [e.kind for e in crash.scheduled_events()] == ["crash", "join"]
    assert [e.kind for e in crash.membership_events(8)] == ["crash"]
    assert crash.membership_events(8) == ()

    @register_fault("toy_blip")
    class Blip(FaultModel):
        name = "toy_blip"

        def __init__(self, step=0):
            super().__init__()
            self.step = step

        def bandwidth_scale(self, step):
            return 0.5 if step == self.step else 1.0

    try:
        specs = resolve_faults([("toy_blip", {"step": 2}),
                                {"name": "straggler", "worker": 0,
                                 "start": 0, "stop": 4},
                                Crash(worker=1, step=9)])
        assert [type(f).__name__ for f in specs] == ["Blip", "Straggler",
                                                     "Crash"]
        assert specs[0].bandwidth_scale(2) == 0.5
        assert specs[1].to_jsonable() == JE.make_fault(
            "straggler", worker=0, start=0, stop=4).to_jsonable()
    finally:
        unregister_fault("toy_blip")
    with pytest.raises(KeyError):
        make_fault("toy_blip")
    for name, kw in (("crash", dict(worker=0, step=5, rejoin_step=5)),
                     ("straggler", dict(worker=0, start=0, stop=4,
                                        factor=0.5)),
                     ("link_degrade", dict(start=0, stop=4, factor=0.0))):
        with pytest.raises(ValueError):
            make_fault(name, **kw)


def test_detector_flags_sustained_straggler_only():
    det, jdet = StragglerDetector(), JE.StragglerDetector()
    base = {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0}
    spike = {**base, 2: 3.5}
    series = [base, base, spike, spike, {0: 1.0, 1: 1.0, 3: 1.0}]
    got = [det.observe(i, t) for i, t in enumerate(series)]
    want = [jdet.observe(i, t) for i, t in enumerate(series)]
    assert [s.stragglers for s in got] == [(), (), (), (2,), ()]
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert got[3].slowdown > 2.0
    assert set(got[4].times) == {0, 1, 3}
    assert det.state_dict() == jdet.state_dict()


# ---------------------------------------------------------------------------
# the ElasticTrainer
# ---------------------------------------------------------------------------

def test_no_fault_run_bit_identical_to_fixed_membership():
    """Armed faults that never fire perturb no bit."""
    def run(faults):
        tr = _trainer(SgdMomentum(peak_lr=0.2, total_steps=40), _data(), 4,
                      plan=_PLAN, faults=faults, ecfg=_ecfg(),
                      reference_params=False)
        return [h["loss"] for h in tr.run(8)], tr.state.model.tree()

    fixed, p_fixed = run(())
    armed, p_armed = run([("crash", dict(worker=3, step=100)),
                          ("straggler", dict(worker=1, start=50, stop=60))])
    assert fixed == armed
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(p_fixed),
                                                 T.leaves(p_armed)))
    assert fixed[-1] < fixed[0]


def test_crash_rejoin_matches_reference(reference, tmp_path):
    """Crash at 9 (checkpoint at 8: one replayed step), rejoin at 14:
    the report and history the reference's."""
    tr = _trainer(SgdMomentum(peak_lr=0.2, total_steps=60), _data(), 4,
                  plan=_PLAN, ckpt_dir=str(tmp_path),
                  faults=[("crash", dict(worker=3, step=9, rejoin_step=14))],
                  ecfg=_ecfg(checkpoint_interval=4))
    hist = tr.run(20)
    rep = tr.report()
    assert rep == reference["crash"].report()
    assert rep["restarts"] == 1 and rep["replayed_steps"] == 1
    assert rep["recoveries"][0]["steps_to_recover"] == 1
    assert rep["compiled_steps"] == 3 and rep["traffic_overhead"] > 1.0
    assert rep["final_view"] == {"epoch": 2, "workers": [0, 1, 2, 3]}
    assert [h["num_workers"] for h in hist if h["step"] == 8] == [4, 3]
    _same_history(hist, reference["crash"].history)
    assert all(np.isfinite(h["loss"]) for h in hist)
    # one built step per (plan, diagnostics, W, epoch)
    assert sorted(k[2:] for k in tr._compiled) == [(3, 1), (4, 0), (4, 2)]


def test_restore_across_membership_change_keeps_phase(reference, tmp_path):
    """A checkpoint of 4 workers restored into 3: the buckets re-planned
    for the live view, the paper controller resumed admitted."""
    ctrl_a, ctrl_b = _paper("t"), _paper("t")
    tr_a = _trainer(SgdMomentum(peak_lr=0.1, total_steps=60), _data(), 4,
                    controller=ctrl_a, ckpt_dir=str(tmp_path),
                    ecfg=_ecfg(checkpoint_interval=2))
    tr_a.run(10)
    tr_b = _trainer(SgdMomentum(peak_lr=0.1, total_steps=60), _data(), 3,
                    controller=ctrl_b, ckpt_dir=str(tmp_path),
                    ecfg=_ecfg(checkpoint_interval=2),
                    reference_params=False)
    hist = tr_b.run(12)
    assert (ctrl_a.program.phase, ctrl_b.program.phase) == \
        reference["phase"] == ("admitted", "admitted")
    assert hist[0]["step"] == 10 and hist[0]["num_workers"] == 3
    assert "gbinary" in hist[0]["plan"]
    assert tr_b.fabric.num_workers == 3
    assert all(w == 3 for (_, _, w, _) in tr_b._compiled)
    for got, want in ((tr_a, reference["a"]), (tr_b, reference["b"])):
        assert got.report() == want.report()
        _same_history(got.history, want.history)
    assert [(e.step, e.kind, e.plan_signature) for e in ctrl_b.events] == \
        [(e.step, e.kind, e.plan_signature)
         for e in reference["b"].controller.events]


def test_graceful_leave_and_join_without_rollback():
    m = Membership(4, schedule=[MembershipEvent(3, "leave", 0),
                                MembershipEvent(6, "join", 0)])
    tr = _trainer(SgdMomentum(peak_lr=0.2, total_steps=40), _data(), m,
                  plan=_PLAN, ecfg=_ecfg(), reference_params=False)
    hist = tr.run(9)
    rep = tr.report()
    assert rep["restarts"] == 0 and rep["replayed_steps"] == 0
    assert [h["num_workers"] for h in hist] == [4, 4, 4, 3, 3, 3, 4, 4, 4]
    assert [h["membership_epoch"] for h in hist] == [0] * 3 + [1] * 3 + \
        [2] * 3
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_resize_ef_reseats_rows_by_worker_id():
    ef = {"a": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
    out = _resize_ef(ef, (0, 1, 2, 3), (0, 1, 3))["a"]
    assert torch.equal(out, ef["a"][[0, 1, 3]])
    back = _resize_ef({"a": out}, (0, 1, 3), (0, 1, 2, 3))["a"]
    assert torch.equal(back[2], torch.zeros(3))
    assert torch.equal(back[[0, 1, 3]], out)


def test_fabric_step_cache_keys_include_membership_epoch(tmp_path):
    """Re-binding an epoch-bumped view misses the step cache even at the
    same worker count; a virtual session re-sizes its group; a
    host-local or process-group session refuses another W."""
    cfg = _cfg()
    opt = SgdMomentum(peak_lr=0.1, total_steps=10)
    params = init_params(cfg, device="meta")
    plan = AdmissionPlan.fp32_all()
    fabric = Fabric(num_workers=1)
    loss = lambda p, b: 0  # noqa: E731
    fabric.step_for(opt, plan, params, loss)
    fabric.step_for(opt, plan, params, loss)
    assert len(fabric._steps) == 1
    fabric.bind_membership(WorkerView(epoch=1, workers=(0,)))
    fabric.step_for(opt, plan, params, loss)
    assert len(fabric._steps) == 2 and fabric.membership_epoch == 1
    fabric.bind_membership(WorkerView(epoch=2, workers=(0, 1, 4)))
    assert fabric.num_workers == fabric.group.size == 3
    with pytest.raises(ValueError, match="fixes the data-parallel extent"):
        Fabric(group=LocalGroup()).bind_membership(WorkerView(1, (0, 1)))
    import torch.distributed as dist
    from repro_torch.core import DistributedGroup
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        session = Fabric(group=DistributedGroup(device="cpu"))
        session.bind_membership(WorkerView(1, (0,)))       # the same W
        assert session.membership_epoch == 1
        with pytest.raises(ValueError, match="fixes the data-parallel"):
            session.bind_membership(WorkerView(2, (0, 1)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the straggler ladder
# ---------------------------------------------------------------------------

#: run V' of chip_smoke.py: worker 1 six times slow on steps 1-2 of 7
V_PRIME = dict(steps=7, straggler=dict(worker=1, start=1, stop=3,
                                       factor=6.0),
               controller=dict(lowbit_plan="gbin_packed", demote_after=2,
                               recover_after=2))
#: the events the detector and controller give for those times
V_PRIME_EVENTS = [(2, "demoted"), (6, "recovered")]


def test_straggler_ladder_of_run_v_prime_matches_reference():
    """The port's ElasticTrainer on the toy model with run V''s scenario
    and synthetic times, against the reference's detector and controller
    fed the same times through the reference's Telemetry."""
    ctrl = StragglerAwareController(**V_PRIME["controller"])
    tr = _trainer(SgdMomentum(peak_lr=0.1, total_steps=60), _data(), 4,
                  controller=ctrl,
                  faults=[("straggler", V_PRIME["straggler"])],
                  ecfg=_ecfg(), reference_params=False)
    hist = tr.run(V_PRIME["steps"])
    jctrl = JE.StragglerAwareController(**V_PRIME["controller"])
    jdet = JE.StragglerDetector()
    fault = JE.make_fault("straggler", **V_PRIME["straggler"])
    for h in hist:
        times = {w: 1e-3 * fault.step_time_scale(h["step"], w)
                 for w in range(4)}
        stats = jdet.observe(h["step"], times)
        assert stats.stragglers == h["stragglers"]
        assert jctrl.plan.signature() == h["plan"]
        jctrl.observe(dataclasses.replace(
            JTelemetry(step=h["step"], loss=h["loss"],
                       step_time_s=max(times.values())),
            worker_step_times=times, stragglers=stats.stragglers,
            membership_epoch=0))
    events = [(e.step, e.kind) for e in ctrl.events]
    assert events == [(e.step, e.kind) for e in jctrl.events] == \
        V_PRIME_EVENTS
    assert [e.plan_signature for e in ctrl.events] == \
        [e.plan_signature for e in jctrl.events]
    assert "gbinary" in hist[3]["plan"] and "gbinary" not in hist[0]["plan"]
    blob = ctrl.state_dict()
    fresh = StragglerAwareController()
    fresh.load_state_dict(blob)
    assert fresh.phase == ctrl.phase and blob == jctrl.state_dict()


def test_straggler_fault_flips_admission_ladder():
    ctrl = StragglerAwareController(demote_after=2, recover_after=6)
    tr = _trainer(SgdMomentum(peak_lr=0.1, total_steps=60), _data(), 4,
                  controller=ctrl,
                  faults=[("straggler", dict(worker=1, start=3, stop=12,
                                             factor=6.0))],
                  ecfg=_ecfg(), reference_params=False)
    hist = tr.run(24)
    assert any(h["stragglers"] == (1,) for h in hist)
    assert [e.kind for e in ctrl.events] == ["demoted", "recovered"]
    plans = [h["plan"] for h in hist]
    assert "gbinary" not in plans[0] and any("gbinary" in p for p in plans)
    assert "gbinary" not in plans[-1]


# ---------------------------------------------------------------------------
# local SGD through the public seams
# ---------------------------------------------------------------------------

def test_local_sgd_strategy_traffic_and_training():
    tr = _trainer(SgdMomentum(peak_lr=0.3, total_steps=40), _data(), 4,
                  controller=LocalSgdController(sync_every=4), ecfg=_ecfg(),
                  reference_params=False)
    hist = tr.run(16)
    traffic = [h["traffic_ratio"] for h in hist]
    assert traffic[:4] == [0.0, 0.0, 0.0, traffic[3]] and traffic[3] > 0.0
    for i, t in enumerate(traffic):
        assert (t > 0.0) == (i % 4 == 3), (i, t)
    assert hist[-1]["loss"] < hist[0]["loss"]
    jctrl = JE.LocalSgdController(sync_every=4)
    assert LocalSgdController(sync_every=4).sync_plan.signature() == \
        jctrl.sync_plan.signature()


def test_local_accum_requires_error_feedback():
    """The port's leaves carry the local ranks on their first axis; the
    aggregate comes back replicated."""
    backend = LocalAccumBackend()
    ctx = AggregationContext(group=LocalGroup(), num_workers=1)
    g = torch.ones((1, 4))
    agg, ef = backend.aggregate(ctx, g, None, ef=torch.zeros((1, 4)))
    assert torch.equal(agg, torch.zeros(4))
    assert torch.equal(ef, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="error_feedback=True"):
        backend.aggregate(ctx, g, None, ef=None)
    assert backend.fusable is False
    assert backend.wire_bytes_per_device(1000, "local", 4) == 0.0


def test_local_codec_canonicalizes_onto_local_accum():
    for nominal in ("psum", "vote_psum", "packed_a2a", "local_accum"):
        assert wire_schedule("local", nominal) == "local_accum"


# ---------------------------------------------------------------------------
# offline replay
# ---------------------------------------------------------------------------

def test_replay_schedule_matches_reference():
    """Crash -> rejoin, a straggler and a degraded link on cxl_direct:
    the phases of the reference's test, and the report's JSON ``==`` the
    reference's."""
    params = init_params(_cfg(), device="meta")
    jparams = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                   JModelConfig(**CFG)))
    faults = [("crash", dict(worker=3, step=8, rejoin_step=14)),
              ("straggler", dict(worker=1, start=4, stop=8, factor=5.0)),
              ("link_degrade", dict(start=16, stop=20, factor=0.25))]
    rep = replay_schedule(params, _PLAN, 4, 24, faults=faults,
                          topology="cxl_direct", compute_time_s=1e-4)
    jrep = JE.replay_schedule(jparams, _JPLAN, 4, 24, faults=faults,
                              topology="cxl_direct", compute_time_s=1e-4)
    assert rep.to_jsonable() == jrep.to_jsonable()
    spans = [(p.start, p.stop, p.num_workers, p.straggler_scale,
              p.bandwidth_scale) for p in rep.phases]
    assert spans == [(0, 4, 4, 1.0, 1.0), (4, 8, 4, 5.0, 1.0),
                     (8, 14, 3, 1.0, 1.0), (14, 16, 4, 1.0, 1.0),
                     (16, 20, 4, 1.0, 0.25), (20, 24, 4, 1.0, 1.0)]
    clean = replay_schedule(params, _PLAN, 4, 24, topology="cxl_direct",
                            compute_time_s=1e-4)
    assert len(clean.phases) == 1
    assert clean.total_time_s < rep.total_time_s
    assert clean.to_jsonable() == JE.replay_schedule(
        jparams, _JPLAN, 4, 24, topology="cxl_direct",
        compute_time_s=1e-4).to_jsonable()
