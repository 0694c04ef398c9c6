"""The port's plan autotuner and ``tuned`` controller against the reference's.

``repro_torch.tune`` and ``repro.tune`` driven side by side on the same
shapes (``init_params(cfg, device="meta")`` against ``jax.eval_shape``):

  * ``TunedPlan.to_jsonable()`` equal (``==``) to the reference's for
    full-width qwen3-0.6B at W = 4 on ``ici_ring``, ``multihop`` and
    ``cxl_switched``, under ``grid``, ``random`` and
    ``successive_halving``, with error feedback on and off;
  * ``rescore`` reproducing the artifact with ``==``, the JSON file round
    trip, and the version, signature, census and worker-count guards
    raising as the reference's do;
  * the space (names, seeds first, constraints, signature), the
    ``@register_search`` registry and ``install`` / ``apply``;
  * ``TunedPlanController``'s events and active entries equal to the
    reference's on one telemetry sequence, its state round trip, and its
    state through a Trainer checkpoint and restore;
  * ``--autotune`` in the launcher.

Every price is plain Python float arithmetic in the reference's order,
so equality is exact, not within a tolerance.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import Telemetry as JTelemetry  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.core.buckets import DEFAULT_BUCKET_BYTES  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import Fabric, plan_presets  # noqa: E402
from repro_torch.fabric.control import Telemetry  # noqa: E402
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.models import ModelConfig, init_params  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tune import (Candidate, MaxLowbitFraction,  # noqa: E402
                              PinGroup, SearchSpace, TunedPlan,
                              TunedPlanController, available_searches,
                              default_space, get_search, make_search,
                              register_search, rescore, unregister_search)

W = 4
TOPOLOGIES = ["ici_ring", "multihop", "cxl_switched"]
STRATEGIES = ["grid", "random", "successive_halving"]
#: the winner on full qwen3-0.6B at W = 4 (the reference's, on all three
#: topologies): the backbone and the tied embedding on the packed vote
WINNER = ("backbone:gbinary:packed_a2a:0|embed:gbinary:packed_a2a:0|"
          "*:fp32:psum:0")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small steps (more gain
    nothing, and the suite's workers share the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    """Full-width qwen3-0.6B's shapes in both packages."""
    like = init_params(get_config("qwen3_0p6b"), device="meta")
    jlike = jax.eval_shape(lambda: j_init_params(
        jax.random.PRNGKey(0), j_get_config("qwen3_0p6b")))
    return like, jlike


@pytest.fixture(scope="module")
def tuned(qwen):
    """Both packages' grid artifact on ``ici_ring``."""
    like, jlike = qwen
    return (Fabric(num_workers=W).autotune(like),
            JFabric(num_workers=W).autotune(jlike))


# ---------------------------------------------------------------------------
# the artifact against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_tuned_plan_json_equals_reference(qwen, topology, strategy,
                                          error_feedback):
    like, jlike = qwen
    got = Fabric(num_workers=W).autotune(
        like, topology=topology, strategy=strategy,
        error_feedback=error_feedback).to_jsonable()
    want = JFabric(num_workers=W).autotune(
        jlike, topology=topology, strategy=strategy,
        error_feedback=error_feedback).to_jsonable()
    assert got == want
    # the census counts the same leaves as jax.tree_util
    assert got["provenance"]["model"]["num_leaves"] == len(T.leaves(like))
    if not error_feedback:
        assert got["plan_signature"] == WINNER


def test_winner_on_full_qwen3(tuned):
    """The reference's decision, read off the port's artifact: 9
    launches, the largest bucket the tied embedding."""
    got, _ = tuned
    assert got.name == "tuned_ici_ring"
    assert got.plan.signature() == WINNER
    assert got.bucket_bytes == DEFAULT_BUCKET_BYTES
    assert got.score.launches == 9
    assert got.score.step_time_s == 0.0033862764799999995
    prov = got.provenance["candidates"]
    assert (prov["enumerated"], prov["estimated"], prov["sim_scored"]) == \
        (28, 28, 26)
    assert len(got.runners_up) == 27


def test_pin_head_leaves_a_tied_classifier_to_the_vote(qwen, tuned):
    """A reference fault the port follows (ROADMAP queue 3): the
    default space's ``PinGroup("head")`` pins the group ``head``, but a
    tied classifier is ``embed/tok``, in group ``embed``, so the tuned
    plan votes the classifier in 1 bit."""
    like, _ = qwen
    got, want = tuned
    fabric = Fabric(num_workers=W)
    assert "head" not in fabric.group_sizes(like)
    assert dict(T.flatten(fabric.groups(like)))["embed/tok"] == "embed"
    for t in (got, want):
        assert t.group_policy("head").mode.value == "fp32"
        assert t.group_policy("embed").mode.value == "gbinary"


def test_rescore_reproduces_the_artifact(tuned, qwen):
    like, _ = qwen
    got, want = tuned
    again = rescore(got, Fabric(num_workers=W), like)
    assert again.to_jsonable() == got.to_jsonable() == want.to_jsonable()


def test_artifact_file_round_trip(tuned, qwen, tmp_path):
    like, _ = qwen
    got, _ = tuned
    path = got.save(str(tmp_path / "tuned.json"))
    loaded = TunedPlan.load(path)
    assert loaded == got
    assert rescore(loaded, Fabric(num_workers=W), like).to_jsonable() \
        == got.to_jsonable()
    # the reference reads the port's file and writes the same bytes
    jpath = jtune.TunedPlan.load(path).save(str(tmp_path / "j.json"))
    assert open(jpath).read() == open(path).read()


def test_artifact_guards_raise_as_the_references(tuned, qwen):
    like, jlike = qwen
    got, want = tuned
    d, jd = got.to_jsonable(), want.to_jsonable()
    for mod, blob in ((tune, d), (jtune, jd)):
        with pytest.raises(ValueError, match="newer"):
            mod.TunedPlan.from_jsonable(dict(blob, version=99))
        with pytest.raises(ValueError, match="signature"):
            mod.TunedPlan.from_jsonable(dict(blob, plan_signature="x"))
    small = init_params(get_config("qwen3_0p6b", smoke=True), device="meta")
    with pytest.raises(ValueError, match="census"):
        rescore(got, Fabric(num_workers=W), small)
    with pytest.raises(ValueError, match="worker-count"):
        rescore(got, Fabric(num_workers=8), like)


# ---------------------------------------------------------------------------
# the space, the registry, install and apply
# ---------------------------------------------------------------------------

def test_space_enumerates_the_references_candidates(qwen):
    like, jlike = qwen
    sizes = Fabric(num_workers=W).group_sizes(like)
    jsizes = JFabric(num_workers=W).group_sizes(jlike)
    assert sizes == jsizes
    for kw in ({}, {"error_feedback": True},
               {"constraints": (MaxLowbitFraction(0.5),)},
               {"preset_names": ("fp32", "gbin_packed")}):
        jkw = dict(kw)
        if "constraints" in kw:
            jkw["constraints"] = (jtune.MaxLowbitFraction(0.5),)
        space, jspace = default_space(**kw), jtune.default_space(**jkw)
        assert space.signature() == jspace.signature()
        got = [(c.name, c.signature(), c.seed)
               for c in space.enumerate(sizes)]
        want = [(c.name, c.signature(), c.seed)
                for c in jspace.enumerate(jsizes)]
        assert got == want
        seeds = [s for _, _, s in got]
        assert seeds == sorted(seeds, reverse=True)     # seeds first
    assert PinGroup("head").name == jtune.PinGroup("head").name
    with pytest.raises(KeyError, match="unknown plan presets"):
        default_space(preset_names=("nope",))
    with pytest.raises(ValueError, match="empty SearchSpace"):
        SearchSpace()


def test_unsatisfiable_space_raises(qwen):
    like, _ = qwen
    space = SearchSpace(codecs=("gbinary",),
                        constraints=(MaxLowbitFraction(0.0),))
    with pytest.raises(ValueError, match="admitted no candidates"):
        Fabric(num_workers=W).autotune(like, space)


def test_search_registry_round_trip():
    assert {"grid", "random", "successive_halving", "sha"} <= \
        set(available_searches())
    assert get_search("sha") is get_search("successive_halving")
    with pytest.raises(KeyError, match="register_search"):
        get_search("nope")
    with pytest.raises(ValueError, match="eta"):
        make_search("successive_halving", eta=1.0)

    @register_search("toy_first")
    class First:
        name = "toy_first"

        def search(self, candidates, model, objective, *, shortlist=8):
            return get_search("grid")().search(candidates[:3], model,
                                               objective, shortlist=1)

    try:
        assert "toy_first" in available_searches()
        with pytest.raises(ValueError, match="override"):
            register_search("toy_first")(First)
    finally:
        unregister_search("toy_first")
    assert "toy_first" not in available_searches()


def test_install_and_apply(tuned, qwen):
    like, _ = qwen
    got, _ = tuned
    name = got.install("tuned_test_install")
    try:
        assert plan_presets()[name].signature() == WINNER
    finally:
        from repro_torch.fabric import unregister_plan_preset
        unregister_plan_preset(name)
    fabric = Fabric(num_workers=W, bucket_bytes=8 * 2 ** 20)
    fabric.layout_for(like, got.plan)
    plan = got.apply(fabric)
    assert plan is got.plan and fabric.bucket_bytes == got.bucket_bytes
    assert fabric.layout_for(like, plan).num_launches == 9
    cand = Candidate("x", got.plan, got.bucket_bytes)
    assert cand.signature() == f"{WINNER}@bb={DEFAULT_BUCKET_BYTES}"


# ---------------------------------------------------------------------------
# the tuned controller
# ---------------------------------------------------------------------------

#: step times (s): in the band, then the ~1 s steps of the card (the
#: prediction is the modeled communication alone), an unknown time, and
#: one fast step that resets the strikes
STEP_TIMES = ([0.003] * 3 + [1.0] * 6 + [None] + [1.0] * 3 + [0.001]
              + [1.0] * 8)


def _drive(ctl, telemetry, times):
    out = []
    for step, t in enumerate(times):
        plan = ctl.observe(telemetry(step=step, loss=1.0, step_time_s=t))
        out.append((ctl.active, plan.signature()))
    return out


@pytest.mark.parametrize("patience", [1, 5])
def test_tuned_controller_matches_reference(tuned, patience):
    got, want = tuned
    ctl = TunedPlanController(got, patience=patience)
    jctl = jtune.TunedPlanController(want, patience=patience)
    assert _drive(ctl, Telemetry, STEP_TIMES) == \
        _drive(jctl, JTelemetry, STEP_TIMES)
    events = [(e.step, e.kind, e.plan_signature) for e in ctl.events]
    assert events == [(e.step, e.kind, e.plan_signature)
                      for e in jctl.events]
    assert events
    assert json.loads(json.dumps(ctl.state_dict())) == jctl.state_dict()


def test_tuned_controller_retunes_every_patience_steps(tuned):
    """A reference fault the port follows (ROADMAP queue 3): the
    artifact predicts the modeled communication alone (the launcher
    passes no compute time), so on ~1 s steps every step is out of band
    and the controller retunes every ``patience`` steps, first to the
    int4 backbone with the embedding on ``vote_psum``."""
    got, _ = tuned
    ctl = TunedPlanController(got)
    _drive(ctl, Telemetry, [1.0] * 15)
    assert [e.step for e in ctl.events] == [4, 9, 14]
    assert ctl.events[0].plan_signature == (
        "backbone:int4:psum:0|embed:gbinary:vote_psum:0|*:fp32:psum:0")
    assert len(ctl._entries) == 13


def test_tuned_controller_state_round_trip_and_guards(tuned):
    got, _ = tuned
    ctl = TunedPlanController(got, patience=2)
    _drive(ctl, Telemetry, [1.0] * 5)
    fresh = TunedPlanController(got, patience=2)
    fresh.load_state_dict(json.loads(json.dumps(ctl.state_dict())))
    assert fresh.state_dict() == ctl.state_dict()
    assert fresh.active == ctl.active != got.name
    with pytest.raises(ValueError, match="shortlist"):
        fresh.load_state_dict(dict(ctl.state_dict(), active="nope"))
    with pytest.raises(ValueError, match="patience"):
        TunedPlanController(got, patience=0)
    with pytest.raises(ValueError, match="alpha"):
        TunedPlanController(got, alpha=0.0)


TINY = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                   num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                   dtype="float32", remat=False)


def _tuned_trainer(ckpt_dir, tuned_plan):
    fabric = Fabric(num_workers=2)
    tuned_plan.apply(fabric)
    fabric.attach_controller("tuned", tuned=tuned_plan, patience=2)
    data = SyntheticLMStream(vocab=64, seq_len=8, batch=4, seed=0)
    return Trainer(TINY, AdamW(peak_lr=3e-3, warmup_steps=2, total_steps=20),
                   data, fabric=fabric, device="cpu", ckpt_dir=ckpt_dir,
                   tcfg=TrainerConfig(checkpoint_interval=3))


def test_tuned_controller_state_through_a_trainer_checkpoint(tmp_path):
    """The controller's state rides in the Trainer's checkpoint: a new
    Trainer restores the active entry, the EWMAs, strikes and events,
    and trains on under the retuned plan."""
    tuned_plan = Fabric(num_workers=2).autotune(
        init_params(TINY, device="meta"))
    first = _tuned_trainer(str(tmp_path), tuned_plan)
    first.run(5)
    ctl = first.controller
    assert ctl.events, "CPU steps lie far outside the modeled band"
    assert [h["plan"] for h in first.history][-1] != \
        tuned_plan.plan.signature()
    second = _tuned_trainer(str(tmp_path), tuned_plan)
    second.init_state()
    assert second._restore()
    assert second.controller.state_dict() == json.loads(
        json.dumps(ctl.state_dict()))
    second.run(6)
    assert second.history[0]["step"] == 5
    assert second.history[0]["plan"] == ctl.plan.signature()


def test_launcher_autotunes_and_trains_under_tuned(tmp_path, capsys):
    out = tmp_path / "tuned.json"
    history = launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                           "cpu", "--mesh", "2,1", "--steps", "2",
                           "--global-batch", "4", "--seq-len", "16",
                           "--autotune", "--autotune-topology", "multihop",
                           "--autotune-strategy", "successive_halving",
                           "--autotune-out", str(out)])
    saved = TunedPlan.load(str(out))
    assert saved.topology == "multihop"
    assert saved.provenance["strategy"] == "successive_halving"
    assert history[0]["plan"] == saved.plan.signature()
    assert "workers=2" in capsys.readouterr().out
