"""The port's model, step and launcher against the reference's.

On the qwen3 SMOKE config in float32 with W = 4 virtual workers, with
the reference's parameters carried across (``params_from_jax``):

  * the parameter tree round-trips and flattens in JAX's leaf order;
  * each worker's loss and gradients equal ``jax.value_and_grad`` of
    ``repro.models.loss_fn`` to ``rtol=1e-5, atol=1e-6``;
  * three steps of the port's train step follow a JAX reference step
    (vmapped grads -> vmapped reference Fabric aggregate -> reference
    AdamW) to ``rtol=1e-5``, also with ``grad_accum=2`` (the reference
    step builder's microbatch loop: float32 gradients);
  * the ``paper`` controller drives the port's Trainer as the reference's
    controller drives a loop of reference steps with the reference's
    diagnostics: the same events and admitted signatures, cosines within
    ``rtol=1e-5`` and parameters to the step tolerance;
  * the ``static`` controller gives the ``plan=`` path's history bit for
    bit; error feedback stays off after admission, as in the reference;
  * the launcher runs the paper controller on the CPU, refuses a model
    axis outside torchrun and trains a (2, 2) mesh under it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import AggregationMode as JMode  # noqa: E402
from repro.core import init_ef_states as j_init_ef  # noqa: E402
from repro.core.diagnostics import group_cosines_from_mean as j_cosines  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import control as JC  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.fabric.session import _split_microbatches as j_split  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode,  # noqa: E402
                              Commander, Schedule)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import (Fabric, TrainState, make_controller,  # noqa: E402
                                plan_presets)
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.models import (Transformer, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
W = 4
# Adam's update g / (|g| + eps) turns a float32 difference dg in a
# near-zero FP32-mean gradient into an update difference of up to
# lr * dg / eps; eps = 1e-2 bounds that below the parameter tolerance
# (with the default 1e-8 it is O(1) on such elements).
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("qwen3_0p6b", smoke=True)
    cfg = get_config("qwen3_0p6b", smoke=True)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    # The init's 0.02-scale embedding is renormalized by the first RMSNorm,
    # which scales its gradient up ~50x, past 1 in magnitude, where
    # atol=1e-6 is finer than float32 resolves.  Both packages get the
    # same table at unit scale, so the stated tolerance means the same on
    # every leaf.
    jparams["embed"]["tok"] = jparams["embed"]["tok"] * 50.0
    host = jax.tree.map(np.asarray, jparams)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    return jcfg, cfg, jparams, host, data


def _shards(batch):
    return {k: jnp.asarray(v.reshape(W, -1, *v.shape[1:]))
            for k, v in batch.items()}


def test_params_round_trip_in_jax_leaf_order(setup):
    _, cfg, jparams, host, _ = setup
    model = Transformer(cfg, params=params_from_jax(host, device="cpu"),
                        device="cpu")
    j_paths = ["/".join(str(k.key) for k in kp)
               for kp, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert [p for p, _ in T.flatten(model.tree())] == j_paths
    back = params_to_numpy(model)
    for (p, a), (_, b) in zip(T.flatten(back), T.flatten(host)):
        np.testing.assert_array_equal(a, b, p)
    # the port's own init gives the same tree structure, shapes and dtypes
    own = Transformer(cfg, seed=1, device="cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in T.flatten(own.tree())] \
        == [(p, tuple(t.shape), t.dtype)
            for p, t in T.flatten(params_from_jax(host, device="cpu"))]


def test_params_from_jax_reads_bfloat16_bits():
    x = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(
        jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_worker_losses_and_grads_match_reference(setup):
    jcfg, cfg, jparams, host, data = setup
    batch = data.batch_at(0)
    shards = _shards(batch)
    vg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b)), in_axes=(None, 0)))
    jl, jg = vg(jparams, shards)

    model = Transformer(cfg, params=params_from_jax(host, device="cpu"),
                        device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, loss = Fabric(num_workers=W).worker_grads(model.tree(), tb,
                                                     model.loss)
    np.testing.assert_allclose(float(loss), float(np.mean(np.asarray(jl))),
                               rtol=1e-5)
    for (p, g), (_, j) in zip(T.flatten(grads), T.flatten(
            jax.tree.map(np.asarray, jg))):
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-6,
                                   err_msg=p)


# The configurations the port's step runs, each with its reference:
#   gbin_packed  — the main path: bucketed, fused kernel sets, no EF;
#   per_leaf_ef  — leaf by leaf with error feedback, EF inside the kernels;
#   staged       — a packed G-Ternary backbone on the staged chain;
#   grad_accum   — the main path over two microbatches a worker.
CONFIGS = {
    "gbin_packed": dict(
        plan=lambda: plan_presets()["gbin_packed"],
        jplan=lambda: j_plan_presets()["gbin_packed"], fabric={}),
    "per_leaf_ef": dict(
        plan=lambda: plan_presets(error_feedback=True)["gbin_packed"],
        jplan=lambda: j_plan_presets(error_feedback=True)["gbin_packed"],
        fabric=dict(fused=False)),
    "staged": dict(
        plan=lambda: AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, schedule=Schedule.PACKED_A2A),
        jplan=lambda: JPlan.lowbit_backbone(JMode.G_TERNARY,
                                            schedule="packed_a2a"),
        fabric=dict(fused_kernels=False)),
    "grad_accum": dict(
        plan=lambda: plan_presets()["gbin_packed"],
        jplan=lambda: j_plan_presets()["gbin_packed"], fabric={},
        grad_accum=2),
}


def _reference_step(jcfg, jplan, fused=True, fused_kernels=True,
                    grad_accum=1):
    """vmapped grads -> vmapped reference Fabric aggregate (EF threaded
    per worker) -> reference AdamW, under jit.  ``grad_accum > 1`` runs
    the reference step builder's microbatch loop
    (``repro/fabric/session.py:669-684``): float32 sums over the
    microbatches, divided by ``grad_accum``."""
    jfab = JFabric(dp_axes=("w",), num_workers=W,
                   fused_kernels=fused_kernels)
    opt = JAdamW(**OPT)

    def value_and_grad(params, b):
        lf = lambda p, mb: j_loss_fn(p, jcfg, mb)  # noqa: E731
        if grad_accum == 1:
            return jax.value_and_grad(lf)(params, b)
        g0 = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)

        def body(carry, mb):
            lacc, gacc = carry
            lval, g = jax.value_and_grad(lf)(params, mb)
            gacc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32),
                                gacc, g)
            return (lacc + lval, gacc), None

        (lval, g), _ = jax.lax.scan(body, (jnp.zeros((), jnp.float32), g0),
                                    j_split(b, grad_accum))
        return lval / grad_accum, jax.tree.map(lambda x: x / grad_accum, g)

    @jax.jit
    def step(params, state, ef, shards):
        def one(b, e):
            lval, g = value_and_grad(params, b)
            agg, new_e = jfab.aggregate(g, jplan, ef=e, fused=fused)
            return jax.lax.pmean(lval, "w"), agg, g, new_e
        lval, agg, g, new_ef = jax.vmap(one, axis_name="w")(shards, ef)
        agg0 = jax.tree.map(lambda x: x[0], agg)
        new_p, new_s = opt.apply(params, agg0, state)
        return new_p, new_s, lval[0], agg0, g, new_ef

    return step, opt, jfab


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_steps_match_reference(setup, config):
    """Three steps of each configuration, port vs reference.

    The exception: an element of a low-bit aggregate may come out with
    another sign (or zero) when some worker's vote input there (the
    gradient, plus the residual under EF) is below 1e-6 of that worker's
    largest: float32 gradients summed in another order differ in the last
    bits, which can flip such a worker's vote and with it the majority.
    At most 1e-4 of the backbone may flip; flipped elements are left out
    of the parameter comparison from then on, since their update
    legitimately differs.  Under EF the residuals follow the reference to
    the parameters' tolerance wherever no worker's vote input was that
    small, and are updated every step.
    """
    jcfg, cfg, jparams, host, data = setup
    spec = CONFIGS[config]
    plan, jplan = spec["plan"](), spec["jplan"]()
    fabric = Fabric(num_workers=W, **spec["fabric"])
    grad_accum = spec.get("grad_accum", 1)
    step_fn, jopt, jfab = _reference_step(
        jcfg, jplan, fused=fabric.fused, fused_kernels=fabric.fused_kernels,
        grad_accum=grad_accum)
    jstate = jopt.init(jparams)
    jpol = jfab.resolve(jparams, jplan)
    # per-worker residuals: (1, *shape) each in the reference, (W, *shape)
    # in the port; scalar sentinels where EF is off
    jef = jax.tree.map(lambda e: jnp.broadcast_to(e, (W,) + e.shape),
                       j_init_ef(jparams, jpol))

    model = Transformer(cfg, params=params_from_jax(host, device="cpu"),
                        device="cpu")
    opt = AdamW(**OPT)
    params = model.tree()
    policies = fabric.resolve(params, plan)
    state = TrainState(model=model, opt=opt.init(params),
                       ef=fabric.init_ef(params, policies))
    step = fabric.build_step(opt, plan, params, model.loss,
                             grad_accum=grad_accum)
    assert (step.layout is None) == (not fabric.fused)
    lowbit = {s.name for b in fabric.layout_for(params, plan).buckets
              if b.key.schedule == "packed_a2a" for s in b.slots}
    assert lowbit and "embed/tok" not in lowbit
    ef_leaves = {p for p, e in T.flatten(state.ef) if e.dim() > 0}
    assert ef_leaves == (lowbit if config == "per_leaf_ef" else set())
    for p in ef_leaves:
        e = dict(T.flatten(state.ef))[p]
        assert e.dtype == torch.float32
        assert e.shape == (W, *dict(T.flatten(params))[p].shape)
    flipped = {p: np.zeros(t.shape, bool) for p, t in T.flatten(params)}
    backbone_size = sum(flipped[p].size for p in lowbit)

    for k in range(3):
        batch = data.batch_at(k)
        ef_in = dict(T.flatten(jax.tree.map(np.asarray, jef)))
        jparams, jstate, jl, jagg, jg, jef = step_fn(jparams, jstate, jef,
                                                     _shards(batch))
        tb = {n: torch.from_numpy(v) for n, v in batch.items()}
        ef_before = state.ef
        state, metrics, agg = step(state, tb)
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-5)
        assert all(u.dtype == torch.float32 for u in T.leaves(agg))
        jagg = dict(T.flatten(jax.tree.map(np.asarray, jagg)))
        jg = dict(T.flatten(jax.tree.map(np.asarray, jg)))
        new_ef = dict(T.flatten(jax.tree.map(np.asarray, jef)))
        for p, u in T.flatten(agg):
            if p in lowbit:
                x = jg[p] + ef_in[p].reshape(W, *jg[p].shape[1:]) \
                    if p in ef_leaves else jg[p]
                diff = u.numpy() != jagg[p]
                x = np.abs(x).reshape(W, -1)
                small = x < 1e-6 * x.max(axis=1, keepdims=True)
                assert not (diff.reshape(-1) & ~small.any(axis=0)).any(), p
                flipped[p] |= diff
                if p in ef_leaves:
                    e = dict(T.flatten(state.ef))[p].numpy().reshape(W, -1)
                    keep = ~small
                    np.testing.assert_allclose(
                        e[keep], new_ef[p].reshape(W, -1)[keep], rtol=1e-5,
                        atol=1e-6, err_msg=f"step {k}: EF {p}")
                    assert not torch.equal(dict(T.flatten(state.ef))[p],
                                           dict(T.flatten(ef_before))[p])
            else:
                np.testing.assert_allclose(u.numpy(), jagg[p], rtol=1e-5,
                                           atol=1e-7, err_msg=p)
        assert sum(flipped[p].sum() for p in lowbit) <= 1e-4 * backbone_size
        for p, t in T.flatten(state.model.tree()):
            keep = ~flipped[p]
            np.testing.assert_allclose(
                t.detach().numpy()[keep],
                np.asarray(dict(T.flatten(jparams))[p])[keep],
                rtol=1e-5, atol=1e-7, err_msg=f"step {k}: {p}")
    assert int(state.opt.step) == 3 and state.step == 3


def test_launcher_runs_on_cpu(capsys):
    history = launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                           "cpu", "--mesh", "4,1", "--steps", "2",
                           "--plan", "gbin_packed"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "workers=4" in capsys.readouterr().out


@pytest.mark.parametrize("vocab", [512, 3001])
@pytest.mark.parametrize("block", ["one", "rows"])
def test_markov_successors_are_the_references_drawn_in_blocks(
        vocab, block, monkeypatch):
    """``MarkovLM`` draws the reference's ``vocab x vocab`` matrix a block
    of rows at a time (at 50,304 tokens the whole matrix is 20.2 GB):
    ``succ`` and ``probs`` byte-equal to the reference's at the SMOKE
    vocabulary and at 3001 tokens, in one block and in blocks of 7 rows
    and a ragged last one."""
    from repro.data.pipeline import MarkovLM as JMarkovLM
    from repro_torch.data import pipeline
    if block == "rows":
        monkeypatch.setattr(pipeline, "SUCCESSOR_BLOCK", 7 * vocab + 3)
    got, want = pipeline.MarkovLM(vocab, seed=5), JMarkovLM(vocab, seed=5)
    assert got.succ.dtype == want.succ.dtype
    assert got.succ.shape == want.succ.shape == (vocab, 16)
    np.testing.assert_array_equal(got.succ, want.succ)
    assert got.probs.tobytes() == want.probs.tobytes()
    rng, jrng = np.random.RandomState(1), np.random.RandomState(1)
    np.testing.assert_array_equal(got.sample(rng, 3, 20),
                                  want.sample(jrng, 3, 20))


def test_launcher_rejects_a_model_axis_and_unported_flags():
    """A model axis above 1 runs one rank a process: outside torchrun the
    launcher refuses it (unless ``--device-count`` starts the ranks), as
    it refuses a ``--device-count`` other than the mesh's size and a
    static controller without a concrete plan."""
    for argv in (["--mesh", "2,2"], ["--device-count", "2"],
                 ["--controller", "static", "--plan", "adaptive"]):
        with pytest.raises(SystemExit):
            launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                         "cpu", *argv])


def test_launcher_device_count_must_match_the_mesh(monkeypatch):
    """``--device-count`` must equal the mesh's size, and under torchrun
    ``WORLD_SIZE``; both refusals come before any rank starts."""
    base = ["--arch", "qwen3_0p6b", "--smoke", "--device", "cpu"]
    for argv in (["--mesh", "2,2", "--device-count", "3"],
                 ["--mesh", "2,2", "--device-count", "8"]):
        with pytest.raises(SystemExit) as e:
            launch_main(base + argv)
        assert e.value.code == 2
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit) as e:
        launch_main(base + ["--mesh", "2,1", "--device-count", "2"])
    assert e.value.code == 2


def test_launcher_under_torchrun_trains_a_2x2_mesh(tmp_path):
    """``torchrun --nproc-per-node 4 ... --mesh 2,2``: one step on a
    (data 2) x (model 2) mesh over gloo; every rank prints the same loss
    and the whole model's traffic ratio.  ``--device-count 4`` with the
    same flags, outside torchrun, starts the four ranks itself and prints
    the same ``final:`` lines."""
    env = dict(os.environ)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    flags = ["--arch", "qwen3_0p6b", "--smoke", "--device", "cpu", "--mesh",
             "2,2", "--steps", "1", "--plan", "gbin_packed",
             "--global-batch", "4", "--seq-len", "16"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *flags]
    own = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *flags,
         "--device-count", "4"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=tmp_path)
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300, cwd=tmp_path)
        own_out, own_err = own.communicate(timeout=300)
    finally:
        if own.poll() is None:
            own.kill()
            own.wait()
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert own.returncode == 0, own_out[-2000:] + own_err[-3000:]
    finals = [line for line in r.stdout.splitlines()
              if line.startswith("final:")]
    assert sorted(finals) == sorted(
        line for line in own_out.splitlines() if line.startswith("final:"))
    assert len(finals) == 4, r.stdout
    assert len({line.split("loss=")[1].split()[0] for line in finals}) == 1
    assert {line.rsplit("rank=", 1)[1] for line in finals} == \
        {"0", "1", "2", "3"}
    assert all("workers=2 model=2" in line for line in finals)
    single = launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                          "cpu", "--mesh", "1,1", "--steps", "1", "--plan",
                          "gbin_packed", "--global-batch", "4",
                          "--seq-len", "16"])
    ratio = finals[0].split("traffic=")[1].split()[0]
    assert ratio == f"{single[-1]['traffic_ratio']:.4f}"


# ---------------------------------------------------------------------------
# the controller path of the Trainer
# ---------------------------------------------------------------------------

def _smoke_trainer(setup, **kw):
    """A port Trainer on the SMOKE config, W = 4, holding the reference's
    parameters."""
    _, cfg, _, host, data = setup
    trainer = Trainer(cfg, AdamW(**OPT), data, fabric=Fabric(num_workers=W),
                      device="cpu", **kw)
    trainer.init_state()
    with torch.no_grad():
        for t, h in zip(T.leaves(trainer.state.model.tree()),
                        T.leaves(params_from_jax(host, device="cpu"))):
            t.copy_(h)
    return trainer


def test_paper_controller_trainer_matches_reference(setup):
    """Five steps under ``paper`` (warm-up 2, packed schedule): steps 0-1
    on FP32 with diagnostics, admission at step 1, steps 2-4 under the
    admitted plan.  The reference side is its controller observing a loop
    of reference steps (one per latched plan) with its diagnostics.  Votes
    may flip where a worker's gradient is below 1e-6 of its largest, as in
    ``test_train_steps_match_reference``; those elements leave the
    parameter comparison."""
    jcfg, cfg, jparams, host, data = setup
    make = dict(warmup_steps=2)
    trainer = _smoke_trainer(setup, controller=make_controller(
        "paper", commander=Commander(schedule=Schedule.PACKED_A2A), **make))
    jc = JC.make_controller("paper", commander=JC.Commander(
        schedule="packed_a2a"), **make)
    jfab = JFabric(dp_axes=("w",), num_workers=W)
    groups = jfab.groups(jparams)
    jstate = JAdamW(**OPT).init(jparams)
    jef = jax.tree.map(lambda e: jnp.broadcast_to(e, (W,) + e.shape),
                       j_init_ef(jparams, jfab.resolve(jparams,
                                                       JPlan.fp32_all())))
    steps = {}
    flipped = {p: np.zeros(t.shape, bool)
               for p, t in T.flatten(trainer.state.model.tree())}
    for k in range(5):
        jplan, diag = jc.plan, jc.wants_diagnostics
        assert trainer.controller.wants_diagnostics == diag
        sig = jplan.signature()
        if sig not in steps:
            steps[sig] = _reference_step(jcfg, jplan)[0]
        jparams, jstate, jl, jagg, jg, jef = steps[sig](
            jparams, jstate, jef, _shards(data.batch_at(k)))
        metrics = {"loss": float(jl), "plan": sig}
        if diag:
            for g, d in j_cosines(jagg, groups).items():
                metrics[f"cos/{g}/gbinary"] = float(d["gbinary"])
                metrics[f"cos/{g}/gternary"] = float(d["gternary"])
        jc.observe(JC.Telemetry.from_metrics(k, metrics))

        plan = trainer.controller.plan
        assert plan.signature() == sig
        trainer.run(k + 1)
        rec = trainer.history[-1]
        np.testing.assert_allclose(rec["loss"], float(jl), rtol=1e-5)
        cos = sorted(m for m in rec if m.startswith("cos/"))
        assert cos == sorted(m for m in metrics if m.startswith("cos/"))
        for m in cos:
            np.testing.assert_allclose(rec[m], metrics[m], rtol=1e-5,
                                       err_msg=m)
        jagg = dict(T.flatten(jax.tree.map(np.asarray, jagg)))
        jg = dict(T.flatten(jax.tree.map(np.asarray, jg)))
        lowbit = {p for p, pol in T.flatten(trainer.fabric.resolve(
            trainer.state.model.tree(), plan)) if pol.schedule == "packed_a2a"}
        assert bool(lowbit) == (k >= 2)
        for p, u in T.flatten(trainer.last_aggregates):
            if p in lowbit:
                diff = u.numpy() != jagg[p]
                x = np.abs(jg[p]).reshape(W, -1)
                small = x < 1e-6 * x.max(axis=1, keepdims=True)
                assert not (diff.reshape(-1) & ~small.any(axis=0)).any(), p
                flipped[p] |= diff
            else:
                np.testing.assert_allclose(u.numpy(), jagg[p], rtol=1e-5,
                                           atol=1e-7, err_msg=p)
        for p, t in T.flatten(trainer.state.model.tree()):
            keep = ~flipped[p]
            np.testing.assert_allclose(
                t.detach().numpy()[keep],
                np.asarray(dict(T.flatten(jparams))[p])[keep],
                rtol=1e-5, atol=1e-7, err_msg=f"step {k}: {p}")
    events = [(e.step, e.kind, e.plan_signature)
              for e in trainer.controller.events]
    assert events == [(e.step, e.kind, e.plan_signature) for e in jc.events]
    assert [(s, k) for s, k, _ in events] == [(1, "warmup_end"),
                                              (1, "admitted")]
    assert "packed_a2a" in events[-1][2]


def test_static_controller_history_is_bit_identical(setup):
    """``controller="static"`` (by name, through the fabric) and the
    ``plan=`` path: the same history and the same parameters, bit for
    bit."""
    plan = plan_presets()["gbin_packed"]
    runs = []
    for kw in (dict(plan=plan),
               dict(controller=make_controller("static", plan="gbin_packed"))):
        trainer = _smoke_trainer(setup, **kw)
        trainer.run(3)
        runs.append(trainer)
    a, b = runs
    assert b.controller is b.fabric.controller and a.controller is None
    for ha, hb in zip(a.history, b.history):
        ha, hb = dict(ha), dict(hb)
        ha.pop("step_time_s"), hb.pop("step_time_s")
        assert ha == hb
    for x, y in zip(T.leaves(a.state.model.tree()),
                    T.leaves(b.state.model.tree())):
        assert torch.equal(x, y)


def test_trainer_takes_the_fabric_controller_and_refuses_a_conflict(setup):
    _, cfg, _, _, data = setup
    fabric = Fabric(num_workers=W)
    attached = fabric.attach_controller("paper", warmup_steps=1)
    assert Trainer(cfg, AdamW(**OPT), data, fabric=fabric,
                   device="cpu").controller is attached
    with pytest.raises(ValueError, match="conflicts"):
        Trainer(cfg, AdamW(**OPT), data, fabric=fabric, device="cpu",
                controller="fp32")
    with pytest.raises(TypeError, match="registered name"):
        fabric.attach_controller(attached, warmup_steps=1)


def test_error_feedback_stays_off_after_admission(setup):
    """The EF state is built once, for the plan latched at ``init_state``:
    the paper controller's FP32 warm-up plan, so every leaf holds the
    scalar sentinel and EF never runs, even after the Commander admits
    an EF plan.  The reference Trainer builds it the same way
    (``repro/runtime/train.py:194-205``); its fault is in ROADMAP
    queue 3."""
    jcfg, _, jparams, _, _ = setup
    trainer = _smoke_trainer(setup, controller=make_controller(
        "paper", warmup_steps=1, commander=Commander(
            schedule=Schedule.PACKED_A2A, error_feedback=True)))
    trainer.run(3)
    assert ":packed_a2a:1" in trainer.controller.plan.signature()
    assert [e.kind for e in trainer.controller.events] == \
        ["warmup_end", "admitted"]
    assert all(e.dim() == 0 and float(e) == 0.0
               for e in T.leaves(trainer.state.ef))
    # the reference's EF tree for the warm-up plan: sentinels too
    jfab = JFabric(dp_axes=("w",), num_workers=W)
    assert all(np.ndim(e) == 0 for e in jax.tree.leaves(
        j_init_ef(jparams, jfab.resolve(jparams, JPlan.fp32_all()))))
    # built for the admitted plan, it would hold residuals
    params = trainer.state.model.tree()
    admitted = trainer.fabric.init_ef(
        params, trainer.fabric.resolve(params, trainer.controller.plan))
    assert any(e.dim() > 0 for e in T.leaves(admitted))


def test_grad_accum_keeps_float32_gradients_on_bfloat16_params():
    """The reference accumulates in float32 and never casts back: on a
    bfloat16 model the layout is planned on bf16 leaves and the buckets
    carry float32 payloads, so every aggregate is float32."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                              dtype="bfloat16")
    model = Transformer(cfg, seed=0, device="cpu")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    fabric = Fabric(num_workers=W)
    params = model.tree()
    plan = plan_presets()["gbin_packed"]
    opt = AdamW(**OPT)
    step = fabric.step_for(opt, plan, params, model.loss, grad_accum=2)
    assert step is fabric.step_for(opt, plan, params, model.loss,
                                   grad_accum=2)
    assert step is not fabric.step_for(opt, plan, params, model.loss)
    assert {b.key.dtype for b in step.layout.buckets
            if b.key.schedule == "packed_a2a"} == {"bfloat16"}
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    grads, _ = fabric.worker_grads(params, batch, model.loss, grad_accum=2)
    assert all(g.dtype == torch.float32 for g in T.leaves(grads))
    state = TrainState(model=model, opt=opt.init(params),
                       ef=fabric.init_ef(params, fabric.resolve(params,
                                                                plan)))
    state, metrics, agg = step(state, batch)
    assert all(u.dtype == torch.float32 for u in T.leaves(agg))
    assert np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("argv", [["--controller", "paper"],
                                  ["--plan", "adaptive"]])
def test_launcher_runs_the_paper_controller_on_cpu(argv):
    history = launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                           "cpu", "--mesh", "4,1", "--steps", "3",
                           "--warmup-steps", "1", *argv])
    fp32 = AdmissionPlan.fp32_all().signature()
    assert history[0]["plan"] == fp32 and "cos/backbone/gbinary" in history[0]
    assert all(h["plan"] != fp32 for h in history[1:])
    assert all("cos/backbone/gbinary" not in h for h in history[1:])
    assert history[-1]["traffic_ratio"] < 1.0
