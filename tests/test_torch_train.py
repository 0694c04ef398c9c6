"""The port's model, step and launcher against the reference's.

On the qwen3 SMOKE config in float32 with W = 4 virtual workers, with
the reference's parameters carried across (``params_from_jax``):

  * the parameter tree round-trips and flattens in JAX's leaf order;
  * each worker's loss and gradients equal ``jax.value_and_grad`` of
    ``repro.models.loss_fn`` to ``rtol=1e-5, atol=1e-6``;
  * three steps of the port's train step follow a JAX reference step
    (vmapped grads -> vmapped reference Fabric aggregate -> reference
    AdamW) to ``rtol=1e-5``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import AggregationMode as JMode  # noqa: E402
from repro.core import init_ef_states as j_init_ef  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AdmissionPlan, AggregationMode, Schedule  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import Fabric, TrainState, plan_presets  # noqa: E402
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.models import (Transformer, params_from_jax,  # noqa: E402
                                params_to_numpy)
from repro_torch.optim import AdamW  # noqa: E402

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
#   staged       — a packed G-Ternary backbone on the staged chain.
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
}


def _reference_step(jcfg, jplan, fused=True, fused_kernels=True):
    """vmapped grads -> vmapped reference Fabric aggregate (EF threaded
    per worker) -> reference AdamW, under jit."""
    jfab = JFabric(dp_axes=("w",), num_workers=W,
                   fused_kernels=fused_kernels)
    opt = JAdamW(**OPT)

    @jax.jit
    def step(params, state, ef, shards):
        def one(b, e):
            lval, g = jax.value_and_grad(
                lambda p: j_loss_fn(p, jcfg, b))(params)
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
    step_fn, jopt, jfab = _reference_step(
        jcfg, jplan, fused=fabric.fused, fused_kernels=fabric.fused_kernels)
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
    step = fabric.build_step(opt, plan, params, model.loss)
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


def test_launcher_rejects_a_model_axis_and_unported_flags():
    for argv in (["--mesh", "2,2"], ["--controller", "paper"]):
        with pytest.raises(SystemExit):
            launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                         "cpu", *argv])
