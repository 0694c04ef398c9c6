"""The port's accuracy harness against the reference's, on the CPU.

``repro_torch.core.experiments`` (and the task generators and cosine
diagnostics it runs on) beside ``repro.core.experiments``:

  * ``ClassificationTask`` samples and batches: byte-equal;
  * the aggregation ``RULES`` on seeded (W, ...) stacks with ties, zero
    columns and NaNs: the vote rules and ``sign_of_mean`` byte-equal (the
    sign follows ``jnp.sign``: NaN stays NaN); the FP32 mean within the
    float32 rounding of another summation order, ``rtol=1e-6``;
  * ``group_cosines_from_mean`` / ``group_cosines_from_workers``: within
    ``rtol=1e-5`` of the reference's;
  * ``run_training`` fed the reference's initial weights (``params=``) and
    its degradation noise (``noise=``): the first 30 losses of every
    policy, admitted from step 0, within ``rtol=1e-5`` (measured: 3e-7);
  * the four HARD runs of ``benchmarks/bench_convergence.py`` (700 steps,
    batch 64, W = 8, warm-up 50, seed 0, sign lr 2e-4) and the guarded
    pilot of ``benchmarks/bench_recovery.py``, each recomputed here with
    the reference: traffic ratios equal, accuracy within 2 points, the
    pilot's events of the same kinds in the same order and its count of
    low-bit steps within 30 (5% of its 600) of the reference's.  The one
    exception is ``fp32_all``, held to 3 points: at lr 0.08 with momentum
    its trajectory is chaotic.  The two packages' losses agree to 1e-6 for
    its first 100 steps and then part, and scaling the port's own initial
    weights by 1 +- 1e-7 moves its final accuracy over 2.7 points
    (0.8687-0.8960); the sign runs, at lr 2e-4 after the warm-up, do not
    part so.

The file runs in about a minute, most of it the reference's runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import experiments as JE  # noqa: E402
from repro.core import diagnostics as JD  # noqa: E402
from repro.core.admission import Commander as JCommander  # noqa: E402
from repro.core.admission import CusumGuard as JCusumGuard  # noqa: E402
from repro.core.admission import Supervisor as JSupervisor  # noqa: E402
from repro.data import make_cluster_task as j_make_cluster_task  # noqa: E402
from repro.fabric import control as JC  # noqa: E402
from repro_torch.core import (Commander, CusumGuard, Supervisor,  # noqa: E402
                              group_cosines_from_mean,
                              group_cosines_from_workers)
from repro_torch.core import experiments as PE  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import make_cluster_task  # noqa: E402
from repro_torch.fabric.control import Telemetry, make_controller  # noqa: E402

HARD = dict(steps=700, batch=64, warmup_fp32=50, seed=0)
SIGN_LR = 2e-4
RUNS = {"fp32_all": dict(policy="fp32"),
        "gbinary_all": dict(policy="gbinary", lr=SIGN_LR),
        "gbinary_backbone_fp32_head": dict(policy="gbinary",
                                           head_policy="fp32", lr=SIGN_LR),
        "sign_of_mean": dict(policy="sign_of_mean", lr=SIGN_LR)}
ACC_POINTS = {"fp32_all": 3.0}     # the chaotic run; see the docstring


@pytest.fixture(scope="module")
def ref_params():
    return jax.tree.map(np.asarray,
                        JE.init_mlp(jax.random.PRNGKey(0), 64, 256, 100))


def ref_noise(step, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(step), shape))


# ---------------------------------------------------------------------------
# tasks, rules and cosines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hard", [False, True])
def test_task_samples_are_byte_equal(hard):
    task = make_cluster_task(100 if hard else 10, dim=64, hard=hard, seed=3)
    jtask = j_make_cluster_task(100 if hard else 10, dim=64, hard=hard,
                                seed=3)
    np.testing.assert_array_equal(task.centers, jtask.centers)
    assert task.noise == jtask.noise
    for (x, y), (jx, jy) in zip(
            [task.sample(np.random.RandomState(5), 300)]
            + [next(task.batches(64, seed_offset=7)) for _ in range(2)],
            [jtask.sample(np.random.RandomState(5), 300)]
            + [next(jtask.batches(64, seed_offset=7)) for _ in range(2)]):
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert PE.hard_task().centers.tobytes() == \
        JE.hard_task().centers.tobytes()
    assert PE.easy_task(2).centers.tobytes() == \
        JE.easy_task(2).centers.tobytes()


def _stack(seed, w, shape):
    """Seeded (W, *shape) worker gradients with a tie column, a zero
    column, a -0.0 column and a NaN."""
    rng = np.random.RandomState(seed)
    g = rng.randn(w, *shape).astype(np.float32)
    flat = g.reshape(w, -1)
    flat[: w // 2, 0], flat[w // 2:, 0] = 1.0, -1.0
    flat[:, 1] = 0.0
    flat[:, 2] = -0.0
    flat[0, 3] = np.nan
    return g


@pytest.mark.parametrize("w", [3, 8])
@pytest.mark.parametrize("rule", sorted(PE.RULES))
def test_rules_match_reference(rule, w):
    assert PE.LR == JE.LR and set(PE.RULES) == set(JE.RULES)
    for shape in ((7,), (64, 33)):
        g = _stack(w + len(shape), w, shape)
        got = PE.RULES[rule](torch.from_numpy(g)).numpy()
        want = np.asarray(JE.RULES[rule](jnp.asarray(g)))
        assert got.dtype == want.dtype and got.shape == want.shape
        if rule == "fp32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("phase", [0, 2])
def test_cosines_match_reference(phase):
    rng = np.random.RandomState(phase)
    shapes = {"backbone": {"w1": (64, 40), "b1": (40,)},
              "head": {"w": (40, 10), "b": (10,)},
              "norms": {"scale": (40,)}}
    workers = T.map_leaves(
        lambda s: (rng.randn(8, *s) + 0.3).astype(np.float32), shapes)
    groups = {g: T.map_leaves(lambda _, n=g: n, shapes[g]) for g in shapes}
    mean = T.map_leaves(lambda a: a.mean(axis=0), workers)
    for fn, jfn, tree in (
            (group_cosines_from_mean, JD.group_cosines_from_mean, mean),
            (group_cosines_from_workers, JD.group_cosines_from_workers,
             workers)):
        got = fn(T.map_leaves(torch.from_numpy, tree), groups, phase)
        want = jfn(T.map_leaves(jnp.asarray, tree), groups, phase)
        assert set(got) == set(want) == set(shapes)
        for g in got:
            for m in ("gbinary", "gternary"):
                np.testing.assert_allclose(float(got[g][m]),
                                           float(want[g][m]), rtol=1e-5)


# ---------------------------------------------------------------------------
# run_training against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", sorted(PE.RULES))
def test_first_losses_match_reference(policy, ref_params):
    lr = None if policy == "fp32" else SIGN_LR
    kw = dict(policy=policy, steps=30, batch=64, warmup_fp32=0, seed=0,
              lr=lr)
    got = PE.run_training(PE.hard_task(), device="cpu", params=ref_params,
                          **kw)
    want = JE.run_training(JE.hard_task(), **kw)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert got.traffic_ratio == want.traffic_ratio
    assert got.policy == want.policy


def _pilot(run_training, task, commander, supervisor, guard, telemetry,
           make, **kw):
    """``benchmarks/bench_recovery.py::_pilot(degrade=(250, 280))``."""
    cp = make("paper", commander=commander(tau_binary=0.2),
              supervisor=supervisor(guard=guard(kappa=0.02, h=0.6),
                                    cooldown_steps=60),
              warmup_steps=50)
    lowbit = []

    def callback(step, loss):
        plan = cp.observe(telemetry(step=step, loss=loss, cosines={
            "backbone": {"gbinary": 0.8, "gternary": 0.7},
            "head": {"gbinary": 0.8, "gternary": 0.7}}))
        lowbit.append("gbinary" in plan.signature())
        return ("gbinary", "gbinary") if lowbit[-1] else ("fp32", "fp32")

    r = run_training(task, policy="fp32", steps=600, batch=64, lr=SIGN_LR,
                     warmup_fp32=0, degrade=(250, 280),
                     plan_callback=callback, seed=0, **kw)
    return r, sum(lowbit), [e.kind for e in cp.events]


@pytest.fixture(scope="module")
def hard_runs(ref_params):
    out = {}
    for name, kw in RUNS.items():
        out[name] = (PE.run_training(PE.hard_task(), device="cpu",
                                     params=ref_params, **HARD, **kw),
                     JE.run_training(JE.hard_task(), **HARD, **kw))
    out["pilot"] = (
        _pilot(PE.run_training, PE.hard_task(), Commander, Supervisor,
               CusumGuard, Telemetry, make_controller, device="cpu",
               params=ref_params, noise=ref_noise),
        _pilot(JE.run_training, JE.hard_task(), JCommander, JSupervisor,
               JCusumGuard, JC.Telemetry, JC.make_controller))
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_hard_runs_match_reference(name, hard_runs):
    got, want = hard_runs[name]
    assert got.traffic_ratio == want.traffic_ratio
    assert abs(got.final_acc - want.final_acc) * 100 <= \
        ACC_POINTS.get(name, 2.0), (got.final_acc, want.final_acc)
    # the first 50 steps are the FP32 warm-up of every run
    np.testing.assert_allclose(got.losses[:50], want.losses[:50], rtol=1e-5)


def test_pilot_matches_reference(hard_runs):
    (got, lowbit, kinds), (want, jlowbit, jkinds) = hard_runs["pilot"]
    assert kinds == jkinds
    assert {"admitted", "recovery", "readmitted"} <= set(kinds)
    assert abs(got.final_acc - want.final_acc) * 100 <= 2.0
    assert abs(lowbit - jlowbit) <= 30, (lowbit, jlowbit)


def test_layer_aware_boundary_holds(hard_runs):
    """The paper's boundary on the port's runs: full-path G-Binary at
    least 4 points under FP32, the FP32 head at least 5 points over it."""
    acc = {k: v[0].final_acc for k, v in hard_runs.items() if k in RUNS}
    assert acc["gbinary_all"] <= acc["fp32_all"] - 0.04
    assert acc["gbinary_backbone_fp32_head"] >= acc["gbinary_all"] + 0.05


def test_run_training_labels_a_user_program_and_raises_without_cuda():
    from repro_torch.fabric.control import PolicyProgram
    r = PE.run_training(PE.easy_task(), policy="fp32", steps=4, batch=16,
                        hidden=16, device="cpu",
                        program=PolicyProgram.staged(
                            [("all", ("gternary", "gternary"), None)]))
    assert r.policy == "gternary+gternaryhead"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PE.run_training(PE.easy_task(), steps=1, batch=16)
