"""The port's fabric against the reference's, on identical inputs.

  * ``plan_buckets`` on the full qwen3-0.6B shapes (``jax.eval_shape``)
    gives the reference's layout and kernel accounting.
  * Fed the same per-worker gradients (numpy seed), ``Fabric.aggregate``
    equals ``jax.vmap(repro Fabric(dp_axes=("w",)).aggregate,
    axis_name="w")`` under ``jax.jit``: vote aggregates byte for byte;
    FP32 means to ``rtol=1e-6``, and EF residuals ``x - beta * sgn(x)``
    to ``1e-6 * beta`` (``beta`` is an FP32 mean), because the two
    frameworks sum in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AggregationMode as JMode  # noqa: E402
from repro.core import GroupPolicy as JGroupPolicy  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import init_ef_states as j_init_ef  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.fabric.session import layout_kernel_stats as j_stats  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode, GroupPolicy,
                              Schedule, codec_name, plan_traffic_ratio,
                              wire_bytes_per_device)  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import Fabric, layout_kernel_stats, plan_presets  # noqa: E402

SHAPES = {"backbone": {"w1": (40, 33), "w2": (257,), "w3": (64, 8)},
          "embed": {"table": (130, 7)},
          "head": {"w": (17,)},
          "norms": {"scale": (33,)}}
LOWBIT = {"backbone/w1", "backbone/w2", "backbone/w3", "embed/table"}


def _grads(rng, w):
    return T.map_leaves(lambda s: rng.randn(w, *s).astype(np.float32),
                        SHAPES)


def _plans(schedule, error_feedback):
    """The same plan in both packages: a G-Binary backbone (EF as asked),
    a G-Ternary embedding table, FP32 for the rest."""
    def make(plan_cls, policy_cls, mode_cls, sched):
        return plan_cls.from_dict(
            {"backbone": policy_cls(mode_cls.G_BINARY, sched,
                                    error_feedback=error_feedback),
             "embed": policy_cls(mode_cls.G_TERNARY, sched)},
            default=policy_cls(mode_cls.FP32))
    return (make(JPlan, JGroupPolicy, JMode, schedule),
            make(AdmissionPlan, GroupPolicy, AggregationMode, schedule))


def test_full_qwen3_layout_matches_reference():
    cfg = j_get_config("qwen3_0p6b")
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg))
    jfab = JFabric(dp_axes=("w",), num_workers=4)
    fab = Fabric(num_workers=4)
    want = jfab.layout_for(shapes, j_plan_presets()["gbin_packed"])
    got = fab.layout_for(shapes, plan_presets()["gbin_packed"])
    assert len(got.buckets) == len(want.buckets) == 9
    assert not got.unfused and not want.unfused
    assert got.num_leaves == want.num_leaves == 13
    for a, b in zip(got.buckets, want.buckets):
        assert codec_name(a.key.mode) == b.key.mode.value
        assert (a.key.schedule, a.key.error_feedback, a.key.gate_phase,
                a.key.dtype) == (b.key.schedule, b.key.error_feedback,
                                 b.key.gate_phase, b.key.dtype)
        assert a.size == b.size
        assert [(s.leaf, s.name, s.shape, s.size, s.offset) for s in a.slots] \
            == [(s.leaf, s.name, s.shape, s.size, s.offset) for s in b.slots]
    packed = [b for b in got.buckets if b.key.schedule == "packed_a2a"]
    assert len(packed) == 7 and all(b.key.dtype == "bfloat16" for b in packed)
    stats = layout_kernel_stats(got, 4)
    assert stats == j_stats(want, 4)
    assert stats["launches_fused"] == 21
    sizes = fab.group_sizes(shapes)
    assert sizes == jfab.group_sizes(shapes)
    assert sum(sizes.values()) == 596_049_920


@pytest.mark.parametrize("name", sorted(plan_presets()))
def test_plan_presets_match_reference(name):
    assert plan_presets()[name].signature() == \
        j_plan_presets()[name].signature()
    sizes = {"backbone": 1000, "embed": 300, "norms": 7, "head": 50}
    from repro.core import plan_traffic_ratio as j_ratio
    assert plan_traffic_ratio(sizes, plan_presets()[name]) == \
        j_ratio(sizes, j_plan_presets()[name])


@pytest.mark.parametrize("mode", ["fp32", "gbinary", "gternary"])
@pytest.mark.parametrize("schedule", ["psum", "vote_psum", "packed_a2a"])
@pytest.mark.parametrize("w", [1, 4, 33])
def test_wire_bytes_match_reference(mode, schedule, w):
    from repro.core import wire_bytes_per_device as j_wire
    assert wire_bytes_per_device(12345, mode, schedule, w) == \
        j_wire(12345, mode, schedule, w)


def _run_reference(grads, efs, jplan, w, fused, error_feedback,
                   fused_kernels=True):
    jfab = JFabric(dp_axes=("w",), num_workers=w,
                   fused_kernels=fused_kernels)

    @jax.jit
    def run(gs, es):
        def one(g, e):
            return jfab.aggregate(g, jplan, ef=e if error_feedback else None,
                                  fused=fused)
        return jax.vmap(one, axis_name="w")(gs, es)

    return run(grads, efs)


@pytest.mark.parametrize("schedule", [Schedule.VOTE_PSUM, Schedule.PACKED_A2A])
@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("fused_kernels", [True, False])
def test_aggregate_matches_reference(schedule, error_feedback, fused, w,
                                     fused_kernels):
    """Both sessions with the same ``fused_kernels`` switch: the codecs'
    fused kernel sets, or the staged four-kernel chain."""
    rng = np.random.RandomState(w + 10 * error_feedback)
    grads = _grads(rng, w)
    jplan, plan = _plans(schedule.value, error_feedback)
    g0 = T.map_leaves(lambda g: jnp.asarray(g[0]), grads)
    jpol = JFabric(dp_axes=("w",), num_workers=w).resolve(g0, jplan)
    # per-worker residuals: (1, *shape) per worker in the reference,
    # (W, *shape) in the port; scalar sentinels where EF is off
    ef_on = T.map_leaves(lambda e: e.ndim > 0, j_init_ef(g0, jpol))
    efs = T.map_leaves(
        lambda g, on: (rng.randn(*g.shape).astype(np.float32) if on
                       else np.zeros((w,), np.float32)), grads, ef_on)
    j_efs = T.map_leaves(lambda e, on: e[:, None] if on else e, efs, ef_on)
    want, want_ef = _run_reference(
        T.map_leaves(jnp.asarray, grads), T.map_leaves(jnp.asarray, j_efs),
        jplan, w, fused, error_feedback, fused_kernels)

    t_efs = T.map_leaves(lambda e, on: torch.from_numpy(e) if on
                         else torch.zeros(()), efs, ef_on)
    got, got_ef = Fabric(num_workers=w, fused=fused,
                         fused_kernels=fused_kernels).aggregate(
        T.map_leaves(torch.from_numpy, grads), plan,
        ef=t_efs if error_feedback else None)

    for path, u in T.flatten(got):
        ref_u = np.asarray(dict(T.flatten(want))[path])
        assert u.shape == ref_u.shape[1:]
        for k in range(w):
            if path in LOWBIT:
                np.testing.assert_array_equal(u.numpy(), ref_u[k], path)
            else:
                np.testing.assert_allclose(u.numpy(), ref_u[k], rtol=1e-6,
                                           atol=0, err_msg=path)
    if not error_feedback:
        assert got_ef is None
        return
    for path, e in T.flatten(got_ef):
        ref_e = np.asarray(dict(T.flatten(want_ef))[path])
        if dict(T.flatten(ef_on))[path]:
            # e' = x - beta * sgn(x): the FP32 mean beta = mean|x| may
            # differ by rtol 1e-6, which moves e' by at most 1e-6 * beta
            e_in = dict(T.flatten(efs))[path]
            x = dict(T.flatten(grads))[path] + e_in
            beta = np.abs(x).reshape(w, -1).mean(axis=1)
            err = np.abs(e.numpy() - ref_e[:, 0]).reshape(w, -1)
            assert (err <= 1e-6 * beta[:, None]).all(), path
            assert not np.array_equal(e.numpy(), e_in), "EF not updated"
        else:
            assert e.dim() == 0


def test_fused_equals_per_leaf_bit_for_bit():
    """Bucketed and per-leaf, each on the fused kernel sets and on the
    staged chain: four paths, one set of bits (EF states included).  On
    ``packed_a2a`` per leaf, EF runs inside the kernels with the fused
    sets and in plain torch on the staged chain."""
    rng = np.random.RandomState(5)
    grads = T.map_leaves(torch.from_numpy, _grads(rng, 4))
    for schedule in (Schedule.VOTE_PSUM, Schedule.PACKED_A2A):
        _, plan = _plans(schedule, True)
        fab = Fabric(num_workers=4)
        staged = Fabric(num_workers=4, fused_kernels=False)
        ef = fab.init_ef(T.map_leaves(lambda g: g[0], grads),
                         fab.resolve(T.map_leaves(lambda g: g[0], grads),
                                     plan))
        ef = T.map_leaves(lambda e: e + 0.25 if e.dim() else e, ef)
        a, ea = fab.aggregate(grads, plan, ef=ef, fused=True)
        for f, fused in ((fab, False), (staged, True), (staged, False)):
            b, eb = f.aggregate(grads, plan, ef=ef, fused=fused)
            for (_, x), (_, y) in zip(T.flatten(a) + T.flatten(ea),
                                      T.flatten(b) + T.flatten(eb)):
                assert torch.equal(x, y)


@pytest.mark.parametrize("path", ["bucketed", "per_leaf_ef", "staged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vote_aggregates_in_the_payload_dtype_match_reference(path, dtype):
    """The packed vote decodes straight into the payload's dtype; the
    reference decodes to float32 and casts.  Same bits on the bucketed
    path, per leaf with EF in the kernels, and on the staged chain."""
    w = 4
    fused, error_feedback, fused_kernels = {
        "bucketed": (True, False, True), "per_leaf_ef": (False, True, True),
        "staged": (True, False, False)}[path]
    rng = np.random.RandomState(17)
    grads = _grads(rng, w)
    jplan, plan = _plans(Schedule.PACKED_A2A.value, error_feedback)
    g0 = T.map_leaves(lambda g: jnp.asarray(g[0]), grads)
    jpol = JFabric(dp_axes=("w",), num_workers=w).resolve(g0, jplan)
    ef_on = T.map_leaves(lambda e: e.ndim > 0, j_init_ef(g0, jpol))
    efs = T.map_leaves(
        lambda g, on: (rng.randn(*g.shape).astype(np.float32) if on
                       else np.zeros((w,), np.float32)), grads, ef_on)
    j_efs = T.map_leaves(lambda e, on: e[:, None] if on else e, efs, ef_on)
    want, _ = _run_reference(
        T.map_leaves(lambda g: jnp.asarray(g).astype(dtype), grads),
        T.map_leaves(jnp.asarray, j_efs), jplan, w, fused, error_feedback,
        fused_kernels)
    t_efs = T.map_leaves(lambda e, on: torch.from_numpy(e) if on
                         else torch.zeros(()), efs, ef_on)
    got, _ = Fabric(num_workers=w, fused=fused,
                    fused_kernels=fused_kernels).aggregate(
        T.map_leaves(lambda g: torch.from_numpy(g).to(getattr(torch, dtype)),
                     grads), plan, ef=t_efs if error_feedback else None)
    want = dict(T.flatten(want))
    for p, u in T.flatten(got):
        if p in LOWBIT:
            # bit patterns, so that -0.0 would not pass for +0.0
            view = torch.int16 if dtype == "bfloat16" else torch.int32
            ref_u = np.asarray(want[p][0])
            assert u.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(
                u.view(view).numpy(), ref_u.view(u.view(view).numpy().dtype),
                p)


# ---------------------------------------------------------------------------
# the Section 9 baselines and the microbatch split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["sign_of_mean", "majority_sign_sgd"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("w", [3, 4])
def test_section9_baselines_match_reference(schedule, fused, w):
    """A G-Binary backbone and a G-Ternary embedding table on each
    baseline's schedule, per leaf and bucketed: every leaf byte-equal to
    ``repro``'s, and the same wire bytes.  One stated difference: on the
    dense vote schedule a gated-out element whose vote was -1 is -0.0
    (``-1 * 0``) in the port and in the eager reference, and +0.0 in the
    jitted reference, whose ``u * gate`` XLA rewrites; those zeros are
    compared as zeros."""
    from repro.core import lowbit as JL
    from repro.core import wire_bytes_per_device as j_wire
    from repro_torch.core import VirtualGroup, majority_sign_sgd, sign_of_mean

    rng = np.random.RandomState(40 + w)
    grads = _grads(rng, w)
    jplan, plan = _plans(schedule, False)
    zeros = T.map_leaves(lambda g: jnp.zeros((w,), jnp.float32), grads)
    want, _ = _run_reference(T.map_leaves(jnp.asarray, grads), zeros, jplan,
                             w, fused, False)
    fab = Fabric(num_workers=w, fused=fused)
    got, _ = fab.aggregate(T.map_leaves(torch.from_numpy, grads), plan)
    if fused:
        assert schedule in {b.key.schedule for b in fab.layout_for(
            T.map_leaves(lambda g: torch.from_numpy(g[0]), grads),
            plan).buckets}
    want = dict(T.flatten(want))
    for path, u in T.flatten(got):
        ref_u = np.asarray(want[path][0])
        if path in LOWBIT:
            u = u.numpy()
            if schedule == "majority_sign_sgd":      # -0.0 -> +0.0
                u, ref_u = u + np.float32(0), ref_u + np.float32(0)
            np.testing.assert_array_equal(u.view(np.int32),
                                          ref_u.view(np.int32), path)
        else:
            np.testing.assert_allclose(u.numpy(), ref_u, rtol=1e-6, atol=0,
                                       err_msg=path)
    for mode in ("gbinary", "gternary", "fp32"):
        assert wire_bytes_per_device(12345, mode, schedule, w) == \
            j_wire(12345, mode, schedule, w)

    # the free functions of repro/core/lowbit.py:234-253
    g = grads["backbone"]["w1"]
    fn = {"sign_of_mean": lambda x: JL.sign_of_mean(x, ("w",)),
          "majority_sign_sgd": lambda x: JL.majority_sign_sgd(x, ("w",), w)}
    ref_u = np.asarray(jax.jit(jax.vmap(fn[schedule], axis_name="w"))(
        jnp.asarray(g)))[0]
    group = VirtualGroup(w)
    u = (sign_of_mean(torch.from_numpy(g), group)
         if schedule == "sign_of_mean" else
         majority_sign_sgd(torch.from_numpy(g), group, w))
    np.testing.assert_array_equal(u.numpy().view(np.int32),
                                  ref_u.view(np.int32))


def test_sign_of_mean_keeps_jnp_sign_at_nan():
    """``torch.sign`` maps NaN to 0; the baseline follows ``jnp.sign``."""
    from repro.core import lowbit as JL
    from repro_torch.core import VirtualGroup, sign_of_mean

    g = np.array([[np.nan, 1.0, -2.0, 0.0], [0.5, -3.0, 1.0, 0.0]],
                 np.float32)
    ref_u = np.asarray(jax.jit(jax.vmap(
        lambda x: JL.sign_of_mean(x, ("w",)), axis_name="w"))(
            jnp.asarray(g)))[0]
    u = sign_of_mean(torch.from_numpy(g), VirtualGroup(2)).numpy()
    np.testing.assert_array_equal(u.view(np.int32), ref_u.view(np.int32))


def test_ragged_microbatch_split_raises_as_reference():
    from repro.fabric.session import _split_microbatches as j_split
    from repro_torch.fabric.session import _split_microbatches

    with pytest.raises(ValueError) as want:
        j_split({"tokens": jnp.zeros((4, 5), jnp.int32)}, 3)
    with pytest.raises(ValueError) as got:
        _split_microbatches({"tokens": torch.zeros((4, 5))}, 3)
    assert str(got.value) == str(want.value)
    # a worker's shard of 4 rows does not split in 3: the step raises
    params = {"w": torch.ones(3, requires_grad=True)}
    loss = lambda p, b: (p["w"] * b["x"].sum()).sum()  # noqa: E731
    with pytest.raises(ValueError, match="trailing samples"):
        Fabric(num_workers=2).worker_grads(
            params, {"x": torch.ones(8, 3)}, loss, grad_accum=3)
    parts = _split_microbatches({"x": torch.arange(6)}, 3)
    assert [p["x"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
