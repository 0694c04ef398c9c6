"""Hop plans in the port against the reference's.

  * a 1-hop plan is byte-equal to its flat codec's backend (fp32,
    gbinary, gternary, int4; fused and per leaf; EF on and off) and to
    the reference's 1-hop plan under ``jax.vmap`` in ``jax.jit``;
  * a 2-hop plan on ``VirtualGroup((2, 2))`` equals the reference's
    ``Fabric(dp_axes=("outer", "inner"))`` under nested ``vmap``: the
    inner sums are of 2 values, so the FP32 means are exact and the
    aggregates byte-equal (zeros of either sign as zeros: a gated zero is
    -0.0 in the port and +0.0 under ``jit``); fused equals per leaf; EF
    residuals within ``1e-6 * beta`` (``beta`` is a mean over a leaf's
    elements, summed in another order); bf16 gradients leave hop 0 as
    float32 in both; an int4 mean of 2 encoded values may part from the
    reference's where XLA fuses the dequantize into the sum (an FMA),
    within ``same_mean``'s bound of ``tests/test_torch_codecs.py``;
  * a 2-hop plan on one axis raises ``ValueError``, and so does a plan
    whose hop sizes disagree with the axes (the reference mis-prices that
    case, ROADMAP queue 3);
  * host-local hier equals the flat backbone, and the reference's;
  * per-hop and total wire bytes equal the reference's (``==``) for every
    registered codec pair at W in {1, 4, 32};
  * the bucket key's hop signature and the layout cache on a plan swap;
  * the ``hier_*`` presets, the Commander ladder and the launcher's
    ``--plan hier_fp32_gbinary`` on ``--mesh 2,8,1`` (SMOKE, CPU);
  * one spawn of four gloo ranks as ``ProcessMesh((2, 2, 1))`` under
    registered 2 x 2 plans: aggregates and two Trainer steps (every group
    on the route, so every sum is of 2 values) equal to the virtual
    (2 x 2) group's on the same gradients;
  * one spawn of eight gloo ranks as ``ProcessMesh((2, 2, 2))`` beside
    the reference on eight forced host devices: a hop plan on a
    tensor-parallel leaf (its columns over ``"model"``), each hop seeing
    the block as its backend does (the packed vote per block, fused and
    staged; ``vote_psum``'s gate at the whole leaf's indices; int4's
    absmax over the model group), equal to the reference's
    ``HierarchicalBackend`` on the GSPMD leaf.
"""
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import hop_wire_bytes_per_device as j_hop_wire  # noqa: E402
from repro.core import init_ef_states as j_init_ef  # noqa: E402
from repro.core import resolve_policies as j_resolve  # noqa: E402
from repro.core import wire_bytes_per_device as j_wire  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import HopPlan as JHopPlan  # noqa: E402
from repro.fabric import HopSpec as JHopSpec  # noqa: E402
from repro.fabric import get_codec as j_get_codec  # noqa: E402
from repro.fabric import register_hop_plan as j_register  # noqa: E402
from repro.fabric import unregister_hop_plan as j_unregister  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro_torch.core import (AdmissionPlan, Commander,  # noqa: E402
                              LocalGroup, VirtualGroup, codec_name,
                              hop_wire_bytes_per_device, schedule_name,
                              wire_bytes_per_device, wire_schedule)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import (Fabric, HopPlan, HopSpec,  # noqa: E402
                                available_codecs, get_codec, plan_presets,
                                register_hop_plan, unregister_hop_plan)
from test_torch_codecs import same_mean  # noqa: E402
from test_torch_tp import SRC, _finish_reference, spawn_ranks  # noqa: E402

FLAT_CODECS = ["fp32", "gbinary", "gternary", "int4"]
SHAPES = {"backbone": {"w1": (40, 33), "w2": (257,), "w3": (64, 8)},
          "embed": {"table": (130, 7)},
          "head": {"w": (17,)},
          "norms": {"scale": (33,)}}
#: 2 x 2 plans: an FP32 mean over the inner 2, the backbone over the outer 2
PLANS_2X2 = {
    "h22_vote": (("fp32", 2, None), ("gbinary", None, None)),
    "h22_packed": (("fp32", 2, None), ("gbinary", None, "packed_a2a")),
    "h22_ter": (("fp32", 2, None), ("gternary", None, None)),
    "h22_ter_packed": (("fp32", 2, None), ("gternary", None, "packed_a2a")),
    "h22_int4": (("fp32", 2, None), ("int4", None, None)),
}


def _register(name, legs):
    """Register the same plan in both packages; returns a remover."""
    register_hop_plan(HopPlan(name, tuple(HopSpec(*h) for h in legs)),
                      override=True)
    j_register(JHopPlan(name, tuple(JHopSpec(*h) for h in legs)),
               override=True)

    def remove():
        unregister_hop_plan(name)
        j_unregister(name)
    return remove


@pytest.fixture
def plans_2x2():
    removers = [_register(n, legs) for n, legs in PLANS_2X2.items()]
    yield
    for r in removers:
        r()


def _grads(rng, lead):
    return T.map_leaves(lambda s: rng.randn(*lead, *s).astype(np.float32),
                        SHAPES)


def _bits_equal(a, b):
    a, b = a.contiguous(), b.contiguous()
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))


def _efs(rng, grads, plan, lead):
    """Random residuals where the plan puts EF, both packages' layouts:
    the port's rows of all W workers, the reference's (..., 1, *shape)
    per worker; scalar sentinels elsewhere."""
    g0 = T.map_leaves(lambda g: jnp.asarray(g.reshape(-1, *g.shape[len(lead):])
                                            [0]), grads)
    on = T.map_leaves(lambda e: e.ndim > 0, j_init_ef(g0, j_resolve(
        g0, plan)))
    raw = T.map_leaves(lambda g, o: rng.randn(*g.shape).astype(np.float32)
                       if o else np.zeros(lead, np.float32), grads, on)
    w = int(np.prod(lead))
    port = T.map_leaves(lambda e, o: torch.from_numpy(
        e.reshape(w, *e.shape[len(lead):])) if o else torch.zeros(()),
        raw, on)
    ref = T.map_leaves(lambda e, o: jnp.asarray(
        e[(slice(None),) * len(lead) + (None,)] if o else e), raw, on)
    return port, ref, on


def _int4_encs(rows, fused):
    """The int4 encodes of ``rows`` (a tree of (R, *shape) arrays, the
    values the int4 hop sees) at the path's granularity: each leaf, or
    the one bucket all the leaves share."""
    codec = get_codec("int4")
    flat = {p: torch.from_numpy(np.ascontiguousarray(x)).reshape(
        x.shape[0], -1) for p, x in T.flatten(rows)}
    if not fused:
        return {p: codec.encode(None, x).numpy() for p, x in flat.items()}
    enc = codec.encode(None, torch.cat(list(flat.values()), dim=1)).numpy()
    out, off = {}, 0
    for p, x in flat.items():
        out[p] = enc[:, off:off + x.shape[1]]
        off += x.shape[1]
    return out


def _same_int4_mean(got, want, encs):
    for path, u in T.flatten(got):
        same_mean(u, want[path], encs[path])


def _check_ef(got_ef, want_ef, grads, efs_port, on, lead):
    w = int(np.prod(lead))
    for path, e in T.flatten(got_ef):
        if not dict(T.flatten(on))[path]:
            assert e.dim() == 0
            continue
        ref_e = np.asarray(dict(T.flatten(want_ef))[path]).reshape(w, -1)
        x = dict(T.flatten(grads))[path].reshape(w, -1) + \
            dict(T.flatten(efs_port))[path].numpy().reshape(w, -1)
        beta = np.abs(x).mean(axis=1)
        err = np.abs(e.numpy().reshape(w, -1) - ref_e)
        assert (err <= 1e-6 * beta[:, None]).all(), path


# ---------------------------------------------------------------------------
# plans, sizes, the codec contract
# ---------------------------------------------------------------------------

def test_hop_plan_validation():
    with pytest.raises(ValueError, match="at least one hop"):
        HopPlan("bad_empty", ())
    with pytest.raises(ValueError, match="more than one remainder"):
        HopPlan("bad_two_rem", (HopSpec("fp32"), HopSpec("gbinary")))
    with pytest.raises(ValueError, match=">= 1"):
        HopSpec("fp32", workers=0)
    with pytest.raises(ValueError, match="do not nest"):
        register_hop_plan(HopPlan("bad_nested",
                                  (HopSpec("hier_fp32_gbinary"),)))
    assert "bad_nested" not in available_codecs()


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 24, 32, 64])
def test_group_sizes_equal_the_references(w):
    for name in ("hier_fp32_gbinary", "hier_fp32_gternary",
                 "hier_fp32_int4"):
        assert get_codec(name).plan.group_sizes(w) == \
            j_get_codec(name).plan.group_sizes(w)
    odd = HopPlan("odd", (HopSpec("fp32", workers=3), HopSpec("gbinary")))
    jodd = JHopPlan("odd", (JHopSpec("fp32", workers=3),
                            JHopSpec("gbinary")))
    try:
        want = jodd.group_sizes(w)
    except ValueError:
        with pytest.raises(ValueError, match="does not divide"):
            odd.group_sizes(w)
    else:
        assert odd.group_sizes(w) == want


def test_signature_and_codec_contract_delegate_to_hops():
    plan = HopPlan("x", (HopSpec("fp32", workers=8),
                         HopSpec("gbinary", schedule="vote_psum")))
    assert plan.signature() == "x[fp32:8>gbinary:*@vote_psum]"
    for name in ("hier_fp32_gbinary", "hier_fp32_gternary",
                 "hier_fp32_int4"):
        c, jc = get_codec(name), j_get_codec(name)
        assert c.hop_signature == jc.hop_signature
        assert (c.reduction, c.default_schedule, c.bits_per_element,
                c.gated, c.threads_ef) == \
            (jc.reduction, jc.default_schedule, jc.bits_per_element,
             jc.gated, jc.threads_ef)
        assert c.lane == get_codec(c.plan.hops[-1].codec).lane
        assert c.lane.name == jc.lane.name
        assert c.kernel_set() is None
        for sched in ("psum", "vote_psum", "packed_a2a"):
            assert wire_schedule(name, sched) == "hierarchical"
        assert wire_schedule(name, "sign_of_mean") == "sign_of_mean"
    # the route's kernel signature joins the hops'
    vote_sig = get_codec("gbinary").kernel_signature()
    assert get_codec("hier_fp32_gbinary").kernel_signature() == \
        f"->{vote_sig}"


# ---------------------------------------------------------------------------
# 1-hop plan == flat backend, and == the reference's
# ---------------------------------------------------------------------------

def _ref_one_axis(grads, efs, jplan, w, fused, with_ef):
    jfab = JFabric(dp_axes=("w",), num_workers=w)

    @jax.jit
    def run(gs, es):
        def one(g, e):
            return jfab.aggregate(g, jplan, ef=e if with_ef else None,
                                  fused=fused)
        return jax.vmap(one, axis_name="w")(gs, es)
    return run(T.map_leaves(jnp.asarray, grads), efs)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode,ef", [(m, False) for m in FLAT_CODECS]
                         + [("gbinary", True), ("gternary", True)])
def test_one_hop_plan_matches_flat_backend_and_reference(mode, ef, fused, w):
    name = f"hier1_{mode}"
    remove = _register(name, ((mode, None, None),))
    try:
        rng = np.random.RandomState(w + 3 * fused)
        grads = _grads(rng, (w,))
        jplan = JPlan.lowbit_all(name, error_feedback=ef)
        efs, j_efs, on = _efs(rng, grads, jplan, (w,))
        tg = T.map_leaves(torch.from_numpy, grads)
        fab = Fabric(num_workers=w, fused=fused)
        flat, flat_ef = fab.aggregate(
            tg, AdmissionPlan.lowbit_all(mode, error_feedback=ef),
            ef=efs if ef else None)
        hier, hier_ef = fab.aggregate(
            tg, AdmissionPlan.lowbit_all(name, error_feedback=ef),
            ef=efs if ef else None)
        for (p, a), (_, b) in zip(T.flatten(flat), T.flatten(hier)):
            assert _bits_equal(a, b), p
        if ef:
            for (p, a), (_, b) in zip(T.flatten(flat_ef),
                                      T.flatten(hier_ef)):
                assert _bits_equal(a, b) if a.dim() else b.dim() == 0, p
        want, want_ef = _ref_one_axis(grads, j_efs, jplan, w, fused, ef)
        if mode == "int4":
            assert len(fab.layout_for(T.map_leaves(lambda g: g[0], tg),
                                      AdmissionPlan.lowbit_all(name))
                       .buckets) == 1
            _same_int4_mean(hier, {p: np.asarray(x)[0] for p, x in
                                   T.flatten(want)},
                            _int4_encs(grads, fused))
        for path, u in T.flatten(hier if mode != "int4" else {}):
            ref_u = np.asarray(dict(T.flatten(want))[path])
            for k in range(w):
                if mode in ("gbinary", "gternary") or w == 2:
                    np.testing.assert_array_equal(u.numpy(), ref_u[k], path)
                else:       # means of 4 values, summed in another order
                    np.testing.assert_allclose(u.numpy(), ref_u[k],
                                               rtol=1e-6, atol=0)
        if ef:
            _check_ef(hier_ef, want_ef, grads, efs, on, (w,))
    finally:
        remove()


# ---------------------------------------------------------------------------
# 2-hop plans on a (2 x 2) group == the reference's nested vmap
# ---------------------------------------------------------------------------

def _ref_nested(grads, efs, jplan, fused, with_ef):
    jfab = JFabric(dp_axes=("outer", "inner"), num_workers=4)

    @jax.jit
    def run(gs, es):
        def one(g, e):
            return jfab.aggregate(g, jplan, ef=e if with_ef else None,
                                  fused=fused)
        return jax.vmap(jax.vmap(one, axis_name="inner"),
                        axis_name="outer")(gs, es)
    return run(T.map_leaves(jnp.asarray, grads), efs)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("name", sorted(PLANS_2X2))
def test_two_hop_plan_matches_reference_nested_vmap(plans_2x2, name, ef,
                                                    fused):
    rng = np.random.RandomState(7 + 2 * ef + fused)
    grads = _grads(rng, (2, 2))
    jplan = JPlan.lowbit_all(name, error_feedback=ef)
    efs, j_efs, on = _efs(rng, grads, jplan, (2, 2))
    tg = T.map_leaves(lambda g: torch.from_numpy(g.reshape(4, *g.shape[2:])),
                      grads)
    fab = Fabric(group=VirtualGroup((2, 2)), fused=fused)
    got, got_ef = fab.aggregate(tg, AdmissionPlan.lowbit_all(
        name, error_feedback=ef), ef=efs if ef else None)
    want, want_ef = _ref_nested(grads, j_efs, jplan, fused, ef)
    for path, u in T.flatten(got):
        ref_u = np.asarray(dict(T.flatten(want))[path])
        assert u.dtype == torch.float32
        for o, i in itertools.product(range(2), range(2)):
            if "int4" in name:      # an int4 mean of the 2 inner means
                assert ref_u[o, i].tobytes() == ref_u[0, 0].tobytes()
                continue
            np.testing.assert_array_equal(u.numpy(), ref_u[o, i], path)
    if "int4" in name:
        means = T.map_leaves(lambda g: (g[:, 0] + g[:, 1]) / np.float32(2),
                             grads)
        _same_int4_mean(got, {p: np.asarray(x)[0, 0] for p, x in
                              T.flatten(want)}, _int4_encs(means, fused))
    if ef:
        _check_ef(got_ef, want_ef, grads, efs, on, (2, 2))
    if "int4" in name:      # int4's absmax spans the payload: a leaf or
        return              # a bucket, the same meaning, other bits
    # per leaf and bucketed agree bit for bit, EF included
    other, other_ef = Fabric(group=VirtualGroup((2, 2)),
                             fused=not fused).aggregate(
        tg, AdmissionPlan.lowbit_all(name, error_feedback=ef),
        ef=efs if ef else None)
    for (p, a), (_, b) in zip(T.flatten(got), T.flatten(other)):
        assert _bits_equal(a, b), p
    if ef:
        for (p, a), (_, b) in zip(T.flatten(got_ef), T.flatten(other_ef)):
            assert (_bits_equal(a, b) if a.dim() else b.dim() == 0), p


def test_two_hop_oracle_and_staged_chain(plans_2x2):
    """sign(sum_outer(sign(mean_inner(g)))); the packed backbone on the
    staged chain gives the fused kernels' bits."""
    rng = np.random.RandomState(11)
    g = rng.randn(2, 2, 300).astype(np.float32)
    tg = {"p": torch.from_numpy(g.reshape(4, 300))}
    want = np.sign(np.where(g.mean(axis=1) > 0, 1, -1).sum(axis=0))
    for name in ("h22_vote", "h22_packed"):
        plan = AdmissionPlan.lowbit_all(name)
        a, _ = Fabric(group=VirtualGroup((2, 2))).aggregate(tg, plan)
        b, _ = Fabric(group=VirtualGroup((2, 2)),
                      fused_kernels=False).aggregate(tg, plan)
        np.testing.assert_array_equal(a["p"].numpy(), want)
        assert _bits_equal(a["p"], b["p"])


def test_bf16_gradients_leave_hop_zero_as_float32(plans_2x2):
    """The FP32 hop hands float32 to the backbone hop, in the reference
    (``fp32_allreduce`` casts, nothing casts back) as in the port."""
    rng = np.random.RandomState(3)
    g = rng.randn(2, 2, 4096).astype(np.float32)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    for name in ("h22_vote", "h22_packed", "h22_int4"):
        got, _ = Fabric(group=VirtualGroup((2, 2))).aggregate(
            {"p": gb.reshape(4, 4096)}, AdmissionPlan.lowbit_all(name))
        jg = jnp.asarray(gb.to(torch.float32).numpy()).astype(jnp.bfloat16)
        want, _ = _ref_nested({"p": jg}, {"p": jnp.zeros((2, 2))},
                              JPlan.lowbit_all(name), True, False)
        assert got["p"].dtype == torch.float32
        assert want["p"].dtype == jnp.float32
        if name == "h22_int4":
            g32 = gb.to(torch.float32).numpy()
            means = {"p": (g32[:, 0] + g32[:, 1]) / np.float32(2)}
            _same_int4_mean(got, {"p": np.asarray(want["p"][1, 0])},
                            _int4_encs(means, True))
            continue
        np.testing.assert_array_equal(got["p"].numpy(),
                                      np.asarray(want["p"][1, 0]))


def test_two_hop_plan_on_one_axis_raises():
    rng = np.random.RandomState(0)
    tg = T.map_leaves(torch.from_numpy, _grads(rng, (4,)))
    plan = AdmissionPlan.lowbit_all("hier_fp32_gbinary")
    for fused in (True, False):
        with pytest.raises(ValueError, match="one data-parallel axis a hop"):
            Fabric(num_workers=4, fused=fused).aggregate(tg, plan)
    with pytest.raises(ValueError, match="one data-parallel axis a hop"):
        Fabric(group=VirtualGroup((2, 2, 1))).aggregate(tg, plan)


def test_hop_sizes_must_equal_the_axes():
    """The built-in plan on a (2 x 2) group sizes its hops (4, 1): the
    reference runs it anyway and prices hop 0 at 4 workers and hop 1 at
    none (and its packed backbone fails in ``all_to_all``); the port
    refuses by name (ROADMAP queue 3)."""
    rng = np.random.RandomState(0)
    tg = T.map_leaves(torch.from_numpy, _grads(rng, (4,)))
    with pytest.raises(ValueError, match=r"sizes its hops \(4, 1\)"):
        Fabric(group=VirtualGroup((2, 2))).aggregate(
            tg, AdmissionPlan.lowbit_all("hier_fp32_gbinary"))
    assert j_hop_wire(64, "hier_fp32_gbinary", "hierarchical", 4) == \
        (384.0, 0.0)
    assert (j_wire(64, "fp32", "psum", 2), j_wire(64, "gbinary",
                                                  "vote_psum", 2)) == \
        (256.0, 64.0)
    # the built-in plan runs where the inner axis holds its 8 workers
    g = torch.from_numpy(rng.randn(16, 100).astype(np.float32))
    a, _ = Fabric(group=VirtualGroup((2, 8))).aggregate(
        {"p": g}, AdmissionPlan.lowbit_all("hier_fp32_gbinary"))
    m = g.reshape(2, 8, 100).sum(dim=1) / 8
    want = torch.sign(torch.where(m > 0, 1.0, -1.0).sum(dim=0))
    assert _bits_equal(a["p"], want)


def test_host_local_hier_matches_flat_backbone_and_reference():
    rng = np.random.RandomState(0)
    grads = _grads(rng, ())
    tg = T.map_leaves(lambda g: torch.from_numpy(g)[None], grads)
    fab = Fabric(group=LocalGroup())
    for fused in (True, False):
        a, _ = fab.aggregate(tg, AdmissionPlan.lowbit_all(
            "hier_fp32_gbinary"), fused=fused)
        b, _ = fab.aggregate(tg, AdmissionPlan.lowbit_all("gbinary"),
                             fused=fused)
        want, _ = JFabric().aggregate(
            T.map_leaves(jnp.asarray, grads),
            JPlan.lowbit_all("hier_fp32_gbinary"), fused=fused)
        for (p, x), (_, y) in zip(T.flatten(a), T.flatten(b)):
            assert _bits_equal(x, y), p
            np.testing.assert_array_equal(x.numpy(),
                                          np.asarray(dict(
                                              T.flatten(want))[p]))


# ---------------------------------------------------------------------------
# per-hop traffic accounting
# ---------------------------------------------------------------------------

def _flat_registered():
    return [c for c in available_codecs()
            if get_codec(c).reduction != "hierarchical"]


@pytest.mark.parametrize("w", [1, 4, 32])
def test_wire_bytes_equal_the_references_for_every_codec_pair(w):
    flat = _flat_registered()
    assert {"identity", "fp32", "gbinary", "gternary", "int4",
            "topk"} <= set(flat)
    for n in (1, 1000, 1 << 16):
        for mode in flat:
            sched = get_codec(mode).default_schedule
            legs = hop_wire_bytes_per_device(n, mode, sched, w)
            assert legs == j_hop_wire(n, mode, sched, w)
            assert legs == (wire_bytes_per_device(n, mode, sched, w),)
        for name in ("hier_fp32_gbinary", "hier_fp32_gternary",
                     "hier_fp32_int4"):
            legs = hop_wire_bytes_per_device(n, name, "hierarchical", w)
            assert legs == j_hop_wire(n, name, "hierarchical", w)
            assert sum(legs) == wire_bytes_per_device(n, name,
                                                      "hierarchical", w) \
                == j_wire(n, name, "hierarchical", w)
    for intra, backbone in itertools.product(flat, repeat=2):
        for intra_w in (2, 8):
            remove = _register("hier_pair_tmp", ((intra, intra_w, None),
                                                 (backbone, None, None)))
            try:
                for n in (1, 12345):
                    legs = hop_wire_bytes_per_device(
                        n, "hier_pair_tmp", "hierarchical", w)
                    assert legs == j_hop_wire(n, "hier_pair_tmp",
                                              "hierarchical", w)
                    assert len(legs) == 2
                    assert wire_bytes_per_device(
                        n, "hier_pair_tmp", "hierarchical", w) == \
                        j_wire(n, "hier_pair_tmp", "hierarchical", w)
            finally:
                remove()


def test_hier_backbone_leg_beats_flat_backbone_total():
    n, w = 1 << 20, 32
    legs = hop_wire_bytes_per_device(n, "hier_fp32_gbinary", "hierarchical",
                                     w)
    assert legs == (wire_bytes_per_device(n, "fp32", "psum", 8),
                    wire_bytes_per_device(n, "gbinary", "vote_psum", 4))
    assert legs[-1] < wire_bytes_per_device(n, "gbinary", "vote_psum", w)


def test_layout_kernel_stats_count_each_hop_as_the_reference():
    from repro.fabric.session import layout_kernel_stats as j_stats
    from repro_torch.fabric import layout_kernel_stats
    remove = _register("h_packed_8", (("fp32", 8, None),
                                      ("gbinary", None, "packed_a2a")))
    try:
        like = T.map_leaves(lambda s: torch.empty(s, device="meta"), SHAPES)
        jlike = T.map_leaves(lambda s: jax.ShapeDtypeStruct(s, "float32"),
                             SHAPES)
        for name in ("hier_fp32_gbinary", "hier_fp32_int4", "h_packed_8"):
            for w in (1, 8, 32):
                lay = Fabric(num_workers=w).layout_for(
                    like, AdmissionPlan.lowbit_all(name))
                jlay = JFabric(dp_axes=("w",), num_workers=w).layout_for(
                    jlike, JPlan.lowbit_all(name))
                assert layout_kernel_stats(lay, w) == j_stats(jlay, w)
    finally:
        remove()


# ---------------------------------------------------------------------------
# bucket identity
# ---------------------------------------------------------------------------

def test_bucket_key_carries_hop_signature():
    like = T.map_leaves(lambda s: torch.empty(s, device="meta"), SHAPES)
    jlike = T.map_leaves(lambda s: jax.ShapeDtypeStruct(s, "float32"),
                         SHAPES)
    plan = AdmissionPlan.lowbit_backbone("hier_fp32_gbinary")
    layout = Fabric().layout_for(like, plan)
    jlayout = JFabric().layout_for(
        jlike, JPlan.lowbit_backbone("hier_fp32_gbinary"))
    hops = {codec_name(b.key.mode): b.key.hops for b in layout.buckets}
    assert hops == {"hier_fp32_gbinary":
                    "hier_fp32_gbinary[fp32:8>gbinary:*]", "fp32": None}
    assert [b.key.hops for b in layout.buckets] == \
        [b.key.hops for b in jlayout.buckets]
    assert [b.size for b in layout.buckets] == \
        [b.size for b in jlayout.buckets]


def test_layout_cache_invalidated_when_hop_plan_swapped():
    like = T.map_leaves(lambda s: torch.empty(s, device="meta"), SHAPES)
    fabric = Fabric()
    plan = AdmissionPlan.lowbit_all("hier_swap")
    register_hop_plan(HopPlan("hier_swap", (HopSpec("gbinary"),)))
    try:
        lay1 = fabric.layout_for(like, plan)
        assert lay1.buckets[0].key.hops == "hier_swap[gbinary:*]"
        register_hop_plan(HopPlan("hier_swap", (HopSpec("fp32", workers=2),
                                                HopSpec("gbinary"))),
                          override=True)
        lay2 = fabric.layout_for(like, plan)
        assert lay2.buckets[0].key.hops == "hier_swap[fp32:2>gbinary:*]"
    finally:
        unregister_hop_plan("hier_swap")


# ---------------------------------------------------------------------------
# control surface: presets, the admission ladder, the launcher
# ---------------------------------------------------------------------------

def test_hier_presets_registered():
    presets = plan_presets(error_feedback=True)
    jpresets = j_plan_presets(error_feedback=True)
    for name in ("hier_fp32_gbinary", "hier_fp32_gternary",
                 "hier_fp32_int4"):
        pol = presets[name].policy_for("backbone")
        assert codec_name(pol.mode) == name
        assert schedule_name(pol.resolved_schedule()) == "hierarchical"
        assert codec_name(presets[name].policy_for("head").mode) == "fp32"
        assert presets[name].signature() == jpresets[name].signature()
    assert presets["hier_fp32_gbinary"].policy_for("backbone").error_feedback
    assert not presets["hier_fp32_int4"].policy_for(
        "backbone").error_feedback


def test_commander_ladder_admits_hier_modes():
    cmd = Commander(binary_mode="hier_fp32_gbinary",
                    ternary_mode="hier_fp32_gternary",
                    tau_binary=0.5, tau_ternary=0.2)
    plan = cmd.propose({"backbone": {"gbinary": 0.9},
                        "embed": {"gbinary": 0.3, "gternary": 0.4},
                        "norms": {"gbinary": 0.9}})
    assert codec_name(plan.policy_for("backbone").mode) == \
        "hier_fp32_gbinary"
    assert codec_name(plan.policy_for("embed").mode) == "hier_fp32_gternary"
    assert codec_name(plan.policy_for("norms").mode) == "fp32"
    from repro.core import Commander as JCommander
    jplan = JCommander(binary_mode="hier_fp32_gbinary",
                       ternary_mode="hier_fp32_gternary", tau_binary=0.5,
                       tau_ternary=0.2).propose(
        {"backbone": {"gbinary": 0.9},
         "embed": {"gbinary": 0.3, "gternary": 0.4},
         "norms": {"gbinary": 0.9}})
    assert plan.signature() == jplan.signature()


def test_launcher_trains_a_hop_plan_on_two_data_axes():
    from repro.configs import get_config as j_get_config
    from repro.core import plan_traffic_ratio as j_ratio
    from repro.models import init_params as j_init_params
    from repro_torch.launch.train import main
    torch.manual_seed(0)
    history = main(["--arch", "qwen3_0p6b", "--smoke", "--device", "cpu",
                    "--mesh", "2,8,1", "--steps", "2", "--seq-len", "16",
                    "--plan", "hier_fp32_gbinary"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "hierarchical" in history[-1]["plan"]
    shapes = jax.eval_shape(lambda: j_init_params(
        jax.random.PRNGKey(0), j_get_config("qwen3_0p6b", smoke=True)))
    sizes = JFabric().group_sizes(shapes)
    assert history[-1]["traffic_ratio"] == j_ratio(
        sizes, j_plan_presets()["hier_fp32_gbinary"])
    with pytest.raises(ValueError, match="one data-parallel axis a hop"):
        main(["--arch", "qwen3_0p6b", "--smoke", "--device", "cpu",
              "--mesh", "4,1", "--steps", "1", "--seq-len", "16",
              "--plan", "hier_fp32_gbinary"])


def test_launcher_under_torchrun_runs_a_hop_plan_on_pod_and_data(tmp_path):
    """``torchrun --nproc-per-node 2 ... --mesh 1,2,1``: a
    ``ProcessMesh`` of (pod 1, data 2), so the built-in plan's hops
    (sizes (2, 1)) run over ``data`` and ``pod``; both ranks print the
    loss of the virtual (1 x 2) group."""
    import os
    import subprocess
    import sys
    from repro_torch.launch.train import main
    from test_torch_tp import SRC
    env = dict(os.environ)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    args = ["--arch", "qwen3_0p6b", "--smoke", "--device", "cpu", "--mesh",
            "1,2,1", "--steps", "2", "--plan", "hier_fp32_gbinary",
            "--global-batch", "4", "--seq-len", "16"]
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2", "-m",
                        "repro_torch.launch.train", *args],
                       env=env, capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    finals = [line for line in r.stdout.splitlines()
              if line.startswith("final:")]
    assert len(finals) == 2, r.stdout
    virtual = main(args)
    for line in finals:
        assert f"loss={virtual[-1]['loss']:.4f}" in line, line
        assert "workers=2 model=1" in line


# ---------------------------------------------------------------------------
# four gloo ranks on a (pod 2, data 2, model 1) mesh
# ---------------------------------------------------------------------------

RANK_PROGRAM = r'''
import json, os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
WORLD, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT = os.environ["OUT_DIR"]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=WORLD, timeout=timedelta(seconds=60))

from repro_torch.configs import get_config
from repro_torch.core import AdmissionPlan, ProcessMesh, VirtualGroup
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMStream
from repro_torch.fabric import Fabric, HopPlan, HopSpec, register_hop_plan
from repro_torch.optim import AdamW
from repro_torch.runtime import Trainer, TrainerConfig

PLANS = %(plans)r
for name, legs in PLANS.items():
    register_hop_plan(HopPlan(name, tuple(HopSpec(*h) for h in legs)))
SHAPES = %(shapes)r
rng = np.random.RandomState(0)
grads = T.map_leaves(lambda s: rng.randn(4, *s).astype(np.float32), SHAPES)
efs = T.map_leaves(lambda s: rng.randn(4, *s).astype(np.float32), SHAPES)
arrays, info = {}, {}

mesh = ProcessMesh((2, 2, 1), device="cpu")
info["data_index"] = mesh.data_index
info["axis_ranks"] = {n: list(dist.get_process_group_ranks(
    g.process_group)) for n, g in mesh.axis_groups.items()}
mine = T.map_leaves(lambda g: torch.from_numpy(g[R:R + 1].copy()), grads)
my_ef = T.map_leaves(lambda e: torch.from_numpy(e[R:R + 1].copy()), efs)


def cases():
    for name in PLANS:
        for fused in (True, False):
            for ef in ((False, True) if "int4" not in name else (False,)):
                yield name, fused, ef


for name, fused, ef in cases():
    tag = f"{name}/{int(fused)}/{int(ef)}"
    fab = Fabric(mesh=mesh, fused=fused)
    mesh.reset_counts()
    agg, new_ef = fab.aggregate(mine, AdmissionPlan.lowbit_all(
        name, error_feedback=ef), ef=my_ef if ef else None)
    info[tag] = {n: dict(g.calls_by_op) for n, g in
                 (("data", mesh.data_group), ("world", mesh.world),
                  *mesh.axis_groups.items())}
    for p, u in T.flatten(agg):
        arrays[f"{tag}/agg/{p}"] = u.numpy()
    if ef:
        for p, e in T.flatten(new_ef):
            arrays[f"{tag}/ef/{p}"] = e.numpy()

try:
    Fabric(mesh=ProcessMesh((4, 1), device="cpu")).aggregate(
        mine, AdmissionPlan.lowbit_all("h22_vote"))
    info["one_axis_error"] = None
except ValueError as e:
    info["one_axis_error"] = str(e)

cfg = get_config("qwen3_0p6b", smoke=True)


def train(fabric, device_mesh=None):
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    tr = Trainer(cfg, AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=4),
                 data, plan=AdmissionPlan.lowbit_all(
                     "h22_packed", error_feedback=True),
                 fabric=fabric, device="cpu",
                 tcfg=TrainerConfig(log_interval=1000))
    tr.run(2)
    return tr


tr = train(Fabric(mesh=mesh))
info["mesh/losses"] = [h["loss"] for h in tr.history]
for p, x in T.flatten(tr.state.model.tree()):
    arrays[f"mesh/params/{p}"] = x.detach().numpy().copy()
dist.barrier()
dist.destroy_process_group()

if R == 0:
    # the virtual (2 x 2) group on the same inputs, in this process (the
    # same thread settings)
    tg = T.map_leaves(torch.from_numpy, grads)
    te = T.map_leaves(torch.from_numpy, efs)
    for name, fused, ef in cases():
        tag = f"{name}/{int(fused)}/{int(ef)}"
        agg, new_ef = Fabric(group=VirtualGroup((2, 2)), fused=fused) \
            .aggregate(tg, AdmissionPlan.lowbit_all(name, error_feedback=ef),
                       ef=te if ef else None)
        for p, u in T.flatten(agg):
            arrays[f"virtual/{tag}/agg/{p}"] = u.numpy()
        if ef:
            for p, e in T.flatten(new_ef):
                arrays[f"virtual/{tag}/ef/{p}"] = e.numpy()
    tr = train(Fabric(group=VirtualGroup((2, 2))))
    info["virtual/losses"] = [h["loss"] for h in tr.history]
    for p, x in T.flatten(tr.state.model.tree()):
        arrays[f"virtual/params/{p}"] = x.detach().numpy().copy()

np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
'''

MESH_PLANS = {k: PLANS_2X2[k] for k in ("h22_vote", "h22_packed",
                                        "h22_ter_packed", "h22_int4")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("hier") / "out"
    return spawn_ranks(RANK_PROGRAM % {"plans": MESH_PLANS,
                                       "shapes": SHAPES}, 4, out)


def test_mesh_axis_groups_place_the_hops(world):
    for r, (_, info) in enumerate(world):
        assert info["data_index"] == r
        p, d = divmod(r, 2)
        assert info["axis_ranks"]["pod"] == [d, 2 + d]
        assert info["axis_ranks"]["data"] == [2 * p, 2 * p + 1]
        assert "one data-parallel axis a hop" in info["one_axis_error"]
        for tag, calls in info.items():
            if not tag.startswith("h22"):
                continue
            # hop 0 (the FP32 mean) on the data axis, hop 1 on the pod
            # axis; nothing on the whole data group or the world
            assert calls["data"] == {"all_reduce": calls["data"].get(
                "all_reduce", 0)} and calls["data"]["all_reduce"] > 0, tag
            assert calls["world"] == {}, tag
            if "packed" in tag:
                assert {"all_to_all", "all_gather"} <= set(calls["pod"]), tag
            else:
                assert set(calls["pod"]) == {"all_reduce"}, tag


@pytest.mark.parametrize("name", sorted(MESH_PLANS))
def test_mesh_aggregates_equal_the_virtual_group(world, name):
    """Byte-equal, zeros of either sign as zeros: a gloo sum of -0.0 and
    -0.0 stays -0.0 where a virtual sum starts from +0.0 (an int4 code of
    zero keeps its sign)."""
    virtual = world[0][0]
    for r, (arrays, _) in enumerate(world):
        for key, x in arrays.items():
            if not key.startswith(f"{name}/"):
                continue
            want = virtual[f"virtual/{key}"]
            if "/ef/" in key:
                want = want[r:r + 1]
            assert x.dtype == want.dtype and np.array_equal(x, want), \
                (r, key)
            nonzero = x != 0
            assert x[nonzero].tobytes() == want[nonzero].tobytes()


def test_mesh_trainer_equals_the_virtual_group(world):
    virtual = world[0]
    for arrays, info in world:
        np.testing.assert_allclose(info["mesh/losses"],
                                   virtual[1]["virtual/losses"], rtol=1e-6)
        for key, x in arrays.items():
            if key.startswith("mesh/params/"):
                assert x.tobytes() == \
                    virtual[0][key.replace("mesh/", "virtual/")].tobytes(), \
                    key


# ---------------------------------------------------------------------------
# a hop plan on a tensor-parallel leaf: eight gloo ranks as (2, 2, 2)
# ---------------------------------------------------------------------------

#: the leaf (its columns over "model") and the plans run on it
TP_LEAF, TP_SPEC = (24, 96), (None, "model")
TP_PLANS = {k: PLANS_2X2[k] for k in ("h22_packed", "h22_vote", "h22_ter",
                                      "h22_int4")}

TP_REFERENCE = r'''
import functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, os.environ["SRC"])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.core import LeafPolicy
from repro.fabric import HopPlan, HopSpec, register_hop_plan
from repro.fabric.registry import AggregationContext
from repro.fabric.session import aggregate_leaf

PLANS, LEAF = %(plans)r, %(leaf)r
for name, legs in PLANS.items():
    register_hop_plan(HopPlan(name, tuple(HopSpec(*h) for h in legs)))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
grads = np.random.RandomState(5).randn(4, *LEAF).astype(np.float32)
g = jax.device_put(jnp.asarray(grads),
                   NamedSharding(mesh, P(("pod", "data"), None, "model")))
out = {"grads": grads}
for name in PLANS:
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(("pod", "data")),
                       out_specs=P(), axis_names=frozenset({"pod", "data"}),
                       check_vma=False)
    def run(x):
        ctx = AggregationContext(dp_axes=("pod", "data"), num_workers=4)
        return aggregate_leaf(ctx, x[0], LeafPolicy(
            mode=name, schedule="hierarchical",
            model_spec=P(None, "model"), gate_phase=1))[0]
    out[name] = np.asarray(jax.jit(run)(g))
np.savez(os.environ["OUT_FILE"], **out)
'''

TP_RANKS = r'''
import json, os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
WORLD, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT = os.environ["OUT_DIR"]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=WORLD, timeout=timedelta(seconds=60))

from repro_torch.core import LeafPolicy, ProcessMesh
from repro_torch.fabric import (AggregationContext, HopPlan, HopSpec,
                                aggregate_leaf, register_hop_plan)
from repro_torch.runtime.shardings import shard_of

PLANS, LEAF, SPEC = %(plans)r, %(leaf)r, %(spec)r
for name, legs in PLANS.items():
    register_hop_plan(HopPlan(name, tuple(HopSpec(*h) for h in legs)))
grads = np.random.RandomState(5).randn(4, *LEAF).astype(np.float32)
mesh = ProcessMesh((2, 2, 2), device="cpu")
g = torch.from_numpy(shard_of(grads[mesh.data_index], SPEC, mesh.extents,
                              mesh.coords).copy())[None]
arrays, info = {}, {}
for name in PLANS:
    for tag, fused in (("", True), ("/staged", False)):
        if not fused and "packed" not in name:
            continue
        ctx = AggregationContext(group=mesh.data_group, num_workers=4,
                                 fused_kernels=fused, mesh=mesh)
        mesh.reset_counts()
        u, _ = aggregate_leaf(ctx, g, LeafPolicy(
            name, "hierarchical", model_spec=SPEC, gate_phase=1))
        arrays[name + tag] = u.numpy()
        info[name + tag] = {n: dict(grp.calls_by_op) for n, grp in
                            (("model", mesh.model_group),
                             *mesh.axis_groups.items())}
np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """The reference's aggregates (a subprocess, started first) and the
    eight ranks' blocks."""
    args = {"plans": TP_PLANS, "leaf": TP_LEAF, "spec": TP_SPEC}
    ref_file = tmp_path_factory.mktemp("hier_tp_ref") / "ref.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(SRC=SRC, OUT_FILE=str(ref_file), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", TP_REFERENCE % args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(TP_RANKS % args, 8,
                            tmp_path_factory.mktemp("hier_tp") / "out")
    finally:
        ref = _finish_reference(proc, ref_file)
    return ref, ranks


def _tp_leaf(ranks, key):
    """The whole leaf from the ranks' blocks; the data ranks' agree."""
    from repro_torch.runtime.shardings import block_slices
    out = np.full(TP_LEAF, np.nan, np.float32)
    extents = {"pod": 2, "data": 2, "model": 2}
    for r, (arrays, _) in enumerate(ranks):
        coords = {"pod": r // 4, "data": r // 2 % 2, "model": r % 2}
        sl = block_slices(TP_LEAF, TP_SPEC, extents, coords)
        seen = ~np.isnan(out[sl])
        assert np.array_equal(out[sl][seen], arrays[key][seen]), (key, r)
        out[sl] = arrays[key]
    return out


@pytest.mark.parametrize("case", ["h22_packed", "h22_packed/staged",
                                  "h22_vote", "h22_ter", "h22_int4"])
def test_hop_plan_on_a_tensor_parallel_leaf_equals_the_reference(tp_world,
                                                                 case):
    """Hop 0 (the FP32 mean) over ``data``, hop 1 over ``pod``, on the
    block: byte-equal to the reference (zeros of either sign as zeros:
    the jitted gate writes +0.0), an int4 mean of the 2 pods' encodes
    within ``same_mean``'s bound (XLA fuses the dequantize into the
    sum).  No hop runs a collective on the model group but int4's
    absmax."""
    ref, ranks = tp_world
    name = case.split("/")[0]
    got, want = _tp_leaf(ranks, case), ref[name]
    if name == "h22_int4":
        g = ref["grads"].reshape(2, 2, -1)
        means = torch.from_numpy((g[:, 0] + g[:, 1]) / np.float32(2))
        encs = get_codec("int4").encode(None, means).numpy()
        same_mean(torch.from_numpy(got), want, encs)
    else:
        np.testing.assert_array_equal(got, want)
    for _, info in ranks:
        model = info[case]["model"]
        assert model == ({"all_reduce": 1} if name == "h22_int4" else {}), \
            (case, model)
        assert info[case]["data"]["all_reduce"] == 1, case
