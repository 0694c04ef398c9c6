"""The port's third slice against the reference: the host-local vote, the
int4 and top-k codecs, and ``apply_sign_update``.

Inputs come from a numpy seed and go through both packages; the JAX side
runs jitted and, for the kernels, through the Pallas bodies in interpret
mode.  Everything is compared byte for byte.  (The int4 scale is
``max|x| * float32(1/7)`` on both sides: XLA folds the reference's
division by the constant 7.0 into that product, and the port computes
the product itself; ``x / s`` is a true division on both.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import init_ef_states as j_init_ef  # noqa: E402
from repro.core import plan_traffic_ratio as j_ratio  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import get_codec as j_get_codec  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.fabric.session import layout_kernel_stats as j_stats  # noqa: E402
from repro.kernels import apply_update as j_apply  # noqa: E402
from repro.kernels import fused as j_fused  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AdmissionPlan, LocalGroup,  # noqa: E402
                              plan_traffic_ratio)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import (Fabric, TrainState, get_codec,  # noqa: E402
                                layout_kernel_stats, plan_presets)
from repro_torch.kernels import fused, ops, ref  # noqa: E402
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.models import Transformer, params_from_jax  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

SHAPES = {"backbone": {"w1": (40, 33), "w2": (257,), "w3": (64, 8)},
          "head": {"w": (17,)},
          "norms": {"scale": (33,)}}
BACKBONE = {"backbone/w1", "backbone/w2", "backbone/w3"}


def bits(t) -> np.ndarray:
    """Float values of either package as their unsigned bit patterns."""
    a = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32) \
        .numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def same_bits(got: torch.Tensor, want) -> None:
    """Byte equality, NaNs by position (their bits differ by framework:
    see ROADMAP queue 3)."""
    g, w = got.to(torch.float32).numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(g), nan)
    np.testing.assert_array_equal(bits(torch.from_numpy(g))[~nan],
                                  w.view(np.uint32)[~nan])


def u32(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.numpy().view(np.uint32))


def rand_words(rng, *shape) -> torch.Tensor:
    w = rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32).copy())


def to_jax(t: torch.Tensor):
    """A torch tensor as a jax array of the same dtype and bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# the four twins, against the jitted reference and the Pallas bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 3, 4, 31, 128, 256])
@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_vote_pipeline_twin_matches_reference(w, ternary, dtype, out):
    """W sweep (counts in int32: the reference wrapped int8 twice at
    W >= 128); -0.0 and NaN count as non-positive.  The decode in ``out``
    is byte for byte the reference's float32 decode cast to ``out``, as
    its own ``dtype`` argument gives it (+0.0 stays +0.0)."""
    rng = np.random.RandomState(w)
    n = 4000                                     # ragged: pads to one tile
    vals = rng.randn(w, n).astype(np.float32)
    vals[:, :4] = [0.0, -0.0, np.nan, -np.inf]
    stack = ref.to_plane(torch.from_numpy(vals).to(getattr(torch, dtype)))
    gate = fused.local_gate_words(stack.shape[1] // 32, ternary=ternary,
                                  gate_phase=w % 3)
    got = ops.vote_pipeline(stack, gate, num_workers=w,
                            dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == stack.shape[1:]
    js, jg = to_jax(stack), u32(gate)
    want = jax.jit(j_ref.vote_pipeline_dense, static_argnums=1)(
        js, w, jg).astype(getattr(jnp, out))
    np.testing.assert_array_equal(bits(got), np.asarray(want).view(
        bits(got).dtype))
    if w < 128 or ternary:      # the interpreted body unrolls W: ~5 s each
        np.testing.assert_array_equal(bits(got), np.asarray(
            j_fused.vote_pipeline(js, jg, num_workers=w,
                                  dtype=getattr(jnp, out), interpret=True)
        ).view(bits(got).dtype))


@pytest.mark.parametrize("out", [torch.float16, torch.float64, torch.int32])
def test_vote_pipeline_rejects_other_dtypes(out):
    """The reference decodes to float32 or bfloat16; any other dtype
    raises instead of being cast."""
    stack = torch.zeros((1, 32, 128))
    gate = fused.local_gate_words(1, ternary=False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.vote_pipeline(stack, gate, num_workers=1, dtype=out)


def test_vote_pipeline_raises_when_the_stack_is_not_num_workers():
    """The reference's Pallas call takes W from the stack, its plain path
    from ``num_workers``; the port refuses the ambiguous call."""
    stack = torch.zeros((2, 32, 128))
    gate = fused.local_gate_words(1, ternary=False)
    with pytest.raises(ValueError, match="num_workers"):
        ops.vote_pipeline(stack, gate, num_workers=3)


def test_int4_twin_per_plane_matches_reference():
    """One scale per leading plane, at random scales: each plane byte for
    byte against the jitted reference, the Pallas body and the
    reference's arithmetic spelled out in numpy (absmax times
    float32(1/7), which differs from the IEEE quotient absmax / 7 in
    some of these planes)."""
    rng = np.random.RandomState(1)
    vals = np.stack([rng.randn(3 * 4096) * 10.0 ** e
                     for e in (-3, -1, 0, 1, 2, 5)]).astype(np.float32)
    planes = ref.to_plane(torch.from_numpy(vals))
    got = ops.int4_quant_plane(planes)
    jq = jax.jit(j_ref.int4_quant_plane)
    quotient_differs = 0
    for p in range(planes.shape[0]):
        x = vals[p]
        jp = jnp.asarray(planes[p].numpy())
        same_bits(got[p], jq(jp))
        same_bits(got[p], j_fused.int4_quant_plane(jp, interpret=True))
        s = np.float32(np.abs(x).max()) * np.float32(1.0 / 7.0)
        q = np.clip(np.round(x / s), -7, 7)
        np.testing.assert_array_equal(ref.from_plane(got[p], x.size).numpy(),
                                      (q * s).astype(np.float32))
        quotient_differs += s != np.float32(np.abs(x).max()) / np.float32(7)
    assert quotient_differs, "no plane where the product and quotient part"


def test_int4_twin_special_values_match_reference():
    """Exact scales (absmax 7 * 2**e): byte-equal, with .5 ties (half to
    even), +-0.0 kept through round and product, a zero plane (scale 1),
    a plane with NaN (its scale is NaN, so 1: NaN stays, the rest clips
    to +-7) and one with inf."""
    rng = np.random.RandomState(2)
    base = rng.randn(4096).astype(np.float32)
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 6.5, -6.5, 7.0, -0.0,
                     0.0, 1e-30, -1e-30], np.float32)
    planes = []
    for e in (-20, 0, 3):
        x = np.clip(base, -6.9, 6.9) * np.float32(2.0 ** e)
        x[:ties.size] = ties * np.float32(2.0 ** e)
        planes.append(x)
    planes.append(np.zeros(4096, np.float32))
    planes.append(np.where(np.arange(4096) == 7, np.nan, base * 30))
    planes.append(np.where(np.arange(4096) == 9, np.inf, base))
    vals = np.stack(planes).astype(np.float32)
    got = ops.int4_quant_plane(ref.to_plane(torch.from_numpy(vals)))
    jq = jax.jit(j_ref.int4_quant_plane)
    for p in range(vals.shape[0]):
        plane = jnp.asarray(ref.to_plane(torch.from_numpy(vals[p])).numpy())
        same_bits(got[p], jq(plane))
        same_bits(got[p], j_fused.int4_quant_plane(plane, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_threshold_twin_per_plane_matches_reference(dtype):
    """One threshold per plane, ties at t kept, NaN dropped, -0.0 kept
    where t is 0."""
    rng = np.random.RandomState(3)
    vals = rng.randn(3, 5000).astype(np.float32)
    vals[:, :6] = [0.75, -0.75, 0.75, np.nan, -0.0, 0.0]
    planes = ref.to_plane(torch.from_numpy(vals).to(getattr(torch, dtype)))
    thresh = torch.tensor([0.75, 1.5, 0.0]).to(planes.dtype)
    got = ops.threshold_mask_plane(planes, thresh)
    jt = jax.jit(j_ref.threshold_mask_plane)
    for p in range(3):
        jp, t = to_jax(planes[p]), to_jax(thresh[p])
        same_bits(got[p].to(torch.float32), jt(jp, t).astype(jnp.float32))
        same_bits(got[p].to(torch.float32), j_fused.threshold_mask_plane(
            jp, t, interpret=True).astype(jnp.float32))
        assert got[p].dtype == planes.dtype
    assert int((got[0] != 0).sum()) > 0 and torch.isnan(got).sum() == 0
    assert bits(got[2].reshape(-1)[4:5]) == bits(torch.tensor(
        [-0.0], dtype=planes.dtype))


#: parameters planted in rows 0-31, lanes 0-7 of the plane: +-0, +-inf,
#: NaN and subnormals (each exact in bf16 too), each meeting every bit b
#: of a word with random sign and mask bits
SPECIAL_PARAMS = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e-39,
                  -9.2e-41]


def _subnormal(x: np.ndarray) -> np.ndarray:
    return (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)


def _flush(x: np.ndarray) -> np.ndarray:
    """Subnormal float32 values as zeros of their sign."""
    return np.where(_subnormal(x), np.copysign(np.float32(0), x), x)


@pytest.mark.parametrize("scale", [1e-3, 0.37, 2.0 ** -20, 0.0, -0.0,
                                   np.inf, np.nan],
                         ids=["1e-3", "0.37", "2^-20 tensor", "0", "-0",
                              "inf", "nan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_sign_update_twin_matches_reference(dtype, scale):
    """f32 arithmetic, one rounding to the parameter's dtype, on random
    parameters and on the special ones of ``SPECIAL_PARAMS``, under
    ordinary and special scales (2^-20 as a one-element tensor).

    The plane equals the IEEE float32 arithmetic of the plain path done
    in numpy, everywhere.  It equals the reference's plain path wherever
    no subnormal takes part: XLA's CPU runtime treats subnormal operands
    and results as zeros of their sign, which the card and PyTorch do
    not, and the test checks that this is the only difference there.
    The planted block is held to the reference's plain path alone: its
    Pallas body decodes a dropped element as (2s - 1) * 0, which is -0.0
    where s = 0, and its plain path as +0.0, so the two part on a
    parameter of -0.0 there (ROADMAP queue 3); the port follows the
    plain path.  Outside the block the plane also equals the Pallas
    body, in interpret mode."""
    rng = np.random.RandomState(4)
    vals = rng.randn(3 * 32, 128).astype(np.float32)
    rows, lanes = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
    vals[:32, :8] = np.asarray(SPECIAL_PARAMS,
                               np.float32)[(rows + lanes) % 8]
    param = torch.from_numpy(vals).to(getattr(torch, dtype))
    sw, mw = rand_words(rng, 3, 128), rand_words(rng, 3, 128)
    arg = torch.tensor(scale) if scale == 2.0 ** -20 else scale
    got = ops.apply_sign_update(param, sw, mw, arg)
    assert got.dtype == param.dtype
    got = got.to(torch.float32)

    bit = np.arange(32, dtype=np.uint32)[None, :, None]
    s, m = ((w.numpy().view(np.uint32)[:, None, :] >> bit) & 1
            for w in (sw, mw))
    u = np.where(m, np.where(s, 1, -1), 0).astype(np.float32).reshape(-1, 128)
    p = param.to(torch.float32).numpy()
    with np.errstate(all="ignore"):
        step = np.float32(scale) * u
        ieee, flushed = p - step, _flush(_flush(p) - step)
    rounded = [torch.from_numpy(x).to(param.dtype).to(torch.float32)
               for x in (ieee, flushed)]
    same_bits(got, rounded[0])
    assert int(_subnormal(got.numpy()).sum()) > 0 or scale in (np.inf,
                                                                np.nan)

    js = jnp.float32(scale)
    want = np.asarray(jax.jit(j_ref.apply_sign_update)(
        to_jax(param), u32(sw), u32(mw), js).astype(jnp.float32))
    normal = ~(_subnormal(p) | _subnormal(ieee))
    same_bits(got[torch.from_numpy(normal)], want[normal])
    same_bits(rounded[1], want)
    pallas = np.asarray(j_apply.apply_sign_update(
        to_jax(param), u32(sw), u32(mw), js,
        interpret=True).astype(jnp.float32))
    rest = np.ones(vals.shape, bool)
    rest[:32, :8] = False
    same_bits(got[torch.from_numpy(rest)], pallas[rest])


@pytest.mark.parametrize("scale", [0.1, -1e-3, 1e-45, 1e39],
                         ids=["0.1", "-1e-3", "subnormal", "overflow"])
def test_apply_sign_update_float_and_tensor_scale_agree(scale):
    """A float scale is rounded to float32 as ``torch.tensor(scale,
    dtype=torch.float32)`` rounds it (to a subnormal, or past the largest
    float32 to inf), so a float and that one-element tensor, 0-d or of
    shape (1,), give the same bits, and the reference's."""
    rng = np.random.RandomState(5)
    param = ref.to_plane(torch.from_numpy(
        rng.randn(2 * 4096).astype(np.float32)).to(torch.bfloat16))
    sw, mw = rand_words(rng, 2, 128), rand_words(rng, 2, 128)
    got = ops.apply_sign_update(param, sw, mw, scale)
    for t in (torch.tensor(scale, dtype=torch.float32),
              torch.tensor([scale], dtype=torch.float32)):
        assert torch.equal(ops.apply_sign_update(param, sw, mw, t)
                           .view(torch.int16), got.view(torch.int16))
    want = jax.jit(j_ref.apply_sign_update)(
        to_jax(param), u32(sw), u32(mw),
        jnp.asarray(torch.tensor(scale, dtype=torch.float32).numpy()))
    same_bits(got.to(torch.float32), want.astype(jnp.float32))


# ---------------------------------------------------------------------------
# the host-local session
# ---------------------------------------------------------------------------

def _vote_plans(mode, error_feedback):
    return (JPlan.lowbit_backbone(mode, schedule="packed_a2a",
                                  error_feedback=error_feedback),
            AdmissionPlan.lowbit_backbone(mode, schedule="packed_a2a",
                                          error_feedback=error_feedback))


@pytest.mark.parametrize("mode", ["gbinary", "gternary"])
@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("fused_buckets", [True, False])
@pytest.mark.parametrize("fused_kernels", [True, False])
def test_host_local_matches_reference(mode, error_feedback, fused_buckets,
                                      fused_kernels):
    """``Fabric(group=LocalGroup())`` against the reference's ``Fabric()``
    under jit: votes byte for byte, FP32 leaves identical (no sum is
    taken), EF residuals to 1e-6 * beta (beta is an FP32 mean summed in
    another order)."""
    rng = np.random.RandomState(10 + 2 * error_feedback + fused_kernels)
    grads = T.map_leaves(lambda s: rng.randn(*s).astype(np.float32), SHAPES)
    jplan, plan = _vote_plans(mode, error_feedback)
    jfab = JFabric(fused_kernels=fused_kernels)
    jpol = jfab.resolve(T.map_leaves(jnp.asarray, grads), jplan)
    efs = T.map_leaves(lambda e: rng.randn(*e.shape).astype(np.float32)
                       if e.ndim else np.zeros((), np.float32),
                       j_init_ef(T.map_leaves(jnp.asarray, grads), jpol))
    want, want_ef = jax.jit(lambda g, e: jfab.aggregate(
        g, jplan, ef=e if error_feedback else None, fused=fused_buckets))(
        T.map_leaves(jnp.asarray, grads), T.map_leaves(jnp.asarray, efs))

    fab = Fabric(group=LocalGroup(), fused=fused_buckets,
                 fused_kernels=fused_kernels)
    assert fab.num_workers == 1 and fab.group.host_local
    t_efs = T.map_leaves(lambda e: torch.from_numpy(e)[None] if e.ndim
                         else torch.zeros(()), efs)
    got, got_ef = fab.aggregate(
        T.map_leaves(lambda g: torch.from_numpy(g)[None], grads), plan,
        ef=t_efs if error_feedback else None)
    wl = dict(T.flatten(want))
    for p, u in T.flatten(got):
        same_bits(u, wl[p])
    if not error_feedback:
        assert got_ef is None
        return
    wel = dict(T.flatten(want_ef))
    for p, e in T.flatten(got_ef):
        if p not in BACKBONE:
            assert e.dim() == 0
            continue
        x = (grads[p.split("/")[0]][p.split("/")[1]]
             + dict(T.flatten(efs))[p])
        beta = np.abs(x).mean()
        assert (np.abs(e[0].numpy() - np.asarray(wel[p])) <= 1e-6 * beta).all()
        assert not np.array_equal(e[0].numpy(), dict(T.flatten(efs))[p])


@pytest.mark.parametrize("mode", ["gbinary", "gternary"])
@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("fused_buckets", [True, False])
def test_host_local_bf16_grads_match_reference(mode, error_feedback,
                                               fused_buckets):
    """bf16 gradients through ``Fabric(group=LocalGroup())``, whose vote
    decodes straight into bf16, against the reference's ``Fabric()``,
    which decodes to float32 and casts: every leaf byte for byte, the
    FP32-mode leaves and the float32 EF residuals too."""
    rng = np.random.RandomState(30 + 2 * error_feedback + fused_buckets)
    grads = T.map_leaves(lambda s: rng.randn(*s).astype(np.float32), SHAPES)
    jplan, plan = _vote_plans(mode, error_feedback)
    jgrads = T.map_leaves(lambda g: jnp.asarray(g).astype(jnp.bfloat16),
                          grads)
    jfab = JFabric()
    efs = T.map_leaves(lambda e: rng.randn(*e.shape).astype(np.float32)
                       if e.ndim else np.zeros((), np.float32),
                       j_init_ef(jgrads, jfab.resolve(jgrads, jplan)))
    def j_aggregate(g, e):
        return jfab.aggregate(g, jplan, ef=e if error_feedback else None,
                              fused=fused_buckets)

    want, _ = jax.jit(j_aggregate)(jgrads, T.map_leaves(jnp.asarray, efs))

    fab = Fabric(group=LocalGroup(), fused=fused_buckets)
    t_efs = T.map_leaves(lambda e: torch.from_numpy(e)[None] if e.ndim
                         else torch.zeros(()), efs)
    got, got_ef = fab.aggregate(
        T.map_leaves(lambda g: torch.from_numpy(g)[None].to(torch.bfloat16),
                     grads), plan, ef=t_efs if error_feedback else None)
    wl = dict(T.flatten(want))
    for p, u in T.flatten(got):
        w = np.asarray(wl[p])
        assert str(u.dtype) == f"torch.{w.dtype}", p
        assert p not in BACKBONE or u.dtype == torch.bfloat16, p
        np.testing.assert_array_equal(bits(u), w.view(bits(u).dtype), p)
    if not error_feedback:
        assert got_ef is None
        return
    # the residual x - beta * sgn(x) is taken in the payload's dtype and
    # stored as float32, as the reference computes it run eagerly.  Under
    # jit, XLA keeps it in float32 on the bucketed path (it drops the bf16
    # rounding before the float32 cast), so the residuals are compared
    # with the eager reference
    _, want_ef = j_aggregate(jgrads, T.map_leaves(jnp.asarray, efs))
    wel = dict(T.flatten(want_ef))
    for p, e in T.flatten(got_ef):
        if p in BACKBONE:
            assert e.dtype == torch.float32
            w = np.asarray(wel[p]).reshape(e.shape)
            np.testing.assert_array_equal(bits(e), w.view(np.uint32), p)


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("fused_buckets", [True, False])
def test_host_local_equals_one_virtual_worker(error_feedback, fused_buckets):
    """The one-kernel host-local vote, the three-kernel chain of
    ``Fabric(num_workers=1)`` and the staged chain: one set of bits, EF
    residuals included."""
    rng = np.random.RandomState(20 + error_feedback)
    grads = T.map_leaves(
        lambda s: torch.from_numpy(rng.randn(1, *s).astype(np.float32)),
        SHAPES)
    plan = AdmissionPlan.lowbit_backbone("gternary", schedule="packed_a2a",
                                         error_feedback=error_feedback)
    like = T.map_leaves(lambda g: g[0], grads)
    fabs = [Fabric(group=LocalGroup(), fused=fused_buckets),
            Fabric(num_workers=1, fused=fused_buckets),
            Fabric(group=LocalGroup(), fused=fused_buckets,
                   fused_kernels=False)]
    ef = T.map_leaves(lambda e: e + 0.3 if e.dim() else e,
                      fabs[0].init_ef(like, fabs[0].resolve(like, plan)))
    outs = [f.aggregate(grads, plan, ef=ef if error_feedback else None)
            for f in fabs]
    first = T.flatten(outs[0][0]) + (T.flatten(outs[0][1])
                                      if error_feedback else [])
    for agg, new_ef in outs[1:]:
        other = T.flatten(agg) + (T.flatten(new_ef) if error_feedback else [])
        for (p, a), (_, b) in zip(first, other):
            assert torch.equal(a.view(torch.int32) if a.dim() else a,
                               b.view(torch.int32) if b.dim() else b), p


def test_fabric_rejects_a_group_of_another_size():
    with pytest.raises(ValueError, match="disagrees"):
        Fabric(4, group=LocalGroup())


# ---------------------------------------------------------------------------
# int4 and top-k under W = 4 virtual workers
# ---------------------------------------------------------------------------

def _mean_grads(rng, w):
    """Per-worker grads, each worker at its own random scale."""
    scales = 10.0 ** rng.uniform(-3, 3, size=(w,))
    return T.map_leaves(
        lambda s: (rng.randn(w, *s) * scales.reshape((w,) + (1,) * len(s))
                   ).astype(np.float32), SHAPES)


def _reference_encodes(mode, grads, w, fused_buckets):
    """Each worker's encoded values of every leaf, from the reference's
    codec under vmap: on the leaf, or on the bucket payload of the port's
    layout (its slots concatenated by offset) and cut back into leaves."""
    enc = jax.jit(jax.vmap(lambda x: j_get_codec(mode).encode(None, x)))
    flat = {p: g.reshape(w, -1) for p, g in T.flatten(grads)}
    if not fused_buckets:
        return {p: np.asarray(enc(jnp.asarray(x))) for p, x in flat.items()}
    like = T.map_leaves(lambda g: torch.from_numpy(g[0]), grads)
    layout = Fabric(num_workers=w).layout_for(
        like, AdmissionPlan.lowbit_backbone(mode))
    out = {}
    for b in layout.buckets:
        slots = sorted(b.slots, key=lambda sl: sl.offset)
        payload = np.concatenate([flat[sl.name] for sl in slots], axis=1)
        e = np.asarray(enc(jnp.asarray(payload)))
        out.update({sl.name: e[:, sl.offset:sl.offset + sl.size]
                    for sl in slots})
    return out


def same_mean(u: torch.Tensor, want, encs: np.ndarray) -> None:
    """Byte equality of a mean of W encoded values, except where they sum
    to other bits in another order: the reference's reduction over the
    worker axis adds pairwise on some shapes, the port's in sequence.
    There the two stay within (W - 1) * eps * sum|e| / W of each other."""
    got, want = u.numpy().reshape(-1), np.asarray(want).reshape(-1)
    w = encs.shape[0]
    bound = (w - 1) * np.finfo(np.float32).eps * \
        np.abs(encs).sum(axis=0).reshape(-1) / w
    differ = got.view(np.uint32) != want.view(np.uint32)
    assert (np.abs(got - want)[differ] <= bound[differ]).all()


def _run_means(mode, grads, w, fused_buckets, fused_kernels):
    jfab = JFabric(dp_axes=("w",), num_workers=w,
                   fused_kernels=fused_kernels)
    jplan = JPlan.lowbit_backbone(mode)
    want = jax.jit(jax.vmap(lambda g: jfab.aggregate(
        g, jplan, fused=fused_buckets)[0], axis_name="w"))(
        T.map_leaves(jnp.asarray, grads))
    got, ef = Fabric(num_workers=w, fused=fused_buckets,
                     fused_kernels=fused_kernels).aggregate(
        T.map_leaves(torch.from_numpy, grads),
        AdmissionPlan.lowbit_backbone(mode))
    assert ef is None
    return got, {p: np.asarray(x)[0] for p, x in T.flatten(want)}


@pytest.mark.parametrize("mode", ["int4", "topk"])
@pytest.mark.parametrize("fused_buckets", [True, False])
@pytest.mark.parametrize("fused_kernels", [True, False])
def test_mean_codecs_match_reference(mode, fused_buckets, fused_kernels):
    """Per-worker statistics at random per-worker scales, per leaf and
    bucketed (the reference states that the two paths differ for these
    codecs, so each is held against its own counterpart), with the
    switch on and off: each worker's encode byte for byte, the means as
    :func:`same_mean` states."""
    rng = np.random.RandomState(30 + 2 * fused_buckets + fused_kernels)
    w = 4
    grads = _mean_grads(rng, w)
    encs = _reference_encodes(mode, grads, w, fused_buckets)
    codec = get_codec(mode)
    for p, g in T.flatten(grads):
        if p in BACKBONE and not fused_buckets:
            same_bits(codec.encode(None, torch.from_numpy(g)), encs[p]
                      .reshape(g.shape))
    if fused_buckets:
        payload = np.concatenate([dict(T.flatten(grads))[p].reshape(w, -1)
                                  for p in sorted(BACKBONE)], axis=1)
        same_bits(codec.encode(None, torch.from_numpy(payload)),
                  np.concatenate([encs[p] for p in sorted(BACKBONE)], 1))
    got, want = _run_means(mode, grads, w, fused_buckets, fused_kernels)
    for p, u in T.flatten(got):
        assert u.dtype == torch.float32
        same_mean(u, want[p], encs[p] if p in BACKBONE
                  else dict(T.flatten(grads))[p])
    if mode == "topk" and not fused_buckets:
        # per leaf, each worker keeps max(1, int(n / 16)) entries (no
        # ties among these random values)
        for p, u in T.flatten(got):
            if p in BACKBONE:
                assert 0 < int((u != 0).sum()) <= \
                    w * max(1, int(u.numel() / 16))


def test_int4_codec_matches_reference_on_a_tie_grid():
    """Per-worker values on the int4 grid and at its .5 ties (absmax 7 *
    2**e, so the scale is exact): round half to even, +-0.0 kept, on
    both paths."""
    rng = np.random.RandomState(40)
    w = 4
    codes = np.arange(-14, 15) / 2.0
    grads = T.map_leaves(
        lambda s: (rng.choice(codes, size=(w,) + s)
                   * 2.0 ** rng.randint(-20, 20, size=(w,) + (1,) * len(s))
                   ).astype(np.float32), SHAPES)
    for fused_buckets in (True, False):
        got, want = _run_means("int4", grads, w, fused_buckets, True)
        for p, u in T.flatten(got):
            same_bits(u, want[p])


def test_fused_kernel_switch_is_bit_identical_for_means():
    """``fused_kernels=False`` leaves the mean codecs on their kernel
    sets (they have no staged chain): the same bits, and on the CPU the
    same twins."""
    rng = np.random.RandomState(41)
    grads = T.map_leaves(torch.from_numpy, _mean_grads(rng, 3))
    for mode in ("int4", "topk"):
        plan = AdmissionPlan.lowbit_backbone(mode)
        for fused_buckets in (True, False):
            a, _ = Fabric(3, fused=fused_buckets).aggregate(grads, plan)
            b, _ = Fabric(3, fused=fused_buckets,
                          fused_kernels=False).aggregate(grads, plan)
            for (p, x), (_, y) in zip(T.flatten(a), T.flatten(b)):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# ---------------------------------------------------------------------------
# accounting, codecs and presets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["int4_backbone", "topk_backbone"])
def test_full_qwen3_layout_stats_and_traffic_match_reference(preset):
    cfg = j_get_config("qwen3_0p6b")
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg))
    jfab = JFabric(dp_axes=("w",), num_workers=4)
    fab = Fabric(num_workers=4)
    want = jfab.layout_for(shapes, j_plan_presets()[preset])
    got = fab.layout_for(shapes, plan_presets()[preset])
    assert len(got.buckets) == len(want.buckets) == 9
    assert [(b.size, b.key.schedule) for b in got.buckets] == \
        [(b.size, b.key.schedule) for b in want.buckets]
    lowbit = [b for b in got.buckets if b.key.mode != "fp32"]
    assert len(lowbit) == 7 and all(b.key.schedule == "psum" for b in lowbit)
    for w in (1, 4):
        stats = layout_kernel_stats(got, w)
        assert stats == j_stats(want, w)
    assert layout_kernel_stats(got, 4)["launches_fused"] == \
        7 * (1 if preset == "int4_backbone" else 2)
    sizes = fab.group_sizes(shapes)
    assert plan_traffic_ratio(sizes, plan_presets()[preset]) == \
        j_ratio(sizes, j_plan_presets()[preset])


@pytest.mark.parametrize("mode", ["int4", "topk"])
def test_kernel_set_accounting_matches_reference(mode):
    ks, jks = get_codec(mode).kernel_set(), j_get_codec(mode).pallas_kernels()
    assert ks.means and not ks.votes and ks.signature() == jks.signature()
    assert get_codec(mode).bits_per_element == \
        j_get_codec(mode).bits_per_element
    assert get_codec(mode).kv_cache == j_get_codec(mode).kv_cache
    for fused_ in (True, False):
        for dist in (True, False):
            assert ks.launches(fused=fused_, distributed=dist) == \
                jks.launches(fused=fused_, distributed=dist)
            assert ks.hbm_bytes(12345, num_workers=4, fused=fused_,
                                distributed=dist) == \
                jks.hbm_bytes(12345, num_workers=4, fused=fused_,
                              distributed=dist)


def test_int4_kv_encode_matches_reference():
    rng = np.random.RandomState(5)
    blocks = [rng.randn(2, 4, 8).astype(np.float32),
              np.zeros((3, 5), np.float32),
              (rng.randn(6, 7) * 100).astype(np.float16)]
    for b in blocks:
        got = get_codec("int4").kv_encode(torch.from_numpy(b))
        want = j_get_codec("int4").kv_encode(b)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(get_codec("int4").kv_encode(got), got)
    assert get_codec("int4").kv_cache
    assert not get_codec("topk").kv_cache and not get_codec("gbinary").kv_cache


# ---------------------------------------------------------------------------
# training steps and the launcher
# ---------------------------------------------------------------------------

W = 4
# the optimizer of tests/test_torch_train.py, for the same reason: with
# eps = 1e-2 a float32 difference in a near-zero gradient stays below the
# parameter tolerance
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2)


@pytest.mark.parametrize("preset", ["int4_backbone", "topk_backbone"])
def test_train_steps_match_reference(preset):
    """Two smoke-config steps under each preset, port vs reference, to
    the tolerances of tests/test_torch_train.py (rtol 1e-5, atol 1e-7),
    every aggregate and every parameter: no int4 code or top-k choice
    parts between the two on these steps."""
    jcfg = j_get_config("qwen3_0p6b", smoke=True)
    cfg = get_config("qwen3_0p6b", smoke=True)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jparams["embed"]["tok"] = jparams["embed"]["tok"] * 50.0
    host = jax.tree.map(np.asarray, jparams)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    jplan, plan = j_plan_presets()[preset], plan_presets()[preset]
    jfab = JFabric(dp_axes=("w",), num_workers=W)
    jopt = JAdamW(**OPT)

    @jax.jit
    def jstep(params, state, shards):
        def one(b):
            lval, g = jax.value_and_grad(
                lambda p: j_loss_fn(p, jcfg, b))(params)
            return jax.lax.pmean(lval, "w"), jfab.aggregate(g, jplan)[0]
        lval, agg = jax.vmap(one, axis_name="w")(shards)
        agg0 = jax.tree.map(lambda x: x[0], agg)
        new_p, new_s = jopt.apply(params, agg0, state)
        return new_p, new_s, lval[0], agg0

    model = Transformer(cfg, params=params_from_jax(host, device="cpu"),
                        device="cpu")
    fabric = Fabric(num_workers=W)
    opt = AdamW(**OPT)
    params = model.tree()
    state = TrainState(model=model, opt=opt.init(params),
                       ef=fabric.init_ef(params,
                                         fabric.resolve(params, plan)))
    step = fabric.build_step(opt, plan, params, model.loss)
    lowbit = [b for b in step.layout.buckets if b.key.mode != "fp32"]
    names = {s.name for b in lowbit for s in b.slots}
    assert names and "embed/tok" not in names
    jstate = jopt.init(jparams)
    for k in range(2):
        batch = data.batch_at(k)
        shards = {n: jnp.asarray(v.reshape(W, -1, *v.shape[1:]))
                  for n, v in batch.items()}
        jparams, jstate, jl, jagg = jstep(jparams, jstate, shards)
        state, metrics, agg = step(state, {n: torch.from_numpy(v)
                                           for n, v in batch.items()})
        np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                                   rtol=1e-5)
        jagg = dict(T.flatten(jax.tree.map(np.asarray, jagg)))
        for p, u in T.flatten(agg):
            np.testing.assert_allclose(u.numpy(), jagg[p], rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {k}: {p}")
        for p, t in T.flatten(state.model.tree()):
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(dict(T.flatten(jparams))[p]),
                rtol=1e-5, atol=1e-7, err_msg=f"step {k}: {p}")


@pytest.mark.parametrize("preset", ["int4_backbone", "topk_backbone"])
def test_launcher_runs_the_codec_presets_on_cpu(preset, capsys):
    history = launch_main(["--arch", "qwen3_0p6b", "--smoke", "--device",
                           "cpu", "--mesh", "4,1", "--steps", "1",
                           "--plan", preset])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    assert history[0]["plan"] == plan_presets()[preset].signature()
    assert "workers=4" in capsys.readouterr().out
