"""The port's kernel twins against the reference kernels, byte for byte.

Inputs come from a numpy seed and go through both packages.  The JAX side
runs jitted (``repro.kernels.ref``; DESIGN §12: XLA on the CPU rounds
differently in eager mode) and through the Pallas kernels in interpret
mode; the port's side runs the plain twins, as its wrappers do for CPU
tensors.  Words are compared as ``np.uint32`` views.  The CUDA kernels
themselves are held against the twins on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import apply_update as j_apply  # noqa: E402
from repro.kernels import fused as j_fused  # noqa: E402
from repro.kernels import popcount_majority as j_pm  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels import sign_pack as j_sign  # noqa: E402
from repro_torch.core.collectives import VirtualGroup  # noqa: E402
from repro_torch.kernels import fused, ops, ref  # noqa: E402

RAGGED = (1, 127, 4095, 4097, 3 * 4096 + 77)
WORKERS = (1, 3, 31, 128, 256)


def u32(t) -> np.ndarray:
    """Words of either package as a uint32 array."""
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t).view(np.uint32)


def both(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def rand_words(rng, *shape) -> np.ndarray:
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def words_t(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(w.view(np.int32).copy())


def bits(t) -> np.ndarray:
    """Float values of either package as their unsigned bit patterns."""
    a = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32) \
        .numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def spread(rng, n: int) -> np.ndarray:
    """Values whose exponents span 2**-24 .. 2**24, so that pairs of them
    differ in exponent by far more than bfloat16's 8-bit mantissa."""
    return (rng.randn(n) * 2.0 ** rng.randint(-24, 25, size=n)) \
        .astype(np.float32)


def gate_pair(rows: int, ternary: bool, phase: int = 0):
    if ternary:
        return (j_ref.ternary_gate_words(rows * 32, phase),
                ref.ternary_gate_words(rows * 32, phase))
    return (jnp.full((rows, 128), 0xFFFFFFFF, jnp.uint32),
            torch.full((rows, 128), -1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# layout helpers and sign_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sign_pack_matches_reference_and_pallas(n, dtype):
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    x[:4] = [0.0, -0.0, np.nan, 1e-30][:n]
    jx, tx = both(x, dtype)
    jplane = jax.jit(j_ref.to_plane)(jx)
    tplane = ref.to_plane(tx)
    assert tplane.shape == jplane.shape == (j_ref.padded_len(n) // 128, 128)
    want = u32(jax.jit(j_ref.sign_pack)(jplane))
    got = u32(ops.pack_signs(tplane))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, u32(j_sign.sign_pack(jplane, interpret=True)))
    np.testing.assert_array_equal(
        ref.from_plane(tplane, n).to(torch.float32).numpy(),
        np.asarray(j_ref.from_plane(jplane, n).astype(jnp.float32)))


def test_sign_pack_packs_stacked_planes_independently():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 64, 128).astype(np.float32)
    got = u32(ops.pack_signs(torch.from_numpy(x)))
    for w in range(3):
        np.testing.assert_array_equal(
            got[w], u32(jax.jit(j_ref.sign_pack)(jnp.asarray(x[w]))))


def test_unpack_bits_popcount_majority_match_reference():
    rng = np.random.RandomState(1)
    w, r = 5, 3
    words = rand_words(rng, w, r, 128)
    np.testing.assert_array_equal(
        ref.unpack_bits(words_t(words[0])).numpy(),
        np.asarray(j_ref.unpack_bits(jnp.asarray(words[0]))))
    counts = ref.popcount_stack(words_t(words))
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(j_ref.popcount_stack(jnp.asarray(words))))
    for ternary in (False, True):
        jg, tg = gate_pair(r, ternary, phase=1)
        want = jax.jit(j_ref.majority_decode, static_argnums=1)(
            jnp.asarray(counts.numpy()), w, jg)
        got = ref.majority_decode(counts, w, tg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(u32(a), u32(b))


@pytest.mark.parametrize("phase", [0, 1, 2])
def test_gate_words_match_reference(phase):
    rng = np.random.RandomState(phase)
    np.testing.assert_array_equal(
        u32(ref.ternary_gate_words(64, phase)),
        u32(j_ref.ternary_gate_words(64, phase)))
    keep = rng.rand(5000) > 0.4
    for mask in (keep, torch.from_numpy(keep)):   # host array or tensor
        np.testing.assert_array_equal(
            u32(ref.gate_words_from_mask(mask, pad_words=4)),
            u32(j_ref.gate_words_from_mask(keep, pad_words=4)))
    for ternary, mask in ((False, None), (True, None), (True, keep)):
        np.testing.assert_array_equal(
            u32(fused.local_gate_words(2, ternary=ternary, gate_phase=phase,
                                       gate_mask=mask)),
            u32(j_fused.local_gate_words(2, ternary=ternary,
                                         gate_phase=phase, gate_mask=mask)))


@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_shard_gate_words_match_reference(w, masked):
    rng = np.random.RandomState(w)
    rw, phase = 2, 1
    mask = rng.rand(rw * w * 4096 - 999) > 0.3 if masked else None
    want = jax.vmap(
        lambda _: j_fused.shard_gate_words("w", rw, ternary=True,
                                           gate_phase=phase, gate_mask=mask,
                                           total_rows=rw * w),
        axis_name="w")(jnp.arange(w))
    got = fused.shard_gate_words(range(w), rw, ternary=True,
                                 gate_phase=phase, gate_mask=mask,
                                 total_rows=rw * w)
    np.testing.assert_array_equal(u32(got), u32(want))


# ---------------------------------------------------------------------------
# vote_combine and unpack_ternary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WORKERS)
@pytest.mark.parametrize("ternary", [False, True])
def test_vote_combine_matches_reference_and_pallas(w, ternary):
    rng = np.random.RandomState(w)
    r = 2
    routed = rand_words(rng, w, r, 128)
    if w > 1:
        # ties and unanimous columns, where a narrow counter would wrap
        routed[: w // 2, 0] = 0xFFFFFFFF
        routed[w // 2:, 0] = 0
        routed[:, 1, :4] = 0xFFFFFFFF
    jg, tg = gate_pair(r, ternary, phase=w % 3)
    want = jax.jit(j_ref.vote_combine, static_argnums=1)(
        jnp.asarray(routed), w, jg)
    got = ops.vote_combine(words_t(routed), tg, num_workers=w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))
    if w <= 31:
        # the interpreted kernel unrolls its W loop: slow past a few dozen,
        # and the reference's own tests hold it to the jnp oracle there
        pallas = j_fused.vote_combine(jnp.asarray(routed), jg, num_workers=w,
                                      interpret=True)
        for a, c in zip(got, pallas):
            np.testing.assert_array_equal(u32(a), u32(c))


def test_vote_combine_takes_the_all_to_all_view():
    """Owner shards as a transposed (owner, worker) view: each owner's
    pair equals the reference combine of its routed segment."""
    rng = np.random.RandomState(7)
    w, rw = 4, 3
    words = rand_words(rng, w, w * rw, 128)
    view = VirtualGroup(w).all_to_all(words_t(words).reshape(w, w, rw, 128))
    gate = torch.full((w, rw, 128), -1, dtype=torch.int32)
    sw, mw = ops.vote_combine(view, gate, num_workers=w)
    for k in range(w):
        seg = jnp.asarray(words[:, k * rw:(k + 1) * rw])
        want = j_ref.vote_combine(seg, w, jnp.full((rw, 128), 0xFFFFFFFF,
                                                   jnp.uint32))
        np.testing.assert_array_equal(u32(sw[k]), u32(want[0]))
        np.testing.assert_array_equal(u32(mw[k]), u32(want[1]))


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_unpack_ternary_matches_reference_and_pallas(rows):
    rng = np.random.RandomState(rows)
    s, m = rand_words(rng, rows, 128), rand_words(rng, rows, 128)
    got = ops.unpack_ternary(words_t(s), words_t(m))
    assert got.dtype == torch.float32
    want = jax.jit(j_ref.unpack_ternary)(jnp.asarray(s), jnp.asarray(m))
    pallas = j_apply.unpack_ternary(jnp.asarray(s), jnp.asarray(m),
                                    interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), u32(want))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), u32(pallas))


@pytest.mark.parametrize("rows", [1, 5, 129])
def test_unpack_ternary_bf16_matches_reference_and_pallas(rows):
    """Decoding straight into bfloat16 (the main path's payload dtype):
    the wrapper (CPU -> twin) and the twin, against the reference's
    ``dtype=jnp.bfloat16`` decode, jitted and in Pallas interpret mode."""
    rng = np.random.RandomState(100 + rows)
    s, m = rand_words(rng, rows, 128), rand_words(rng, rows, 128)
    got = ops.unpack_ternary(words_t(s), words_t(m), dtype=torch.bfloat16)
    twin = ref.unpack_ternary(words_t(s), words_t(m), torch.bfloat16)
    assert got.dtype == twin.dtype == torch.bfloat16
    want = jax.jit(j_ref.unpack_ternary, static_argnums=2)(
        jnp.asarray(s), jnp.asarray(m), jnp.bfloat16)
    pallas = j_apply.unpack_ternary(jnp.asarray(s), jnp.asarray(m),
                                    dtype=jnp.bfloat16, interpret=True)
    for other in (twin, want, pallas):
        np.testing.assert_array_equal(bits(got), bits(other))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_unpack_ternary_rejects_other_dtypes(dtype):
    words = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.unpack_ternary(words, words, dtype=dtype)


@pytest.mark.parametrize("w", WORKERS + (4,))
@pytest.mark.parametrize("ternary", [False, True])
def test_popcount_majority_match_reference_and_pallas(w, ternary):
    """The staged chain's two wrappers (CPU -> twins) against the Pallas
    kernels in interpret mode, owner by owner of the all_to_all view."""
    rng = np.random.RandomState(w)
    rw = 1 if w > 31 else 2     # the twins unpack to int64: keep rows few
    words = rand_words(rng, w, w * rw, 128)
    if w > 1:
        words[: w // 2, 0] = 0xFFFFFFFF     # a tie (or W odd: a majority)
        words[w // 2:, 0] = 0
    view = VirtualGroup(w).all_to_all(words_t(words).reshape(w, w, rw, 128))
    counts = ops.popcount_stack(view)
    assert counts.shape == (w, rw * 32, 128) and counts.dtype == torch.int32
    jg, _ = gate_pair(rw, ternary, phase=w % 3)
    gate = np.tile(np.asarray(jg), (w, 1))              # one per owner
    sw, mw = ops.majority_decode(counts, words_t(gate).reshape(w, rw, 128),
                                 num_workers=w)
    # rows are independent, so the jitted reference over the whole
    # (W, W*rw, LANE) stack gives every owner's shard in order
    want = jax.jit(j_ref.popcount_stack)(jnp.asarray(words))
    np.testing.assert_array_equal(counts.reshape(-1, 128).numpy(),
                                  np.asarray(want))
    pair = jax.jit(j_ref.majority_decode, static_argnums=1)(
        want, w, jnp.asarray(gate))
    np.testing.assert_array_equal(u32(sw.reshape(-1, 128)), u32(pair[0]))
    np.testing.assert_array_equal(u32(mw.reshape(-1, 128)), u32(pair[1]))
    # and the Pallas kernels, owner by owner (first, middle, last: the
    # interpreted kernel unrolls its W loop, slow to run for every owner)
    for k in sorted({0, w // 2, w - 1}):
        seg = jnp.asarray(words[:, k * rw:(k + 1) * rw])
        c = j_pm.popcount_stack(seg, interpret=True)
        np.testing.assert_array_equal(counts[k].numpy(), np.asarray(c))
        sk, mk = j_pm.majority_decode(c, jg, num_workers=w, interpret=True)
        np.testing.assert_array_equal(u32(sw[k]), u32(sk))
        np.testing.assert_array_equal(u32(mw[k]), u32(mk))


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_pack_ef_matches_reference_and_pallas(n, dtype):
    """g in its dtype and float32 residuals: the port rounds e to g's
    dtype inside the encode, the reference before it; words and g_eff
    byte for byte, except that NaNs in g_eff are compared by position:
    each framework writes its own NaN bits when it rounds a NaN to
    bfloat16 (torch's CPU path 0xFFFF, XLA's 0x7FC0)."""
    rng = np.random.RandomState(n)
    g, e = spread(rng, n), spread(rng, n)
    g[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0][:n]
    e[:6] = [-0.0, -0.0, 1.0, 1.0, 2.0, 2.0 ** -20][:n]
    jg, tg = both(g, dtype)
    je, _ = both(e, dtype)
    jgp, jep = jax.jit(j_ref.to_plane)(jg), jax.jit(j_ref.to_plane)(je)
    words, g_eff = ops.encode_pack_ef(ref.to_plane(tg),
                                      ref.to_plane(torch.from_numpy(e)))
    assert g_eff.dtype == tg.dtype
    for want in (jax.jit(j_ref.encode_pack_ef)(jgp, jep),
                 j_fused.encode_pack_ef(jgp, jep, interpret=True)):
        np.testing.assert_array_equal(u32(words), u32(want[0]))
        nan = np.isnan(np.asarray(want[1].astype(jnp.float32)))
        np.testing.assert_array_equal(
            torch.isnan(g_eff.to(torch.float32)).numpy(), nan)
        np.testing.assert_array_equal(bits(g_eff)[~nan], bits(want[1])[~nan])


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("dtype,out", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32")])
def test_ef_residual_matches_reference_and_pallas(n, dtype, out):
    """x - beta * sgn(x) given the same beta, byte for byte, except at
    -0.0 and NaN, which are compared by value and by position: there the
    frameworks' sign functions differ (torch.sign gives +0 for -0.0 and
    for NaN, jnp.sign gives -0.0 and NaN), so -0.0 comes out as -0.0 in
    the port and +0.0 in the reference, and NaN stays NaN in both."""
    rng = np.random.RandomState(n)
    x = spread(rng, 2 * n).reshape(2, n)
    x[0, :6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30][:n]
    beta = np.abs(np.nan_to_num(x, nan=0, posinf=0, neginf=0)).mean(axis=1)
    jx, tx = both(x, dtype)
    tplane = ref.to_plane(tx)
    got = ops.ef_residual_plane(tplane, torch.from_numpy(beta),
                                out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and got.shape == tplane.shape
    for k in range(2):
        jplane = jax.jit(j_ref.to_plane)(jx[k])
        for want in (jax.jit(j_ref.ef_residual)(jplane, beta[k]),
                     j_fused.ef_residual_plane(jplane, beta[k],
                                               interpret=True)):
            want = np.asarray(want.astype(out))
            mine = got[k].numpy() if out == "float32" else \
                got[k].to(torch.float32).numpy()
            odd = np.isnan(want) | (want == 0)
            np.testing.assert_array_equal(bits(got[k])[~odd],
                                          bits(want)[~odd])
            np.testing.assert_array_equal(mine[odd],
                                          want[odd].astype(np.float32))


@pytest.mark.parametrize("w", [1, 3, 4, 31])
def test_dense_oracles_match_reference(w):
    rng = np.random.RandomState(w)
    g = rng.randn(w, 1000).astype(np.float32)
    g[:, :5] = 0.0
    np.testing.assert_array_equal(
        ref.gbinary_aggregate_dense(torch.from_numpy(g)).numpy(),
        np.asarray(jax.jit(j_ref.gbinary_aggregate_dense)(jnp.asarray(g))))
    np.testing.assert_array_equal(
        ref.gternary_aggregate_dense(torch.from_numpy(g), phase=2).numpy(),
        np.asarray(jax.jit(j_ref.gternary_aggregate_dense,
                           static_argnums=1)(jnp.asarray(g), 2)))


# ---------------------------------------------------------------------------
# the bucket entry point and the KernelSet accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [3, 4])
@pytest.mark.parametrize("ternary", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ef", [False, True])
def test_fused_packed_vote_matches_reference(w, ternary, dtype, ef):
    """u byte for byte; under EF the new float32 residuals to 1e-6 * beta,
    since beta = mean|g_eff| is summed in another order in each package."""
    rng = np.random.RandomState(w)
    n = 3 * 4096 + 5
    g = rng.randn(w, n).astype(np.float32)
    e = rng.randn(w, n).astype(np.float32) if ef else None
    jg, tg = both(g, dtype)

    def one(x, r):
        return j_fused.fused_packed_vote(x, ("w",), w, ternary=ternary,
                                         gate_phase=1, ef=r, interpret=True)
    if ef:
        want, want_ef = jax.jit(jax.vmap(one, axis_name="w"))(
            jg, jnp.asarray(e))
    else:
        want = jax.jit(jax.vmap(lambda x: one(x, None)[0],
                                axis_name="w"))(jg)
    got, got_ef = fused.fused_packed_vote(
        tg, VirtualGroup(w), w, ternary=ternary, gate_phase=1,
        ef=torch.from_numpy(e) if ef else None)
    assert got.dtype == tg.dtype and got.shape == (n,)
    for k in range(w):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want[k], np.float32))
    if not ef:
        assert got_ef is None
        dense = (ref.gternary_aggregate_dense if ternary
                 else ref.gbinary_aggregate_dense)
        oracle = dense(tg, 1) if ternary else dense(tg)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      oracle.numpy())
        return
    assert got_ef.dtype == torch.float32 and got_ef.shape == (w, n)
    g_eff = tg + torch.from_numpy(e).to(tg.dtype)
    beta = g_eff.abs().to(torch.float64).mean(dim=1, keepdim=True).numpy()
    err = np.abs(got_ef.numpy() - np.asarray(want_ef))
    assert (err <= 1e-6 * beta).all()
    assert not np.array_equal(got_ef.numpy(), e)
    # the dense oracle on the votes' input, g + e in g's dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  (ref.gternary_aggregate_dense(g_eff, 1)
                                   if ternary else
                                   ref.gbinary_aggregate_dense(g_eff))
                                  .numpy())


def test_ef_update_fused_equals_plain_update():
    """The kernel path's residual update against the plain one that the
    bucketed and staged paths run: the same bits, f32 and bf16 g_eff."""
    from repro_torch.core.lowbit import _ef_update
    rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.bfloat16):
        g_eff = torch.from_numpy(spread(rng, 3 * 70 * 61)
                                 .reshape(3, 70, 61)).to(dtype)
        ef = torch.zeros((3, 70, 61))
        assert torch.equal(fused.ef_update_fused(g_eff, ef),
                           _ef_update(g_eff, ef))


@pytest.mark.parametrize("fused_path", [True, False])
@pytest.mark.parametrize("distributed", [True, False])
@pytest.mark.parametrize("ef", [True, False])
def test_vote_kernel_set_accounting_matches_reference(fused_path,
                                                      distributed, ef):
    mine, theirs = fused.vote_kernel_set(), j_fused.vote_kernel_set()
    assert mine.signature() == theirs.signature()
    kw = dict(fused=fused_path, distributed=distributed, ef=ef)
    assert mine.launches(**kw) == theirs.launches(**kw)
    for n, w in ((88_080_384, 4), (1000, 3), (4096, 256)):
        assert mine.hbm_bytes(n, num_workers=w, **kw) == \
            theirs.hbm_bytes(n, num_workers=w, **kw)


def test_wrappers_reject_other_devices_and_mixed_operands():
    """CPU operands run the twins, CUDA ones the kernels and ``meta`` ones
    the dry-run's route (tests/test_torch_launch.py); operands on any
    other device, or on several, raise."""
    import types

    def elsewhere(t):       # a stand-in for a tensor on another device
        return types.SimpleNamespace(device=torch.device("xpu"),
                                     dtype=t.dtype, shape=t.shape)

    words = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        ops.unpack_ternary(elsewhere(words), elsewhere(words))
    with pytest.raises(ValueError, match="workers"):
        ops.vote_combine(torch.zeros((3, 1, 128), dtype=torch.int32), words,
                         num_workers=4)
    plane = torch.zeros((32, 128))
    with pytest.raises(ValueError, match="no kernel"):
        ops.popcount_stack(elsewhere(words.reshape(1, 1, 128)))
    with pytest.raises(ValueError, match="no kernel"):
        ops.majority_decode(elsewhere(plane.to(torch.int32)),
                            elsewhere(words), num_workers=2)
    with pytest.raises(ValueError, match="several devices"):
        ops.encode_pack_ef(plane, plane.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        ops.ef_residual_plane(elsewhere(plane), elsewhere(torch.ones(1)))
    with pytest.raises(ValueError, match="several devices"):
        ops.ef_residual_plane(plane.to("meta"), torch.ones(1))
    # the meta route launches nothing and returns the kernel's shapes
    before = ops.unpack_ternary.launches
    out = ops.unpack_ternary(words.to("meta"), words.to("meta"))
    assert out.device.type == "meta" and out.shape == (32, 128)
    assert ops.unpack_ternary.launches == before


def test_kernel_wrappers_list_every_ported_kernel():
    wrappers = ops.kernel_wrappers()
    assert sorted(wrappers) == sorted([
        "sign_pack", "vote_combine", "unpack_ternary", "encode_pack_ef",
        "ef_residual", "popcount_stack", "majority_decode", "vote_pipeline",
        "apply_sign_update", "int4_quant", "threshold_mask"])
    assert all(isinstance(fn.launches, int) for fn in wrappers.values())
