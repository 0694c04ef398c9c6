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
    np.testing.assert_array_equal(
        u32(ref.gate_words_from_mask(keep, pad_words=4)),
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
def test_fused_packed_vote_matches_reference(w, ternary, dtype):
    rng = np.random.RandomState(w)
    n = 3 * 4096 + 5
    g = rng.randn(w, n).astype(np.float32)
    jg, tg = both(g, dtype)
    want = jax.jit(jax.vmap(
        lambda x: j_fused.fused_packed_vote(x, ("w",), w, ternary=ternary,
                                            gate_phase=1, interpret=True)[0],
        axis_name="w"))(jg)
    got, _ = fused.fused_packed_vote(tg, VirtualGroup(w), w, ternary=ternary,
                                     gate_phase=1)
    assert got.dtype == tg.dtype and got.shape == (n,)
    for k in range(w):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want[k], np.float32))
    dense = (ref.gternary_aggregate_dense if ternary
             else ref.gbinary_aggregate_dense)
    oracle = dense(tg, 1) if ternary else dense(tg)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  oracle.numpy())


def test_fused_packed_vote_raises_for_unported_branches():
    g = torch.zeros((2, 10))
    with pytest.raises(NotImplementedError, match="vote_pipeline"):
        fused.fused_packed_vote(g, None, 2)
    with pytest.raises(NotImplementedError, match="encode_pack_ef"):
        fused.fused_packed_vote(g, VirtualGroup(2), 2, ef=torch.zeros_like(g))


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
    words = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        ops.unpack_ternary(words.to("meta"), words.to("meta"))
    with pytest.raises(ValueError, match="workers"):
        ops.vote_combine(torch.zeros((3, 1, 128), dtype=torch.int32), words,
                         num_workers=4)
