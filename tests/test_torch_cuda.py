"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; each test skips unless a CUDA device is present.  The
file imports only torch and numpy, so it runs on a GPU machine without
jax (skip this suite's jax-importing conftest there):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LocalGroup  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import Fabric, plan_presets  # noqa: E402
from repro_torch.kernels import fused, kernel_wrappers, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def words(rng, *shape):
    w = rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32).copy())


def bits_equal(a, b) -> bool:
    """Byte equality of two float tensors, NaNs by bit pattern too: the
    kernel and PyTorch's CUDA ops round with the same instructions."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def spread(rng, *shape):
    """Values with exponents 2**-24 .. 2**24 and the special values."""
    x = (rng.randn(*shape) * 2.0 ** rng.randint(-24, 25, size=shape)) \
        .astype(np.float32)
    x.reshape(-1)[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30]
    return torch.from_numpy(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sign_pack_matches_twin(cuda, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 5 * 32, 128).astype(np.float32))
    x[0, 0, :3] = torch.tensor([-0.0, float("nan"), 0.0])
    plane = x.to(dtype).to(cuda)
    assert torch.equal(ops.pack_signs(plane), ref.sign_pack(plane))


# W = 2^k - 1, 2^k, 2^k + 1 for k = 1..12, and 65,537: every count-plane
# width P = bit_length(W) from 1 to 13, and 17
VOTE_WORKERS = sorted({2 ** k + d for k in range(1, 13) for d in (-1, 0, 1)}
                      | {65_537})


@pytest.mark.parametrize("w", VOTE_WORKERS)
def test_vote_combine_matches_twin(cuda, w):
    """One owner, (W, rows, 128) words with a tie (W // 2 ones) and a
    unanimous column, under a ternary gate; at W <= 256 also the
    transposed all_to_all view of W owners, which needs W * rows rows
    (the twin unpacks them to int64)."""
    rng = np.random.RandomState(w)
    rows = 2 if w <= 4097 else 1
    routed = words(rng, w, rows, 128)
    routed[:w // 2, 0, :32] = -1
    routed[w // 2:, 0, :32] = 0
    routed[:, 0, 32:36] = -1
    gate = fused.local_gate_words(rows, ternary=True, gate_phase=w % 3,
                                  device=cuda)
    cases = [(routed.to(cuda), gate)]
    if w <= 256:
        packed = words(rng, w, w * rows, 128).to(cuda)
        cases.append((packed.reshape(w, w, rows, 128).transpose(0, 1),
                      fused.local_gate_words(w * rows, ternary=True,
                                             gate_phase=w % 3, device=cuda)
                      .reshape(w, rows, 128)))
    for r, g in cases:
        for a, b in zip(ops.vote_combine(r, g, num_workers=w),
                        ref.vote_combine(r, w, g)):
            assert torch.equal(a, b)


def test_vote_combine_and_unpack_ternary_raise_on_misaligned_views(cuda):
    """The kernels move 16 bytes a thread: a pointer or a stride off that
    grid raises, and nothing falls back to the twin; 16 bytes further on,
    the same views launch."""
    buf = torch.zeros(4 * 2 * 128 + 4, dtype=torch.int32, device=cuda)
    gate = torch.full((2, 128), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ops.vote_combine(buf[1:1 + 4 * 2 * 128].view(4, 2, 128), gate,
                         num_workers=4)
    strided = torch.zeros((4, 257), dtype=torch.int32, device=cuda) \
        .as_strided((4, 2, 128), (257, 128, 1))
    with pytest.raises(ValueError, match="16-byte"):
        ops.vote_combine(strided, gate, num_workers=4)
    with pytest.raises(ValueError, match="16-byte"):
        ops.unpack_ternary(buf[1:129].view(1, 128), gate[:1])
    before = (ops.vote_combine.launches, ops.unpack_ternary.launches)
    ops.vote_combine(buf[4:4 + 4 * 2 * 128].view(4, 2, 128), gate,
                     num_workers=4)
    ops.unpack_ternary(buf[4:132].view(1, 128), gate[:1])
    assert (ops.vote_combine.launches, ops.unpack_ternary.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("rows", [1, 9, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpack_ternary_matches_twin(cuda, rows, dtype):
    rng = np.random.RandomState(rows)
    s, m = words(rng, rows, 128).to(cuda), words(rng, rows, 128).to(cuda)
    got = ops.unpack_ternary(s, m, dtype=dtype)
    assert got.dtype == dtype
    assert bits_equal(got, ref.unpack_ternary(s, m, dtype))


@pytest.mark.parametrize("gdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edt", [torch.float32, torch.bfloat16])
def test_encode_pack_ef_matches_twin(cuda, gdt, edt):
    rng = np.random.RandomState(2)
    g = spread(rng, 3, 5 * 32, 128).to(gdt).to(cuda)
    e = spread(rng, 3, 5 * 32, 128).to(edt).to(cuda)
    got, want = ops.encode_pack_ef(g, e), ref.encode_pack_ef(g, e)
    assert torch.equal(got[0], want[0]) and bits_equal(got[1], want[1])


@pytest.mark.parametrize("dt,out", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_ef_residual_matches_twin(cuda, dt, out):
    rng = np.random.RandomState(3)
    x = spread(rng, 3, 5 * 32, 128).to(dt).to(cuda)
    beta = torch.tensor([0.5, 3e-5, float("inf")], device=cuda)
    got = ops.ef_residual_plane(x, beta, out_dtype=out)
    assert bits_equal(got, ref.ef_residual(x, beta).to(out))


@pytest.mark.parametrize("w", [1, 3, 4, 31, 128, 256])
def test_popcount_majority_match_twins(cuda, w):
    rng = np.random.RandomState(w)
    packed = words(rng, w, 2 * w, 128).to(cuda)
    view = packed.reshape(w, w, 2, 128).transpose(0, 1)
    for p in (packed, view):
        counts = ops.popcount_stack(p)
        assert torch.equal(counts, ref.popcount_stack(p))
        gate = words(rng, *counts.shape[:-2], counts.shape[-2] // 32,
                     128).to(cuda)
        for a, b in zip(ops.majority_decode(counts, gate, num_workers=w),
                        ref.majority_decode(counts, w, gate)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("fused_kernels", [True, False])
def test_per_leaf_ef_and_staged_match_cpu_twin_path(cuda, fused_kernels):
    """Per-leaf aggregation with EF (on the fused sets: EF in the
    kernels) and the staged chain, on the card and on the CPU twins:
    equal aggregates and residuals, and the kernels each path runs."""
    w = 4
    rng = np.random.RandomState(9)
    shapes = {"layers": {"wq": (2, 64, 96), "w_up": (2, 64, 130)},
              "embed": {"tok": (300, 64)}, "final_norm": {"scale": (64,)}}
    grads = T.map_leaves(
        lambda s: torch.from_numpy(rng.randn(w, *s).astype(np.float32))
        .to(torch.bfloat16), shapes)
    plan = plan_presets(error_feedback=True)["gbin_packed"]
    fabric = Fabric(num_workers=w, fused=False, fused_kernels=fused_kernels)
    like = T.map_leaves(lambda g: g[0], grads)
    ef = T.map_leaves(lambda e: e + 0.01 if e.dim() else e,
                      fabric.init_ef(like, fabric.resolve(like, plan)))
    for fn in kernel_wrappers().values():
        fn.launches = 0
    got, got_ef = fabric.aggregate(
        T.map_leaves(lambda g: g.to(cuda), grads), plan,
        ef=T.map_leaves(lambda e: e.to(cuda), ef))
    torch.cuda.synchronize()
    want, want_ef = fabric.aggregate(grads, plan, ef=ef)
    ran = {k for k, fn in kernel_wrappers().items() if fn.launches}
    assert ran == ({"encode_pack_ef", "vote_combine", "unpack_ternary",
                    "ef_residual"} if fused_kernels else
                   {"sign_pack", "popcount_stack", "majority_decode",
                    "unpack_ternary"})
    assert all(kernel_wrappers()[k].launches == 2 for k in ran)
    for (p, a), (_, b) in zip(T.flatten(got) + T.flatten(got_ef),
                              T.flatten(want) + T.flatten(want_ef)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if p.startswith("layers"):
            assert bits_equal(a.cpu(), b), p
        else:   # FP32 means: another summation order on the card
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("plan", ["gbin_packed", "gbin_packed_all"])
@pytest.mark.parametrize("w", [3, 4])
def test_fabric_kernel_path_matches_cpu_twin_path(cuda, plan, w):
    """The same per-worker grads through the kernels (on the card) and
    through the twins (on the CPU): equal aggregates, and one launch of
    each kernel per low-bit bucket."""
    rng = np.random.RandomState(w)
    shapes = {"layers": {"wq": (2, 64, 96), "w_up": (2, 64, 130)},
              "embed": {"tok": (300, 64)}, "final_norm": {"scale": (64,)}}
    grads = T.map_leaves(
        lambda s: torch.from_numpy(rng.randn(w, *s).astype(np.float32))
        .to(torch.bfloat16), shapes)
    fabric = Fabric(num_workers=w)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    got, _ = fabric.aggregate(T.map_leaves(lambda g: g.to(cuda), grads),
                              plan_presets()[plan])
    torch.cuda.synchronize()
    want, _ = fabric.aggregate(grads, plan_presets()[plan])
    layout = fabric.layout_for(T.map_leaves(lambda g: g[0], grads),
                               plan_presets()[plan])
    lowbit = sum(b.key.schedule == "packed_a2a" for b in layout.buckets)
    path = {"sign_pack", "vote_combine", "unpack_ternary"}
    assert lowbit and all(fn.launches == (lowbit if k in path else 0)
                          for k, fn in kernel_wrappers().items())
    for (p, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.cpu(), b), p
        else:   # FP32 means: another summation order on the card
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the third slice: vote_pipeline, int4_quant, threshold_mask,
# apply_sign_update, and the paths they run on
# ---------------------------------------------------------------------------

# W = 1-5, 31-33, 128, 255-257 and 65,537: ties at even W, and counts
# past every narrow integer the reference once wrapped
PIPELINE_WORKERS = [1, 2, 3, 4, 5, 31, 32, 33, 128, 255, 256, 257, 65_537]


@pytest.mark.parametrize("w", PIPELINE_WORKERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_vote_pipeline_matches_twin(cuda, w, dtype, out):
    """Ragged sizes (1, 4 and 9 word rows; one at W = 65,537), a tie in
    row 0 (W // 2 positive workers), and columns of -0.0, NaN, +inf,
    -inf and +-subnormals in row 1, under a G-Binary and a G-Ternary
    gate; the decode in ``out`` equals the twin's float32 decode cast to
    ``out``."""
    gen = torch.Generator(device=cuda).manual_seed(w)
    for n in ((4000,) if w > 257 else (4000, 3 * 4096 + 77, 9 * 4096 - 5)):
        x = torch.randn((w, n), device=cuda, generator=gen)
        x[:w // 2, :8] = 1.0
        x[w // 2:, :8] = -1.0
        x[:, 128:134] = torch.tensor([-0.0, float("nan"), float("inf"),
                                      -float("inf"), 1e-40, -1e-40])
        stack = ref.to_plane(x.to(dtype))
        del x
        for ternary in (False, True):
            gate = fused.local_gate_words(stack.shape[1] // 32,
                                          ternary=ternary, gate_phase=w % 3,
                                          device=cuda)
            got = ops.vote_pipeline(stack, gate, num_workers=w, dtype=out)
            want = ref.vote_pipeline_dense(stack, w, gate)
            assert bits_equal(got, want.to(out))
            if w % 2 == 0:                     # the tie decodes to +0.0
                assert not got[0, :8].view(torch.int16 if out ==
                                           torch.bfloat16 else
                                           torch.int32).any()
    with pytest.raises(ValueError, match="num_workers"):
        ops.vote_pipeline(stack, gate, num_workers=w + 1)


def test_vote_pipeline_and_threshold_mask_raise_on_misaligned_views(cuda):
    """Both kernels move 16 bytes a thread: a view that does not start on
    a 16-byte boundary raises and launches nothing; 16 bytes further on,
    the same views launch."""
    buf = torch.ones(4096 + 4, device=cuda)
    gbuf = torch.full((128 + 4,), -1, dtype=torch.int32, device=cuda)
    wrappers = (ops.vote_pipeline, ops.threshold_mask_plane)
    before = [fn.launches for fn in wrappers]
    with pytest.raises(ValueError, match="16-byte"):
        ops.vote_pipeline(buf[1:4097].view(1, 32, 128),
                          gbuf[4:132].view(1, 128), num_workers=1)
    with pytest.raises(ValueError, match="16-byte"):
        ops.vote_pipeline(buf[4:4100].view(1, 32, 128),
                          gbuf[1:129].view(1, 128), num_workers=1)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="16-byte"):
            ops.threshold_mask_plane(buf.to(dt)[1:257].view(2, 1, 128), 0.5)
    assert [fn.launches for fn in wrappers] == before
    u = ops.vote_pipeline(buf[4:4100].view(1, 32, 128),
                          gbuf[4:132].view(1, 128), num_workers=1,
                          dtype=torch.bfloat16)
    kept = ops.threshold_mask_plane(buf.to(torch.bfloat16)[8:264]
                                    .view(2, 1, 128), 0.5)
    assert bool((u == 1).all()) and bool((kept == 1).all())
    assert [fn.launches for fn in wrappers] == [b + 1 for b in before]


def int4_planes(rng) -> torch.Tensor:
    """Planes of one scale each: random magnitudes, exact scales with .5
    ties and +-0.0, a zero plane, a NaN plane and an inf plane."""
    base = rng.randn(3 * 4096).astype(np.float32)
    planes = [base * np.float32(10.0 ** e) for e in (-30, -3, 0, 4)]
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 6.5, -6.5, 7.0, -0.0,
                     0.0, 1e-30], np.float32)
    for e in (-20, 3):
        x = np.clip(base, -6.9, 6.9) * np.float32(2.0 ** e)
        x[:ties.size] = ties * np.float32(2.0 ** e)
        planes.append(x)
    planes.append(np.zeros_like(base))
    planes.append(np.where(np.arange(base.size) == 7, np.nan, base * 30))
    planes.append(np.where(np.arange(base.size) == 9, np.inf, base))
    return ref.to_plane(torch.from_numpy(np.stack(planes).astype(np.float32)))


def test_int4_quant_matches_twin(cuda):
    planes = int4_planes(np.random.RandomState(5)).to(cuda)
    got = ops.int4_quant_plane(planes)
    assert bits_equal(got, ref.int4_quant_plane(planes))
    for p in range(planes.shape[0]):         # one plane at a time, too
        assert bits_equal(ops.int4_quant_plane(planes[p]),
                          ref.int4_quant_plane(planes[p]))


#: int4's special values: .5 ties under a power-of-two scale, +-0.0, 7
#: (the absmax), a value far below the scale, the subnormal 3 * 2**-149.
#: Thirteen, a count prime to 4: four runs in a row put each in every
#: lane of a 16-byte vector; the last run leaves a tie, -0.0, +0.0 and the
#: subnormal in a plane's last vector
INT4_RUN = np.array([1.5, -1.5, 6.5, -6.5, 7.0, 1e-30, 2.5, -2.5, 0.5, -0.5,
                     -0.0, 0.0, 3 * 2.0 ** -149], np.float32)


def int4_lane_planes(rng, count: int) -> torch.Tensor:
    """``count`` planes of 3 x 4096 values, each with four runs of
    INT4_RUN at its start and at its end, cycling through: scales 2**-140
    (subnormal), 2**3 and 2**-20 (absmax 7 * 2**e), a NaN plane and an inf
    plane (scale 1: the runs with NaN, or -inf and inf, in place of 1e-30
    and +0.0)."""
    base = rng.randn(3 * 4096).astype(np.float32)
    kinds = []
    for e in (-140, 3, -20):
        r = (INT4_RUN * np.float32(2.0 ** e)).astype(np.float32)
        r[-1] = INT4_RUN[-1]
        kinds.append((np.clip(base, -6.9, 6.9) * np.float32(2.0 ** e), r))
    for special in (np.nan, np.inf):
        r = INT4_RUN.copy()
        r[5], r[11] = -special, special
        kinds.append((base * np.float32(30), r))
    planes = []
    for i in range(count):
        x, r = kinds[i % len(kinds)]
        x = x.copy()
        x[:4 * r.size] = np.tile(r, 4)
        x[-4 * r.size:] = np.tile(r, 4)
        planes.append(x)
    return ref.to_plane(torch.from_numpy(np.stack(planes)))


@pytest.mark.parametrize("count", [1, 2, 5, 11])
def test_int4_quant_special_values_in_every_lane_match_twin(cuda, count):
    """The quantize launch's 16-byte vectors: ties, +-0, NaN, inf and a
    subnormal in each lane of a vector and in a plane's last vector, on
    one plane, an odd count and more planes than the kinds, byte-equal
    to the twin (the planes together and one at a time)."""
    planes = int4_lane_planes(np.random.RandomState(count), count).to(cuda)
    before = fused.int4_quant_plane.launches
    assert bits_equal(ops.int4_quant_plane(planes),
                      ref.int4_quant_plane(planes))
    assert fused.int4_quant_plane.launches == before + 2
    for p in range(count):
        assert bits_equal(ops.int4_quant_plane(planes[p]),
                          ref.int4_quant_plane(planes[p]))


def test_int4_quant_raises_on_misaligned_planes(cuda):
    """Planes that do not start on a 16-byte boundary raise and launch
    nothing, and the quantize entry refuses them itself; 16 bytes further
    on the same values quantize as the twin does."""
    from repro_torch.kernels import build
    buf = torch.randn(2 * 4096 + 8, device=cuda)
    before = fused.int4_quant_plane.launches
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte"):
            ops.int4_quant_plane(buf[off:off + 8192].view(2, 32, 128))
    assert fused.int4_quant_plane.launches == before
    quantize = build.bind("int4_quant", "int4_quantize_f32", 3, 2, 1)
    bits = torch.zeros(1, dtype=torch.int32, device=cuda)
    out = torch.empty(4096 + 4, device=cuda)
    assert quantize(buf.data_ptr() + 4, bits.data_ptr(), out.data_ptr(), 1,
                    4096, 7.0, build.stream_ptr(buf.device)) != 0
    assert quantize(buf.data_ptr(), bits.data_ptr(), out.data_ptr() + 4, 1,
                    4096, 7.0, build.stream_ptr(buf.device)) != 0
    planes = buf[4:4 + 8192].view(2, 32, 128)
    assert bits_equal(ops.int4_quant_plane(planes),
                      ref.int4_quant_plane(planes))


class OtherRank:
    """A model group of two ranks in one process: ``all_reduce`` combines
    this rank's tensor with the other rank's, given; or, with none, a
    group of one (the tensor itself)."""

    def __init__(self, other=None):
        self.other = other

    def all_reduce(self, x, op="sum"):
        if self.other is None:
            return x.clone()
        other = self.other.to(x.device, x.dtype)
        return torch.maximum(x, other) if op == "max" else x + other


#: the main path's largest leaf (qwen3-0.6B's MLP weights) and a ragged one
GROUP_LEAVES = (88_080_384, 100_003)


@pytest.mark.parametrize("n", GROUP_LEAVES)
def test_int4_quant_with_the_groups_absmax_matches_twin(cuda, n):
    """The split entry on one rank's block of a tensor-parallel leaf, the
    other block's absmax bits (three times larger) reduced in between:
    byte-equal to the twin's, and to the whole leaf's one-scale quant."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(2, n, generator=gen, device=cuda)
    x[1] *= 3.0
    other = x[1].abs().amax().reshape(1).view(torch.int32)
    planes = ref.to_plane(x[:1])
    before = fused.int4_quant_plane.launches
    got = fused.int4_quant_plane(planes, group=OtherRank(other))
    assert fused.int4_quant_plane.launches == before + 2
    assert bits_equal(got, ref.int4_quant_plane(planes,
                                                group=OtherRank(other)))
    whole = ref.int4_quant_plane(ref.to_plane(x.reshape(1, -1)))
    assert bits_equal(ref.from_plane(got, n),
                      ref.from_plane(whole, 2 * n)[:, :n])


@pytest.mark.parametrize("n", GROUP_LEAVES)
def test_threshold_mask_with_the_groups_threshold_matches_twin(cuda, n):
    """The radix select's k-th largest |x| (a group of one) equals
    ``torch.topk``'s at top-k's fraction, and ``threshold_mask`` with it
    on a block's planes is byte-equal to the twin."""
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    x = torch.randn(1, n, generator=gen, device=cuda)
    k = max(1, int(n / 16))
    t = fused.kth_largest(x.abs(), k, OtherRank())
    assert bits_equal(t, torch.topk(x.abs(), k, dim=-1).values[:, -1])
    planes = ref.to_plane(x[:, :n // 2])
    before = fused.threshold_mask_plane.launches
    got = fused.threshold_mask_plane(planes, t)
    assert fused.threshold_mask_plane.launches == before + 1
    assert bits_equal(got, ref.threshold_mask_plane(planes, t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_mask_matches_twin(cuda, dtype):
    rng = np.random.RandomState(6)
    x = spread(rng, 3, 5000)
    x[:, 10:14] = torch.tensor([0.75, -0.75, 0.75, 1.5])     # ties at t
    planes = ref.to_plane(x).to(dtype).to(cuda)
    thresh = torch.tensor([0.75, 1.5, 0.0], device=cuda)
    got = ops.threshold_mask_plane(planes, thresh)
    assert bits_equal(got, ref.threshold_mask_plane(planes,
                                                    thresh.to(dtype)))
    assert bits_equal(ops.threshold_mask_plane(planes[0], 0.75),
                      ref.threshold_mask_plane(planes[0], 0.75))


#: thresholds of the special-value test: a tie value, 0, a subnormal, a
#: negative t (keeps all but NaN), +inf (keeps only infinities) and NaN
#: (keeps nothing)
SPECIAL_T = [0.75, 0.0, 1e-40, -1.0, float("inf"), float("nan")]


@pytest.mark.parametrize("planes", [300, 70_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_mask_special_values_and_many_planes(cuda, planes, dtype):
    """More planes than a grid's y dimension holds (65,535), each with
    ties at t, NaN, +-0.0, +-inf and subnormals, under the thresholds of
    ``SPECIAL_T`` in turn; 300 planes of 33 rows, 70,000 of one row."""
    rows = 33 if planes == 300 else 1
    gen = torch.Generator(device=cuda).manual_seed(planes)
    x = torch.randn((planes, rows, 128), device=cuda, generator=gen)
    x[:, 0, :12] = torch.tensor([0.75, -0.75, float("nan"), 0.0, -0.0,
                                 float("inf"), -float("inf"), 1e-40,
                                 -3e-39, 1e-30, -1.0, 1.0])
    x = x.to(dtype)
    thresh = torch.tensor(SPECIAL_T, device=cuda).repeat(
        planes // len(SPECIAL_T) + 1)[:planes]
    got = ops.threshold_mask_plane(x, thresh)
    assert bits_equal(got, ref.threshold_mask_plane(x, thresh.to(dtype)))
    head = got[:len(SPECIAL_T), 0, :12].to(torch.float32)
    assert int(head[3].isnan().sum()) == 0 and bool(head[5].eq(0).all())
    assert int((head[3] != 0).sum()) == 9           # t < 0: all but NaN, +-0
    assert int((head[4] != 0).sum()) == 2           # t = inf: +-inf


#: scales of the apply_sign_update tests: ordinary ones, 2^-20 as a
#: one-element tensor, and the special values
ASU_SCALES = [1e-3, -0.37, 2.0 ** -20, 0.0, -0.0, float("inf"),
              float("nan")]


@pytest.mark.parametrize("scale", ASU_SCALES,
                         ids=["1e-3", "-0.37", "2^-20 tensor", "0", "-0",
                              "inf", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_sign_update_matches_twin(cuda, dtype, scale):
    """Parameters with exponents 2^-24 .. 2^24, led by +-0, NaN, +-inf
    and subnormals in rows 0-31 of lanes 0-7, each under every bit of
    random sign and mask words; the bits equal the twin's, NaNs too."""
    rng = np.random.RandomState(7)
    param = ref.to_plane(spread(rng, 5 * 4096))
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf"), 1e-40, -3e-39, -9.2e-41])
    rows, lanes = torch.meshgrid(torch.arange(32), torch.arange(8),
                                 indexing="ij")
    param[:32, :8] = special[(rows + lanes) % 8]
    param = param.to(dtype).to(cuda)
    sw, mw = words(rng, 5, 128).to(cuda), words(rng, 5, 128).to(cuda)
    arg = torch.tensor(scale, device=cuda) if scale == 2.0 ** -20 else scale
    got = ops.apply_sign_update(param, sw, mw, arg)
    assert bits_equal(got, ref.apply_sign_update(param, sw, mw, arg))


def test_apply_sign_update_raises_on_misaligned_views(cuda):
    """The kernel moves 16 bytes a thread: a parameter plane or a word
    plane that does not start on a 16-byte boundary raises and launches
    nothing; 16 bytes further on, the same views launch."""
    buf = torch.ones(4096 + 8, dtype=torch.bfloat16, device=cuda)
    wbuf = torch.full((128 + 4,), -1, dtype=torch.int32, device=cuda)
    before = ops.apply_sign_update.launches
    with pytest.raises(ValueError, match="16-byte"):
        ops.apply_sign_update(buf[1:4097].view(32, 128),
                              wbuf[4:132].view(1, 128),
                              wbuf[4:132].view(1, 128), 0.5)
    with pytest.raises(ValueError, match="16-byte"):
        ops.apply_sign_update(buf[8:4104].view(32, 128),
                              wbuf[1:129].view(1, 128),
                              wbuf[4:132].view(1, 128), 0.5)
    assert ops.apply_sign_update.launches == before
    got = ops.apply_sign_update(buf[8:4104].view(32, 128),
                                wbuf[4:132].view(1, 128),
                                wbuf[4:132].view(1, 128), 0.5)
    assert bool((got == 0.5).all())
    assert ops.apply_sign_update.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_sign_update_never_synchronises(cuda, dtype):
    """Neither a float scale (by value) nor a one-element tensor scale
    (read on the card) makes the wrapper wait for the device: under
    ``set_sync_debug_mode("error")`` a synchronising call raises."""
    rng = np.random.RandomState(9)
    param = ref.to_plane(spread(rng, 2 * 4096)).to(dtype).to(cuda)
    sw, mw = words(rng, 2, 128).to(cuda), words(rng, 2, 128).to(cuda)
    tensor = torch.tensor([-0.37], device=cuda)
    ops.apply_sign_update(param, sw, mw, 1e-3)     # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        by_value = ops.apply_sign_update(param, sw, mw, -0.37)
        on_card = ops.apply_sign_update(param, sw, mw, tensor)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bits_equal(by_value, on_card)
    assert bits_equal(on_card, ref.apply_sign_update(param, sw, mw, tensor))


@pytest.mark.parametrize("error_feedback", [False, True])
def test_host_local_fabric_matches_cpu_twin_path(cuda, error_feedback):
    """The host-local session on the card and on the CPU twins: one
    vote_pipeline launch per low-bit leaf (plus ef_residual under EF, per
    leaf), equal aggregates and residuals."""
    rng = np.random.RandomState(8)
    shapes = {"layers": {"wq": (2, 64, 96), "w_up": (2, 64, 130)},
              "embed": {"tok": (300, 64)}, "final_norm": {"scale": (64,)}}
    grads = T.map_leaves(
        lambda s: torch.from_numpy(rng.randn(1, *s).astype(np.float32))
        .to(torch.bfloat16), shapes)
    plan = plan_presets(error_feedback=error_feedback)["gbin_packed"]
    fabric = Fabric(group=LocalGroup(), fused=not error_feedback)
    like = T.map_leaves(lambda g: g[0], grads)
    ef = T.map_leaves(lambda e: e + 0.01 if e.dim() else e,
                      fabric.init_ef(like, fabric.resolve(like, plan)))
    ef = ef if error_feedback else None
    for fn in kernel_wrappers().values():
        fn.launches = 0
    got, got_ef = fabric.aggregate(
        T.map_leaves(lambda g: g.to(cuda), grads), plan,
        ef=None if ef is None else T.map_leaves(lambda e: e.to(cuda), ef))
    torch.cuda.synchronize()
    want, want_ef = fabric.aggregate(grads, plan, ef=ef)
    lowbit = 2 if error_feedback else len(
        [b for b in fabric.layout_for(like, plan).buckets
         if b.key.schedule == "packed_a2a"])
    expect = {"vote_pipeline": lowbit,
              "ef_residual": lowbit if error_feedback else 0}
    assert {k: fn.launches for k, fn in kernel_wrappers().items()} == \
        {k: expect.get(k, 0) for k in kernel_wrappers()}
    for (p, a), (_, b) in zip(
            T.flatten(got) + (T.flatten(got_ef) if ef else []),
            T.flatten(want) + (T.flatten(want_ef) if ef else [])):
        assert a.dtype == b.dtype and bits_equal(a.cpu(), b), p


@pytest.mark.parametrize("preset", ["int4_backbone", "topk_backbone"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("fused_kernels", [True, False])
def test_mean_codecs_match_cpu_twin_path(cuda, preset, fused, fused_kernels):
    """int4 / top-k under W = 4 on the card and on the CPU twins: the
    encode kernels run once per low-bit bucket or leaf (int4_quant counts
    its two launches), with the kernel switch on or off (the mean codecs
    have no staged chain), and the means agree to the FP32 tolerance."""
    rng = np.random.RandomState(9)
    w = 4
    shapes = {"layers": {"wq": (2, 64, 96), "w_up": (2, 64, 130)},
              "embed": {"tok": (300, 64)}, "final_norm": {"scale": (64,)}}
    grads = T.map_leaves(
        lambda s: torch.from_numpy(rng.randn(w, *s).astype(np.float32))
        .to(torch.bfloat16), shapes)
    plan = plan_presets()[preset]
    fabric = Fabric(num_workers=w, fused=fused, fused_kernels=fused_kernels)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    got, _ = fabric.aggregate(T.map_leaves(lambda g: g.to(cuda), grads),
                              plan)
    torch.cuda.synchronize()
    want, _ = fabric.aggregate(grads, plan)
    n = len([b for b in fabric.layout_for(
        T.map_leaves(lambda g: g[0], grads), plan).buckets
        if b.key.mode != "fp32"]) if fused else 2
    expect = ({"int4_quant": 2 * n} if preset == "int4_backbone"
              else {"threshold_mask": n})
    assert {k: fn.launches for k, fn in kernel_wrappers().items()} == \
        {k: expect.get(k, 0) for k in kernel_wrappers()}
    for (p, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the control plane on the card
# ---------------------------------------------------------------------------

def _smoke_paper_trainer(device, init=None):
    from repro_torch.configs import get_config
    from repro_torch.core import Commander, Schedule
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import make_controller
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = get_config("qwen3_0p6b", smoke=True)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    trainer = Trainer(
        cfg, AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-2),
        data, fabric=Fabric(num_workers=4), device=device,
        controller=make_controller(
            "paper", commander=Commander(schedule=Schedule.PACKED_A2A),
            warmup_steps=2))
    trainer.init_state()
    if init is not None:
        with torch.no_grad():
            for t, x in zip(T.leaves(trainer.state.model.tree()), init):
                t.copy_(x)
    return trainer


def test_paper_trainer_on_the_card_admits_as_on_the_cpu(cuda):
    """The SMOKE-config paper Trainer (W = 4, warm-up 2, packed schedule)
    from the same parameters on the CPU twins and on the card: the same
    events and admitted plan; on the card the admitted packed buckets
    launch sign_pack, vote_combine and unpack_ternary once each a step,
    and the FP32 warm-up launches nothing."""
    cpu = _smoke_paper_trainer("cpu")
    init = [t.detach().clone() for t in T.leaves(cpu.state.model.tree())]
    card = _smoke_paper_trainer(cuda, [x.to(cuda) for x in init])
    cpu.run(4)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    per_step = []
    for k in range(4):
        before = {n: fn.launches for n, fn in kernel_wrappers().items()}
        card.run(k + 1)
        per_step.append({n: fn.launches - before[n]
                         for n, fn in kernel_wrappers().items()})
    log = lambda c: [(e.step, e.kind, e.plan_signature)  # noqa: E731
                     for e in c.controller.events]
    assert log(card) == log(cpu)
    assert [(s, k) for s, k, _ in log(card)] == [(1, "warmup_end"),
                                                (1, "admitted")]
    plan = card.controller.plan
    layout = card.fabric.layout_for(card.state.model.tree(), plan)
    packed = sum(b.key.schedule == "packed_a2a" for b in layout.buckets)
    assert packed
    path = {"sign_pack", "vote_combine", "unpack_ternary"}
    for k, got in enumerate(per_step):
        want = packed if k >= 2 else 0
        assert got == {n: (want if n in path else 0) for n in got}, k
    for a, b in zip(card.history, cpu.history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)


def test_grad_accum_launches_float32_unpack_ternary(cuda):
    """``grad_accum=2`` on a bfloat16 model: the float32 accumulated
    gradients ride the bf16-planned buckets, so each packed bucket's
    decode is a float32 unpack_ternary launch, and its aggregates equal
    the CPU twins' on the same gradients."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import TrainState
    from repro_torch.fabric.session import aggregate_tree_bucketed
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                              dtype="bfloat16")
    model = Transformer(cfg, seed=0, device=cuda)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in data.batch_at(0).items()}
    fabric = Fabric(num_workers=4)
    params = model.tree()
    plan = plan_presets()["gbin_packed"]
    opt = AdamW(peak_lr=1e-3, total_steps=10)
    step = fabric.build_step(opt, plan, params, model.loss, grad_accum=2)
    packed = [b for b in step.layout.buckets
              if b.key.schedule == "packed_a2a"]
    assert packed and {b.key.dtype for b in packed} == {"bfloat16"}
    unpack = kernel_wrappers()["unpack_ternary"]
    by_dtype = dict(unpack.launches_by_dtype)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    grads, _ = fabric.worker_grads(params, batch, model.loss, grad_accum=2)
    agg, _ = aggregate_tree_bucketed(fabric.context, grads, step.policies,
                                     layout=step.layout)
    torch.cuda.synchronize()
    assert unpack.launches_by_dtype[torch.float32] - \
        by_dtype[torch.float32] == len(packed)
    assert unpack.launches_by_dtype[torch.bfloat16] == \
        by_dtype[torch.bfloat16]
    assert all(g.dtype == torch.float32 for g in T.leaves(grads))
    want, _ = aggregate_tree_bucketed(
        fabric.context, T.map_leaves(lambda g: g.cpu(), grads),
        step.policies, layout=step.layout)
    lowbit = {s.name for b in packed for s in b.slots}
    for (p, a), (_, b) in zip(T.flatten(agg), T.flatten(want)):
        assert a.dtype == b.dtype == torch.float32
        if p in lowbit:
            assert bits_equal(a.cpu(), b), p
    state = TrainState(model=model, opt=opt.init(params),
                       ef=fabric.init_ef(params, step.policies))
    state, metrics, agg = step(state, batch)
    assert all(u.dtype == torch.float32 for u in T.leaves(agg))
    assert np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------------
# the process group on the card: NCCL at world size 1
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A one-rank NCCL process group in this process (a ``file://``
    store in the test's directory), torn down after the test."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch.core import DistributedGroup

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield DistributedGroup(device="cuda:0")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["gbinary", "gternary"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nccl_group_equals_one_virtual_worker(nccl_group, mode, dtype):
    """A packed G-Binary / G-Ternary bucket over NCCL at world size 1:
    the same bits as ``VirtualGroup(1)``, through the fused kernels
    (sign_pack, vote_combine on the contiguous all_to_all buffer,
    unpack_ternary) and the group's all_to_all and two all_gathers."""
    from repro_torch.core import AdmissionPlan, Schedule

    cuda = nccl_group.device
    rng = np.random.RandomState(0)
    grads = {"layers": {"w": torch.from_numpy(
        rng.randn(1, 3, 4096 + 77).astype(np.float32)).to(dtype).to(cuda)},
        "embed": {"tok": torch.from_numpy(
            rng.randn(1, 64, 8).astype(np.float32)).to(dtype).to(cuda)}}
    plan = AdmissionPlan.lowbit_backbone(mode, schedule=Schedule.PACKED_A2A)
    for fn in kernel_wrappers().values():
        fn.launches = 0
    nccl_group.reset_counts()
    got, _ = Fabric(group=nccl_group).aggregate(grads, plan)
    launches = {n: fn.launches for n, fn in kernel_wrappers().items()}
    want, _ = Fabric(num_workers=1).aggregate(grads, plan)
    for p, u in T.flatten(want):
        assert bits_equal(dict(T.flatten(got))[p], u), p
    assert launches == {n: int(n in ("sign_pack", "vote_combine",
                                     "unpack_ternary"))
                        for n in launches}
    assert nccl_group.calls_by_op == {"all_to_all": 1, "all_gather": 2,
                                      "all_reduce": 1}


def test_nccl_all_to_all_buffer_feeds_vote_combine(nccl_group):
    """The received (1, W, rw, LANE) buffer is contiguous, not the
    virtual group's transposed view, and vote_combine takes it."""
    cuda = nccl_group.device
    rng = np.random.RandomState(1)
    w = words(rng, 1, 1, 9, 128).to(cuda)
    routed = nccl_group.all_to_all(w)
    assert routed.shape == (1, 1, 9, 128) and routed.is_contiguous()
    assert routed.data_ptr() != w.data_ptr()
    gate = fused.shard_gate_words(nccl_group.rank(), 9, ternary=True,
                                  gate_phase=1, total_rows=9, device=cuda)
    before = fused.vote_combine.launches
    sw, mw = fused.vote_combine(routed, gate, num_workers=1)
    assert fused.vote_combine.launches == before + 1
    ws, wm = ref.vote_combine(w.cpu(), 1, gate.cpu())
    assert torch.equal(sw.cpu(), ws.reshape(sw.shape))
    assert torch.equal(mw.cpu(), wm.reshape(mw.shape))


# ---------------------------------------------------------------------------
# the model's attention and MoE layers on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_global", [True, False], ids=["global", "local"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_attention_matches_full_scores_on_the_card(cuda, is_global,
                                                           dtype,
                                                           monkeypatch):
    """4096 tokens at a small width (2 KV heads of 2 queries, head dim
    32, window 1024 on the local layer, 1024-token blocks): the blocked
    path against the full-scores path on the card, forward and the
    gradient of a fixed cotangent.  float32 to 1e-5 of the largest
    value; bfloat16 to 2 bf16 ulps (each path rounds p to bf16 for the
    PV product, over other partial sums)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("gemma3_27b", smoke=True),
                              sliding_window=1024, dtype=str(dtype)[6:])
    gen = torch.Generator(device=cuda).manual_seed(0)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": torch.randn(d, h * hd, generator=gen, device=cuda) / 8,
         "wk": torch.randn(d, kv * hd, generator=gen, device=cuda) / 8,
         "wv": torch.randn(d, kv * hd, generator=gen, device=cuda) / 8,
         "wo": torch.randn(h * hd, d, generator=gen, device=cuda) / 8,
         "q_norm": {"scale": torch.ones(hd, device=cuda)},
         "k_norm": {"scale": torch.ones(hd, device=cuda)}}
    p = {k: v.to(dtype) if k.startswith("w") else v for k, v in p.items()}
    x = torch.randn(1, 4096, d, generator=gen, device=cuda).to(dtype)
    ct = torch.randn(1, 4096, d, generator=gen, device=cuda).to(dtype)

    def run(threshold):
        monkeypatch.setattr(L, "FLASH_SEQ_THRESHOLD", threshold)
        tp = T.map_leaves(lambda a: a.detach().requires_grad_(), p)
        tx = x.detach().requires_grad_()
        out = L.attn_forward(tp, tx, cfg, is_global=is_global)
        return [out.detach(),
                *torch.autograd.grad(out, [tx, *T.leaves(tp)], ct)]

    blocked, full = run(2048), run(8192)
    for a, b in zip(blocked, full):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        tol = 1e-5 * scale if dtype == torch.float32 else 2 ** -6 * scale
        assert float((a - b).abs().max()) <= tol


def test_moe_layer_on_the_card_matches_cpu(cuda):
    """One float32 MoE layer of the deepseek-moe smoke config over 4 x 96
    tokens (groups of 32, capacity overflow), forward and backward, on the
    card against the same layer on the CPU: the routes agree (the outputs
    to 1e-5) and every gradient to 1e-5 of its largest."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models import layers as L
    cfg = get_config("deepseek_moe_16b", smoke=True)
    moe = T.map_leaves(lambda a: a[0], init_params(
        cfg, generator=torch.Generator().manual_seed(0),
        device="cpu")["layers"]["moe"])
    x = torch.randn(4, 96, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))

    def run(device):
        tp = T.map_leaves(lambda a: a.to(device).requires_grad_(), moe)
        tx = x.to(device).requires_grad_()
        out = L.moe_forward(tp, tx, cfg)
        grads = torch.autograd.grad(out, [tx, *T.leaves(tp)], ct.to(device))
        return [t.detach().cpu() for t in (out, *grads)]

    for a, b in zip(run(cuda), run("cpu")):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1.0)


@pytest.mark.parametrize("block", ["mlstm", "slstm", "mamba"])
def test_full_width_recurrent_block_on_the_card_matches_cpu(cuda, block):
    """One block at full width (xlstm-125m's mLSTM, d 768 -> 1536 inner,
    4 heads of 384, and its sLSTM; hymba-1.5b's Mamba head, d 1600,
    state 16), float32, over 2 x 36 tokens (the chunked scan: 6 chunks
    of 6, each under a checkpoint): output and every gradient on the
    card against the port on the CPU, to 1e-4 of the largest value
    (float32 sums in other orders, carried through 36 recurrent steps)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    arch = "hymba_1p5b" if block == "mamba" else "xlstm_125m"
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    init = {"mlstm": S.init_mlstm, "slstm": S.init_slstm,
            "mamba": S.init_mamba_head}[block]
    fwd = {"mlstm": S.mlstm_forward, "slstm": S.slstm_forward,
           "mamba": S.mamba_forward}[block]
    params = init(cfg, gen, torch.device("cpu"))
    x = torch.randn(2, 36, cfg.d_model, generator=gen)
    ct = torch.randn(x.shape, generator=gen)

    def run(device):
        tp = T.map_leaves(lambda a: a.to(device).requires_grad_(), params)
        tx = x.to(device).requires_grad_()
        out = fwd(tp, tx, cfg)
        grads = torch.autograd.grad(out, [tx, *T.leaves(tp)], ct.to(device))
        return [t.detach().cpu() for t in (out, *grads)]

    for a, b in zip(run(cuda), run("cpu")):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("block", ["mlstm", "slstm", "mamba"])
def test_full_width_recurrent_decode_on_the_card_matches_cpu(cuda, block):
    """Three chained one-token decode steps of one block at full width
    (xlstm-125m's mLSTM and sLSTM, hymba-1.5b's Mamba head), float32,
    batch 4, from the zero state: each output and new state on the card
    against the port on the CPU, to 1e-5 of the largest value (float32
    sums in other orders)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    arch = "hymba_1p5b" if block == "mamba" else "xlstm_125m"
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    init = {"mlstm": S.init_mlstm, "slstm": S.init_slstm,
            "mamba": S.init_mamba_head}[block]
    state0 = {"mlstm": S.mlstm_init_state, "slstm": S.slstm_init_state,
              "mamba": S.mamba_init_state}[block]
    dec = {"mlstm": S.mlstm_decode, "slstm": S.slstm_decode,
           "mamba": S.mamba_decode}[block]
    params = init(cfg, gen, torch.device("cpu"))
    xs = torch.randn(3, 4, 1, cfg.d_model, generator=gen)

    def run(device):
        p = T.map_leaves(lambda a: a.to(device), params)
        st, out = state0(cfg, 4, torch.device(device)), []
        for x in xs:
            y, st = dec(p, x.to(device), cfg, st)
            out += [y, *T.leaves(st)]
        return [t.cpu() for t in out]

    for a, b in zip(run(cuda), run("cpu")):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def _smoke_bf16():
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                               dtype="bfloat16")


def test_serve_engine_batched_equals_solo_on_the_card(cuda):
    """The determinism contract on the card (run T's, at smoke width): a
    bf16 model over the float32 cache, a pool small enough to preempt and
    spill; each request's logits bit-identical to its solo run at the
    same max_batch, and the pool drained."""
    from repro_torch.serve import ServeEngine

    cfg = _smoke_bf16()
    rng = np.random.RandomState(0)
    trace = [{"prompt": rng.randint(0, cfg.vocab_size, p).tolist(),
              "max_new_tokens": n, "arrival_step": a}
             for p, n, a in ((20, 12, 0), (9, 10, 1), (14, 12, 1),
                             (30, 6, 3))]
    kw = dict(max_batch=3, max_seq=48, block_size=4, collect_logits=True,
              device=cuda)
    eng = ServeEngine(cfg, seed=0, num_blocks=18, **kw)
    outputs = eng.serve(trace)
    assert eng.timeline().total_preemptions > 0
    assert eng.cache.tier.spills > 0 and eng.cache.tier.fetches > 0
    assert eng.cache.blocks_in_use == 0
    for rid, entry in enumerate(trace):
        solo = ServeEngine(cfg, params=eng.params, num_blocks=18, **kw)
        got = solo.serve([{"prompt": entry["prompt"],
                           "max_new_tokens": entry["max_new_tokens"]}])
        assert got[0] == outputs[rid]
        assert all(torch.equal(a, b)
                   for a, b in zip(solo.logits[0], eng.logits[rid]))


def test_tuned_controller_retunes_on_the_card(cuda):
    """Run S at smoke width: the autotuned plan, the ``tuned`` controller
    (patience 2) and the Trainer on the card; every step launches what
    its latched plan's layout holds, and the retune falls where a second
    controller fed the same step times puts it."""
    from repro_torch.core import codec_name
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, Telemetry
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer
    from repro_torch.tune import TunedPlanController

    cfg = _smoke_bf16()
    fabric = Fabric(num_workers=4)
    tuned = fabric.autotune(init_params(cfg, device="meta"))
    tuned.apply(fabric)
    ctl = fabric.attach_controller("tuned", tuned=tuned, patience=2)
    trainer = Trainer(cfg, AdamW(total_steps=4), SyntheticLMStream(
        vocab=cfg.vocab_size, seq_len=16, batch=8, seed=0), fabric=fabric,
        device=cuda)
    params = trainer.init_state().model.tree()
    wrappers = kernel_wrappers()
    for k in range(4):
        plan = ctl.plan
        before = {n: fn.launches for n, fn in wrappers.items()}
        trainer.run(k + 1)
        delta = {n: fn.launches - before[n] for n, fn in wrappers.items()}
        layout = fabric.layout_for(params, plan)
        packed = sum(b.key.schedule == "packed_a2a" for b in layout.buckets)
        int4 = sum(codec_name(b.key.mode) == "int4" for b in layout.buckets)
        want = {"sign_pack": packed, "vote_combine": packed,
                "unpack_ternary": packed, "int4_quant": 2 * int4}
        assert delta == {n: want.get(n, 0) for n in delta}, k
    shadow = TunedPlanController(tuned, patience=2)
    for h in trainer.history:
        shadow.observe(Telemetry(step=h["step"], loss=h["loss"],
                                 step_time_s=h["step_time_s"]))
    assert ctl.events and ctl.events == shadow.events
    first = ctl.events[0]
    assert trainer.history[first.step + 1]["plan"] == \
        first.plan_signature != tuned.plan.signature()
