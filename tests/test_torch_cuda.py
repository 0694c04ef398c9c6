"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; each test skips unless a CUDA device is present.  The
file imports only torch and numpy, so it runs on a GPU machine without
jax (skip this suite's jax-importing conftest there):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import Fabric, plan_presets  # noqa: E402
from repro_torch.kernels import kernel_wrappers, ops, ref  # noqa: E402

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


@pytest.mark.parametrize("w", [1, 3, 4, 31, 128, 256])
def test_vote_combine_matches_twin(cuda, w):
    rng = np.random.RandomState(w)
    routed = words(rng, w, 2 * w, 128).to(cuda)
    gate = words(rng, 2 * w, 128).to(cuda)
    for r, g in ((routed, gate),
                 (routed.reshape(w, w, 2, 128).transpose(0, 1),
                  gate.reshape(w, 2, 128))):
        for a, b in zip(ops.vote_combine(r, g, num_workers=w),
                        ref.vote_combine(r, w, g)):
            assert torch.equal(a, b)


def test_unpack_ternary_matches_twin(cuda):
    rng = np.random.RandomState(1)
    s, m = words(rng, 9, 128).to(cuda), words(rng, 9, 128).to(cuda)
    assert torch.equal(ops.unpack_ternary(s, m).view(torch.int32),
                       ref.unpack_ternary(s, m).view(torch.int32))


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
