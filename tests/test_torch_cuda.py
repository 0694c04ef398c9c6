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
    assert lowbit and all(fn.launches == lowbit
                          for fn in kernel_wrappers().values())
    for (p, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.cpu(), b), p
        else:   # FP32 means: another summation order on the card
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
