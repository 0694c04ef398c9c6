"""The port's recurrent blocks against the reference's, on the CPU.

``repro_torch.models.ssm`` against ``repro.models.ssm`` (jitted), with
the reference's parameters carried across:

  * ``chunked_scan``: T = 24 takes the chunked path (chunks of 4, each
    under a checkpoint), T = 10 stays flat (10 % 3 != 0), forward and
    gradients;
  * each block (mLSTM, sLSTM, the Mamba head) over 2 x 24 tokens,
    forward and the gradient of a fixed cotangent, in float32 and in a
    bfloat16 variant of the SMOKE config;
  * the bfloat16 q / k scaling bit for bit, and ``softplus``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# chunked_scan
# ---------------------------------------------------------------------------

def _step_j(state, inp):
    x, g = inp
    state = jnp.tanh(state * jax.nn.sigmoid(g) + x)
    return state, state * g


def _step_t(state, inp):
    x, g = inp
    state = torch.tanh(state * torch.sigmoid(g) + x)
    return state, state * g


@pytest.mark.parametrize("seq,chunked", [(24, True), (10, False)],
                         ids=["T24_chunked", "T10_flat"])
def test_chunked_scan_matches_reference(seq, chunked, monkeypatch):
    """The reference's rule picks the branch (chunk = int(sqrt(T)), flat
    when T % chunk != 0); the chunked branch runs one checkpoint a chunk.
    Final state, outputs and the gradients of both inputs and the
    initial state to 1e-6 (float32)."""
    calls = []
    real = S.checkpoint

    def counting(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(S, "checkpoint", counting)
    rng = np.random.RandomState(0)
    x, g = (rng.randn(seq, 3, 5).astype(np.float32) for _ in range(2))
    s0 = rng.randn(3, 5).astype(np.float32)
    ct_s, ct_y = rng.randn(3, 5).astype(np.float32), \
        rng.randn(seq, 3, 5).astype(np.float32)

    def jfn(s, xx, gg):
        return JS.chunked_scan(_step_j, s, (xx, gg), seq)

    (js, jy), vjp = jax.vjp(jax.jit(jfn), s0, x, g)
    jgrads = vjp((jnp.asarray(ct_s), jnp.asarray(ct_y)))
    ts, tx, tg = (torch.from_numpy(a).requires_grad_() for a in (s0, x, g))
    state, ys = S.chunked_scan(_step_t, ts, (tx, tg), seq)
    assert len(calls) == (seq // int(math.sqrt(seq)) if chunked else 0)
    assert all(kw == {"use_reentrant": False} for kw in calls)
    grads = torch.autograd.grad((state, ys), (ts, tx, tg),
                                (torch.from_numpy(ct_s),
                                 torch.from_numpy(ct_y)))
    np.testing.assert_allclose(_f32(state), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(_f32(ys), np.asarray(jy), atol=1e-6)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(_f32(got), np.asarray(want), atol=1e-6)
    # without grad the chunks run as they are
    calls.clear()
    with torch.no_grad():
        again = S.chunked_scan(_step_t, ts, (tx, tg), seq)[1]
    assert not calls and torch.equal(again, ys.detach())


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

BLOCKS = {
    "mlstm": ("xlstm_125m", JS.init_mlstm, JS.mlstm_forward, S.mlstm_forward),
    "slstm": ("xlstm_125m", JS.init_slstm, JS.slstm_forward, S.slstm_forward),
    "mamba": ("hymba_1p5b", JS.init_mamba_head, JS.mamba_forward,
              S.mamba_forward),
}

#: the reference's float32 leaves, float32 in a bfloat16 model too
FLOAT32_LEAVES = {"mlstm": {"w_if", "if_bias"}, "slstm": {"r", "bias"},
                  "mamba": {"w_dt", "dt_bias", "w_bc", "a_log",
                            "skip_scale"}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_reference(block, dtype):
    """One block of the SMOKE config (in a bfloat16 variant too) over 2 x
    24 tokens (the chunked scan), the reference's parameters: output and
    the gradients of x and of every leaf for a fixed cotangent.

    float32: to rtol 1e-5 plus 1e-6 of the largest value.  bfloat16:
    the output to 2 bf16 ulps of its largest value (2^-6), gradients to
    4 (2^-5).  The reference runs under XLA on the CPU, which keeps a
    bf16 product in float32 where an op follows it in the same fusion
    (the mLSTM's sigmoid output gate parts from the port's by an ulp in
    ~30% of its elements); the port rounds each op's result to bf16, as
    eager PyTorch and the card do."""
    arch, j_init, j_fwd, fwd = BLOCKS[block]
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    jd = jnp.dtype(dtype)
    x = jnp.asarray(rng.randn(2, 24, cfg.d_model).astype(np.float32)).astype(jd)
    ct = jnp.asarray(rng.randn(2, 24, cfg.d_model).astype(np.float32)).astype(jd)
    out, vjp = jax.vjp(jax.jit(lambda p, a: j_fwd(p, a, jcfg)), jp, x)
    jgp, jgx = vjp(ct)

    host = jax.tree.map(np.asarray, jp)
    for name, a in host.items():   # the float32 islands, as the reference
        assert (a.dtype == np.float32) == (
            dtype == "float32" or name in FLOAT32_LEAVES[block]), name
    tp = T.map_leaves(lambda a: _torch(a).requires_grad_(), host)
    tx = _torch(x).requires_grad_()
    got = fwd(tp, tx, cfg)
    assert got.dtype == getattr(torch, dtype)
    grads = torch.autograd.grad(got, [tx, *T.leaves(tp)], _torch(ct))
    want = [jgx, *jax.tree.leaves(jgp)]
    assert [g.dtype for g in grads] == [t.dtype for t in [tx, *T.leaves(tp)]]
    pairs = [("out", got, out, 2 ** -6)] + [
        (name, g, w, 2 ** -5) for name, g, w in
        zip(["x", *(p for p, _ in T.flatten(tp))], grads, want)]
    for name, a, b, ulps in pairs:
        a, b = _f32(a), _f32(b)
        scale = np.abs(b).max()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"{block}: {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=ulps * scale,
                                       err_msg=f"{block}: {name}")


@pytest.mark.parametrize("hd", [32, 96, 384])
def test_bf16_qk_scaling_is_the_references_bit_for_bit(hd):
    """``scale_qk`` divides by ``bf16(sqrt(hd))``, as JAX does with a
    weakly typed Python float (19.625 at xlstm-125m's hd = 384):
    4096 bf16 values equal the jitted reference's bit for bit, where
    torch's division by the float itself parts from it."""
    rng = np.random.RandomState(hd)
    x = jnp.asarray(rng.randn(4096).astype(np.float32) * 4).astype(
        jnp.bfloat16)
    want = np.asarray(jax.jit(lambda t: t / math.sqrt(hd))(x))
    t = _torch(x)
    got = S.scale_qk(t, hd)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    if hd == 384:
        naive = (t / math.sqrt(hd)).view(torch.int16).numpy()
        assert (naive != want.view(np.int16)).sum() > 100


def test_mlstm_bf16_preactivations_scale_q_and_k_as_the_reference():
    """The bf16 mLSTM's q, k and v preactivations equal the jitted
    reference's bit for bit (the same bf16 products, then the scaling)."""
    jcfg = dataclasses.replace(j_get_config("xlstm_125m", smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("xlstm_125m", smoke=True),
                              dtype="bfloat16")
    jp = JS.init_mlstm(jax.random.PRNGKey(3), jcfg)
    x = jnp.asarray(np.random.RandomState(4).randn(2, 24, cfg.d_model)
                    .astype(np.float32)).astype(jnp.bfloat16)
    want = jax.jit(lambda p, a: JS._mlstm_preact(p, a, jcfg))(jp, x)
    tp = T.map_leaves(_torch, jax.tree.map(np.asarray, jp))
    got = S._mlstm_preact(tp, _torch(x), cfg)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))


def test_softplus_is_logaddexp():
    """``softplus`` against ``jax.nn.softplus`` (``logaddexp(x, 0)``) on
    float32 values from -40 to 40, either side of ``F.softplus``'s switch
    to x at 20: to 2 ulps (PyTorch's and XLA's exp and log1p round apart
    below x = 1; ``F.softplus`` parts at nearly twice as many points, up
    to x = 15), and its gradient to 1e-6."""
    x = np.linspace(-40, 40, 4001).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    wgrad = np.asarray(jax.jit(jax.grad(lambda a: jax.nn.softplus(a).sum()))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = S.softplus(tx)
    np.testing.assert_array_max_ulp(got.detach().numpy(), want, maxulp=2)
    grad, = torch.autograd.grad(got.sum(), tx)
    np.testing.assert_allclose(grad.numpy(), wgrad, rtol=0, atol=1e-6)
