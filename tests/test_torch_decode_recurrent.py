"""The port's recurrent and cross-attention decode against the reference's.

``repro_torch``'s decode of the SSM (xLSTM), hybrid (hymba) and
encoder-decoder (whisper) families beside ``repro``'s (jitted), on the
SMOKE configs with the reference's parameters carried across
(``params_from_jax``):

  * ``mlstm_decode``, ``slstm_decode`` and ``mamba_decode``: three
    chained steps' outputs and new states, in float32 to 1e-5 of the
    largest value and in a bfloat16 variant to 2 bf16 ulps of it (2^-6;
    ``tests/test_torch_ssm.py`` states why XLA's CPU fusions part from
    eager bf16 by an ulp);
  * ``init_cache`` and 8 ``decode_step``s of each model, with scalar and
    per-row (B,) positions: the cache trees equal at the start, logits
    and every cache leaf to 1e-5 of the largest value (float32; the
    summation orders differ) after each step;
  * ``build_cached_prefill`` and ``build_serve_step`` with
    ``donate=False``: the same tolerance, and the caller's cache tree
    left as it was;
  * the reference's ``test_decode_matches_forward`` on the port
    (xlstm-smoke and hymba-smoke at its 2e-2);
  * the reference's whisper decode ignores the audio: the cross cache
    is zeros, nothing writes the encoder's K and V into it, so the
    logits do not depend on ``frames`` in either package (ROADMAP
    queue 3), and the cross-attention adds exactly zero;
  * ``ServeEngine`` refuses the three families with the reference's
    message.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.runtime.serve import \
    build_cached_prefill as j_build_cached_prefill  # noqa: E402
from repro.runtime.serve import \
    build_serve_step as j_build_serve_step  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402
                                params_from_jax)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.runtime.serve import (build_cached_prefill,  # noqa: E402
                                       build_serve_step)
from repro_torch.serve import ServeEngine  # noqa: E402

#: float32 decode: to this fraction of the largest value (summation
#: orders differ; the logits of the SMOKE models sit near 4)
TOL = 1e-5
#: bfloat16 decode: 2 bf16 ulps of the largest value
BF16_REL = 2.0 ** -6
ARCHS = ["xlstm_125m", "hymba_1p5b", "whisper_tiny"]
B, S_MAX = 3, 24


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the SMOKE shapes (the suite's workers share
    the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, want, rel, what=""):
    want = _f32(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _close_trees(got, want, rel):
    items = T.flatten(got)
    j_items = T.flatten(jax.tree.map(np.asarray, want))
    assert [p for p, _ in items] == [p for p, _ in j_items]
    for (p, a), (_, b) in zip(items, j_items):
        assert tuple(a.shape) == b.shape, p
        _close(a, b, rel, p)


_MODELS = {}


def _model(arch):
    """(cfg, jcfg, host params, port params), built once a module."""
    if arch not in _MODELS:
        jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch,
                                                               smoke=True)
        host = jax.tree.map(np.asarray,
                            j_init_params(jax.random.PRNGKey(0), jcfg))
        _MODELS[arch] = cfg, jcfg, host, params_from_jax(host, device="cpu")
    return _MODELS[arch]


def _tokens(cfg, seed=0, s=S_MAX):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the blocks' decode steps
# ---------------------------------------------------------------------------

BLOCKS = {
    "mlstm": ("xlstm_125m", JS.init_mlstm, JS.mlstm_init_state,
              JS.mlstm_decode, S.mlstm_init_state, S.mlstm_decode),
    "slstm": ("xlstm_125m", JS.init_slstm, JS.slstm_init_state,
              JS.slstm_decode, S.slstm_init_state, S.slstm_decode),
    "mamba": ("hymba_1p5b", JS.init_mamba_head, JS.mamba_init_state,
              JS.mamba_decode, S.mamba_init_state, S.mamba_decode),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_decode_matches_reference(block, dtype):
    """Three chained one-token steps from the zero state, each package
    from its own state: outputs and new states (float32 always)."""
    arch, j_init, j_state0, j_dec, state0, dec = BLOCKS[block]
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    p = T.map_leaves(_torch, jax.tree.map(np.asarray, jp))
    rng = np.random.RandomState(2)
    xs = rng.randn(3, B, 1, cfg.d_model).astype(np.float32)
    jstep = jax.jit(lambda pp, x, st: j_dec(pp, x, jcfg, st))
    jst, st = j_state0(jcfg, B), state0(cfg, B, "cpu")
    rel = TOL if dtype == "float32" else BF16_REL
    for x in xs:
        jy, jst = jstep(jp, jnp.asarray(x).astype(jcfg.dtype), jst)
        y, st = dec(p, _torch(jnp.asarray(x).astype(jcfg.dtype)), cfg, st)
        assert y.dtype == getattr(torch, dtype)
        _close(y, jy, rel, "output")
        _close_trees(st, jst, rel)
        assert all(t.dtype == torch.float32 for t in T.leaves(st))


# ---------------------------------------------------------------------------
# the models' decode
# ---------------------------------------------------------------------------

def _positions(kind, i):
    """A step's positions: every row at i, or rows at i, i + 5, i + 11."""
    if kind == "scalar":
        return jnp.int32(i), i
    pos = np.array([i, i + 5, i + 11], np.int32)
    return jnp.asarray(pos), torch.from_numpy(pos)


@pytest.mark.parametrize("kind", ["scalar", "rows"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, kind):
    """init_cache, then 8 decode steps of B = 3 rows (per-row depths up
    to 18 of 24 for ``rows``; hymba-smoke's 16-token window masks the
    deepest rows' oldest keys)."""
    cfg, jcfg, host, params = _model(arch)
    toks = _tokens(cfg)
    jcache = j_init_cache(jcfg, B, S_MAX, dtype=jnp.float32)
    cache = init_cache(cfg, B, S_MAX, dtype=torch.float32, device="cpu")
    _close_trees(cache, jcache, 0.0)
    jstep = jax.jit(lambda p, t, c, i: j_decode_step(p, jcfg, t, c, i))
    for i in range(8):
        jpos, pos = _positions(kind, i)
        jl, jcache = jstep(host, jnp.asarray(toks[:, i:i + 1]), jcache, jpos)
        logits, cache = decode_step(params, cfg,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    cache, pos)
        assert logits.shape == (B, cfg.vocab_size)
        _close(logits, jl, TOL, f"step {i} logits")
        _close_trees(cache, jcache, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_and_step_match_reference(arch):
    """Prefill 12 of 24 positions, then one serve step at per-row depths
    12, 3 and 7, both with ``donate=False``: the caller's cache tree is
    left as it was."""
    cfg, jcfg, host, params = _model(arch)
    toks = _tokens(cfg, seed=1)
    jl, jc = j_build_cached_prefill(jcfg, donate=False)(
        host, jnp.asarray(toks), jnp.int32(12),
        j_init_cache(jcfg, B, S_MAX, dtype=jnp.float32))
    cache = init_cache(cfg, B, S_MAX, dtype=torch.float32, device="cpu")
    before = T.map_leaves(torch.Tensor.clone, cache)
    logits, filled = build_cached_prefill(cfg, donate=False)(
        params, torch.from_numpy(toks).long(), 12, cache)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(cache),
                                                 T.leaves(before)))
    _close(logits, jl, TOL)
    _close_trees(filled, jc, TOL)
    pos = np.array([12, 3, 7], np.int32)
    jl2, jc2 = j_build_serve_step(jcfg, batch=B, max_seq=S_MAX,
                                  donate=False)[0](
        host, jnp.asarray(toks[:, 12:13]), jc, jnp.asarray(pos))
    step, _ = build_serve_step(cfg, batch=B, max_seq=S_MAX, donate=False)
    kept = T.map_leaves(torch.Tensor.clone, filled)
    logits2, cache2 = step(params, torch.from_numpy(toks[:, 12:13]).long(),
                           filled, torch.from_numpy(pos))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(filled),
                                                 T.leaves(kept)))
    _close(logits2, jl2, TOL)
    _close_trees(cache2, jc2, TOL)


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1p5b"])
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` on the port: a
    teacher-forced decode of 8 tokens reproduces the parallel forward's
    logits to its 2e-2 (a float32 cache)."""
    cfg, _, _, params = _model(arch)
    s = 8
    toks = torch.from_numpy(
        np.random.RandomState(3).randint(0, cfg.vocab_size, (1, s))).long()
    with torch.no_grad():
        ref = forward(params, cfg, {"tokens": toks})
    cache = init_cache(cfg, 1, s, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = decode_step(params, cfg, toks[:, t:t + 1], cache, t)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), ref.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_whisper_decode_ignores_the_audio():
    """The reference's cross cache is zeros sized by ``enc_out`` and
    nothing writes the encoder's K and V there, so two encoder outputs
    of different audio give the same decode, in both packages; each
    step's cross-attention adds exactly zero."""
    cfg, jcfg, host, params = _model("whisper_tiny")
    toks = _tokens(cfg, seed=4)
    rng = np.random.RandomState(5)
    frames = [rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32)
              for _ in range(2)]
    jstep = jax.jit(lambda p, t, c, i: j_decode_step(p, jcfg, t, c, i))
    j_out, out = [], []
    for f in frames:
        enc = jnp.asarray(f) @ host["embed"]["frame_proj"]["w"]
        jc = j_init_cache(jcfg, B, S_MAX, enc_out=enc, dtype=jnp.float32)
        cache = init_cache(cfg, B, S_MAX,
                           torch.from_numpy(f) @ params["embed"][
                               "frame_proj"]["w"],
                           dtype=torch.float32, device="cpu")
        assert cache["cross_k"].shape[2] == cfg.encoder_seq
        jl = lg = None
        for i in range(4):
            jl, jc = jstep(host, jnp.asarray(toks[:, i:i + 1]), jc,
                           jnp.int32(i))
            lg, cache = decode_step(params, cfg,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    cache, i)
        j_out.append(np.asarray(jl))
        out.append(lg)
        assert not jnp.any(jc["cross_k"]) and not jnp.any(jc["cross_v"])
        assert not bool(cache["cross_k"].any() or cache["cross_v"].any())
    np.testing.assert_array_equal(j_out[0], j_out[1])
    assert torch.equal(out[0], out[1])
    cross = {k: v[0] for k, v in params["layers"]["cross"].items()}
    h = torch.from_numpy(rng.randn(B, 1, cfg.d_model).astype(np.float32))
    term = L.cross_attn_forward(cross, h, cfg, cache["cross_k"][0],
                                cache["cross_v"][0])
    assert not bool(term.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_recurrent_and_cross_attention_families(arch):
    """The paged engine serves the attention families alone, as the
    reference's: the same ValueError and message."""
    cfg, jcfg, host, params = _model(arch)
    kw = dict(max_batch=2, max_seq=16, num_blocks=8, block_size=4)
    with pytest.raises(ValueError) as want:
        JServeEngine(jcfg, params=host, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(cfg, params=params, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "not token-paged" in str(got.value)
