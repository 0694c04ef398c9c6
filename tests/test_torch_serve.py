"""The port's decode path and serving engine against the reference's.

``repro_torch.serve``, ``repro_torch.runtime.serve`` and the models'
decode path driven beside ``repro``'s on the same inputs (weights
carried across by ``params_from_jax``):

  * ``build_cached_prefill`` and ``build_serve_step`` (scalar and (B,)
    positions) on the SMOKE dense, MoE, VLM and sliding-window configs:
    logits and caches to the forward pass's 1e-5 (float32; summation
    orders differ), and a bf16 model over a float32 cache to 2^-9 of the
    largest logit;
  * the engine on ``tests/test_serve.py``'s toy config: outputs,
    ``StepRecord``s, timeline JSON and ``simulate`` reports equal
    (``==``) to the reference's, with the fp32 and the int4 KV codec,
    with and without preemption and spill, after asserting that every
    sampled row's top-2 margin exceeds the logits tolerance;
  * the determinism contract on the CPU: each request's logits
    bit-identical to its solo run at the same ``max_batch``, through
    batching, paging, preemption and spill;
  * the allocator, evictor, scheduler policies and cache as
    ``tests/test_serve.py`` holds the reference's, and a hypothesis
    property test of the allocator and of capacity round trips whose
    draws are bounded by the pool's capacity;
  * the reference's faults the port follows or states: batched MoE
    decode is not row-independent; the reference's layer scan cannot
    decode a bf16 model over a float32 cache;
  * the hybrid served on two gloo ranks as ``{"data": 1, "model": 2}``
    (its Mamba states split by channel) against one device.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fabric.codecs import get_codec as j_get_codec  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime.serve import \
    build_cached_prefill as j_build_cached_prefill  # noqa: E402
from repro.runtime.serve import \
    build_serve_step as j_build_serve_step  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fabric import get_codec  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step,  # noqa: E402
                                init_cache, params_from_jax)
from repro_torch.models.config import SsmConfig  # noqa: E402
from repro_torch.runtime.serve import (build_cached_prefill,  # noqa: E402
                                       build_prefill, build_serve_step,
                                       serve_shardings)
from repro_torch.serve import (BlockAllocator, NoFreeBlocks,  # noqa: E402
                               PagedKVCache, Request, Scheduler,
                               ServeEngine, get_policy, register_policy,
                               unregister_policy)

#: logits and caches of a float32 decode against the reference's (the
#: forward pass's tolerance in tests/test_torch_models.py)
TOL = 1e-5
#: a bf16 model's decode: 2^-9 of the largest logit (a bf16 product may
#: round an ulp apart in the first layer's projections)
BF16_REL = 2.0 ** -9
DECODE_ARCHS = ["qwen3_0p6b", "deepseek_moe_16b", "phi3_vision_4p2b",
                "gemma3_27b"]


def toy(**kw):
    base = dict(name="toy", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=97,
                dtype="float32", remat=False)
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


@pytest.fixture(scope="module")
def toy_params():
    cfg, jcfg = toy()
    host = jax.tree.map(np.asarray,
                        j_init_params(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, host, params_from_jax(host, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's SMOKE shapes (more gain
    nothing, and the suite's workers share the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(cfg, params, **kw):
    return ServeEngine(cfg, params=params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the decode path against the reference's
# ---------------------------------------------------------------------------

def _pair(arch, dtype=None):
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    host = jax.tree.map(np.asarray,
                        j_init_params(jax.random.PRNGKey(0), jcfg))
    return cfg, jcfg, host, params_from_jax(host, device="cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 20 of 24 positions (scalar path), then one step at
    per-row depths 20, 5 and 13 (vector path), each row masked by its
    own depth and, on gemma3, by the sliding window."""
    cfg, jcfg, host, params = _pair(arch)
    b, s = 3, 24
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (b, s)).astype(np.int32)
    jl, jc = j_build_cached_prefill(jcfg, donate=False)(
        host, jnp.asarray(toks), jnp.int32(20),
        j_init_cache(jcfg, b, s, dtype=jnp.float32))
    cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    logits, cache = build_cached_prefill(cfg)(
        params, torch.from_numpy(toks).long(), 20, cache)
    _close(logits, jl, TOL)
    for key in ("k", "v"):
        _close(cache[key], jc[key], TOL)
    pos = np.array([20, 5, 13], np.int32)
    jl2, jc2 = j_build_serve_step(jcfg, batch=b, max_seq=s, donate=False)[0](
        host, jnp.asarray(toks[:, 1:2]), jc, jnp.asarray(pos))
    step, shardings = build_serve_step(cfg, batch=b, max_seq=s,
                                       donate=False)
    before = {k: v.clone() for k, v in cache.items()}
    logits2, cache2 = step(params, torch.from_numpy(toks[:, 1:2]).long(),
                           cache, torch.from_numpy(pos))
    assert shardings["shard_seq"] is False
    assert all(torch.equal(cache[k], before[k]) for k in cache)  # a copy
    _close(logits2, jl2, TOL)
    for key in ("k", "v"):
        _close(cache2[key], jc2[key], TOL)


def test_vector_positions_match_the_scalar_path(toy_params):
    """(B,) positions at B = 1 reproduce the scalar path bit for bit (the
    reference's ``test_vector_positions_match_scalar_unbatched_path``)."""
    cfg, _, _, params = toy_params
    cache = init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    logits, cache = build_cached_prefill(cfg)(
        params, torch.tensor([[3, 5, 7, 0]]), 3, cache)
    tok = logits.argmax(-1).reshape(1, 1)
    step, _ = build_serve_step(cfg, batch=1, max_seq=16, donate=False)
    l_s, c_s = step(params, tok, cache, 3)
    l_v, c_v = step(params, tok, cache, torch.tensor([3]))
    assert torch.equal(l_s, l_v)
    assert all(torch.equal(c_s[k], c_v[k]) for k in ("k", "v"))


def _j_unrolled_decode(params, cfg, token, cache, position):
    """The reference's decode with its layers unrolled in Python (its
    ``_layer_decode`` on each layer's slice): what its layer scan would
    compute if its carry could change dtype."""
    x = jnp.take(params["embed"]["tok"], token, axis=0)
    flags = JT.global_attention_flags(cfg)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        x, nc = JT._layer_decode(lp, x, cfg, {"k": cache["k"][i],
                                              "v": cache["v"][i]},
                                 position, bool(flags[i]))
        ks.append(nc["k"])
        vs.append(nc["v"])
    return JT._logits(params, cfg, x)[:, 0], {"k": jnp.stack(ks),
                                              "v": jnp.stack(vs)}


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "deepseek_moe_16b"])
def test_bf16_model_over_a_float32_cache(arch):
    """The full models are bf16 and the engine's default cache float32:
    the first attention's float32 output promotes the residual stream to
    float32, as JAX's promotion does.  The reference's MoE model (its
    dense first layer unrolled) decodes so; its dense model raises in
    the layer scan, whose carry may not change dtype (ROADMAP queue 3),
    so the port is held there to the reference's layers unrolled."""
    cfg, jcfg, host, params = _pair(arch, "bfloat16")
    b, s = 2, 8
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (b, s)).astype(np.int32)
    jcache = j_init_cache(jcfg, b, s, dtype=jnp.float32)
    if arch == "qwen3_0p6b":
        with pytest.raises(TypeError, match="carry"):
            j_build_serve_step(jcfg, batch=b, max_seq=s, donate=False)[0](
                host, jnp.asarray(toks[:, :1]), jcache, jnp.int32(0))
        jstep = jax.jit(lambda p, t, c, i: _j_unrolled_decode(p, jcfg, t, c,
                                                              i))
    else:
        jstep = j_build_serve_step(jcfg, batch=b, max_seq=s,
                                   donate=False)[0]
    cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    for i in range(5):
        jl, jcache = jstep(host, jnp.asarray(toks[:, i:i + 1]), jcache,
                           jnp.int32(i))
        logits, cache = decode_step(params, cfg,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    cache, i)
        assert logits.dtype == torch.float32 and jl.dtype == jnp.float32
        _close(logits, jl, BF16_REL * float(np.abs(np.asarray(jl)).max()))


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec"])
def test_recurrent_and_cross_attention_decode_raise(family):
    arch = {"ssm": "xlstm_125m", "hybrid": "hymba_1p5b",
            "encdec": "whisper_tiny"}[family]
    """The recurrent and cross-attention families decode (held to the
    reference in ``tests/test_torch_decode_recurrent.py``), but the paged
    engine raises on them, as the reference's does: their states are not
    token-paged."""
    cfg, jcfg, host, params = _pair(arch)
    cache = init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    logits, _ = decode_step(params, cfg, torch.zeros((1, 1),
                                                     dtype=torch.int64),
                            cache, 0)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="not token-paged"):
        _engine(cfg, params, max_batch=1, max_seq=8, num_blocks=4,
                block_size=4)


SERVE_MESH_PROGRAM = r'''
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
from repro_torch.core import ProcessMesh
from repro_torch.core import tree as T
from repro_torch.models import init_cache, init_params
from repro_torch.models.transformer import shard_params
from repro_torch.runtime.serve import (build_cached_prefill, build_prefill,
                                       build_serve_step)

cfg = get_config("hymba_1p5b", smoke=True)
mesh = ProcessMesh((1, 2), device="cpu")
whole = init_params(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
params = T.map_leaves(torch.Tensor.clone, shard_params(
    whole, cfg, mesh.extents, mesh.coords))
tokens = torch.from_numpy(np.random.RandomState(0).randint(
    0, cfg.vocab_size, (2, 8)))
prefill = build_cached_prefill(cfg, mesh, batch=2, max_seq=8)
step, sh = build_serve_step(cfg, mesh, batch=2, max_seq=8)
cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu", mesh=mesh)
logits, cache = prefill(params, tokens, 5, cache)
rows = [logits]
for t in range(5, 8):
    logits, cache = step(params, tokens[:, t:t + 1], cache, t)
    rows.append(logits)
arrays = {"decode": torch.stack(rows).numpy(),
          "prefill": build_prefill(cfg, mesh)(params, {"tokens": tokens})
          .numpy(), "ssm": cache["ssm"].numpy()}
np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump({"ssm_spec": list(map(str, sh["cache"]["ssm"]))}, f)
dist.barrier()
dist.destroy_process_group()
'''


def test_mesh_layouts_raise_for_families_without_tp(tmp_path):
    """The hybrid (hymba SMOKE, float32) served on two ranks as
    ``{"data": 1, "model": 2}``: the cached prefill of 5 prompt tokens
    and 3 decode steps, and the batched prefill, on every rank equal to
    one device's to the forward pass's tolerance; each rank's Mamba
    states are its channels' (``P(None, dp, "model", None)``)."""
    from test_torch_tp import spawn_ranks
    from repro_torch.models import forward, init_params
    cfg = get_config("hymba_1p5b", smoke=True)
    sh = serve_shardings(cfg, {"data": 1, "model": 2}, batch=2, max_seq=8)
    assert sh["cache"]["k"] == (None, ("data",), "model", None, None)
    assert sh["cache"]["ssm"] == (None, ("data",), "model", None)
    ranks = spawn_ranks(SERVE_MESH_PROGRAM, 2, tmp_path / "out")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 8)))
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    rows = []
    for t in range(8):
        logits, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        if t >= 4:
            rows.append(logits)
    want = torch.stack(rows).numpy()
    with torch.no_grad():
        full = forward(params, cfg, {"tokens": tokens}).numpy()
    half = cfg.d_model // 2
    for r, (arrays, _) in enumerate(ranks):
        np.testing.assert_allclose(arrays["decode"], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(arrays["prefill"], full, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(
            arrays["ssm"], cache["ssm"][:, :, r * half:(r + 1) * half],
            rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the engine against the reference's
# ---------------------------------------------------------------------------

STAGGERED = dict(kw=dict(max_batch=3, max_seq=32, num_blocks=16,
                         block_size=4),
                 trace=[{"prompt": [3, 5, 7], "max_new_tokens": 6},
                        {"prompt": [11, 2], "max_new_tokens": 5,
                         "arrival_step": 1},
                        {"prompt": [1, 4, 1, 5, 9], "max_new_tokens": 4,
                         "arrival_step": 2}])
#: a pool too small for both: preemption and a spill/fetch round trip
SQUEEZED = dict(kw=dict(max_batch=2, max_seq=16, num_blocks=6,
                        block_size=2),
                trace=[{"prompt": [3, 5, 7], "max_new_tokens": 8},
                       {"prompt": [11, 2, 6], "max_new_tokens": 8,
                        "arrival_step": 1}])


@pytest.mark.parametrize("kv_codec", ["fp32", "int4"])
@pytest.mark.parametrize("case", ["staggered", "squeezed"])
def test_engine_equals_reference(toy_params, case, kv_codec):
    cfg, jcfg, host, params = toy_params
    spec = {"staggered": STAGGERED, "squeezed": SQUEEZED}[case]
    jeng = JServeEngine(jcfg, params=host, kv_codec=kv_codec,
                        collect_logits=True, **spec["kw"])
    want = jeng.serve(spec["trace"])
    # no sampled token is decided by a tie within the tolerance
    for rows in jeng.logits.values():
        for row in rows:
            top2 = np.sort(np.asarray(row))[-2:]
            assert top2[1] - top2[0] > TOL
    eng = _engine(cfg, params, kv_codec=kv_codec, collect_logits=True,
                  **spec["kw"])
    got = eng.serve(spec["trace"])
    assert got == want
    for rid in want:
        assert len(eng.logits[rid]) == len(jeng.logits[rid])
        for a, b in zip(eng.logits[rid], jeng.logits[rid]):
            _close(a, b, TOL)
    assert eng.records == [type(eng.records[0])(**r.__dict__)
                           for r in jeng.records]
    assert eng.timeline().to_jsonable() == jeng.timeline().to_jsonable()
    for topology in ("cxl_direct", "cxl_switched"):
        assert eng.simulate(topology=topology).to_jsonable() == \
            jeng.simulate(topology=topology).to_jsonable()
    assert (eng.cache.tier.spills, eng.cache.tier.fetches) == \
        (jeng.cache.tier.spills, jeng.cache.tier.fetches)
    if case == "squeezed":
        assert eng.timeline().total_preemptions > 0
        assert eng.cache.tier.spills > 0 and eng.cache.tier.fetches > 0
    assert eng.cache.blocks_in_use == 0


@pytest.mark.parametrize("case", ["staggered", "squeezed"])
def test_batched_logits_equal_solo_runs(toy_params, case):
    """The determinism contract: each request's logits equal its solo
    run's at the same ``max_batch``, bit for bit, through batching,
    paging, preemption and spill."""
    cfg, _, _, params = toy_params
    spec = {"staggered": STAGGERED, "squeezed": SQUEEZED}[case]
    eng = _engine(cfg, params, collect_logits=True, **spec["kw"])
    outputs = eng.serve(spec["trace"])
    solo_kw = dict(spec["kw"], num_blocks=16)
    for rid, entry in enumerate(spec["trace"]):
        solo = _engine(cfg, params, collect_logits=True, **solo_kw)
        got = solo.serve([{"prompt": entry["prompt"],
                           "max_new_tokens": entry["max_new_tokens"]}])
        assert got[0] == outputs[rid]
        assert len(solo.logits[0]) == len(eng.logits[rid])
        for a, b in zip(solo.logits[0], eng.logits[rid]):
            assert torch.equal(a, b)
    if case == "squeezed":
        preempted = [r for r in eng.requests.values() if r.preemptions]
        assert preempted and preempted[0].state.value == "finished"


def test_moe_batched_decode_is_not_row_independent():
    """A reference fault the port follows (ROADMAP queue 3): the MoE
    layer dispatches a decode step's B tokens as one group, so a row's
    expert slots, and past ``cap`` its dropped choices, depend on the
    other rows.  One decode step at B = 8 on deepseek-moe-smoke (cap 4
    of 8 tokens), each row against the same row served alone in slot 0
    (the engine's solo run): some row differs by O(1) in both packages."""
    cfg, jcfg, host, params = _pair("deepseek_moe_16b")
    b, s = 8, 8
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.full((b,), 3, np.int32)
    kv = rng.randn(2, cfg.num_layers, b, s, cfg.num_kv_heads,
                   cfg.hd).astype(np.float32)
    kv[:, :, :, 3:] = 0.0

    def alone(r):
        """Row r in slot 0, the other slots empty (token 0 at 0)."""
        t, p, c = np.zeros_like(toks), np.zeros_like(pos), np.zeros_like(kv)
        t[0], p[0], c[:, :, 0] = toks[r], pos[r], kv[:, :, r]
        return t, p, c

    jstep = j_build_serve_step(jcfg, batch=b, max_seq=s, donate=False)[0]
    step, _ = build_serve_step(cfg, batch=b, max_seq=s, donate=False)

    def j_run(t, p, c):
        return np.asarray(jstep(host, jnp.asarray(t), {"k": jnp.asarray(c[0]),
                                                      "v": jnp.asarray(c[1])},
                                jnp.asarray(p))[0])

    def run(t, p, c):
        c = torch.from_numpy(c)
        return step(params, torch.from_numpy(t).long(), {"k": c[0],
                                                          "v": c[1]},
                    torch.from_numpy(p))[0].numpy()

    for fn in (j_run, run):
        batched = fn(toks, pos, kv)
        worst = max(float(np.abs(batched[r] - fn(*alone(r))[0]).max())
                    for r in range(b))
        assert worst > 0.1


# ---------------------------------------------------------------------------
# allocator, evictor, cache, codecs and policies
# ---------------------------------------------------------------------------

def test_allocator_free_list_refcounts_and_fork():
    a = BlockAllocator(3)
    parent, other = a.allocate(), a.allocate()
    assert a.fork(parent) == parent and a.ref_count(parent) == 2
    assert a.free(parent) is False and a.num_in_use == 2
    assert a.free(parent) is True and a.stats.releases == 1
    assert a.allocate() == parent            # LIFO: the warm block first
    assert a.free(other) is True
    with pytest.raises(ValueError, match="double free"):
        a.free(other)
    with pytest.raises(ValueError, match="cannot fork unallocated"):
        a.fork(other)
    a.allocate(), a.allocate()
    with pytest.raises(NoFreeBlocks):
        a.allocate()
    with pytest.raises(ValueError, match="out of range"):
        a.free(7)


def test_allocator_and_capacity_properties():
    """Hypothesis, with keyword strategies and draws bounded by the
    pool: random allocate / fork / free interleavings keep every block
    either free or held; ragged capacities fill a pool sized to them
    exactly and release it whole."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=50, deadline=None, database=None)
    @given(ops=st.lists(st.integers(0, 5), min_size=1, max_size=40),
           num_blocks=st.integers(1, 8))
    def allocator_never_leaks_or_double_frees(ops, num_blocks):
        a = BlockAllocator(num_blocks)
        held = []
        for op in ops:
            if op <= 2:
                try:
                    held.append(a.allocate())
                except NoFreeBlocks:
                    assert a.num_free == 0
            elif op == 3 and held:
                held.append(a.fork(held[0]))
            elif held:
                a.free(held.pop())
            assert a.num_free + a.num_in_use == num_blocks
            assert all(a.ref_count(b) >= 1 for b in held)
        for bid in held:
            a.free(bid)
        assert a.num_free == num_blocks

    cfg, _ = toy()

    @settings(max_examples=25, deadline=None, database=None)
    @given(lengths=st.lists(st.integers(1, 23), min_size=1, max_size=6),
           block_size=st.sampled_from([1, 3, 4, 8]))
    def capacity_round_trips_at_ragged_lengths(lengths, block_size):
        need = [-(-n // block_size) for n in lengths]
        cache = PagedKVCache(cfg, num_blocks=sum(need),
                             block_size=block_size, device="cpu")
        for rid, n in enumerate(lengths):
            cache.add_request(rid)
            cache.ensure_capacity(rid, n)
            assert len(cache._tables[rid]) == need[rid]
        assert cache.blocks_in_use == sum(need) and cache.utilization() == 1
        with pytest.raises(NoFreeBlocks):       # full, and nothing cold
            cache.ensure_capacity(0, lengths[0] + block_size)
        for rid in range(len(lengths)):
            cache.release(rid)
        assert cache.blocks_in_use == 0

    allocator_never_leaks_or_double_frees()
    capacity_round_trips_at_ragged_lengths()


@pytest.mark.parametrize("kv_codec", ["fp32", "int4"])
def test_spill_fetch_round_trip_is_lossless(kv_codec):
    cfg, _ = toy()
    gen = torch.Generator().manual_seed(0)
    cache = PagedKVCache(cfg, num_blocks=2, block_size=4, kv_codec=kv_codec,
                         device="cpu")
    k = torch.randn((cfg.num_layers, 4, cfg.num_kv_heads, cfg.hd),
                    generator=gen)
    v = torch.randn(k.shape, generator=gen)
    cache.add_request(0)
    cache.write_prompt(0, k, v)
    dense = (cfg.num_layers, 8, cfg.num_kv_heads, cfg.hd)
    before = torch.zeros(dense), torch.zeros(dense)
    cache.gather_into(0, *before)
    cache.deactivate(0, tick=1)
    for rid in (1, 2):                  # squeeze request 0 out
        cache.add_request(rid)
        cache.ensure_capacity(rid, 4)
    assert cache.tier.spills == 1 and 0 not in [o for o, _ in
                                                cache._owner.values()]
    cache.release(1), cache.release(2)
    assert cache.activate(0, tick=2) and cache.tier.fetches == 1
    after = torch.zeros(dense), torch.zeros(dense)
    cache.gather_into(0, *after)
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])
    price = get_codec(kv_codec).kv_bytes(cache.block_elements)
    assert cache.tier.spilled_bytes == cache.tier.fetched_bytes == price


def test_kv_codecs_match_reference():
    """kv_cache flags, kv_bytes, and int4's kv_encode on a tensor equal to
    the reference's numpy encode (scales from 2^-130 to 2^100, float16
    blocks, zero blocks, NaN); int4 stays idempotent."""
    for name in ("fp32", "identity", "int4", "topk", "gbinary", "gternary"):
        codec, jcodec = get_codec(name), j_get_codec(name)
        assert codec.kv_cache == jcodec.kv_cache
        assert codec.kv_bytes(12345) == jcodec.kv_bytes(12345)
    rng = np.random.RandomState(3)
    blocks = [(rng.randn(2, 4, 8) * 2.0 ** e).astype(np.float32)
              for e in (-130, -20, 0, 40, 100)]
    blocks += [rng.randn(3, 5).astype(np.float16),
               np.zeros((2, 3), np.float32),
               np.array([1.0, np.nan, -2.0], np.float32)]
    int4 = get_codec("int4")
    for b in blocks:
        with np.errstate(all="ignore"):
            want = j_get_codec("int4").kv_encode(b)
        got = int4.kv_encode(torch.from_numpy(b))
        assert got.numpy().dtype == want.dtype
        assert got.numpy().tobytes() == want.tobytes()
        if np.isfinite(b).all():
            assert torch.equal(int4.kv_encode(got), got)
    block = torch.randn(4, 4)
    for name in ("fp32", "identity"):
        assert get_codec(name).kv_encode(block) is block
        assert get_codec(name).kv_decode(block) is block
    assert int4.kv_decode(block) is block


def test_kv_codec_must_declare_kv_cache():
    cfg, _ = toy()
    with pytest.raises(ValueError, match="kv_cache"):
        PagedKVCache(cfg, num_blocks=4, block_size=4, kv_codec="gbinary",
                     device="cpu")


def test_unsupported_family_rejected():
    cfg, _ = toy(family="ssm", d_ff=0, ssm=SsmConfig(state_size=8))
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, max_batch=1, max_seq=8, num_blocks=4,
                    block_size=4, device="cpu")


def test_policy_registry_and_orders():
    reqs = [Request(rid=0, prompt=[1], max_new_tokens=9, arrival_step=0),
            Request(rid=1, prompt=[1], max_new_tokens=2, arrival_step=1),
            Request(rid=2, prompt=[1], max_new_tokens=5, arrival_step=2)]
    fcfs, sjf = get_policy("fcfs"), get_policy("sjf")
    assert [r.rid for r in fcfs.admission_order(reqs)] == [0, 1, 2]
    assert [r.rid for r in sjf.admission_order(reqs)] == [1, 2, 0]
    assert fcfs.preemption_victim(reqs).rid == 2
    assert sjf.preemption_victim(reqs).rid == 0

    @register_policy("toy_lifo")
    class Lifo:
        name = "toy_lifo"

        def admission_order(self, waiting):
            return sorted(waiting, key=lambda r: -r.arrival_step)

        def preemption_victim(self, running):
            return running[0]

    try:
        s = Scheduler(max_batch=2, policy="toy_lifo")
        for r in reqs:
            s.add(r)
        assert [r.rid for r in s.admissible(now_step=5)] == [2, 1]
    finally:
        unregister_policy("toy_lifo")
    with pytest.raises(KeyError, match="unknown serve policy 'nope'"):
        get_policy("nope")


def test_sjf_engine_equals_reference(toy_params):
    cfg, jcfg, host, params = toy_params
    trace = [{"prompt": [3, 1], "max_new_tokens": 6},
             {"prompt": [2, 7], "max_new_tokens": 2},
             {"prompt": [5], "max_new_tokens": 4}]
    kw = dict(max_batch=2, max_seq=16, num_blocks=12, block_size=2,
              policy="sjf")
    eng = _engine(cfg, params, **kw)
    jeng = JServeEngine(jcfg, params=host, **kw)
    assert eng.serve(trace) == jeng.serve(trace)
    assert eng.timeline().to_jsonable() == jeng.timeline().to_jsonable()


def test_timeline_replays_through_the_sim(toy_params):
    cfg, _, _, params = toy_params
    eng = _engine(cfg, params, **STAGGERED["kw"])
    outputs = eng.serve(STAGGERED["trace"])
    tl = eng.timeline()
    d = tl.to_jsonable()
    assert d["total_new_tokens"] == sum(len(v) for v in outputs.values())
    admitted = {rid: s["step"] for s in d["steps"] for rid in s["admitted"]}
    assert admitted[0] == 0 and admitted[1] >= 1 and admitted[2] >= 2
    rep = eng.simulate(topology="cxl_switched", step_compute_s=1e-4)
    assert rep.num_launches == tl.num_steps
    assert rep.step_time_s >= tl.num_steps * 1e-4
    assert math.isclose(sum(x.wire_bytes for x in rep.launches),
                        tl.total_wire_bytes)
    assert all(x.start_s >= x.ready_s for x in rep.launches)
