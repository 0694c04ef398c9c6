"""Serving on a process mesh: the port's layouts against the reference's.

  * ``cache_pspecs`` and ``serve_shardings`` equal the reference's after
    sanitizing (the reference's on an ``AbstractMesh``) for the dense,
    MoE, SSM, hybrid and encoder-decoder SMOKE configs, on meshes (2, 2)
    and (4, 1), a batch the data ranks divide and a batch of 1, a
    ``max_seq`` the sharded axes divide and one they do not.  A
    one-axis entry compares equal to its axis name, as ``PartitionSpec``
    holds it;
  * one spawn of four gloo ranks (``torch.set_num_threads(1)``, a
    ``file://`` store, 60 s collective timeouts) runs every layout,
    teacher-forced on seeded tokens, and rank 0 the one-device path on
    the same parameters:

      - qwen3 and gemma3 (sliding-window layers, decoded past their
        window) on (2, 2): batched (batch 4) and ``shard_seq`` (batch 1,
        and 3 with a (B,) position), with a scalar and with a (B,)
        position; qwen3's batched case also through the mesh's
        ``build_cached_prefill``;
      - deepseek-moe (capacity factor 0.25, so that the 16-token step
        puts an expert past its capacity), hymba, xLSTM and whisper on
        (4, 1), batched, and hymba, xLSTM and whisper ``shard_seq``;
      - deepseek-moe on (2, 2), batched: its experts over the model ranks
        (the input gathered over the data ranks, then expert-parallel),
        and qwen2.5 with 6 query and 2 KV heads on (1, 4), batched: 48 of
        192 query columns a rank, 1.5 heads in GQA groups of 3, as
        qwen2.5-14B's 40 heads on 16 ranks;

    every rank's logits (the whole (B, V), replicated) within ``TOL`` of
    the one-device path's (float32 sums in another order: the combine of
    partial softmaxes, the tensor-parallel sums), the caches' blocks
    assembled into the one-device cache to the same tolerance; for the
    dense (2, 2) cases, also within ``TOL`` of the reference's jitted
    ``build_serve_step(cfg, mesh)`` on four forced host devices in one
    JAX subprocess (weights carried across by ``params_from_jax``); the
    MoE batch overflows and a dispatch of each rank's rows alone parts
    from the one-device path by O(1); the collectives of one step by op
    (qwen3's, and the expert-parallel step's);
    ``build_prefill`` (the forward, the batch over the data ranks) within
    ``TOL`` of the one-device forward for qwen3 on (2, 2) and
    deepseek-moe on (4, 1).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import cache_pspecs as j_cache_pspecs  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.runtime.serve import \
    serve_shardings as j_serve_shardings  # noqa: E402
from repro.runtime.shardings import \
    sanitize_pspecs as j_sanitize_pspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.models import SHAPES_BY_NAME, cache_pspecs  # noqa: E402
from repro_torch.runtime.serve import serve_shardings  # noqa: E402
from repro_torch.runtime.shardings import block_slices  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
SPAWN_TIMEOUT = 300
#: a mesh layout's logits and caches against the one-device path and the
#: reference's mesh step: float32 SMOKE models, sums in another order
TOL = 1e-5
SPEC_ARCHS = ("qwen3_0p6b", "deepseek_moe_16b", "xlstm_125m", "hymba_1p5b",
              "whisper_tiny")
DENSE = ("qwen3_0p6b", "gemma3_27b")
#: name -> (arch, mesh, batch, max_seq, steps, row offsets or None)
CASES = {}
for _arch in DENSE:
    _tag = _arch.split("_")[0]
    CASES.update({
        f"{_tag}/batched": (_arch, (2, 2), 4, 16, 12, None),
        f"{_tag}/batched/rows": (_arch, (2, 2), 4, 16, 12, (0, 3, 1, 2)),
        f"{_tag}/seq": (_arch, (2, 2), 1, 16, 12, None),
        f"{_tag}/seq/rows": (_arch, (2, 2), 3, 16, 12, (2, 0, 3)),
    })
CASES.update({
    "moe/batched": ("deepseek_moe_16b", (4, 1), 16, 8, 4, None),
    "hymba/batched": ("hymba_1p5b", (4, 1), 8, 24, 20, None),
    "hymba/seq": ("hymba_1p5b", (4, 1), 1, 24, 20, None),
    "xlstm/batched": ("xlstm_125m", (4, 1), 8, 8, 6, None),
    "xlstm/seq": ("xlstm_125m", (4, 1), 1, 8, 6, None),
    "whisper/batched": ("whisper_tiny", (4, 1), 8, 8, 6, None),
    "whisper/seq": ("whisper_tiny", (4, 1), 1, 8, 6, None),
    "moe/ep": ("deepseek_moe_16b", (2, 2), 16, 8, 4, None),
    "qwen2p5/columns": ("qwen2p5_14b:6h", (1, 4), 4, 16, 12, None),
})
#: SMOKE configs changed by name: ``arch:variant``
VARIANTS = {"6h": {"num_heads": 6, "num_kv_heads": 2}}
#: the cases the reference's own mesh step runs
REF_CASES = {k: v for k, v in CASES.items() if v[0] in DENSE}
#: prompt length of qwen3's batched case through the cached prefill
PREFILL = 6
MOE_CAPACITY_FACTOR = 0.25


def _config(arch: str):
    """A SMOKE config by name, ``arch:variant`` changed by ``VARIANTS``."""
    base, _, variant = arch.partition(":")
    cfg = get_config(base, smoke=True)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


def _norm(spec) -> tuple:
    """A spec as a tuple of entries, a one-axis tuple as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in (spec or ()))


def _jspecs(tree) -> list:
    return [_norm(tuple(s)) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)]


def _jshardings(tree) -> list:
    return [_norm(tuple(s.spec)) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def test_shapes_by_name():
    assert SHAPES_BY_NAME["long_500k"].global_batch == 1
    assert SHAPES_BY_NAME["decode_32k"].seq_len == 32768
    assert list(SHAPES_BY_NAME) == ["train_4k", "prefill_32k", "decode_32k",
                                    "long_500k"]


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_cache_pspecs_equal_the_references(arch, shard_seq):
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    for dp in (("data",), ("pod", "data")):
        got = [_norm(s) for s in T.leaves(cache_pspecs(
            cfg, shard_seq=shard_seq, dp_axes=dp))]
        assert got == _jspecs(j_cache_pspecs(jcfg, shard_seq=shard_seq,
                                             dp_axes=dp)), (arch, dp)


@pytest.mark.parametrize("max_seq", [16, 6])
@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_serve_shardings_equal_the_references(arch, mesh, batch, max_seq):
    """The token spec, ``shard_seq`` and the sanitized cache specs, and
    the reference's ``sanitize_pspecs`` of its ``cache_pspecs`` on the
    cache's shapes, leaf for leaf."""
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    extents = {"data": mesh[0], "model": mesh[1]}
    amesh = AbstractMesh(mesh, ("data", "model"))
    got = serve_shardings(cfg, extents, batch=batch, max_seq=max_seq)
    want = j_serve_shardings(jcfg, amesh, batch=batch, max_seq=max_seq)
    assert got["shard_seq"] == want["shard_seq"] == (batch % mesh[0] != 0)
    assert _norm(got["token"]) == _norm(tuple(want["token"].spec))
    specs = [_norm(s) for s in T.leaves(got["cache"])]
    assert specs == _jshardings(want["cache"]), (arch, mesh, batch, max_seq)
    jlike = jax.eval_shape(lambda: j_init_cache(jcfg, batch, max_seq))
    direct = j_sanitize_pspecs(j_cache_pspecs(
        jcfg, shard_seq=got["shard_seq"], dp_axes=("data",)), jlike, amesh)
    assert specs == _jspecs(direct)


def test_a_sequence_the_mesh_does_not_divide_is_replicated():
    cfg = get_config("qwen3_0p6b", smoke=True)
    sh = serve_shardings(cfg, {"data": 2, "model": 2}, batch=1, max_seq=6)
    assert sh["shard_seq"] and sh["cache"]["k"] == (None,) * 5
    sh = serve_shardings(cfg, {"data": 2, "model": 2}, batch=2, max_seq=6)
    assert sh["cache"]["k"] == (None, ("data",), "model", None, None)


def test_local_cache_is_the_block_shape():
    """``init_cache(..., mesh=)`` allocates one rank's block alone."""
    from repro_torch.models import init_cache
    cfg = get_config("hymba_1p5b", smoke=True)
    ext = {"data": 4, "model": 1}
    whole = init_cache(cfg, 8, 24, dtype=torch.float32, device="cpu")
    local = init_cache(cfg, 8, 24, dtype=torch.float32, device="cpu",
                       mesh=ext)
    assert local["k"].shape == (2, 2, 24, 2, 16)
    assert local["ssm"].shape == (2, 2) + tuple(whole["ssm"].shape[2:])
    seq = init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu", mesh=ext)
    assert seq["k"].shape == (2, 1, 6, 2, 16)
    x = init_cache(get_config("xlstm_125m", smoke=True), 8, 8, device="cpu",
                   mesh=ext)
    for blk in x["blocks"]:
        for t in T.leaves(blk):
            assert t.shape[0] == 2
    assert bool((x["blocks"][3]["slstm"]["n"] == 1).all())


# ---------------------------------------------------------------------------
# the spawn
# ---------------------------------------------------------------------------

def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env["PYTHONPATH"] = SRC
    env.update({k: str(v) for k, v in extra.items()})
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's parameters and its jitted mesh step on the dense
    (2, 2) cases, in one JAX subprocess on four forced host devices."""
    out = tmp_path_factory.mktemp("serve_mesh_ref") / "ref.npz"
    env = _env(OUT_FILE=out, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=1)
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_PROGRAM % {"cases": REF_CASES,
                                                    "dense": DENSE}],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, reference):
    out = tmp_path_factory.mktemp("serve_mesh") / "out"
    out.mkdir()
    logs = [open(out / f"rank{r}.log", "w") for r in range(4)]
    program = RANK_PROGRAM % {"cases": CASES, "dense": DENSE,
                              "prefill": PREFILL,
                              "cf": MOE_CAPACITY_FACTOR,
                              "variants": VARIANTS}
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", program],
            env=_env(WORLD_SIZE=4, RANK=r, OUT_DIR=out, REF_FILE=reference,
                     OMP_NUM_THREADS=1),
            stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=SPAWN_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        text = (out / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r}:\n{text[-4000:]}"
    ranks = []
    for r in range(4):
        with np.load(out / f"rank{r}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(out / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    with np.load(reference) as data:
        ref = {k: data[k] for k in data.files if k.startswith("logits/")}
    return ranks, ref


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} over {TOL} x {scale}"
    return err


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_logits_equal_the_one_device_path(world, case):
    ranks, _ = world
    want = ranks[0][0][f"{case}/one"]
    assert np.isfinite(want).all()
    for r, (arrays, _) in enumerate(ranks):
        _close(arrays[f"{case}/mesh"], want, f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_mesh_logits_equal_the_references_mesh_step(world, case):
    ranks, ref = world
    want = ref[f"logits/{case}"]
    for r, (arrays, _) in enumerate(ranks):
        _close(arrays[f"{case}/mesh"], want, f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(k for k, v in CASES.items()
                                        if v[0] != "xlstm_125m"))
def test_cache_blocks_assemble_the_one_device_cache(world, case):
    """Each rank's K and V blocks, placed by the sanitized specs, rebuild
    the one-device cache (every position written once, by its owner)."""
    ranks, _ = world
    arch, mesh, batch, max_seq, _, _ = CASES[case]
    cfg = _config(arch)
    specs = serve_shardings(cfg, {"data": mesh[0], "model": mesh[1]},
                            batch=batch, max_seq=max_seq)["cache"]
    extents = {"data": mesh[0], "model": mesh[1]}
    for key in ("k", "v"):
        want = ranks[0][0][f"{case}/one/cache/{key}"]
        got = np.full(want.shape, np.nan, np.float32)
        for r, (arrays, _) in enumerate(ranks):
            coords = {"data": r // mesh[1], "model": r % mesh[1]}
            got[block_slices(want.shape, specs[key], extents, coords)] = \
                arrays[f"{case}/cache/{key}"]
        _close(got, want, f"{case} {key}")


def test_prefill_through_the_mesh_step(world):
    ranks, _ = world
    want = ranks[0][0]["prefill/one"]
    for arrays, _ in ranks:
        _close(arrays["prefill/mesh"], want, "prefill")


@pytest.mark.parametrize("tag", ["qwen3", "moe"])
def test_build_prefill_is_the_forward(world, tag):
    """qwen3 on (2, 2) (heads, MLP and vocabulary over the model ranks),
    deepseek-moe on (4, 1) (32 tokens a rank: whole dispatch groups)."""
    ranks, _ = world
    want = ranks[0][0][f"forward/{tag}/one"]
    for arrays, _ in ranks:
        _close(arrays[f"forward/{tag}/mesh"], want, f"forward {tag}")


def test_moe_batch_overflows_and_needs_the_whole_dispatch(world):
    """The 16-token step puts an expert past its capacity: the mesh path
    (the input gathered over the data ranks) keeps to the one-device
    path, and a dispatch of each rank's 4 rows alone parts from it."""
    ranks, _ = world
    info = ranks[0][1]
    load, cap = info["moe/batched/overflow"]
    assert load > cap
    one = ranks[0][0]["moe/batched/one"]
    per_rank = ranks[0][0]["moe/batched/per_rank"]
    assert float(np.abs(per_rank - one).max()) > 1e-2


def test_collectives_of_a_step(world):
    """One decode step's calls by op: qwen3's batched (2, 2) step gathers
    the heads and the partial softmaxes over the model group (two
    all_gathers a layer), sums the row-parallel wo and MLP outputs over
    it (two all_reduces a layer, and the embedding's), gathers the
    vocabulary over it and the rows over the data group; ``shard_seq``
    gathers the partials over the world."""
    ranks, _ = world
    layers = get_config("qwen3_0p6b", smoke=True).num_layers
    for _, info in ranks:
        b = info["qwen3/batched/calls"]
        assert b["model"] == {"all_gather": 2 * layers + 1,
                              "all_reduce": 2 * layers + 1}
        assert b["data"] == {"all_gather": 1}
        assert b["world"] == {}
        s = info["qwen3/seq/calls"]
        assert s["model"] == {"all_gather": layers + 1,
                              "all_reduce": 2 * layers + 1}
        assert s["world"] == {"all_gather": layers}
        assert s["data"] == {}


def test_collectives_of_an_expert_parallel_step(world):
    """deepseek-moe's batched (2, 2) step, 3 layers (one dense, two
    MoE): a layer's heads and partials gathered over the model group and
    its attention summed, the dense layer's MLP summed, a MoE layer's
    input gathered over the data group and its routed and shared experts
    summed over the model group, the embedding summed and the vocabulary
    gathered; the logits' rows over the data group."""
    ranks, _ = world
    layers = get_config("deepseek_moe_16b", smoke=True).num_layers
    moe = layers - 1
    for _, info in ranks:
        b = info["moe/ep/calls"]
        assert b["model"] == {"all_gather": 2 * layers + 1,
                              "all_reduce": layers + 1 + 2 * moe + 1}
        assert b["data"] == {"all_gather": moe + 1}
        assert b["world"] == {}


REFERENCE_PROGRAM = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import init_cache, init_params
from repro.runtime.serve import build_serve_step

CASES, DENSE = %(cases)r, %(dense)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}


def name(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


with jax.set_mesh(mesh):
    for arch in DENSE:
        params = init_params(jax.random.PRNGKey(0),
                             get_config(arch, smoke=True))
        for kp, a in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"params/{arch}/" + name(kp)] = np.asarray(a)
    for case, (arch, _, b, s, n, offs) in CASES.items():
        cfg = get_config(arch, smoke=True)
        params = init_params(jax.random.PRNGKey(0), cfg)
        step, sh = build_serve_step(cfg, mesh, batch=b, max_seq=s,
                                    dp_axes=("data",), donate=False)
        params = jax.device_put(params, sh["params"])
        cache = jax.device_put(init_cache(cfg, b, s, dtype=jnp.float32),
                               sh["cache"])
        toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, n))
        rows = []
        for i in range(n):
            tok = jax.device_put(jnp.asarray(toks[:, i:i + 1], jnp.int32),
                                 sh["token"])
            pos = (jnp.int32(i) if offs is None else
                   jnp.asarray(i + np.asarray(offs), jnp.int32))
            logits, cache = step(params, tok, cache, pos)
            rows.append(np.asarray(logits))
        out[f"logits/{case}"] = np.stack(rows)
np.savez(os.environ["OUT_FILE"], **out)
'''

RANK_PROGRAM = r'''
import dataclasses, json, os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
WORLD, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT = os.environ["OUT_DIR"]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=WORLD, timeout=timedelta(seconds=60))

import repro_torch.models.layers as L
from repro_torch.configs import get_config
from repro_torch.core import ProcessMesh
from repro_torch.core import tree as T
from repro_torch.models import init_cache, init_params, params_from_jax
from repro_torch.models.transformer import shard_params
from repro_torch.models import forward
from repro_torch.runtime.serve import (build_cached_prefill, build_prefill,
                                       build_serve_step)

CASES, DENSE = %(cases)r, %(dense)r
PREFILL, CF, VARIANTS = %(prefill)r, %(cf)r, %(variants)r
with np.load(os.environ["REF_FILE"]) as f:
    REF = {k: f[k] for k in f.files if k.startswith("params/")}
meshes = {shape: ProcessMesh(shape, device="cpu")
          for shape in sorted({case[1] for case in CASES.values()})}
arrays, info = {}, {}


def config(arch):
    base, _, variant = arch.partition(":")
    cfg = get_config(base, smoke=True)
    if variant:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    return cfg


def whole_params(arch, cfg):
    if arch in DENSE:
        prefix = f"params/{arch}/"
        return params_from_jax(T.unflatten([
            (k[len(prefix):], v) for k, v in REF.items()
            if k.startswith(prefix)]), device="cpu")
    return init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")


def position(i, offs):
    return i if offs is None else torch.tensor([i + o for o in offs])


def decode(step, params, cache, toks, offs, start=0):
    rows = []
    for i in range(start, toks.shape[1]):
        logits, cache = step(params, toks[:, i:i + 1], cache,
                             position(i, offs))
        rows.append(logits.numpy())
    return rows, cache


def keep_cache(prefix, cache):
    if "k" in cache:
        arrays[prefix + "/k"] = cache["k"].numpy()
        arrays[prefix + "/v"] = cache["v"].numpy()


moe_inputs = []
real_moe = L.moe_forward


def recording_moe(p, x, cfg, tp=None):
    moe_inputs.append((p["router"], x))
    return real_moe(p, x, cfg, tp=tp)


def overflow(cfg):
    """The largest expert load of a recorded MoE call, and the capacity."""
    worst, cap = 0, 0
    for router, x in moe_inputs:
        m = cfg.moe
        t = x.shape[0] * x.shape[1]
        gs = min(m.group_size, t)
        xg = x.reshape(-1, gs, x.shape[-1]).to(torch.float32)
        gates = torch.softmax(xg @ router, dim=-1)
        _, topi = L._top_k(gates, m.top_k)
        counts = torch.nn.functional.one_hot(topi, m.num_experts).sum((1, 2))
        worst = max(worst, int(counts.max()))
        cap = min(max(4, int(gs * m.top_k / m.num_experts
                             * m.capacity_factor)), gs)
    return [worst, cap]


for case, (arch, shape, b, s, n, offs) in CASES.items():
    mesh = meshes[shape]
    cfg = config(arch)
    whole = whole_params(arch, cfg)
    params = T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (b, n)))
    step, sh = build_serve_step(cfg, mesh, batch=b, max_seq=s)
    cache = init_cache(cfg, b, s, dtype=torch.float32, device="cpu",
                       mesh=mesh)
    rows, cache = decode(step, params, cache, toks[:, :1], offs)
    mesh.reset_counts()
    more, cache = decode(step, params, cache, toks[:, :2], offs, start=1)
    info[f"{case}/calls"] = {
        name: dict(g.calls_by_op) for name, g in
        (("data", mesh.data_group), ("model", mesh.model_group),
         ("world", mesh.world))}
    rest, cache = decode(step, params, cache, toks, offs, start=2)
    arrays[f"{case}/mesh"] = np.stack(rows + more + rest)
    keep_cache(f"{case}/cache", cache)
    if R == 0:
        one, _ = build_serve_step(cfg, batch=b, max_seq=s)
        moe_inputs.clear()
        L.moe_forward = recording_moe
        rows, cache1 = decode(one, whole, init_cache(
            cfg, b, s, dtype=torch.float32, device="cpu"), toks, offs)
        L.moe_forward = real_moe
        arrays[f"{case}/one"] = np.stack(rows)
        keep_cache(f"{case}/one/cache", cache1)
        if cfg.moe is not None:
            info[f"{case}/overflow"] = overflow(cfg)
            # each data rank's rows dispatched alone
            per = []
            k = b // shape[0]
            for d in range(shape[0]):
                rows, _ = decode(one, whole, init_cache(
                    cfg, k, s, dtype=torch.float32, device="cpu"),
                    toks[d * k:(d + 1) * k], offs)
                per.append(np.stack(rows))
            arrays[f"{case}/per_rank"] = np.concatenate(per, axis=1)

# qwen3's batched case through the mesh's cached prefill
arch, shape, b, s, n, _ = CASES["qwen3/batched"]
mesh, cfg = meshes[shape], config(arch)
whole = whole_params(arch, cfg)
params = T.map_leaves(torch.Tensor.clone, shard_params(
    whole, cfg, mesh.extents, mesh.coords))
toks = torch.from_numpy(np.random.RandomState(1).randint(
    0, cfg.vocab_size, (b, n)))


def prefilled(prefill, step, params, cache):
    first, cache = prefill(params, toks, PREFILL, cache)
    rows, _ = decode(step, params, cache, toks, None, start=PREFILL)
    return np.stack([first.numpy()] + rows)


arrays["prefill/mesh"] = prefilled(
    build_cached_prefill(cfg, mesh, batch=b, max_seq=s),
    build_serve_step(cfg, mesh, batch=b, max_seq=s)[0], params,
    init_cache(cfg, b, s, dtype=torch.float32, device="cpu", mesh=mesh))
if R == 0:
    arrays["prefill/one"] = prefilled(
        build_cached_prefill(cfg), build_serve_step(cfg, batch=b,
                                                    max_seq=s)[0],
        whole, init_cache(cfg, b, s, dtype=torch.float32, device="cpu"))

# the batched prefill: the forward with the batch over the data ranks
for tag, (arch, shape, b, s) in {
        "qwen3": ("qwen3_0p6b", (2, 2), 4, 8),
        "moe": ("deepseek_moe_16b", (4, 1), 4, 32)}.items():
    mesh, cfg = meshes[shape], config(arch)
    whole = whole_params(arch, cfg)
    params = T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))
    batch = {"tokens": torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, s)))}
    arrays[f"forward/{tag}/mesh"] = build_prefill(cfg, mesh)(
        params, batch).numpy()
    if R == 0:
        with torch.no_grad():
            arrays[f"forward/{tag}/one"] = forward(whole, cfg, batch).numpy()
np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
dist.destroy_process_group()
'''
