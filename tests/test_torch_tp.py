"""The port's tensor parallelism against the reference's, on the CPU.

  * the partition-spec trees of all ten configs equal the reference's
    ``sanitize_pspecs(param_pspecs(cfg), ...)`` at meshes (2, 2) and
    (2, 4), and block ``k`` of every spec is the block the reference's
    ``shard_map`` hands the device at those coordinates;
  * the families and codecs the port does not run on a model axis raise
    by name;
  * one spawn of four gloo ranks (``torch.set_num_threads(1)``, a
    ``file://`` store, 60 s collective timeouts) beside one JAX
    subprocess on four forced host devices (the reference's parameters,
    its per-shard votes and its Trainer on a ``("data", "model")`` mesh of
    (2, 2)).  The ranks build a :class:`ProcessMesh` of (2, 2), then one
    of (1, 4) on the same world, and the parent compares:

      - the dense SMOKE models (qk-norm, qkv bias, GELU, local/global
        layers), from the reference's parameters: logits (gathered over
        the vocabulary) equal the unsharded port's to rtol 1e-5 / atol
        1e-5 (as the model tests hold them), the loss to rtol 1e-5,
        every gradient block to rtol 1e-4 / atol 1e-5 (``wk`` / ``wv`` and
        the qk-norm scales included, which sum over the model group);
      - the packed vote of a tensor-parallel leaf (G-Binary, G-Ternary and
        EF, fused and staged) byte-equal to the reference's per-shard
        vote (``_packed_a2a_local`` on each block, the body of
        ``lowbit_packed_a2a``'s inner ``shard_map``; G-Binary also
        through ``lowbit_packed_a2a(model_spec=...)`` itself), and
        ``vote_psum`` on it byte-equal to the reference's vote on the
        GSPMD leaf (as numbers: zeros of either sign as zeros, the jitted
        gate's +0.0); the G-Ternary and EF per-shard results differ from the
        unsharded ones, the ``vote_psum`` ones do not; EF residuals are
        held as elsewhere, to 1e-6 of beta;
      - two gbin_packed Trainer steps at (2, 2), each started from the
        reference Trainer's parameters: losses within rtol 1e-5 of the
        reference's, every step's aggregates equal to the per-shard twin
        (``VirtualGroup(2)`` on each block of the gathered gradients;
        FP32 means as numbers, zeros of either sign as zeros), replicated
        leaves equal on all four ranks and blocks on both data ranks, the
        traffic ratio priced on the whole leaves and the aggregates'
        norm the whole model's (to rtol 1e-5); the paper controller's
        cosines from a random tree's blocks equal the whole tree's, and
        three steps under it admit as ``Fabric(num_workers=2)`` does on
        the unsharded model;
      - ``remat_policy="dots"`` against ``"full"``: the same gradients,
        and exactly one model-group all-reduce fewer a layer (the
        attention's, which the full recompute runs again; it stops before
        the MLP's, which the backward does not need).
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import param_pspecs as j_param_pspecs  # noqa: E402
from repro.runtime.shardings import \
    sanitize_pspecs as j_sanitize_pspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import (LeafPolicy, Schedule, VirtualGroup,  # noqa: E402
                              lowbit_packed_a2a)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import (AggregationContext, aggregate_leaf,  # noqa: E402
                                plan_presets)
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.models.transformer import param_pspecs  # noqa: E402
from repro_torch.runtime.shardings import (block_slices,  # noqa: E402
                                           local_shape, place,
                                           sanitize_pspecs, shard_of)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: seconds a spawn may take before it is killed
SPAWN_TIMEOUT = 300
#: the dense SMOKE configs run tensor-parallel
DENSE = ("qwen3_0p6b", "qwen2p5_14b", "gemma3_27b", "starcoder2_15b")
MESHES = ((2, 2), (1, 4))
#: the vote cases on one tensor-parallel leaf: (schedule, ternary, EF)
VOTES = {"packed/gbinary": ("packed_a2a", False, False),
         "packed/gternary": ("packed_a2a", True, False),
         "packed/gbinary/ef": ("packed_a2a", False, True),
         "packed/gternary/ef": ("packed_a2a", True, True),
         "vote/gternary": ("vote_psum", True, False),
         "vote/gbinary/ef": ("vote_psum", False, True),
         "vote/gternary/ef": ("vote_psum", True, True)}
LEAF = (77, 260)                          # sharded over its columns
TRAIN = dict(seq=16, batch=8, lr=1e-3)


def _jtree_specs(tree) -> list:
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)]


# ---------------------------------------------------------------------------
# spec trees and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_references(arch, mesh):
    """Leaf for leaf, the unsanitized and the sanitized specs (FULL
    shapes; the SMOKE shapes too, where small dimensions replicate)."""
    extents = {"data": mesh[0], "model": mesh[1]}
    fake = types.SimpleNamespace(shape=extents)
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), j_get_config(arch, smoke)
        like = init_params(cfg, device="meta")
        jlike = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                     jcfg))
        assert T.leaves(param_pspecs(cfg)) == \
            _jtree_specs(j_param_pspecs(jcfg))
        got = T.leaves(sanitize_pspecs(param_pspecs(cfg), like, extents))
        want = _jtree_specs(j_sanitize_pspecs(j_param_pspecs(jcfg), jlike,
                                              fake))
        assert got == want, arch


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX side, run once: blocks, per-shard votes, parameters and
    the (2, 2) Trainer."""
    out = tmp_path_factory.mktemp("tp_ref") / "ref.npz"
    proc = _start_reference(out)
    return _finish_reference(proc, out)


def _start_reference(out):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(SRC=SRC, OUT_FILE=str(out), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    program = REFERENCE_PROGRAM % {"dense": DENSE, "votes": VOTES,
                                   "leaf": LEAF, "train": TRAIN}
    return subprocess.Popen([sys.executable, "-c", program], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish_reference(proc, out) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, stderr[-4000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("name", ["cols", "rows", "both", "dm"])
def test_blocks_are_the_shard_map_blocks(name, reference):
    """``shard_of`` at coordinates (d, m) of a (2, 2) mesh is the block
    ``jax.shard_map`` hands the device there."""
    specs = {"cols": (None, "model"), "rows": ("model", None),
             "both": (("data", "model"),), "dm": ("data", "model")}
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    extents = {"data": 2, "model": 2}
    for d in range(2):
        for m in range(2):
            got = shard_of(x, specs[name], extents, {"data": d, "model": m})
            np.testing.assert_array_equal(
                got, reference[f"blocks/{name}/{d}/{m}"])


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None),
                                  (("data", "model"),), ("data", "model"),
                                  ()])
def test_place_inverts_shard_of(spec):
    """Every rank's block, placed back, rebuilds the whole array; each
    block has the spec's local shape."""
    extents = {"data": 2, "model": 2}
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    out = np.full_like(x, np.nan)
    for d in range(2):
        for m in range(2):
            coords = {"data": d, "model": m}
            blk = shard_of(x, spec, extents, coords)
            assert blk.shape == local_shape(x.shape, spec, extents)
            place(out, blk, spec, extents, coords)
    np.testing.assert_array_equal(out, x)


# ---------------------------------------------------------------------------
# what a model axis does not run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e",
                                  "phi3_vision_4p2b", "xlstm_125m",
                                  "hymba_1p5b", "whisper_tiny"])
def test_families_without_tensor_parallelism_raise(arch):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, device="meta")
    tp = types.SimpleNamespace(size=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        forward(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                tp)


@pytest.mark.parametrize("mode", ["int4", "topk"])
def test_mean_codecs_raise_on_a_tensor_parallel_leaf(mode):
    ctx = AggregationContext(group=VirtualGroup(2), num_workers=2)
    pol = LeafPolicy(mode, Schedule.PSUM, model_spec=(None, "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        aggregate_leaf(ctx, torch.ones(2, 4, 8), pol)


def test_packed_vote_refuses_a_gate_mask_on_a_tensor_parallel_leaf():
    with pytest.raises(ValueError, match="fully local payload"):
        lowbit_packed_a2a(torch.ones(2, 64), VirtualGroup(2), 2,
                          model_spec=(None, "model"), ternary=True,
                          gate_mask=np.ones(64, bool))


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


def spawn_ranks(program: str, world: int, out, timeout: int = SPAWN_TIMEOUT,
                **extra) -> list:
    """Run ``program`` on ``world`` gloo ranks (``RANK``, ``WORLD_SIZE``
    and ``OUT_DIR`` in the environment); each rank writes
    ``rank{r}.npz`` and ``rank{r}.json`` to ``out``.  Returns
    ``[(arrays, info), ...]`` by rank."""
    out.mkdir(exist_ok=True)
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", program],
            env=_env(WORLD_SIZE=world, RANK=r, OUT_DIR=out,
                     OMP_NUM_THREADS=1, **extra),
            stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
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
        assert p.returncode == 0, f"rank {r} of {world}:\n{text[-4000:]}"
    ranks = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(out / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


@pytest.fixture(scope="module")
def world(tmp_path_factory, reference):
    ref = tmp_path_factory.mktemp("tp_ref_copy") / "ref.npz"
    np.savez(ref, **reference)
    out = tmp_path_factory.mktemp("tp") / "out"
    return spawn_ranks(RANK_PROGRAM % {"dense": DENSE, "votes": VOTES,
                                       "leaf": LEAF, "train": TRAIN},
                       4, out, REF_FILE=ref)


def _coords(mesh, r):
    return {"data": r // mesh[1], "model": r % mesh[1]}


def _assemble(world, key, spec, mesh, full_shape, lead=0):
    """The whole array from each rank's block ``key`` (blocks at
    coordinates that share a block must agree)."""
    out = np.full(full_shape, np.nan, np.float32)
    extents = {"data": mesh[0], "model": mesh[1]}
    for r, (arrays, _) in enumerate(world):
        sl = block_slices(full_shape[lead:], spec, extents, _coords(mesh, r))
        sl = (slice(None),) * lead + sl
        blk = arrays[key]
        prev = out[sl]
        seen = ~np.isnan(prev)
        assert np.array_equal(prev[seen], blk[seen]), (key, r)
        out[sl] = blk
    return out


def test_process_mesh_lays_ranks_out_as_jax_make_mesh(world):
    for r, (_, info) in enumerate(world):
        for mesh in MESHES:
            tag = f"{mesh[0]}x{mesh[1]}"
            assert info[f"{tag}/coords"] == _coords(mesh, r)
            assert info[f"{tag}/data_group"] == [r // mesh[1], mesh[0]]
            assert info[f"{tag}/model_group"] == [r % mesh[1], mesh[1]]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_logits_and_loss_equal_the_unsharded_model(world, arch, mesh):
    tag = f"{mesh[0]}x{mesh[1]}"
    full = world[0][0][f"full/{arch}/logits"]
    cfg = get_config(arch, smoke=True)
    vocab_split = cfg.vocab_size % mesh[1] == 0
    logits = _assemble(world, f"{tag}/{arch}/logits",
                       (None, None, "model") if vocab_split else (),
                       mesh, full.shape)
    np.testing.assert_allclose(logits, full, rtol=1e-5, atol=1e-5)
    for arrays, _ in world:
        np.testing.assert_allclose(arrays[f"{tag}/{arch}/loss"],
                                   world[0][0][f"full/{arch}/loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_gradients_equal_the_unsharded_model(world, arch, mesh):
    tag = f"{mesh[0]}x{mesh[1]}"
    cfg = get_config(arch, smoke=True)
    like = init_params(cfg, device="meta")
    extents = {"data": mesh[0], "model": mesh[1]}
    specs = sanitize_pspecs(param_pspecs(cfg), like, extents)
    for (p, x), spec in zip(T.flatten(like), T.leaves(specs)):
        want = world[0][0][f"full/{arch}/grad/{p}"]
        got = _assemble(world, f"{tag}/{arch}/grad/{p}", spec, mesh,
                        tuple(x.shape))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{tag} {arch} {p}")


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", sorted(VOTES))
def test_tensor_parallel_votes_equal_the_references(world, reference, case):
    sched, _, ef = VOTES[case]
    want = reference[f"lowbit/{case}/u"]
    got = _assemble(world, f"lowbit/{case}/u", (None, "model"), (2, 2),
                    LEAF)
    if sched == "vote_psum":
        # as numbers: the reference's jitted ``sign * gate`` comes out of
        # XLA as a select that writes +0.0 where the port's product gives
        # -0.0 (ROADMAP, known differences)
        assert _numbers(got, want), case
    else:
        assert _same_bits(got, want), case
    if sched == "packed_a2a":
        staged = _assemble(world, f"lowbit/{case}/staged/u",
                           (None, "model"), (2, 2), LEAF)
        assert _same_bits(staged, want), case
    if not ef:
        return
    ref_ef = reference[f"lowbit/{case}/ef"]
    new_ef = _assemble(world, f"lowbit/{case}/ef", ("data", None, "model"),
                       (2, 2), (2, *LEAF))
    # e' = x - beta * sgn(x): the FP32 mean beta may differ by rtol 1e-6
    x = reference["lowbit/grads"] + reference["lowbit/efs"]
    per = x.reshape(2, LEAF[0], 2, -1) if sched == "packed_a2a" else None
    beta = (np.abs(per).mean(axis=(1, 3)) if per is not None
            else np.abs(x).reshape(2, -1).mean(axis=1)[:, None])
    bound = np.repeat(beta, LEAF[1] // beta.shape[1], axis=1)[:, None, :]
    assert (np.abs(new_ef - ref_ef) <= 1e-6 * bound).all(), case


@pytest.mark.parametrize("case", sorted(VOTES))
def test_per_shard_semantics_are_the_references(world, case):
    """The packed vote of a block parts from the unsharded vote for
    G-Ternary (the gate restarts at each block) and EF (beta is the
    block's mean); ``vote_psum`` sees the whole leaf and does not."""
    sched, ternary, ef = VOTES[case]
    got = _assemble(world, f"lowbit/{case}/u", (None, "model"), (2, 2),
                    LEAF)
    whole = world[0][0][f"lowbit/{case}/unsharded/u"]
    if sched == "packed_a2a" and ternary:
        assert not _same_bits(got, whole)
    else:
        assert _same_bits(got, whole)
    if ef:
        # the whole leaf's beta: the unsharded residuals to 1e-6 of it
        new_ef = _assemble(world, f"lowbit/{case}/ef",
                           ("data", None, "model"), (2, 2), (2, *LEAF))
        whole_ef = world[0][0][f"lowbit/{case}/unsharded/ef"]
        x = np.abs(world[0][0]["lowbit/inputs"]).reshape(2, -1)
        beta = x.mean(axis=1).reshape(2, 1, 1)
        close = (np.abs(new_ef - whole_ef) <= 1e-6 * beta).all()
        assert close == (sched == "vote_psum")


def _numbers(a, b) -> bool:
    """Byte equality, zeros of either sign as zeros."""
    a, b = np.where(a == 0, 0, a), np.where(b == 0, 0, b)
    return _same_bits(a, b)


def test_trainer_losses_equal_the_reference_trainer(world, reference):
    """Losses, and the norm of the aggregates over the whole model (a
    block's squares summed over the model group), to rtol 1e-5."""
    for arrays, info in world:
        for k in range(2):
            np.testing.assert_allclose(info[f"trainer/{k}/loss"],
                                       reference[f"trainer/{k}/loss"],
                                       rtol=1e-5)
            np.testing.assert_allclose(info[f"trainer/{k}/agg_norm"],
                                       reference[f"trainer/{k}/agg_norm"],
                                       rtol=1e-5)
            assert info[f"trainer/{k}/traffic"] == pytest.approx(
                float(reference[f"trainer/{k}/traffic"]), rel=1e-12)


def test_trainer_aggregates_equal_the_per_shard_twin(world):
    """Each step's aggregate blocks against ``VirtualGroup(2)`` on each
    block of the two data ranks' gradients; the policies (and so which
    leaves vote per block) are the run's own."""
    cfg = get_config("qwen3_0p6b", smoke=True)
    plan = plan_presets()["gbin_packed"]
    from repro_torch.fabric import Fabric
    fab = Fabric(num_workers=2)
    info = world[0][1]
    for k in range(2):
        for r, (arrays, _) in enumerate(world):
            m = r % 2
            grads = T.unflatten([
                (p, torch.from_numpy(np.concatenate([
                    world[d * 2 + m][0][f"trainer/{k}/grads/{p}"]
                    for d in range(2)])))
                for p, _ in T.flatten(init_params(cfg, device="meta"))])
            pols = T.leaves(fab.resolve(
                T.map_leaves(lambda g: g[0], grads), plan))
            ctx = fab.context
            for (p, g), pol in zip(T.flatten(grads), pols):
                want, _ = aggregate_leaf(ctx, g, pol)
                got = arrays[f"trainer/{k}/agg/{p}"]
                assert _numbers(got, want.numpy()), (k, r, p)
    assert set(info["trainer/unfused"]) == {
        "layers/attn/wq", "layers/attn/wo", "layers/mlp/w_gate",
        "layers/mlp/w_up", "layers/mlp/w_down", "embed/tok", "head/w"}


def test_cosines_of_a_tensor_parallel_tree_are_the_whole_trees(world):
    """The paper controller's diagnostics from blocks (the gate at global
    flat indices, the sums added over the model group) against the same
    tree whole, to rtol 1e-5."""
    for _, info in world:
        for group, d in info["cos/whole"].items():
            for key, want in d.items():
                np.testing.assert_allclose(info["cos/tp"][group][key], want,
                                           rtol=1e-5, err_msg=group)


def test_paper_controller_on_the_mesh_admits_as_the_unsharded_run(world):
    """Three steps under ``paper`` (warm-up 1, packed schedule) at (2, 2)
    against ``Fabric(num_workers=2)`` on the unsharded model from the same
    seed: the step-0 loss and cosines (the diagnostics through the
    step's model-group sums) to rtol 1e-5, the same events and plans on
    every rank."""
    want = world[0][1]["paper/virtual"]
    assert any(e[1] == "admitted" for e in want["events"])
    for _, info in world:
        got = info["paper/tp"]
        assert got["events"] == want["events"]
        assert [h["plan"] for h in got["history"]] == \
            [h["plan"] for h in want["history"]]
        g0, w0 = got["history"][0], want["history"][0]
        cos = [k for k in w0 if k.startswith("cos/")]
        assert cos and sorted(cos) == sorted(k for k in g0
                                             if k.startswith("cos/"))
        for k in ["loss", *cos]:
            np.testing.assert_allclose(g0[k], w0[k], rtol=1e-5, err_msg=k)


def test_trainer_keeps_replicas_equal(world):
    """After each step, a replicated leaf is bit-equal on all four ranks
    and a block on both data ranks that hold it."""
    cfg = get_config("qwen3_0p6b", smoke=True)
    like = init_params(cfg, device="meta")
    specs = sanitize_pspecs(param_pspecs(cfg), like,
                            {"data": 2, "model": 2})
    for k in range(2):
        for (p, _), spec in zip(T.flatten(like), T.leaves(specs)):
            key = f"trainer/{k + 1}/params/{p}"
            blocks = [a[key] for a, _ in world]
            if all(e is None for e in spec):
                assert all(_same_bits(b, blocks[0]) for b in blocks), p
            else:
                for m in range(2):
                    assert _same_bits(blocks[m], blocks[2 + m]), p


def test_dots_gives_the_full_gradients_with_fewer_all_reduces(world):
    cfg = get_config("qwen3_0p6b", smoke=True)
    for arrays, info in world:
        for p, _ in T.flatten(init_params(cfg, device="meta")):
            np.testing.assert_array_equal(arrays[f"dots/dots/grad/{p}"],
                                          arrays[f"dots/full/grad/{p}"], p)
        full, dots = info["dots/full/all_reduce"], info["dots/dots/all_reduce"]
        assert full - dots == cfg.num_layers, (full, dots)
        assert info["dots/dots/forward"] == info["dots/full/forward"]


REFERENCE_PROGRAM = r'''
import functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.environ["SRC"])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import lowbit_packed_a2a, lowbit_vote_psum
from repro.core.lowbit import _packed_a2a_local
from repro.data import SyntheticLMStream
from repro.fabric.control import plan_presets
from repro.kernels import fused as KF
from repro.models import init_params
from repro.optim import AdamW
from repro.runtime import Trainer, TrainerConfig

DENSE, VOTES, LEAF, TRAIN = %(dense)r, %(votes)r, %(leaf)r, %(train)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}


def name(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def put(prefix, tree):
    for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + name(kp)] = np.asarray(a)


# the block shard_map hands the device at (d, m)
x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
for nm, spec in {"cols": P(None, "model"), "rows": P("model", None),
                 "both": P(("data", "model")), "dm": P("data", "model")}.items():
    blk = jax.shard_map(lambda a: a[None], mesh=mesh, in_specs=spec,
                        out_specs=P(("data", "model")), check_vma=False)
    got = np.asarray(jax.jit(blk)(jnp.asarray(x)))
    for d in range(2):
        for m in range(2):
            out[f"blocks/{nm}/{d}/{m}"] = got[d * 2 + m]

# the dense SMOKE models' parameters
for arch in DENSE:
    put(f"params/{arch}/", init_params(jax.random.PRNGKey(0),
                                       get_config(arch, smoke=True)))

# per-shard votes on a leaf sharded over its columns: the body of
# lowbit_packed_a2a's inner shard_map over "model", run with both axes
# manual (jax 0.9 does not lower its axis_index under the data
# shard_map, so the G-Ternary vote cannot run through the wrapper); the
# G-Binary votes also through the wrapper
W = 2
rng = np.random.RandomState(0)
gs = rng.randn(W, *LEAF).astype(np.float32)
efs = (0.1 * rng.randn(W, *LEAF)).astype(np.float32)
out["lowbit/grads"], out["lowbit/efs"] = gs, efs
sh = NamedSharding(mesh, P("data", None, "model"))
G, E = jax.device_put(jnp.asarray(gs), sh), jax.device_put(jnp.asarray(efs), sh)
for case, (sched, ternary, ef) in VOTES.items():
    if sched == "packed_a2a":
        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("data", None, "model"),) * 2,
                           out_specs=(P(None, "model"),
                                      P("data", None, "model")),
                           check_vma=False)
        def local(g, e):
            u, ne = _packed_a2a_local(g[0], ("data",), W, ternary=ternary,
                                      gate_phase=1, ef=e[0] if ef else None,
                                      interpret=None,
                                      kernels=KF.vote_kernel_set())
            return u, (ne if ef else e[0])[None]
        u, ne = jax.jit(local)(G, E)
        out[f"lowbit/{case}/u"], out[f"lowbit/{case}/ef"] = map(np.asarray, (u, ne))
        if ternary:
            continue

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("data"), P("data")),
                       out_specs=(P(), P("data")),
                       axis_names=frozenset({"data"}), check_vma=False)
    def whole(g, e):
        e0 = e[0] if ef else None
        if sched == "packed_a2a":
            u, ne = lowbit_packed_a2a(g[0], ("data",), W,
                                      model_spec=P(None, "model"),
                                      ternary=ternary, gate_phase=1, ef=e0,
                                      kernels=KF.vote_kernel_set())
        else:
            u, ne = lowbit_vote_psum(g[0], ("data",), W, ternary=ternary,
                                     gate_phase=1, ef=e0)
        return u, (ne if ef else e[0])[None]
    u, ne = map(np.asarray, jax.jit(whole)(G, E))
    if sched == "packed_a2a":
        assert np.array_equal(u, out[f"lowbit/{case}/u"]), case
    out[f"lowbit/{case}/u"], out[f"lowbit/{case}/ef"] = u, ne

# the reference's Trainer on the (2, 2) mesh
cfg = get_config("qwen3_0p6b", smoke=True)
data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=TRAIN["seq"],
                         batch=TRAIN["batch"], seed=0)
tr = Trainer(cfg, mesh, AdamW(peak_lr=TRAIN["lr"], warmup_steps=1,
                              total_steps=10), data,
             plan=plan_presets()["gbin_packed"],
             tcfg=TrainerConfig(dp_axes=("data",), log_interval=1000))
tr.init_state()
put("trainer/0/params/", tr.state.params)
for k in range(2):
    tr.run(k + 1)
    out[f"trainer/{k}/loss"] = np.asarray(tr.history[-1]["loss"])
    out[f"trainer/{k}/traffic"] = np.asarray(tr.history[-1]["traffic_ratio"])
    out[f"trainer/{k}/agg_norm"] = np.asarray(tr.history[-1]["agg_norm"])
    put(f"trainer/{k + 1}/params/", tr.state.params)
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

from repro_torch.configs import get_config
from repro_torch.core import (Commander, LeafPolicy, ProcessMesh, Schedule,
                              VirtualGroup)
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMStream
from repro_torch.fabric import (AggregationContext, Fabric, aggregate_leaf,
                                make_controller, plan_presets)
from repro_torch.core import group_cosines_from_mean
from repro_torch.models import forward, init_params, loss_fn, params_from_jax
from repro_torch.models.tp import TensorParallel
from repro_torch.models.transformer import shard_params
from repro_torch.optim import AdamW
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.shardings import shard_of

DENSE, VOTES, LEAF, TRAIN = %(dense)r, %(votes)r, %(leaf)r, %(train)r
with np.load(os.environ["REF_FILE"]) as f:
    REF = {k: f[k] for k in f.files}
arrays, info = {}, {}


def host(prefix):
    return T.unflatten([(k[len(prefix):], v) for k, v in REF.items()
                        if k.startswith(prefix)])


def batch_of(cfg, b=2, s=24):
    rng = np.random.RandomState(0)
    return {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))),
            "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))}


def value_and_grads(params, cfg, batch, tp=None):
    leaves = [t.requires_grad_() for t in T.leaves(params)]
    logits = forward(params, cfg, batch, tp)
    loss = loss_fn(params, cfg, batch, tp)
    return logits.detach(), loss.detach(), torch.autograd.grad(loss, leaves)


# -- the unsharded models (every rank; rank 0 keeps them) -------------------
for arch in DENSE:
    cfg = get_config(arch, smoke=True)
    if R == 0:
        full = params_from_jax(host(f"params/{arch}/"), device="cpu")
        logits, loss, grads = value_and_grads(full, cfg, batch_of(cfg))
        arrays[f"full/{arch}/logits"] = logits.numpy()
        arrays[f"full/{arch}/loss"] = loss.numpy()
        for (p, _), g in zip(T.flatten(full), grads):
            arrays[f"full/{arch}/grad/{p}"] = g.numpy()

meshes = {}
for shape in ((2, 2), (1, 4)):
    mesh = ProcessMesh(shape, device="cpu")
    tag = f"{shape[0]}x{shape[1]}"
    meshes[tag] = mesh
    info[f"{tag}/coords"] = mesh.coords
    info[f"{tag}/data_group"] = [mesh.data_group.rank()[0],
                                 mesh.data_group.size]
    info[f"{tag}/model_group"] = [mesh.model_group.rank()[0],
                                  mesh.model_group.size]
    tp = TensorParallel(mesh.model_group)
    for arch in DENSE:
        cfg = get_config(arch, smoke=True)
        local = params_from_jax(host(f"params/{arch}/"), device="cpu",
                                cfg=cfg, extents=mesh.extents,
                                coords=mesh.coords)
        logits, loss, grads = value_and_grads(local, cfg, batch_of(cfg), tp)
        arrays[f"{tag}/{arch}/logits"] = logits.numpy()
        arrays[f"{tag}/{arch}/loss"] = loss.numpy()
        for (p, _), g in zip(T.flatten(local), grads):
            arrays[f"{tag}/{arch}/grad/{p}"] = g.numpy()
mesh = meshes["2x2"]

# -- votes on one tensor-parallel leaf --------------------------------------
GS, EFS = REF["lowbit/grads"], REF["lowbit/efs"]
SPEC = (None, "model")
d = mesh.data_index
for case, (sched, ternary, ef) in VOTES.items():
    mode = "gternary" if ternary else "gbinary"
    for tag, fused in (("", True), ("/staged", False)):
        if not fused and sched != "packed_a2a":
            continue
        ctx = AggregationContext(group=mesh.data_group, num_workers=2,
                                 fused_kernels=fused, mesh=mesh)
        pol = LeafPolicy(mode, sched, model_spec=SPEC, gate_phase=1,
                         error_feedback=ef)
        g = torch.from_numpy(shard_of(GS[d], SPEC, mesh.extents,
                                      mesh.coords).copy())[None]
        e = torch.from_numpy(shard_of(EFS[d], SPEC, mesh.extents,
                                      mesh.coords).copy())[None]
        u, ne = aggregate_leaf(ctx, g, pol, ef=e if ef else None)
        arrays[f"lowbit/{case}{tag}/u"] = u.numpy()
        if ef:
            arrays[f"lowbit/{case}{tag}/ef"] = ne.numpy()
    if R == 0:
        arrays["lowbit/inputs"] = GS + EFS
        ctx = AggregationContext(group=VirtualGroup(2), num_workers=2)
        pol = LeafPolicy(mode, sched, gate_phase=1, error_feedback=ef)
        u, ne = aggregate_leaf(ctx, torch.from_numpy(GS.copy()), pol,
                               ef=torch.from_numpy(EFS.copy()) if ef else None)
        arrays[f"lowbit/{case}/unsharded/u"] = u.numpy()
        if ef:
            arrays[f"lowbit/{case}/unsharded/ef"] = ne.numpy()

# -- two Trainer steps at (2, 2), each from the reference's parameters ------
cfg = get_config("qwen3_0p6b", smoke=True)
data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=TRAIN["seq"],
                         batch=TRAIN["batch"], seed=0)
tr = Trainer(cfg, AdamW(peak_lr=TRAIN["lr"], warmup_steps=1, total_steps=10),
             data, plan=plan_presets()["gbin_packed"],
             fabric=Fabric(mesh=mesh), device="cpu",
             tcfg=TrainerConfig(log_interval=1000))
tr.init_state()
model = tr.state.model
layout = tr.fabric.layout_for(model.tree(), plan_presets()["gbin_packed"],
                              tr.pspecs)
info["trainer/unfused"] = [u.name for u in layout.unfused]
for k in range(2):
    ref = params_from_jax(host(f"trainer/{k}/params/"), device="cpu", cfg=cfg,
                          extents=mesh.extents, coords=mesh.coords)
    with torch.no_grad():
        for t, x in zip(T.leaves(model.tree()), T.leaves(ref)):
            t.copy_(x)
    batch = {n: torch.as_tensor(v) for n, v in data.batch_at(k).items()}
    grads, _ = tr.fabric.worker_grads(model.tree(), batch, model.loss)
    for p, g in T.flatten(grads):
        arrays[f"trainer/{k}/grads/{p}"] = g.numpy()
    tr.run(k + 1)
    for p, u in T.flatten(tr.last_aggregates):
        arrays[f"trainer/{k}/agg/{p}"] = u.numpy()
    for p, x in T.flatten(model.tree()):
        arrays[f"trainer/{k + 1}/params/{p}"] = x.detach().numpy().copy()
    info[f"trainer/{k}/loss"] = tr.history[-1]["loss"]
    info[f"trainer/{k}/traffic"] = tr.history[-1]["traffic_ratio"]
    info[f"trainer/{k}/agg_norm"] = tr.history[-1]["agg_norm"]

# -- the cosine diagnostics of a tensor-parallel tree ------------------------
fab = tr.fabric
local_like = model.tree()
shards = fab._shards(local_like, fab.resolve(local_like, plan_presets()[
    "gbin_packed"], tr.pspecs))
rng = np.random.RandomState(1)
whole = T.map_leaves(lambda x: rng.randn(*x.shape).astype(np.float32),
                     init_params(cfg, device="meta"))
blocks = T.map_leaves(lambda a: torch.from_numpy(a.copy()), shard_params(
    whole, cfg, mesh.extents, mesh.coords))
groups = fab.groups(local_like)
for tag, tree, sh in (("tp", blocks, shards),
                      ("whole", T.map_leaves(torch.from_numpy, whole), None)):
    cos = group_cosines_from_mean(tree, groups, gate_phase=1, shards=sh)
    info[f"cos/{tag}"] = {g: {k: float(v) for k, v in d.items()}
                          for g, d in cos.items()}

# -- "dots" against "full" --------------------------------------------------
tp = TensorParallel(mesh.model_group)
for policy in ("full", "dots"):
    c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    local = params_from_jax(host("trainer/0/params/"), device="cpu", cfg=c,
                            extents=mesh.extents, coords=mesh.coords)
    leaves = [t.requires_grad_() for t in T.leaves(local)]
    mesh.model_group.reset_counts()
    loss = loss_fn(local, c, batch_of(c, 4, 16), tp)
    info[f"dots/{policy}/forward"] = mesh.model_group.calls_by_op["all_reduce"]
    grads = torch.autograd.grad(loss, leaves)
    info[f"dots/{policy}/all_reduce"] = mesh.model_group.calls_by_op[
        "all_reduce"]
    for (p, _), g in zip(T.flatten(local), grads):
        arrays[f"dots/{policy}/grad/{p}"] = g.numpy()

# -- the paper controller on the (2, 2) mesh ---------------------------------
ADAM = AdamW(peak_lr=TRAIN["lr"], warmup_steps=1, total_steps=10)


def paper(fabric):
    ctl = make_controller("paper", warmup_steps=1, commander=Commander(
        schedule=Schedule.PACKED_A2A))
    t = Trainer(cfg, ADAM, data, controller=ctl, fabric=fabric,
                device="cpu", tcfg=TrainerConfig(log_interval=1000))
    t.run(3)
    return {"history": [{k: v for k, v in h.items()
                         if k.startswith("cos/") or k in ("loss", "plan")}
                        for h in t.history],
            "events": [[e.step, e.kind, e.plan_signature] for e in ctl.events]}


info["paper/tp"] = paper(Fabric(mesh=mesh))

dist.barrier()
dist.destroy_process_group()
if R == 0:
    info["paper/virtual"] = paper(Fabric(num_workers=2))
np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
'''
