"""The port's tensor parallelism against the reference's, on the CPU.

  * the partition-spec trees of all ten configs equal the reference's
    ``sanitize_pspecs(param_pspecs(cfg), ...)`` at meshes (2, 2) and
    (2, 4), and block ``k`` of every spec is the block the reference's
    ``shard_map`` hands the device at those coordinates;
  * the packed vote refuses a gate mask on a tensor-parallel leaf;
  * one spawn of four gloo ranks (``torch.set_num_threads(1)``, a
    ``file://`` store, 60 s collective timeouts) after five JAX
    subprocesses on four forced host devices, run at once (the
    reference's parameters, its per-shard votes and its Trainers on a
    ``("data", "model")`` mesh of (2, 2): qwen3's and each MoE model's).  The ranks build a :class:`ProcessMesh` of (2, 2), then one
    of (1, 4) on the same world, and the parent compares:

      - the dense SMOKE models (qk-norm, qkv bias, GELU, local/global
        layers), the MoE ones (deepseek-moe and llama4-scout: the experts
        over the model axis), the VLM (phi3-vision with seeded
        ``patch_feats``), qwen2.5 with 6 query and 2 KV heads (on
        (1, 4) 48 of 192 query columns a rank: 1.5 heads in GQA groups
        of 3, as qwen2.5-14B's 40 heads on 16 ranks), xLSTM (its 2
        heads split ``r`` at M = 2 and replicate it at M = 4), hymba,
        whisper (seeded ``frames``) and whisper with 6 heads over d 96
        and a tied vocabulary of 513 (replicated, as full whisper's and
        hymba's; 1.5 heads a rank at (1, 4), in self- and
        cross-attention), from the
        reference's parameters: logits (gathered over the vocabulary)
        equal the unsharded port's to rtol 1e-5 / atol 1e-5 (as the
        model tests hold them), the loss to rtol 1e-5, every gradient
        block to rtol 1e-4 / atol 1e-5 (``wk`` / ``wv``, the qk-norm
        scales and the router included, which sum over the model
        group, and ``patch_proj``);
      - each recurrent or encoder-decoder family's decode on both meshes
        (float32 cache, teacher-forced tokens) against one device's, to
        rtol 1e-5 / atol 1e-5;
      - ``int4`` and ``topk`` on a tensor-parallel leaf: each rank's
        encode of its block byte-equal to its block of the reference's
        encode of the whole (GSPMD) leaf, the aggregate to the float32
        mean of those encodes, and the int4 twin with its model-group
        absmax to the reference's ``int4_quant_plane`` of the whole leaf;
      - the packed vote of a tensor-parallel leaf (G-Binary, G-Ternary and
        EF, fused and staged) byte-equal to the reference's per-shard
        vote (``_packed_a2a_local`` on each block, the body of
        ``lowbit_packed_a2a``'s inner ``shard_map``; G-Binary also
        through ``lowbit_packed_a2a(model_spec=...)`` itself; an expert
        leaf ``(L, E, d, d_e)`` split on its expert axis too), and
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
        the unsharded model; two gbin_packed Trainer steps of each MoE,
        recurrent and encoder-decoder SMOKE model at (2, 2), each from
        the reference Trainer's parameters: losses within rtol 1e-5 of
        the reference's (2, 2) Trainer's, traffic ratios equal;
      - two gbin_packed steps with EF of ``build_train_step`` on meshes
        of (2, 2), (1, 4) and (4, 1) bit-equal to ``Fabric(mesh=...)``'s
        step on the same blocks and batches, with the Trainer's specs and
        ZeRO-1 partition (at (4, 1)
        the legacy step keeps the "model"-specced leaves per leaf, as the
        reference's mesh step does: against the session's step on the
        plan, which buckets them, votes byte-equal and FP32 means to
        rtol 1e-6 and 1e-6 of the leaf's largest value);
      - ``remat_policy="dots"`` against ``"full"``: the same gradients,
        and exactly one model-group all-reduce fewer a layer (the
        attention's, which the full recompute runs again; it stops before
        the MLP's, which the backward does not need); on deepseek-moe at
        (2, 2) and the 6-head qwen2.5 at (1, 4) the same gradients, with
        the counts stated in the test.
"""
import dataclasses
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
from repro_torch.core import VirtualGroup, lowbit_packed_a2a  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import aggregate_leaf, plan_presets  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_pspecs  # noqa: E402
from repro_torch.runtime.shardings import (block_slices,  # noqa: E402
                                           local_shape, place,
                                           sanitize_pspecs, shard_of)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: seconds a spawn may take before it is killed
SPAWN_TIMEOUT = 300
#: the dense SMOKE configs run tensor-parallel
DENSE = ("qwen3_0p6b", "qwen2p5_14b", "gemma3_27b", "starcoder2_15b")
#: the MoE SMOKE configs, experts over the model axis
MOE = ("deepseek_moe_16b", "llama4_scout_17b_a16e")
#: the recurrent and encoder-decoder SMOKE configs
RECURRENT = ("xlstm_125m", "hymba_1p5b", "whisper_tiny")
#: SMOKE configs changed by name: ``arch:variant``; ``6h513`` is full
#: whisper's layout at smoke size (6 heads, a tied odd vocabulary)
VARIANTS = {"6h": {"num_heads": 6, "num_kv_heads": 2},
            "6h513": {"num_heads": 6, "num_kv_heads": 6, "d_model": 96,
                      "vocab_size": 513, "tie_embeddings": True}}
#: every model held against the unsharded one
MODELS = DENSE + MOE + ("phi3_vision_4p2b", "qwen2p5_14b:6h") + RECURRENT \
    + ("whisper_tiny:6h513",)
#: the trainers held against the reference's (2, 2) Trainer
TRAINED = MOE + RECURRENT
#: the elements of a recurrent model's Trainer step that may part from
#: the reference's by a flipped vote (up to 2 lr; see the test)
RECURRENT_MOVED = 8
#: the decode on a mesh: rows, cache positions, teacher-forced steps
DECODE = dict(batch=4, max_seq=16, steps=10)
#: the mean codecs on a tensor-parallel leaf
MEANS = ("int4", "topk")
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
#: a stacked expert leaf (L, E, d, d_e), sharded over its experts
EXPERT_LEAF, EXPERT_SPEC = (2, 4, 7, 33), (None, "model", None, None)
EXPERT_VOTES = sorted(k for k, v in VOTES.items() if v[0] == "packed_a2a")
TRAIN = dict(seq=16, batch=8, lr=1e-3)


#: model-group collectives of one loss and its gradients under each
#: remat policy, {policy: calls by op}.  The forward's are the same under
#: both: the embedding's sum, the cross-entropy's max and sum, and a
#: layer's row-parallel sums (attention, MLP; a MoE layer's routed and
#: shared experts), and on column blocks a gather of Q a layer.  "dots"
#: adds the backward's sums: each ``tp.copy`` (x into attention, MLP and
#: router; wk, wv, their biases, the router; the head's input) and each
#: gather of Q summed back.  "full" recomputes a layer up to the last
#: collective its backward needs: the attention's sum, and a MoE layer's
#: routed sum before its shared experts (one dense layer and two MoE:
#: 5 more); Q's gather and the attention's sum (2 a layer on column
#: blocks).  deepseek-moe at (2, 2): 11 in the forward; the 6-head
#: qwen2.5 at (1, 4): 7 all-reduces and 2 gathers.
DOTS_CASES = {
    "deepseek_moe_16b": ((2, 2), {
        "full": {"all_reduce": 11 + 17 + 5},
        "dots": {"all_reduce": 11 + 17}}),
    "qwen2p5_14b:6h": ((1, 4), {
        "full": {"all_gather": 2 + 2, "all_reduce": 7 + 15 + 2},
        "dots": {"all_gather": 2, "all_reduce": 7 + 15}}),
}


#: what the two programs below are formatted with
PROGRAM_ARGS = {"dense": DENSE, "votes": VOTES, "leaf": LEAF, "train": TRAIN,
                "moe": MOE, "variants": VARIANTS, "models": MODELS,
                "recurrent": RECURRENT, "decode": DECODE, "means": MEANS,
                "expert": (EXPERT_LEAF, EXPERT_SPEC),
                "dots": {a: mesh for a, (mesh, _) in DOTS_CASES.items()}}


def _config(arch: str):
    """A SMOKE config by name, ``arch:variant`` changed by ``VARIANTS``."""
    base, _, variant = arch.partition(":")
    cfg = get_config(base, smoke=True)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


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
    """The JAX side, run once, in eight processes at once: blocks,
    per-shard votes, the mean codecs' encodes and the dense parameters;
    qwen3's (2, 2) Trainer; each MoE model's parameters and Trainer;
    each recurrent or encoder-decoder model's Trainer; the other models'
    parameters."""
    out = tmp_path_factory.mktemp("tp_ref")
    parts = ("main", "qwen3", *TRAINED, "others")
    procs = [_start_reference(out / f"{part}.npz", part) for part in parts]
    ref = {}
    for part, proc in zip(parts, procs):
        ref.update(_finish_reference(proc, out / f"{part}.npz"))
    return ref


def _start_reference(out, part: str):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(SRC=SRC, OUT_FILE=str(out), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", PART=part)
    program = REFERENCE_PROGRAM % PROGRAM_ARGS
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
# what a tensor-parallel leaf refuses
# ---------------------------------------------------------------------------

def test_packed_vote_refuses_a_gate_mask_on_a_tensor_parallel_leaf():
    with pytest.raises(ValueError, match="fully local payload"):
        lowbit_packed_a2a(torch.ones(2, 64), VirtualGroup(2), 2,
                          model_spec=(None, "model"), ternary=True,
                          gate_mask=np.ones(64, bool))


class _OneRank:
    """A model group of one: its all-reduce is the identity."""

    def all_reduce(self, x, op="sum"):
        return x.clone()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 600, 1251, 77 * 130])
def test_radix_select_is_the_topk_value(k):
    """``kth_largest`` (top-k's threshold over a model group) against
    ``torch.topk`` on two rows of |x|: normal values with ties, zeros of
    either sign, subnormals and an infinity."""
    from repro_torch.kernels.fused import kth_largest
    rng = np.random.RandomState(k)
    x = rng.randn(2, 77 * 130).astype(np.float32)
    x[:, :8] = [0.0, -0.0, 1.5, -1.5, 1.5, 1e-42, np.inf, 3.0]
    x[1, 100:400] = 0.25
    f = torch.from_numpy(x).abs()
    want = torch.topk(f, k, dim=-1).values[:, -1]
    assert torch.equal(kth_largest(f, k, _OneRank()), want)


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
    return spawn_ranks(RANK_PROGRAM % PROGRAM_ARGS, 4, out, REF_FILE=ref)


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
@pytest.mark.parametrize("arch", MODELS)
def test_logits_and_loss_equal_the_unsharded_model(world, arch, mesh):
    tag = f"{mesh[0]}x{mesh[1]}"
    full = world[0][0][f"full/{arch}/logits"]
    cfg = _config(arch)
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
@pytest.mark.parametrize("arch", MODELS)
def test_gradients_equal_the_unsharded_model(world, arch, mesh):
    tag = f"{mesh[0]}x{mesh[1]}"
    cfg = _config(arch)
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
                float(reference[f"trainer/{k}/traffic_ratio"]), rel=1e-12)


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


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_build_train_step_on_a_mesh_is_the_sessions_step(world, mesh):
    """Two gbin_packed steps with EF of ``build_train_step(cfg,
    ProcessMesh(...))`` against ``Fabric(mesh=...).build_step`` on the
    same blocks and batches, with the specs and ZeRO-1 partition built as
    the Trainer builds them: losses, norms, parameters,
    moments, EF rows and aggregates bit-equal on every rank.  At (4, 1)
    the legacy step keeps the seven "model"-specced leaves on launches of
    their own, as the reference's mesh step does, and so does the
    session's step, on the legacy step's policies or on the plan; a
    session on the data group alone (a worker group, no specs) buckets
    those leaves and gives the same votes byte for byte and the same
    FP32 means to rtol 1e-6 and 1e-6 of the leaf's largest value (gloo's
    ring sums a bucket's elements in an order that depends on their
    offset, and the buckets differ)."""
    for r, (arrays, info) in enumerate(world):
        launches, session_launches, unfused, zero = \
            info[f"legacy/{mesh}/layout"]
        assert zero == (mesh != "1x4"), r
        for k in range(2):
            got = info[f"legacy/{mesh}/legacy/{k}"]
            want = info[f"legacy/{mesh}/session/{k}"]
            assert got == want, (r, k, [n for n in got if got[n] != want[n]])
            assert np.isfinite(got["loss"]), (r, k)
        if mesh != "4x1":
            assert launches == session_launches, r
            continue
        assert unfused == sorted(info["trainer/unfused"])
        assert launches == session_launches == info["legacy/4x1/on_plan"] \
            == 9
        assert info["legacy/4x1/bucketed_unfused"] == 0
        assert info["legacy/4x1/bucketed/0"]["loss"] == \
            info["legacy/4x1/legacy/0"]["loss"]
        fp32 = set(info["legacy/4x1/fp32"])
        assert "embed/tok" in fp32 and "layers/attn/wq" not in fp32
        for p, _ in T.flatten(init_params(get_config("qwen3_0p6b", True),
                                          device="meta")):
            u = arrays[f"legacy/4x1/legacy/agg/{p}"]
            v = arrays[f"legacy/4x1/bucketed/agg/{p}"]
            if p in fp32:
                np.testing.assert_allclose(
                    u, v, rtol=1e-6, atol=1e-6 * np.abs(v).max(),
                    err_msg=p)
            else:
                assert _same_bits(u, v), (r, p)


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


@pytest.mark.parametrize("case", EXPERT_VOTES)
def test_expert_leaf_votes_equal_the_references(world, reference, case):
    """The packed vote of an expert leaf's block (a split on the leading
    expert axis of a stacked 4-D leaf), fused and staged, byte-equal to
    the reference's per-shard vote; EF residuals to 1e-6 of each
    worker's block's beta."""
    _, _, ef = VOTES[case]
    want = reference[f"expert/{case}/u"]
    for tag in ("", "/staged"):
        got = _assemble(world, f"expert/{case}{tag}/u", EXPERT_SPEC, (2, 2),
                        EXPERT_LEAF)
        assert _same_bits(got, want), (case, tag)
    if not ef:
        return
    new_ef = _assemble(world, f"expert/{case}/ef", ("data", *EXPERT_SPEC),
                       (2, 2), (2, *EXPERT_LEAF))
    x = np.abs(reference["expert/grads"] + reference["expert/efs"])
    n, e = EXPERT_LEAF[0], EXPERT_LEAF[1]
    beta = x.reshape(2, n, 2, e // 2, -1).mean(axis=(1, 3, 4))   # (W, M)
    bound = np.repeat(beta, e // 2, axis=1)[:, None, :, None, None]
    assert (np.abs(new_ef - reference[f"expert/{case}/ef"])
            <= 1e-6 * bound).all(), case


@pytest.mark.parametrize("arch", TRAINED)
def test_moe_trainer_losses_equal_the_reference_trainer(world, reference,
                                                        arch):
    """Two gbin_packed steps at (2, 2), each family's blocks over the
    model ranks (a MoE's experts, the recurrences' projections, whisper's
    encoder, decoder and ``frame_proj``) and ZeRO-1 over the data ranks,
    each from the reference Trainer's parameters: losses and the
    aggregates' norm to rtol 1e-5, the traffic ratio priced on the whole
    leaves, and every parameter block after each step (the aggregation,
    AdamW and ZeRO-1 on the 4-D expert leaves) against the reference
    Trainer's to 1% of the learning rate (a flipped vote or a misplaced
    block moves an element by ~2 lr; the expert leaves agree to ~5e-10).
    llama4-scout's router is held only to AdamW's bound: top-1
    renormalises its one gate to ``v / (v + 1e-9)``, so its gradient is
    ~1e-9 of the loss's, the size of float32 rounding, and AdamW scales
    that noise up to ~lr / 2 on both sides.  The recurrent and
    encoder-decoder models' elements are held to 1% of the learning rate
    but at most RECURRENT_MOVED of them a step, each within 2 lr: there a
    G-Binary vote flips, or AdamW's first steps meet a gradient near
    zero, where a worker's element lies within the row-parallel sums'
    rounding of zero (1 or 2 of ~10^5 elements a step on the CPU)."""
    lr = TRAIN["lr"]
    noise = {"llama4_scout_17b_a16e": "layers/moe/router"}
    for arrays, info in world:
        for k in range(2):
            for key in ("loss", "agg_norm"):
                np.testing.assert_allclose(info[f"moe/{arch}/{k}/{key}"],
                                           reference[f"moe/{arch}/{k}/{key}"],
                                           rtol=1e-5, err_msg=key)
            assert info[f"moe/{arch}/{k}/traffic"] == pytest.approx(
                float(reference[f"moe/{arch}/{k}/traffic_ratio"]),
                rel=1e-12)
            prefix = f"moe/{arch}/{k + 1}/params/"
            names = [n[len(prefix):] for n in arrays if n.startswith(prefix)]
            assert len(names) == len(T.leaves(init_params(
                _config(arch), device="meta")))
            moved = 0
            for p in names:
                got, want = arrays[prefix + p], \
                    arrays[f"moe/{arch}/{k + 1}/ref/{p}"]
                if noise.get(arch) == p:
                    assert np.abs(got - want).max() <= 2 * lr, (k, p)
                    continue
                if arch in RECURRENT:
                    assert np.abs(got - want).max() <= 2 * lr, (k, p)
                    moved += int((np.abs(got - want) > 1e-2 * lr).sum())
                    continue
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * lr,
                                           err_msg=f"{k} {p}")
            assert moved <= RECURRENT_MOVED, (k, moved)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_on_the_mesh_equals_one_device(world, arch, mesh):
    """DECODE["steps"] teacher-forced tokens through the mesh's serving
    step (an xLSTM's states replicated over the model ranks, a hybrid's
    Mamba states split by channel, whisper's cross cache its frames over
    ``"model"``; float32 caches) against the one-device step, every
    rank's whole (B, V) logits, to rtol 1e-5 / atol 1e-5."""
    tag = f"{mesh[0]}x{mesh[1]}"
    want = world[0][0][f"decode/{arch}/one"]
    assert want.shape == (DECODE["steps"], DECODE["batch"],
                          _config(arch).vocab_size)
    for arrays, _ in world:
        np.testing.assert_allclose(arrays[f"decode/{tag}/{arch}"], want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MEANS)
def test_mean_codecs_on_a_tensor_parallel_leaf_equal_the_references(
        world, reference, mode):
    """Each data rank's encode of its block (int4's absmax, top-k's k-th
    largest |x| over the model group) byte-equal to its block of the
    reference's encode of the worker's whole leaf, as GSPMD runs it; the
    aggregate byte-equal to the float32 mean of the two workers'
    encodes."""
    want = reference[f"mean/{mode}/enc"]
    got = _assemble(world, f"mean/{mode}/enc", ("data", None, "model"),
                    (2, 2), (2, *LEAF))
    assert _same_bits(got, want), mode
    u = _assemble(world, f"mean/{mode}/u", (None, "model"), (2, 2), LEAF)
    assert _same_bits(u, (want[0] + want[1]) / np.float32(2)), mode


def test_int4_twin_takes_the_model_groups_absmax(world, reference):
    """The int4_quant twin on each rank's planes of a block, its absmax
    reduced over the model group, against the reference's
    ``int4_quant_plane`` of the whole leaf (one scale: ``max|x| / 7``)."""
    got = _assemble(world, "int4/twin", (None, "model"), (2, 2), LEAF)
    assert _same_bits(got, reference["int4/twin"])


@pytest.mark.parametrize("arch", sorted(DOTS_CASES))
def test_dots_gives_the_full_gradients_on_experts_and_column_blocks(world,
                                                                     arch):
    _, want = DOTS_CASES[arch]
    like = init_params(_config(arch), device="meta")
    for arrays, info in world:
        for p, _ in T.flatten(like):
            np.testing.assert_array_equal(
                arrays[f"dots/{arch}/dots/grad/{p}"],
                arrays[f"dots/{arch}/full/grad/{p}"], p)
        for policy, calls in want.items():
            assert info[f"dots/{arch}/{policy}/calls"] == calls, policy
        assert info[f"dots/{arch}/dots/forward"] == \
            info[f"dots/{arch}/full/forward"]


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

import dataclasses
DENSE, VOTES, LEAF, TRAIN = %(dense)r, %(votes)r, %(leaf)r, %(train)r
MOE, VARIANTS, MODELS = %(moe)r, %(variants)r, %(models)r
RECURRENT, MEANS = %(recurrent)r, %(means)r
EXPERT_LEAF, EXPERT_SPEC = %(expert)r
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}


def config(arch):
    base, _, variant = arch.partition(":")
    cfg = get_config(base, smoke=True)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


def put(prefix, tree):
    for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + name(kp)] = np.asarray(a)


def name(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


class Frames:
    """An encoder-decoder's stream: the tokens' batches with seeded
    ``frames``, as the port's ``FramesStream`` draws them."""

    def __init__(self, tokens, frames, width):
        self.tokens, self.frames, self.width = tokens, frames, width

    def batch_at(self, step):
        batch = self.tokens.batch_at(step)
        rng = np.random.RandomState(1_000 + step)
        batch["frames"] = rng.randn(len(batch["tokens"]), self.frames,
                                    self.width).astype(np.float32)
        return batch

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def train(cfg, prefix):
    """The reference's Trainer on the (2, 2) mesh: two gbin_packed steps,
    the parameters before each and after the last, each step's loss,
    traffic ratio and aggregates' norm."""
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=TRAIN["seq"],
                             batch=TRAIN["batch"], seed=0)
    if cfg.family == "encdec":
        data = Frames(data, cfg.encoder_seq, cfg.d_model)
    tr = Trainer(cfg, mesh, AdamW(peak_lr=TRAIN["lr"], warmup_steps=1,
                                  total_steps=10), data,
                 plan=plan_presets()["gbin_packed"],
                 tcfg=TrainerConfig(dp_axes=("data",), log_interval=1000))
    tr.init_state()
    put(f"{prefix}/0/params/", tr.state.params)
    for k in range(2):
        tr.run(k + 1)
        for key in ("loss", "traffic_ratio", "agg_norm"):
            out[f"{prefix}/{k}/{key}"] = np.asarray(tr.history[-1][key])
        put(f"{prefix}/{k + 1}/params/", tr.state.params)


# the parts that run in processes of their own, beside "main"
PART = os.environ["PART"]
if PART != "main":
    # each MoE model's part draws its parameters and runs its Trainer,
    # "others" draws the parameters of the models in neither group
    others = [a for a in MODELS if a not in DENSE + MOE]
    drawn = (PART,) if PART in MOE else others if PART == "others" else ()
    for arch in drawn:
        put(f"params/{arch}/", init_params(jax.random.PRNGKey(0),
                                           config(arch)))
    if PART == "qwen3":
        train(get_config("qwen3_0p6b", smoke=True), "trainer")
    if PART in MOE + RECURRENT:
        train(config(PART), f"moe/{PART}")
    np.savez(os.environ["OUT_FILE"], **out)
    sys.exit(0)


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
    put(f"params/{arch}/", init_params(jax.random.PRNGKey(0), config(arch)))

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

# the mean codecs' encodes of each worker's whole leaf, as GSPMD runs
# them on a tensor-parallel leaf, and the int4 twin's whole-leaf scale
from repro.fabric import get_codec
from repro.kernels import ref as KR
for mode in MEANS:
    enc = jax.jit(lambda g: get_codec(mode).encode(None, g))
    out[f"mean/{mode}/enc"] = np.stack([np.asarray(enc(jnp.asarray(g)))
                                        for g in gs])
out["int4/twin"] = np.asarray(jax.jit(KR.int4_quant_plane)(jnp.asarray(gs[0])))

# per-shard votes on an expert leaf (L, E, d, d_e), its experts over
# "model": the same body on each block
gs = rng.randn(W, *EXPERT_LEAF).astype(np.float32)
efs = (0.1 * rng.randn(W, *EXPERT_LEAF)).astype(np.float32)
out["expert/grads"], out["expert/efs"] = gs, efs
spec = P("data", *EXPERT_SPEC)
G, E = (jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
        for a in (gs, efs))
for case, (sched, ternary, ef) in VOTES.items():
    if sched != "packed_a2a":
        continue

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,) * 2,
                       out_specs=(P(*EXPERT_SPEC), spec), check_vma=False)
    def local(g, e):
        u, ne = _packed_a2a_local(g[0], ("data",), W, ternary=ternary,
                                  gate_phase=1, ef=e[0] if ef else None,
                                  interpret=None,
                                  kernels=KF.vote_kernel_set())
        return u, (ne if ef else e[0])[None]
    u, ne = jax.jit(local)(G, E)
    out[f"expert/{case}/u"], out[f"expert/{case}/ef"] = map(np.asarray, (u, ne))

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
from repro_torch.data import FramesStream, SyntheticLMStream
from repro_torch.fabric import (AggregationContext, Fabric, aggregate_leaf,
                                get_codec, make_controller, plan_presets)
from repro_torch.kernels import ref as KR
from repro_torch.core import group_cosines_from_mean
from repro_torch.models import (forward, init_cache, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models.tp import TensorParallel
from repro_torch.models.transformer import shard_params
from repro_torch.optim import AdamW
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.serve import build_serve_step
from repro_torch.runtime.shardings import shard_of

DENSE, VOTES, LEAF, TRAIN = %(dense)r, %(votes)r, %(leaf)r, %(train)r
MOE, VARIANTS, MODELS = %(moe)r, %(variants)r, %(models)r
RECURRENT, DECODE, MEANS = %(recurrent)r, %(decode)r, %(means)r
EXPERT_LEAF, EXPERT_SPEC = %(expert)r
with np.load(os.environ["REF_FILE"]) as f:
    REF = {k: f[k] for k in f.files}
arrays, info = {}, {}


def host(prefix):
    return T.unflatten([(k[len(prefix):], v) for k, v in REF.items()
                        if k.startswith(prefix)])


def config(arch):
    base, _, variant = arch.partition(":")
    cfg = get_config(base, smoke=True)
    return dataclasses.replace(cfg, **VARIANTS[variant]) if variant else cfg


def batch_of(cfg, b=2, s=24):
    rng = np.random.RandomState(0)
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (b, s))),
             "labels": torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                    (b, s)))}
    if cfg.vision_patches:
        batch["patch_feats"] = torch.from_numpy(rng.randn(
            b, cfg.vision_patches, cfg.vision_feat_dim).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.randn(
            b, cfg.encoder_seq, cfg.d_model).astype(np.float32))
    return batch


def stream(cfg):
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=TRAIN["seq"],
                             batch=TRAIN["batch"], seed=0)
    if cfg.family == "encdec":
        data = FramesStream(data, cfg.encoder_seq, cfg.d_model)
    return data


def decode(cfg, step, params, cache):
    """DECODE["steps"] teacher-forced tokens through ``step``: the
    logits of every step, (steps, B, V)."""
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (DECODE["batch"], DECODE["steps"])))
    rows = []
    for t in range(DECODE["steps"]):
        logits, cache = step(params, tokens[:, t:t + 1], cache, t)
        rows.append(logits)
    return torch.stack(rows).numpy()


def value_and_grads(params, cfg, batch, tp=None):
    leaves = [t.requires_grad_() for t in T.leaves(params)]
    logits = forward(params, cfg, batch, tp)
    loss = loss_fn(params, cfg, batch, tp)
    return logits.detach(), loss.detach(), torch.autograd.grad(loss, leaves)


# -- the unsharded models (rank 0) -------------------------------------------
for arch in MODELS:
    cfg = config(arch)
    if R == 0:
        full = params_from_jax(host(f"params/{arch}/"), device="cpu")
        logits, loss, grads = value_and_grads(full, cfg, batch_of(cfg))
        arrays[f"full/{arch}/logits"] = logits.numpy()
        arrays[f"full/{arch}/loss"] = loss.numpy()
        for (p, _), g in zip(T.flatten(full), grads):
            arrays[f"full/{arch}/grad/{p}"] = g.numpy()
        if arch in RECURRENT:
            step, _ = build_serve_step(cfg, batch=DECODE["batch"],
                                       max_seq=DECODE["max_seq"])
            arrays[f"decode/{arch}/one"] = decode(cfg, step, full, init_cache(
                cfg, DECODE["batch"], DECODE["max_seq"], dtype=torch.float32,
                device="cpu"))

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
    for arch in MODELS:
        cfg = config(arch)
        local = params_from_jax(host(f"params/{arch}/"), device="cpu",
                                cfg=cfg, extents=mesh.extents,
                                coords=mesh.coords)
        logits, loss, grads = value_and_grads(local, cfg, batch_of(cfg), tp)
        arrays[f"{tag}/{arch}/logits"] = logits.numpy()
        arrays[f"{tag}/{arch}/loss"] = loss.numpy()
        for (p, _), g in zip(T.flatten(local), grads):
            arrays[f"{tag}/{arch}/grad/{p}"] = g.numpy()
        if arch in RECURRENT:
            step, _ = build_serve_step(cfg, mesh, batch=DECODE["batch"],
                                       max_seq=DECODE["max_seq"])
            arrays[f"decode/{tag}/{arch}"] = decode(
                cfg, step, T.map_leaves(torch.Tensor.detach, local),
                init_cache(cfg, DECODE["batch"], DECODE["max_seq"],
                           dtype=torch.float32, device="cpu", mesh=mesh))
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

# -- the mean codecs on the same leaf: each data rank's block --------------
for mode in MEANS:
    g = torch.from_numpy(shard_of(GS[d], SPEC, mesh.extents,
                                  mesh.coords).copy())
    enc = get_codec(mode).kernel_set().encode_flat(
        g.reshape(1, -1), mesh.shard_view(SPEC, tuple(g.shape)))
    arrays[f"mean/{mode}/enc"] = enc.reshape(1, *g.shape).numpy()
    ctx = AggregationContext(group=mesh.data_group, num_workers=2, mesh=mesh)
    u, _ = aggregate_leaf(ctx, g[None], LeafPolicy(mode, Schedule.PSUM,
                                                    model_spec=SPEC))
    arrays[f"mean/{mode}/u"] = u.numpy()
g = torch.from_numpy(shard_of(GS[0], SPEC, mesh.extents, mesh.coords).copy())
q = KR.int4_quant_plane(KR.to_plane(g.reshape(1, -1)), group=mesh.model_group)
arrays["int4/twin"] = KR.from_plane(q, g.numel()).reshape(g.shape).numpy()

# -- votes on an expert leaf, its experts over "model" -----------------------
GS, EFS = REF["expert/grads"], REF["expert/efs"]
for case, (sched, ternary, ef) in VOTES.items():
    if sched != "packed_a2a":
        continue
    mode = "gternary" if ternary else "gbinary"
    for tag, fused in (("", True), ("/staged", False)):
        ctx = AggregationContext(group=mesh.data_group, num_workers=2,
                                 fused_kernels=fused, mesh=mesh)
        pol = LeafPolicy(mode, sched, model_spec=EXPERT_SPEC, gate_phase=1,
                         error_feedback=ef)
        g, e = (torch.from_numpy(shard_of(a[d], EXPERT_SPEC, mesh.extents,
                                          mesh.coords).copy())[None]
                for a in (GS, EFS))
        u, ne = aggregate_leaf(ctx, g, pol, ef=e if ef else None)
        arrays[f"expert/{case}{tag}/u"] = u.numpy()
        if ef and fused:
            arrays[f"expert/{case}/ef"] = ne.numpy()

# -- two Trainer steps of the MoE, recurrent and encoder-decoder models at
# (2, 2), each from the reference's parameters
ADAM = AdamW(peak_lr=TRAIN["lr"], warmup_steps=1, total_steps=10)
for arch in MOE + RECURRENT:
    cfg = config(arch)
    data = stream(cfg)
    tr = Trainer(cfg, ADAM, data, plan=plan_presets()["gbin_packed"],
                 fabric=Fabric(mesh=mesh), device="cpu",
                 tcfg=TrainerConfig(log_interval=1000))
    tr.init_state()
    model = tr.state.model
    for k in range(2):
        ref = params_from_jax(host(f"moe/{arch}/{k}/params/"), device="cpu",
                              cfg=cfg, extents=mesh.extents,
                              coords=mesh.coords)
        with torch.no_grad():
            for t, x in zip(T.leaves(model.tree()), T.leaves(ref)):
                t.copy_(x)
        tr.run(k + 1)
        info[f"moe/{arch}/{k}/loss"] = tr.history[-1]["loss"]
        info[f"moe/{arch}/{k}/traffic"] = tr.history[-1]["traffic_ratio"]
        info[f"moe/{arch}/{k}/agg_norm"] = tr.history[-1]["agg_norm"]
        after = params_from_jax(host(f"moe/{arch}/{k + 1}/params/"),
                                device="cpu", cfg=cfg, extents=mesh.extents,
                                coords=mesh.coords)
        for (p, x), y in zip(T.flatten(model.tree()), T.leaves(after)):
            arrays[f"moe/{arch}/{k + 1}/params/{p}"] = \
                x.detach().numpy().copy()
            arrays[f"moe/{arch}/{k + 1}/ref/{p}"] = y.numpy()

# -- "dots" against "full" on the experts and on column blocks --------------
for arch, shape in %(dots)r.items():
    m = meshes[f"{shape[0]}x{shape[1]}"]
    tp = TensorParallel(m.model_group)
    for policy in ("full", "dots"):
        c = dataclasses.replace(config(arch), remat=True,
                                remat_policy=policy)
        local = params_from_jax(host(f"params/{arch}/"), device="cpu", cfg=c,
                                extents=m.extents, coords=m.coords)
        leaves = [t.requires_grad_() for t in T.leaves(local)]
        m.model_group.reset_counts()
        loss = loss_fn(local, c, batch_of(c, 4, 16), tp)
        info[f"dots/{arch}/{policy}/forward"] = dict(
            m.model_group.calls_by_op)
        grads = torch.autograd.grad(loss, leaves)
        info[f"dots/{arch}/{policy}/calls"] = dict(m.model_group.calls_by_op)
        for (p, _), g in zip(T.flatten(local), grads):
            arrays[f"dots/{arch}/{policy}/grad/{p}"] = g.numpy()

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

# -- the legacy build_train_step against the session's step -----------------
import hashlib
from repro_torch.fabric import TrainState
from repro_torch.models import Transformer
from repro_torch.models.transformer import param_pspecs
from repro_torch.optim import Zero1, optimizer_state_pspecs
from repro_torch.runtime import build_train_step
from repro_torch.runtime.shardings import sanitize_pspecs

meshes["4x1"] = ProcessMesh((4, 1), device="cpu")
LEGACY_PLAN = plan_presets(error_feedback=True)["gbin_packed"]


def digest(tree):
    h = hashlib.sha256()
    for x in T.leaves(tree):
        h.update(x.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


for tag in ("2x2", "1x4", "4x1"):
    m = meshes[tag]
    cs = build_train_step(cfg, m, ADAM, LEGACY_PLAN,
                          init_params(cfg, device="meta"))
    tp = TensorParallel(m.model_group) if m.model_size > 1 else None
    session = Fabric(mesh=m)
    # the session's specs and ZeRO-1 partition, built as the Trainer builds
    # them
    whole = init_params(cfg, device="meta")
    specs = sanitize_pspecs(param_pspecs(cfg), whole, m.extents)
    own = None if m.data_size == 1 else Zero1.from_specs(
        m.data_group, optimizer_state_pspecs(
            specs, whole, dp_axes=m.data_axes, dp_size=m.data_size),
        m.data_axes)
    # at (4, 1) the session's step on the legacy step's policies, and
    # ("bucketed") a session on the mesh's data group alone, a worker
    # group without specs, which buckets the "model"-specced leaves
    paths = {"legacy": cs.aux["fabric"], "session": session}
    if tag == "4x1":
        paths["bucketed"] = Fabric(group=m.data_group)
    steps, states = {}, {}
    for path, fab in paths.items():
        model = Transformer(cfg, device="cpu", seed=0, tp=tp)
        params = model.tree()
        zero = cs.aux["zero"] if path == "legacy" else own
        states[path] = TrainState(
            model=model, opt=ADAM.init(params, zero=zero),
            ef=fab.init_ef(params, cs.aux["policies"]))
        steps[path] = cs.step_fn if path == "legacy" else fab.build_step(
            ADAM, cs.aux["policies"] if path == "session" and tag == "4x1"
            else LEGACY_PLAN, params, model.loss,
            pspecs=None if path == "bucketed" else specs, zero=zero)
    info[f"legacy/{tag}/layout"] = [
        cs.aux["num_launches"], steps["session"].layout.num_launches,
        sorted(u.name for u in cs.aux["layout"].unfused),
        cs.aux["zero"] is not None]
    if tag == "4x1":
        # the session's step on the plan resolves with the specs too
        info["legacy/4x1/on_plan"] = session.build_step(
            ADAM, LEGACY_PLAN, init_params(cfg, device="meta"), model.loss,
            pspecs=specs, zero=own).layout.num_launches
        info["legacy/4x1/bucketed_unfused"] = len(
            steps["bucketed"].layout.unfused)
    info[f"legacy/{tag}/fp32"] = sorted(
        p for p, pol in T.flatten(cs.aux["policies"])
        if str(getattr(pol.mode, "value", pol.mode)) == "fp32")
    for k in range(2):
        batch = {n: torch.as_tensor(v) for n, v in data.batch_at(k).items()}
        for path in paths:
            st, metrics, agg = steps[path](states[path], batch)
            states[path] = st
            info[f"legacy/{tag}/{path}/{k}"] = {
                "loss": float(metrics["loss"]),
                "agg_norm": float(metrics["agg_norm"]),
                "params": digest(st.model.tree()), "agg": digest(agg),
                "mu": digest(st.opt.mu), "nu": digest(st.opt.nu),
                "ef": digest(st.ef)}
            if tag == "4x1" and k == 0 and path != "session":
                for p, u in T.flatten(agg):
                    arrays[f"legacy/{tag}/{path}/agg/{p}"] = u.numpy()

# -- the paper controller on the (2, 2) mesh ---------------------------------


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
