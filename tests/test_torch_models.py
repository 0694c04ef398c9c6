"""The port's model zoo against the reference's.

At smoke widths on the CPU, with the reference's parameters carried
across (``params_from_jax``):

  * each of the ten SMOKE configs (dense with qk-norm, qkv bias, GELU
    and local/global layers; MoE with a dense prefix; the VLM with patch
    features; xLSTM's mLSTM and sLSTM blocks; hymba's attention beside a
    Mamba head; whisper's encoder and cross-attending decoder): logits,
    loss and every gradient leaf equal ``jax.value_and_grad`` of
    ``repro.models.loss_fn`` under ``jit``;
  * the blocked attention path: ``_flash_attention`` with 64-token blocks
    and S not a multiple of the block, and ``attn_forward`` at S = 2304
    (over the 2048 threshold) on gemma3-smoke's global and window-8
    layers, which holds rows whose first key block is wholly masked and
    rows whose wholly masked blocks the port skips;
  * ``moe_forward`` with capacity overflow and shared experts;
  * the FULL configs' leaf names, bucket layouts and gbin_packed traffic
    ratios, from shapes alone (``jax.eval_shape`` against the port's
    ``meta`` tree), and the depth cuts of chip runs L to P;
  * two steps of the port's Trainer against the reference's Trainer (on
    four forced host devices, in a subprocess), the new families'
    Trainer steps and aggregates against the reference's Fabric, the
    launcher (and its refusal of whisper) and the MoE checkpoint in both
    packages.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_latest as j_restore_latest  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import Commander as JCommander  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import loss_fn as j_loss_fn  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import \
    global_attention_flags as j_flags  # noqa: E402
from repro_torch.checkpoint import (load_train_state, restore_latest,  # noqa: E402
                                    save_checkpoint, train_state_arrays)
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import Commander, codec_name  # noqa: E402
from repro_torch.core import plan_traffic_ratio  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import FramesStream, SyntheticLMStream  # noqa: E402
from repro_torch.fabric import Fabric, TrainState, plan_presets  # noqa: E402
from repro_torch.launch.train import main as launch_main  # noqa: E402
from repro_torch.models import (Transformer, count_params, forward,  # noqa: E402
                                global_attention_flags, init_params, loss_fn,
                                params_from_jax)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamW, SgdMomentum  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
NEW = ("gemma3_27b", "qwen2p5_14b", "starcoder2_15b", "phi3_vision_4p2b",
       "deepseek_moe_16b", "llama4_scout_17b_a16e", "xlstm_125m",
       "hymba_1p5b", "whisper_tiny")

#: gbin_packed's traffic ratio on each FULL config, the reference's
#: (``Fabric.group_sizes`` and ``plan_traffic_ratio`` on its shapes)
FULL_RATIOS = {
    "llama4_scout_17b_a16e": 0.04988792473262491,
    "deepseek_moe_16b": 0.05627578414242181,
    "starcoder2_15b": 0.06795033676786282,
    "gemma3_27b": 0.0818237320292636,
    "phi3_vision_4p2b": 0.08200166283090937,
    "qwen2p5_14b": 0.1334133419616287,
    "xlstm_125m": 0.4391217050767943,
    "hymba_1p5b": 0.10261667878570666,
    "whisper_tiny": 0.5627112239971452,
}


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _reference_params(arch: str, seed: int = 0):
    """The reference's SMOKE parameters as numpy, with the embedding at
    unit scale and random qkv biases.

    The init's 0.02-scale embedding is renormalized by the first RMSNorm,
    which scales its gradient up ~50x, past 1 in magnitude, where the
    tolerance would be finer than float32 resolves; the reference's
    zero-initialised biases would leave the bias add untested.  Both
    packages get the same numbers."""
    jcfg = j_get_config(arch, smoke=True)
    host = jax.tree.map(np.asarray,
                        j_init_params(jax.random.PRNGKey(seed), jcfg))
    host["embed"]["tok"] = host["embed"]["tok"] * 50.0
    rng = np.random.RandomState(seed + 1)
    stacks = [host[k] for k in ("layers", "encoder") if k in host]
    for layer in stacks + host.get("prefix", []):
        for attn in (layer[k] for k in ("attn", "cross") if k in layer):
            for b in ("bq", "bk", "bv"):
                if b in attn:
                    attn[b] = rng.randn(*attn[b].shape).astype(
                        np.float32) * 0.5
    return jcfg, host


def _batch(cfg, b: int = 2, s: int = 16, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.vision_patches:
        batch["patch_feats"] = rng.randn(
            b, cfg.vision_patches, cfg.vision_feat_dim).astype(np.float32)
        batch["loss_mask"] = (rng.rand(b, s) < 0.7).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(b, cfg.encoder_seq,
                                    cfg.d_model).astype(np.float32)
    return batch


#: tokens of each SMOKE model's test batch: hymba's past its 16-token
#: window, so the local layer masks; xLSTM's 16 run the chunked scan
SMOKE_SEQ = {"hymba_1p5b": 24}


def _grads(params: dict, cfg, batch: dict):
    leaves = T.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lval = loss_fn(params, cfg, tb)
    return lval, torch.autograd.grad(lval, leaves)


# ---------------------------------------------------------------------------
# configs and the forward / backward pass
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    """All ten of the reference's architectures, with its values; an
    unknown family and the 'dots' remat policy raise."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.configs import NOT_PORTED
    assert ARCH_IDS == J_ARCH_IDS and NOT_PORTED == ()
    for arch in ARCH_IDS:
        for smoke in (False, True):
            got = dataclasses.asdict(get_config(arch, smoke))
            assert got == dataclasses.asdict(j_get_config(arch, smoke)), arch
            np.testing.assert_array_equal(
                global_attention_flags(get_config(arch, smoke)),
                j_flags(j_get_config(arch, smoke)))
    assert get_config("gemma3-27b") is get_config("gemma3_27b")
    assert get_config("qwen2.5-14b", smoke=True).name == "qwen2.5-smoke"
    assert get_config("xlstm-125m") is get_config("xlstm_125m")
    assert get_config("hymba-1.5b", smoke=True).name == "hymba-smoke"
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("mamba2_2p7b")
    other = dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                                family="rwkv")
    with pytest.raises(ValueError, match="unknown model family"):
        init_params(other, device="meta")


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "xlstm_125m"])
def test_dots_remat_policy_matches_full(arch):
    """``remat_policy="dots"`` (save the matrix products, recompute the
    rest) gives the logits and every gradient of ``"full"`` bit for bit
    (xLSTM's blocks take no per-block remat, so both run alike)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, s=4).items()}
    leaves = [t.requires_grad_() for t in T.leaves(params)]
    out = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        logits = forward(params, c, batch)
        assert logits.shape == (2, 4, cfg.vocab_size)
        grads = torch.autograd.grad(loss_fn(params, c, batch), leaves)
        out[policy] = (logits.detach(), grads)
    assert torch.equal(out["dots"][0], out["full"][0])
    for (p, _), a, b in zip(T.flatten(params), out["dots"][1],
                            out["full"][1]):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_accounting_matches_reference(arch):
    """The configs' own parameter accounting and cell list, as the
    reference computes them."""
    from repro.models.config import SHAPES as J_SHAPES
    from repro_torch.models import SHAPES
    assert [dataclasses.astuple(c) for c in SHAPES] == \
        [dataclasses.astuple(c) for c in J_SHAPES]
    for smoke in (False, True):
        cfg, jcfg = get_config(arch, smoke), j_get_config(arch, smoke)
        assert (cfg.hd, cfg.is_subquadratic, cfg.param_count(),
                cfg.active_param_count()) == \
            (jcfg.hd, jcfg.is_subquadratic, jcfg.param_count(),
             jcfg.active_param_count())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_model_matches_reference(arch):
    """Logits to 1e-5, the loss to rtol 1e-5 and every gradient leaf to
    rtol 1e-4, atol 1e-5 (float32; summation orders differ)."""
    jcfg, host = _reference_params(arch)
    cfg = get_config(arch, smoke=True)
    params = params_from_jax(host, device="cpu")
    j_paths = [_jpath(kp) for kp, _ in
               jax.tree_util.tree_flatten_with_path(host)[0]]
    assert [p for p, _ in T.flatten(params)] == j_paths
    # the port's own init: the same tree, shapes and dtypes
    assert [(p, tuple(t.shape), t.dtype) for p, t in
            T.flatten(init_params(cfg, device="meta"))] == \
        [(p, tuple(t.shape), t.dtype) for p, t in T.flatten(params)]
    batch = _batch(cfg, s=SMOKE_SEQ.get(arch, 16))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = np.asarray(jax.jit(lambda p, b: j_forward(p, jcfg, b))(host, jb))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, jcfg, b)))(host, jb)
    with torch.no_grad():
        logits = forward(params, cfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-5, atol=1e-5)
    lval, grads = _grads(params, cfg, batch)
    np.testing.assert_allclose(float(lval), float(jl), rtol=1e-5)
    for (p, _), g, j in zip(T.flatten(params), grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{arch}: {p}")
    if cfg.vision_patches:        # the patch projector's gradient is real
        assert float(grads[j_paths.index("embed/patch_proj/w")].abs().max()) > 0
    assert count_params(params) == sum(a.size for a in jax.tree.leaves(host))


# ---------------------------------------------------------------------------
# blocked attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "causal": dict(causal=True, window=None, is_global=True),
    "local8": dict(causal=True, window=8, is_global=False),
    "local80": dict(causal=True, window=80, is_global=False),
    "global_with_window": dict(causal=True, window=8, is_global=True),
    "non_causal": dict(causal=False, window=None, is_global=True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_small_blocks_matches_reference(case, dtype):
    """64-token blocks over S = T = 200 (padded to 256): float32 to 1e-6;
    bfloat16 to one bf16 ulp of the output (the PV product rounds to
    bf16 on both sides, from sums taken in other orders)."""
    rng = np.random.RandomState(0)
    q = rng.randn(2, 200, 2, 3, 16).astype(np.float32)
    k = rng.randn(2, 200, 2, 16).astype(np.float32)
    v = rng.randn(2, 200, 2, 16).astype(np.float32)
    kw = dict(FLASH_CASES[case], scale=0.25, block_q=64, block_k=64)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda a, b, c: JL._flash_attention(a, b, c, **kw))(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    got = L._flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                             **kw)
    assert got.dtype == td and got.shape == q.shape
    want = np.asarray(want.astype(jnp.float32))
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def _gemma_attention(seed: int = 0):
    cfg = get_config("gemma3_27b", smoke=True)
    rng = np.random.RandomState(seed)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {"wq": rng.randn(d, h * hd), "wk": rng.randn(d, kv * hd),
         "wv": rng.randn(d, kv * hd), "wo": rng.randn(h * hd, d),
         "q_norm": {"scale": 1 + 0.1 * rng.randn(hd)},
         "k_norm": {"scale": 1 + 0.1 * rng.randn(hd)}}
    p = jax.tree.map(lambda a: (a / 8).astype(np.float32), p)
    x = rng.randn(1, 2304, d).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("is_global", [True, False], ids=["global", "local"])
def test_attn_forward_blocked_above_threshold(is_global, monkeypatch):
    """S = 2304 > 2048 on gemma3-smoke (window 8, blocks of 1024): the
    port's blocked path against the reference's and against the port's
    own full-scores path, forward and the gradient of a fixed cotangent.

    On the local layer query block 1 processes key block 0 (its first
    rows see keys there) while its rows from 1031 on have none: their
    running max goes through -1e30 and is wiped, as in the reference.
    Query block 2 skips key block 0, which is wholly out of every row's
    window.  The reference, jitted on the CPU, sits up to 2.5e-5 from a
    float64 evaluation here, the port within 2e-6: so 5e-5 against the
    reference, 1e-5 against the full-scores path."""
    cfg, p, x = _gemma_attention()
    assert not L._block_live(2048, 1024, 0, 1024, causal=True, window=8,
                             is_global=False)
    assert L._block_live(1024, 1024, 0, 1024, causal=True, window=8,
                         is_global=False)
    jcfg = j_get_config("gemma3_27b", smoke=True)
    ct = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jfn(pp, xx):
        return JL.attn_forward(pp, xx, jcfg, is_global=is_global)

    jout, jvjp = jax.vjp(jax.jit(jfn), p, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(ct))

    def port(threshold):
        monkeypatch.setattr(L, "FLASH_SEQ_THRESHOLD", threshold)
        tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), p)
        tx = torch.from_numpy(x).requires_grad_()
        out = L.attn_forward(tp, tx, cfg, is_global=is_global)
        grads = torch.autograd.grad(out, [tx, *T.leaves(tp)],
                                    torch.from_numpy(ct))
        return out.detach().numpy(), [g.numpy() for g in grads]

    blocked, bgrads = port(2048)
    full, fgrads = port(4096)
    np.testing.assert_allclose(blocked, np.asarray(jout), rtol=0, atol=5e-5)
    np.testing.assert_allclose(blocked, full, rtol=0, atol=1e-5)
    want = [np.asarray(jgx), *(np.asarray(g) for g in jax.tree.leaves(jgp))]
    for got, ref, alt in zip(bgrads, want, fgrads):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * scale)
        np.testing.assert_allclose(got, alt, rtol=0, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
def test_moe_forward_matches_reference(arch):
    """One MoE layer over 2 x 40 tokens (groups of 32, the last padded),
    with the router tilted toward expert 0 so that it overflows its
    capacity and tokens are dropped, and the shared experts on.  The
    inputs keep every token's top-k gates apart (checked) so that a
    float32 near-tie cannot route a token differently in the two
    packages.  Output and gradients to 1e-5."""
    jcfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    m = cfg.moe
    host = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(3),
                                                  jcfg))["layers"]["moe"]
    host = jax.tree.map(lambda a: a[0], host)
    host["router"] = host["router"].copy()
    host["router"][:, 0] += 0.4
    x = np.random.RandomState(4).randn(2, 40, cfg.d_model).astype(np.float32)

    # the routes, from the inputs: the gaps between each real token's
    # top-(k+1) gates, and how many choices land on each expert of each
    # group (the 16 zero pad tokens tie, and both packages take the lower
    # index there)
    xt = np.concatenate([x.reshape(80, -1),
                         np.zeros((16, cfg.d_model), np.float32)])
    logits = xt.astype(np.float64) @ host["router"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    top = -np.sort(-gates[:80], axis=-1)[:, :m.top_k + 1]
    assert -np.diff(top, axis=-1).min() > 1e-5
    cap = min(max(4, int(32 * m.top_k / m.num_experts * m.capacity_factor)),
              32)
    chosen = np.argsort(-gates, axis=-1, kind="stable")[:, :m.top_k]
    per_expert = np.stack([(chosen.reshape(3, -1) == e).sum(axis=1)
                           for e in range(m.num_experts)], -1)
    assert (per_expert > cap).any(), "no expert overflows its capacity"
    assert "shared" in host

    ct = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    jout, jvjp = jax.vjp(jax.jit(lambda p, a: JL.moe_forward(p, a, jcfg)),
                         host, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(ct))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), host)
    tx = torch.from_numpy(x).requires_grad_()
    out = L.moe_forward(tp, tx, cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out, [tx, *T.leaves(tp)],
                                torch.from_numpy(ct))
    want = [np.asarray(jgx), *(np.asarray(g) for g in jax.tree.leaves(jgp))]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.1]])
    v, i = L._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 3, 0]]
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# FULL configs: leaves, layouts and traffic from shapes alone
# ---------------------------------------------------------------------------

#: chip runs L to P: (config, depth, workers, buckets, low-bit buckets,
#: float32 low-bit buckets, the reference's gbin_packed traffic ratio,
#: parameters)
CHIP_CUTS = {"L": ("gemma3_27b", 6, 2, 9, 7, 0, 0.3825361348161055,
                   3_886_618_368),
             "M": ("deepseek_moe_16b", 3, 4, 15, 12, 0, 0.27310381290117447,
                   1_681_143_808),
             "N": ("xlstm_125m", 4, 2, 7, 4, 1, 0.6954820233478944,
                   112_700_184),
             "O": ("hymba_1p5b", 4, 2, 12, 9, 2, 0.4075318986281921,
                   263_710_400),
             "P": ("whisper_tiny", 4, 4, 4, 1, 0, 0.5627112239971452,
                   36_586_752)}


def _layouts_agree(cfg, jcfg, workers: int = 4):
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    meta = init_params(cfg, device="meta")
    assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in T.flatten(meta)] == \
        [(_jpath(kp), tuple(s.shape), str(s.dtype)) for kp, s in
         jax.tree_util.tree_flatten_with_path(shapes)[0]]
    jfab = JFabric(dp_axes=("w",), num_workers=workers)
    fab = Fabric(num_workers=workers)
    want = jfab.layout_for(shapes, j_plan_presets()["gbin_packed"])
    got = fab.layout_for(meta, plan_presets()["gbin_packed"])
    assert not got.unfused and not want.unfused
    assert got.num_leaves == want.num_leaves
    assert len(got.buckets) == len(want.buckets)
    for a, b in zip(got.buckets, want.buckets):
        assert codec_name(a.key.mode) == b.key.mode.value
        assert (a.key.schedule, a.key.error_feedback, a.key.gate_phase,
                a.key.dtype, a.size) == (b.key.schedule, b.key.error_feedback,
                                         b.key.gate_phase, b.key.dtype, b.size)
        assert [(s.leaf, s.name, s.shape, s.size, s.offset) for s in a.slots] \
            == [(s.leaf, s.name, s.shape, s.size, s.offset) for s in b.slots]
    sizes = fab.group_sizes(meta)
    assert sizes == jfab.group_sizes(shapes)
    return got, sizes, meta


@pytest.mark.parametrize("arch", NEW)
def test_full_config_layout_and_traffic_match_reference(arch):
    cfg = get_config(arch)
    layout, sizes, meta = _layouts_agree(cfg, j_get_config(arch))
    ratio = plan_traffic_ratio(sizes, plan_presets()["gbin_packed"])
    assert abs(ratio - FULL_RATIOS[arch]) <= 1e-12
    assert count_params(meta) == sum(sizes.values())
    assert any(b.key.schedule == "packed_a2a" for b in layout.buckets)


@pytest.mark.parametrize("run", sorted(CHIP_CUTS))
def test_chip_run_depth_cuts(run):
    """The layouts the chip runs check: buckets, low-bit buckets and the
    float32 ones among them (xLSTM's w_if and r, hymba's w_dt, w_bc and
    a_log: their decodes are float32 launches)."""
    arch, depth, workers, buckets, lowbit, lowbit_f32, ratio, n = \
        CHIP_CUTS[run]
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    jcfg = dataclasses.replace(j_get_config(arch), num_layers=depth)
    layout, sizes, meta = _layouts_agree(cfg, jcfg, workers=workers)
    assert len(layout.buckets) == buckets
    low = [b for b in layout.buckets if codec_name(b.key.mode) != "fp32"]
    assert len(low) == lowbit
    assert sum(b.key.dtype == "float32" for b in low) == lowbit_f32
    assert {b.key.dtype for b in low} <= {"float32", "bfloat16"}
    assert abs(plan_traffic_ratio(sizes, plan_presets()["gbin_packed"])
               - ratio) <= 1e-12
    assert count_params(meta) == n


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
def test_zoo_routers_and_heads_grouped_head(arch):
    """MoE routers land in the head group, and the Commander's plan on
    healthy cosines is the reference's."""
    cfg = get_config(arch, smoke=True)
    meta = init_params(cfg, device="meta")
    fab = Fabric(num_workers=8)
    sizes = fab.group_sizes(meta)
    assert "head" in sizes
    routers = [p for p, _ in T.flatten(meta) if p.endswith("/router")]
    assert routers and all(fab.rules.group_of(p) == "head" for p in routers)
    cosines = {g: {"gbinary": 0.9, "gternary": 0.85} for g in sizes}
    plan = Commander().propose(cosines)
    assert plan.signature() == JCommander().propose(cosines).signature()
    assert codec_name(plan.policy_for("backbone").mode) == "gbinary"
    assert codec_name(plan.policy_for("norms").mode) == "fp32"
    assert codec_name(plan.default.mode) == "fp32"


# ---------------------------------------------------------------------------
# Trainer, launcher and checkpoint
# ---------------------------------------------------------------------------

W = 4
TRAIN_RUNS = {"deepseek_moe_16b": dict(seq=16, batch=8),
              "gemma3_27b": dict(seq=2304, batch=4)}
SGD = dict(peak_lr=0.05, warmup_steps=1, total_steps=10)

REFERENCE_TRAINER = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.environ["SRC"])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.data import SyntheticLMStream
from repro.fabric import Fabric
from repro.fabric.control import plan_presets
from repro.models import loss_fn
from repro.optim import SgdMomentum
from repro.runtime import Trainer, TrainerConfig

W = 4
RUNS = %(runs)r
mesh = jax.make_mesh((W, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
plan = plan_presets()["gbin_packed"]
vfab = Fabric(dp_axes=("w",), num_workers=W)
out = {}


def name(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def put(prefix, tree):
    for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + name(kp)] = np.asarray(a)


for arch, run in RUNS.items():
    cfg = get_config(arch, smoke=True)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=run["seq"],
                             batch=run["batch"], seed=0)
    tr = Trainer(cfg, mesh, SgdMomentum(**%(sgd)r), data, plan=plan,
                 tcfg=TrainerConfig(dp_axes=("data",), log_interval=1000))
    tr.init_state()
    put(f"{arch}/0/params/", tr.state.params)

    @jax.jit
    def aggregate(params, shards):
        def one(b):
            g = jax.grad(lambda p: loss_fn(p, cfg, b))(params)
            return vfab.aggregate(g, plan)[0], g
        agg, g = jax.vmap(one, axis_name="w")(shards)
        return jax.tree.map(lambda x: x[0], agg), g

    for k in range(2):
        batch = data.batch_at(k)
        shards = {n: jnp.asarray(v.reshape(W, -1, *v.shape[1:]))
                  for n, v in batch.items()}
        agg, g = aggregate(tr.state.params, shards)
        put(f"{arch}/{k}/agg/", agg)
        put(f"{arch}/{k}/grads/", g)
        tr.run(k + 1)
        out[f"{arch}/{k}/loss"] = np.asarray(tr.history[-1]["loss"])
        put(f"{arch}/{k + 1}/params/", tr.state.params)
np.savez(os.environ["OUT_FILE"], **out)
'''


@pytest.fixture(scope="module")
def reference_trainer(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "trainer.npz"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(SRC=SRC, OUT_FILE=str(out), JAX_PLATFORMS="cpu")
    program = REFERENCE_TRAINER % {"runs": TRAIN_RUNS, "sgd": SGD}
    r = subprocess.run([sys.executable, "-c", program], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("arch", sorted(TRAIN_RUNS))
def test_trainer_matches_reference_trainer(arch, reference_trainer):
    """Two gbin_packed steps at W = 4 (gemma3-smoke at S = 2304, on the
    blocked path), the port's Trainer against the reference's Trainer on
    four host devices, each step started from the reference Trainer's
    parameters.

    A step's vote aggregates equal the reference Fabric's on those
    parameters bit for bit, except where some worker's gradient element
    lies below 1e-6 of its largest (float32 sums in another order may
    flip such a vote; none may flip elsewhere, and at most 1e-4 of the
    backbone); FP32 means to rtol 1e-5 plus 1e-5 of the leaf's largest;
    the loss to rtol 1e-5; the parameters after the step to rtol 1e-5,
    atol 1e-6, but for elements whose vote flipped (their update, and
    momentum, differ by design)."""
    ref, run = reference_trainer, TRAIN_RUNS[arch]
    cfg = get_config(arch, smoke=True)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=run["seq"],
                             batch=run["batch"], seed=0)
    plan = plan_presets()["gbin_packed"]
    trainer = Trainer(cfg, SgdMomentum(**SGD), data, plan=plan,
                      fabric=Fabric(num_workers=W), device="cpu")
    trainer.init_state()
    params = trainer.state.model.tree()
    votes = {s.name for b in trainer.fabric.layout_for(params, plan).buckets
             if b.key.schedule == "packed_a2a" for s in b.slots}
    assert votes and "embed/tok" not in votes
    flipped = {p: np.zeros(t.shape, bool) for p, t in T.flatten(params)}
    for k in range(2):
        with torch.no_grad():
            for p, t in T.flatten(params):
                t.copy_(torch.from_numpy(ref[f"{arch}/{k}/params/{p}"]))
        trainer.run(k + 1)
        np.testing.assert_allclose(trainer.history[-1]["loss"],
                                   ref[f"{arch}/{k}/loss"], rtol=1e-5)
        for p, u in T.flatten(trainer.last_aggregates):
            want = ref[f"{arch}/{k}/agg/{p}"]
            if p not in votes:
                np.testing.assert_allclose(
                    u.numpy(), want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max(), err_msg=f"{k}: {p}")
                continue
            diff = u.numpy() != want
            x = np.abs(ref[f"{arch}/{k}/grads/{p}"]).reshape(W, -1)
            small = (x < 1e-6 * x.max(axis=1, keepdims=True)).any(axis=0)
            assert not (diff.reshape(-1) & ~small).any(), (k, p)
            flipped[p] |= diff
        assert sum(flipped[p].sum() for p in votes) <= 1e-4 * sum(
            flipped[p].size for p in votes)
        for p, t in T.flatten(params):
            keep = ~flipped[p]
            np.testing.assert_allclose(
                t.detach().numpy()[keep],
                ref[f"{arch}/{k + 1}/params/{p}"][keep], rtol=1e-5,
                atol=1e-6, err_msg=f"step {k}: {p}")


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "phi3_vision_4p2b",
                                  "xlstm_125m", "hymba_1p5b"])
def test_launcher_runs_a_new_architecture_on_cpu(arch, capsys):
    """The MoE model, the VLM fed tokens only (as the reference's
    launcher feeds it: its patch projector's gradient is zero), xLSTM and
    hymba."""
    history = launch_main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--mesh", "4,1", "--steps", "2", "--seq-len",
                           "16", "--plan", "gbin_packed"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert "workers=4" in capsys.readouterr().out


def test_launcher_refuses_whisper_by_name(capsys):
    """The reference's launcher feeds whisper tokens only and its forward
    then fails on ``batch["frames"]`` (a KeyError); the port's launcher
    refuses the architecture up front and says why."""
    with pytest.raises(SystemExit) as exc:
        launch_main(["--arch", "whisper_tiny", "--smoke", "--device", "cpu",
                     "--mesh", "4,1", "--steps", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "batch['frames']" in err and "tokens only" in err


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1p5b", "whisper_tiny"])
def test_new_family_trains_and_aggregates_as_the_reference(arch):
    """Two gbin_packed steps of the port's Trainer at W = 4 on the SMOKE
    config (whisper on a stream with frames), then one batch's worker
    gradients through the port's Fabric and through the reference's
    (``jax.vmap`` over four virtual workers): every packed float32
    bucket (xLSTM's w_if and r, hymba's w_dt, w_bc and a_log among them)
    votes byte for byte as the reference; FP32 means to rtol 1e-6 plus
    1e-6 of the leaf's largest (sums in other orders)."""
    cfg = get_config(arch, smoke=True)
    seq = SMOKE_SEQ.get(arch, 16)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=seq, batch=8,
                             seed=0)
    if cfg.family == "encdec":
        data = FramesStream(data, cfg.encoder_seq, cfg.d_model)
    plan = plan_presets()["gbin_packed"]
    trainer = Trainer(cfg, AdamW(), data, plan=plan,
                      fabric=Fabric(num_workers=W), device="cpu")
    history = trainer.run(2)
    assert all(np.isfinite(h["loss"]) for h in history)
    model = trainer.state.model
    params = model.tree()
    if cfg.family == "ssm":      # a list of blocks with their own keys
        assert [sorted(b) for b in params["blocks"]] == \
            [["mlstm", "norm1"]] * 3 + [["norm1", "slstm"]]
    fabric = trainer.fabric
    layout = fabric.layout_for(params, plan)
    packed = {s.name for b in layout.buckets
              if b.key.schedule == "packed_a2a" for s in b.slots}
    assert packed
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(2).items()}
    grads, _ = fabric.worker_grads(params, batch, model.loss)
    agg, _ = fabric.aggregate(grads, plan)

    jfab = JFabric(dp_axes=("w",), num_workers=W)
    jplan = j_plan_presets()["gbin_packed"]
    host = T.map_leaves(lambda g: g.numpy(), grads)
    jagg = jax.jit(jax.vmap(lambda g: jfab.aggregate(g, jplan)[0],
                            axis_name="w"))(host)
    for (p, u), want in zip(T.flatten(agg), jax.tree.leaves(jagg)):
        want = np.asarray(want)[0]
        if p in packed:
            np.testing.assert_array_equal(u.numpy(), want, err_msg=p)
        else:
            np.testing.assert_allclose(u.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=p)


def _moe_state(seed: int):
    """A port train state of the MoE smoke model with random moments."""
    cfg = get_config("deepseek_moe_16b", smoke=True)
    model = Transformer(cfg, seed=seed, device="cpu")
    opt = AdamW().init(model.tree())
    gen = torch.Generator().manual_seed(seed)
    for t in T.leaves(opt.mu) + T.leaves(opt.nu):
        t.copy_(torch.rand(t.shape, generator=gen))
    fabric = Fabric()
    ef = fabric.init_ef(model.tree(), fabric.resolve(
        model.tree(), plan_presets()["gbin_packed"]))
    return TrainState(model=model, opt=opt, ef=ef, step=5)


def test_moe_checkpoint_reads_in_both_packages(tmp_path):
    """The port's checkpoint of the MoE smoke model (``prefix/0/...``
    leaves) restores into the reference's train state and back."""
    from repro.fabric.session import TrainState as JTrainState
    from repro.optim.optimizers import OptState as JOptState
    state = _moe_state(0)
    names = list(train_state_arrays(state))
    assert "params/prefix/0/attn/wq" in names
    assert "params/prefix/0/mlp/w_gate" in names
    save_checkpoint(str(tmp_path / "port"), 5, train_state_arrays(state))

    jcfg = j_get_config("deepseek_moe_16b", smoke=True)
    jp = j_init_params(jax.random.PRNGKey(1), jcfg)
    zeros = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    jstate = JTrainState(params=jp, opt=JOptState(
        step=jnp.asarray(0, jnp.int32), mu=zeros, nu=zeros),
        ef=jax.tree.map(lambda p: jnp.zeros((), jnp.float32), jp),
        step=jnp.asarray(0, jnp.int32))
    step, jtree, _ = j_restore_latest(str(tmp_path / "port"), jstate)
    assert step == 5 and int(jtree.step) == 5
    for got, (p, want) in zip(jax.tree.leaves(jtree.params),
                              T.flatten(state.model.tree())):
        np.testing.assert_array_equal(np.asarray(got),
                                      want.detach().numpy(), err_msg=p)
    for got, want in zip(jax.tree.leaves(jtree.opt.nu), T.leaves(state.opt.nu)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())

    # the reference's own checkpoint of that state, into another port state
    j_save_checkpoint(str(tmp_path / "ref"), 6, jtree)
    other = _moe_state(2)
    step, arrays, _ = restore_latest(str(tmp_path / "ref"))
    restored = load_train_state(other, arrays)
    assert step == 6 and restored.step == 5
    for (p, got), (_, want) in zip(T.flatten(restored.model.tree()),
                                   T.flatten(state.model.tree())):
        assert torch.equal(got, want), p
    assert isinstance(restored.model.tree()["prefix"], list)
