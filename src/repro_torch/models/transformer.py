"""The model zoo's LMs (port of ``repro/models/transformer.py``): dense,
MoE and VLM decoders, the hybrid (attention and a Mamba-style head in
parallel in every layer), the SSM stack (xLSTM) and the
encoder-decoder (whisper).

The parameter tree keeps the reference's layout — stacked ``(L, ...)``
layer tensors, weights ``(in, out)`` used as ``x @ w``, an optional tied
embedding, DeepSeekMoE's dense first layers as a ``prefix`` list of
unstacked layers, the VLM's ``embed/patch_proj``, xLSTM's ``blocks``
list of unstacked blocks with ``mlstm`` or ``slstm`` keys, whisper's
``embed/frame_proj``, stacked ``encoder`` and cross-attending ``layers``
— so the tree flattens to the same leaves, in the same order, as
``jax.tree_util`` gives the reference's (see
:mod:`repro_torch.core.tree`), and the bucket layout is the same.
Per-layer local/global attention follows :func:`global_attention_flags`.
Every layer runs under ``torch.utils.checkpoint`` when ``cfg.remat`` and
grad are on, except xLSTM's blocks: the reference recomputes those only
through the chunks of their scans (:func:`repro_torch.models.ssm.
chunked_scan`).

    init_params(cfg, generator=..., device=...) -> params tree
    forward(params, cfg, batch[, tp])           -> logits
    init_cache(cfg, batch, max_seq[, enc_out][, mesh=])
                                                -> decode cache (a block)
    decode_step(params, cfg, token, cache, pos[, layout])
                                                -> (logits, cache)
    loss_fn(params, cfg, batch[, tp])           -> scalar CE loss
    Transformer(cfg, device=..., seed=...)      -> nn.Module over the tree
    param_pspecs(cfg)                           -> the reference's TP specs
    cache_pspecs(cfg, shard_seq=, dp_axes=)     -> its serving cache specs

``init_params(cfg, device="meta")`` gives the tree's shapes and dtypes
without allocating it (what a bucket layout needs).

Tensor parallelism (``tp``, a :class:`~repro_torch.models.tp.
TensorParallel` over the model group) runs every family: each rank
holds the blocks :func:`param_pspecs` gives it (:func:`shard_params`; a
rank initialises the whole tree from the seed and keeps its blocks, so
it starts from the unsharded run's weights), the embedding and the
tied or untied head are vocab-parallel where the axis divides the
vocabulary, the VLM's ``patch_proj`` and whisper's ``frame_proj``
column-parallel, the MoE's experts over the group, the recurrent blocks
as :mod:`repro_torch.models.ssm` lays them out, and the loss is the
vocab-parallel float32 cross-entropy.  The decode step takes the same
split (:class:`DecodeLayout`, built by
:func:`repro_torch.runtime.serve.build_serve_step` on a mesh), with the
cache's sequence spread over a group (whisper's cross cache its
frames), an xLSTM's states replicated over the model group and a
hybrid's Mamba states split by channel; every family decodes with its
batch spread over the data ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core import tree as T
from ..core.device import resolve_device
from . import layers as L
from . import ssm as S
from .config import ModelConfig
from .layers import _dtype, _normal
from .tp import TP_ALL_GATHER, TP_ALL_REDUCE, TensorParallel

#: the families this port runs: all of the reference's
PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")


def global_attention_flags(cfg: ModelConfig) -> np.ndarray:
    """(L,) bool: global (True) or sliding-window attention per layer."""
    n = cfg.num_layers
    if cfg.sliding_window is None:
        return np.ones((n,), bool)
    if cfg.global_every:                       # gemma3: every Nth is global
        return np.asarray([(i % cfg.global_every) == cfg.global_every - 1
                           for i in range(n)])
    if cfg.family == "hybrid":                 # hymba: first / middle / last
        keep = {0, n // 2, n - 1}
        return np.asarray([i in keep for i in range(n)])
    return np.zeros((n,), bool)               # pure sliding-window


def _is_slstm_block(cfg: ModelConfig, i: int) -> bool:
    e = cfg.ssm.slstm_every if cfg.ssm else 0
    return bool(e) and (i % e == e - 1)


def _init_layer(cfg: ModelConfig, gen, device, n: int | None,
                dense_ffn: bool = False) -> dict:
    """Parameters of ``n`` decoder layers stacked on a leading axis, or of
    one unstacked layer for ``n=None``.  ``dense_ffn`` gives a MoE
    config's dense layer: an MLP of ``d_expert * (top_k + num_shared)``."""
    d = cfg.d_model
    lead = () if n is None else (n,)
    p = {"norm1": L.init_rmsnorm(d, device, lead=lead),
         "attn": L.init_attention(cfg, gen, device, lead=lead),
         "norm2": L.init_rmsnorm(d, device, lead=lead)}
    if cfg.hybrid_parallel:
        p["ssm_head"] = S.init_mamba_head(cfg, gen, device, lead)
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = L.init_moe(cfg, gen, device, lead=lead)
    elif cfg.d_ff or dense_ffn:
        p["mlp"] = L.init_mlp(cfg, gen, device, _mlp_width(cfg), lead=lead)
    return p


def _mlp_width(cfg: ModelConfig) -> int:
    """The hidden width of a layer's dense MLP: a MoE config's dense
    layers take ``d_expert * (top_k + num_shared)``."""
    if cfg.moe is not None:
        return cfg.moe.d_expert * (cfg.moe.top_k + cfg.moe.num_shared)
    return cfg.d_ff


def _init_encoder_layer(cfg: ModelConfig, gen, device, n: int) -> dict:
    d, lead = cfg.d_model, (n,)
    return {"norm1": L.init_rmsnorm(d, device, lead=lead),
            "attn": L.init_attention(cfg, gen, device, lead=lead),
            "norm2": L.init_rmsnorm(d, device, lead=lead),
            "mlp": L.init_mlp(cfg, gen, device, lead=lead)}


def _init_decoder_xlayer(cfg: ModelConfig, gen, device, n: int) -> dict:
    d, lead = cfg.d_model, (n,)
    return {"norm1": L.init_rmsnorm(d, device, lead=lead),
            "attn": L.init_attention(cfg, gen, device, lead=lead),
            "norm_x": L.init_rmsnorm(d, device, lead=lead),
            "cross": L.init_cross_attention(cfg, gen, device, lead=lead),
            "norm2": L.init_rmsnorm(d, device, lead=lead),
            "mlp": L.init_mlp(cfg, gen, device, lead=lead)}


# ---------------------------------------------------------------------------
# partition specs (the reference's ``param_pspecs``; tuples of axis names)
# ---------------------------------------------------------------------------

def _layer_pspecs(cfg: ModelConfig, dense_ffn: bool = False) -> dict:
    p = {"norm1": {"scale": ()}, "attn": L.attention_pspecs(cfg),
         "norm2": {"scale": ()}}
    if cfg.hybrid_parallel:
        p["ssm_head"] = {
            "w_in": (None, "model"), "w_dt": (), "dt_bias": (), "w_bc": (),
            "a_log": ("model", None), "skip_scale": ("model",),
            "w_out": ("model", None)}
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = L.moe_pspecs(cfg)
    elif cfg.d_ff or dense_ffn:
        p["mlp"] = L.mlp_pspecs(cfg)
    return p


def _encoder_layer_pspecs(cfg: ModelConfig) -> dict:
    return {"norm1": {"scale": ()}, "attn": L.attention_pspecs(cfg),
            "norm2": {"scale": ()}, "mlp": L.mlp_pspecs(cfg)}


def _decoder_xlayer_pspecs(cfg: ModelConfig) -> dict:
    return {"norm1": {"scale": ()}, "attn": L.attention_pspecs(cfg),
            "norm_x": {"scale": ()}, "cross": L.attention_pspecs(cfg),
            "norm2": {"scale": ()}, "mlp": L.mlp_pspecs(cfg)}


def _stack(tree):
    """Specs of stacked ``(L, ...)`` leaves: a replicated layer axis."""
    if isinstance(tree, dict):
        return {k: _stack(v) for k, v in tree.items()}
    return (None, *tree)


def param_pspecs(cfg: ModelConfig) -> dict:
    """The spec tree of :func:`init_params`'s tree (tensor parallelism
    over ``"model"``), the reference's ``param_pspecs`` entry for entry;
    :func:`~repro_torch.runtime.shardings.sanitize_pspecs` replicates
    what a mesh does not divide."""
    specs: dict[str, Any] = {"embed": {"tok": ("model", None)},
                             "final_norm": {"scale": ()}}
    if not cfg.tie_embeddings:
        specs["head"] = {"w": (None, "model")}
    if cfg.vision_patches:
        specs["embed"]["patch_proj"] = {"w": (None, "model")}
    if cfg.family == "ssm":
        specs["blocks"] = [
            {"norm1": {"scale": ()}, "slstm": {
                "w_in": (None, "model"), "r": ("model", None, None),
                "bias": ("model",), "w_down": ("model", None)}}
            if _is_slstm_block(cfg, i) else
            {"norm1": {"scale": ()}, "mlstm": {
                "w_up": (None, "model"), "w_q": ("model", None),
                "w_k": ("model", None), "w_v": ("model", None),
                "w_ogate": (None, "model"), "w_if": ("model", None),
                "if_bias": (), "w_down": ("model", None)}}
            for i in range(cfg.num_layers)]
        return specs
    if cfg.family == "encdec":
        specs["embed"]["frame_proj"] = {"w": (None, "model")}
        specs["encoder"] = _stack(_encoder_layer_pspecs(cfg))
        specs["layers"] = _stack(_decoder_xlayer_pspecs(cfg))
        return specs
    n_prefix = _n_prefix(cfg)
    if n_prefix:
        specs["prefix"] = [_layer_pspecs(cfg, dense_ffn=True)
                           for _ in range(n_prefix)]
    specs["layers"] = _stack(_layer_pspecs(cfg))
    return specs


def shard_params(params: Any, cfg: ModelConfig, extents, coords) -> dict:
    """The blocks of a whole parameter tree (tensors or arrays) that the
    rank at ``coords`` of a mesh of ``extents`` holds, under the
    sanitized :func:`param_pspecs` (views, not copies)."""
    from ..runtime.shardings import sanitize_pspecs, shard_of
    specs = T.leaves(sanitize_pspecs(param_pspecs(cfg), params, extents))
    return T.unflatten([(p, shard_of(x, s, extents, coords))
                        for (p, x), s in zip(T.flatten(params), specs)])


def _n_prefix(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (normal init with the reference's scales; the
    qkv biases zero, as the reference's).  On the ``meta`` device the
    tree holds shapes and dtypes only and ``generator`` may be None."""
    device = resolve_device(device)
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"runs {PORTED_FAMILIES}")
    d, v, dt = cfg.d_model, cfg.vocab_size, _dtype(cfg)
    params: dict[str, Any] = {
        "embed": {"tok": _normal((v, d), 0.02, generator, device, dt)},
        "final_norm": L.init_rmsnorm(d, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": _normal((d, v), 1 / math.sqrt(d), generator,
                                       device, dt)}
    if cfg.vision_patches:
        f = cfg.vision_feat_dim
        params["embed"]["patch_proj"] = {
            "w": _normal((f, d), 1 / math.sqrt(f), generator, device, dt)}
    if cfg.family == "ssm":      # xLSTM: unrolled heterogeneous blocks
        params["blocks"] = [
            {"norm1": L.init_rmsnorm(d, device),
             "slstm": S.init_slstm(cfg, generator, device)}
            if _is_slstm_block(cfg, i) else
            {"norm1": L.init_rmsnorm(d, device),
             "mlstm": S.init_mlstm(cfg, generator, device)}
            for i in range(cfg.num_layers)]
        return params
    if cfg.family == "encdec":   # whisper: encoder + decoder stacks
        params["embed"]["frame_proj"] = {
            "w": _normal((d, d), 1 / math.sqrt(d), generator, device, dt)}
        params["encoder"] = _init_encoder_layer(cfg, generator, device,
                                                cfg.encoder_layers)
        params["layers"] = _init_decoder_xlayer(cfg, generator, device,
                                                cfg.num_layers)
        return params
    n_prefix = _n_prefix(cfg)
    if n_prefix:
        params["prefix"] = [_init_layer(cfg, generator, device, None,
                                        dense_ffn=True)
                            for _ in range(n_prefix)]
    params["layers"] = _init_layer(cfg, generator, device,
                                   cfg.num_layers - n_prefix)
    return params


def _layer_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   is_global: bool, positions: torch.Tensor,
                   tp: TensorParallel | None = None) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    a = L.attn_forward(p["attn"], h, cfg, is_global=is_global,
                       positions=positions, tp=tp)
    if cfg.hybrid_parallel:
        a = 0.5 * (a + S.mamba_forward(p["ssm_head"], h, cfg, tp))
    x = x + a
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + L.moe_forward(p["moe"], h, cfg, tp=tp)
    if "mlp" in p:
        return x + L.mlp_forward(p["mlp"], h, cfg, tp=tp,
                                 d_ff=_mlp_width(cfg))
    return x


def _encoder_layer_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           tp: TensorParallel | None = None) -> torch.Tensor:
    """Bidirectional self-attention encoder layer."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attn_forward(p["attn"], h, cfg, causal=False, tp=tp)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h, cfg, tp=tp)


def _decoder_xlayer_forward(p: dict, x: torch.Tensor, enc: torch.Tensor,
                            cfg: ModelConfig, positions: torch.Tensor,
                            tp: TensorParallel | None = None) -> torch.Tensor:
    """Causal self-attention, cross-attention over the encoder's output
    (its K/V projected here, inside the layer's recompute, as the
    reference does; on this rank's query columns under ``tp``), then the
    MLP."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attn_forward(p["attn"], h, cfg, positions=positions, tp=tp)
    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    if tp is not None and tp.split(p["cross"]["wq"].shape[-1],
                                   cfg.num_heads * cfg.hd, "cross/wq"):
        x = x + L.cross_attn_columns(p["cross"], h, enc, cfg, tp)
    else:
        enc_k, enc_v = L.cross_kv(p["cross"], enc, cfg)
        x = x + L.cross_attn_forward(p["cross"], h, cfg, enc_k, enc_v)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h, cfg, tp=tp)


def _vocab_split(params: dict, cfg: ModelConfig, tp) -> bool:
    """Are the embedding and the head split over the vocabulary?"""
    return tp is not None and tp.split(params["embed"]["tok"].shape[0],
                                       cfg.vocab_size, "embed/tok")


def _embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_feats: torch.Tensor | None = None,
                  tp: TensorParallel | None = None) -> torch.Tensor:
    """The tokens' embeddings (vocab-parallel where ``tp`` splits the
    vocabulary), a VLM's projected patches prepended: ``patch_proj`` is
    column-parallel where ``tp`` splits ``d_model``, its output columns
    gathered over the group (replicated consumers: the gradient needs no
    sum)."""
    if _vocab_split(params, cfg, tp):
        x = tp.embed(params["embed"]["tok"], tokens)
    else:
        x = params["embed"]["tok"][tokens]
    if cfg.vision_patches and patch_feats is not None:
        w = params["embed"]["patch_proj"]["w"]
        proj = patch_feats.to(x.dtype) @ w
        if tp is not None and tp.split(w.shape[-1], cfg.d_model,
                                       "embed/patch_proj"):
            proj = tp.gather(proj, -1, partial=False)
        x = torch.cat([proj, x], dim=1)            # prepend image patches
    return x


def _project_frames(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                    tp: TensorParallel | None = None) -> torch.Tensor:
    """Whisper's frame projection: column-parallel where ``tp`` splits
    ``d_model``, its output columns gathered (replicated consumers, as
    the VLM's ``patch_proj``)."""
    w = params["embed"]["frame_proj"]["w"]
    enc = frames @ w
    if tp is not None and tp.split(w.shape[-1], cfg.d_model,
                                   "embed/frame_proj"):
        enc = tp.gather(enc, -1, partial=False)
    return enc


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """Logits over the vocabulary, or over this rank's block of it when
    the vocabulary is split over ``tp``'s group."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["head"]["w"])
    if _vocab_split(params, cfg, tp):
        x = tp.copy(x)
    return L._mm(x, w)


def _unstack(layers: dict, n: int) -> list[dict]:
    """Stacked (L, ...) layer tree -> L per-layer trees of views.

    ``unbind`` keeps one backward pass per stacked leaf (a stack of the
    per-layer gradients) instead of one zero-filled copy per layer.
    """
    items = T.flatten(layers)
    parts = [t.unbind(0) for _, t in items]
    return [T.unflatten([(p, part[i]) for (p, _), part in zip(items, parts)])
            for i in range(n)]


#: the ops whose outputs ``remat_policy="dots"`` saves: the matrix
#: products (``jax.checkpoint_policies.checkpoint_dots``'s dot_general)
#: and the tensor-parallel collectives: the all-reduce that follows a
#: row-parallel product and the gather of a column block
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default, TP_ALL_REDUCE,
                   TP_ALL_GATHER})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg: ModelConfig, fn, *args) -> torch.Tensor:
    """``fn(*args)``, recomputed in the backward when ``cfg.remat`` (the
    reference's per-layer ``jax.checkpoint``).  ``remat_policy="full"``
    recomputes the whole layer (with its tensor-parallel all-reduces up
    to the last one the backward needs); ``"dots"`` saves every matrix
    product and all-reduce output and recomputes the rest, so the
    backward runs no forward collective again."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


def _splitting(tp) -> TensorParallel | None:
    """``tp`` when it splits anything (a model axis above 1), else None."""
    return tp if tp is not None and tp.size > 1 else None


def forward(params: dict, cfg: ModelConfig, batch: dict,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """batch: {'tokens': (B, S)[, 'patch_feats': (B, P, F)][, 'frames':
    (B, T, d)]} -> logits (B, S_total, V), S_total = P + S with patch
    features.  An encoder-decoder batch must carry ``frames``.  With
    ``tp`` the parameters are this rank's blocks, and the logits cover
    its block of the vocabulary where the vocabulary is split."""
    tp = _splitting(tp)
    x = _embed_tokens(params, cfg, batch["tokens"], batch.get("patch_feats"),
                      tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    if cfg.family == "ssm":      # no per-block remat, as in the reference
        for blk in params["blocks"]:
            h = L.rmsnorm(blk["norm1"], x, cfg.norm_eps)
            if "slstm" in blk:
                x = x + S.slstm_forward(blk["slstm"], h, cfg, tp)
            else:
                x = x + S.mlstm_forward(blk["mlstm"], h, cfg, tp)
        return _logits(params, cfg, x, tp)

    if cfg.family == "encdec":
        if "frames" not in batch:
            raise KeyError("an encoder-decoder batch carries 'frames' of "
                           "shape (B, encoder_seq, d_model)")
        enc = _project_frames(params, cfg, batch["frames"].to(x.dtype), tp)
        for lp in _unstack(params["encoder"], cfg.encoder_layers):
            enc = _remat(cfg, _encoder_layer_forward, lp, enc, cfg, tp)
        for lp in _unstack(params["layers"], cfg.num_layers):
            x = _remat(cfg, _decoder_xlayer_forward, lp, x, enc, cfg,
                       positions, tp)
        return _logits(params, cfg, x, tp)

    flags = global_attention_flags(cfg)
    n_prefix = _n_prefix(cfg)
    layers = list(params.get("prefix", [])) + _unstack(
        params["layers"], cfg.num_layers - n_prefix)
    for lp, is_global in zip(layers, flags.tolist()):
        x = _remat(cfg, _layer_forward, lp, x, cfg, is_global, positions, tp)
    return _logits(params, cfg, x, tp)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            tp: TensorParallel | None = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over the text positions
    (a VLM's patch positions dropped), weighted by ``loss_mask`` if the
    batch has one; vocab-parallel under ``tp``."""
    tp = _splitting(tp)
    logits = forward(params, cfg, batch, tp).to(torch.float32)
    labels = batch["labels"].long()
    if logits.shape[1] != labels.shape[1]:         # VLM: drop patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    if _vocab_split(params, cfg, tp):
        ce = tp.cross_entropy(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = logz - gold
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(ce * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce)


def count_params(params: Any) -> int:
    return sum(int(x.numel()) for x in T.leaves(params))


# ---------------------------------------------------------------------------
# the decode path (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               enc_out: torch.Tensor | None = None, *,
               dtype=torch.bfloat16, device="cuda", mesh=None,
               dp_axes=("data",)) -> dict:
    """Decode cache sized for ``max_seq`` past tokens, the reference's
    tree of zeros: an xLSTM's states, one a block (``{"blocks":
    [{"mlstm" | "slstm": state}, ...]}``, float32); else ``{"k", "v"}``
    of shape (L, B, max_seq, KV, hd) in ``dtype``, with the Mamba heads'
    ``"ssm"`` (L, B, d, n) float32 in a hybrid, and ``"cross_k"``,
    ``"cross_v"`` (L, B, T_enc, KV, hd) in an encoder-decoder, T_enc
    ``enc_out``'s length or else ``cfg.encoder_seq``.  As in the
    reference, ``enc_out`` gives only that length: nothing writes the
    encoder's K and V into the cross cache (ROADMAP queue 3).

    With ``mesh`` (a :class:`~repro_torch.core.ProcessMesh`, or its
    extents ``{axis: size}``) this is one rank's block of that cache
    under the serving layout (:func:`cache_pspecs`, sanitized; the
    sequence-sharded one when the data ranks do not divide ``batch``),
    allocated at its local shape: the whole cache is never built."""
    device = resolve_device(device)
    if mesh is not None:
        return _local_cache(cfg, batch, max_seq, enc_out, dtype=dtype,
                            device=device, mesh=mesh, dp_axes=dp_axes)
    n = cfg.num_layers
    if cfg.family == "ssm":
        return {"blocks": [
            {"slstm": S.slstm_init_state(cfg, batch, device)}
            if _is_slstm_block(cfg, i) else
            {"mlstm": S.mlstm_init_state(cfg, batch, device)}
            for i in range(n)]}
    z = dict(dtype=dtype, device=device)
    kv = (n, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(kv, **z), "v": torch.zeros(kv, **z)}
    if cfg.family == "encdec":
        t_enc = enc_out.shape[1] if enc_out is not None else cfg.encoder_seq
        xkv = (n, batch, t_enc, cfg.num_kv_heads, cfg.hd)
        cache["cross_k"] = torch.zeros(xkv, **z)
        cache["cross_v"] = torch.zeros(xkv, **z)
    elif cfg.hybrid_parallel:
        cache["ssm"] = torch.zeros((n, batch, cfg.d_model,
                                    cfg.ssm.state_size),
                                   dtype=torch.float32, device=device)
    return cache


def mesh_extents(mesh) -> dict:
    """A mesh's ``{axis: size}``: a ProcessMesh's extents, or the
    mapping itself."""
    return dict(getattr(mesh, "extents", mesh))


def serving_cache_specs(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                        dp_axes=("data",), enc_len: int | None = None):
    """``(shard_seq, specs, like)``: whether the cache's sequence is
    sharded (the data ranks do not divide ``batch``), the sanitized
    :func:`cache_pspecs` tree, and the whole cache's ``meta`` tree."""
    from ..runtime.shardings import axis_size, sanitize_pspecs
    extents = mesh_extents(mesh)
    dp = tuple(dp_axes)
    shard_seq = batch % axis_size(extents, dp) != 0
    enc = (None if enc_len is None else
           torch.empty((batch, enc_len, 0), device="meta"))
    like = init_cache(cfg, batch, max_seq, enc, device="meta")
    specs = sanitize_pspecs(cache_pspecs(cfg, shard_seq=shard_seq,
                                         dp_axes=dp), like, extents)
    return shard_seq, specs, like


def _local_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_out, *,
                 dtype, device, mesh, dp_axes) -> dict:
    """One rank's block of the serving cache at its local shape (every
    block starts as the same zeros, an sLSTM's ``n`` as ones)."""
    from ..runtime.shardings import local_shape
    extents = mesh_extents(mesh)
    enc_len = enc_out.shape[1] if enc_out is not None else None
    _, specs, like = serving_cache_specs(cfg, batch, max_seq, mesh, dp_axes,
                                         enc_len)
    if cfg.family == "ssm":      # the states' batch is their only axis
        rows = local_shape((batch,), T.leaves(specs)[0][:1], extents)[0]
        return init_cache(cfg, rows, max_seq, device=device)
    out = []
    for (path, x), spec in zip(T.flatten(like), T.leaves(specs)):
        dt = dtype if path in ("k", "v", "cross_k", "cross_v") else x.dtype
        out.append((path, torch.zeros(local_shape(tuple(x.shape), spec,
                                                  extents),
                                      dtype=dt, device=device)))
    return T.unflatten(out)


def cache_pspecs(cfg: ModelConfig, *, shard_seq: bool = False,
                 dp_axes=("pod", "data")) -> dict:
    """The spec tree of the decode cache (the reference's
    ``cache_pspecs``; :func:`~repro_torch.runtime.shardings.
    sanitize_pspecs` replicates what a mesh does not divide).

    Batched decode: the batch over the data axes and the cache's
    sequence over ``"model"``.  ``shard_seq=True`` (a batch the data
    ranks do not divide, such as ``long_500k``'s 1): the sequence over
    every mesh axis, the batch replicated.  An xLSTM's states shard
    their batch (or replicate it); a hybrid's Mamba state its ``d``
    over ``"model"``; an encoder-decoder's cross cache takes the
    self-attention cache's spec."""
    dp = tuple(dp_axes)
    if cfg.family == "ssm":
        bspec = () if shard_seq else (dp,)
        return {"blocks": [
            {"slstm": {k: bspec for k in ("c", "n", "h", "m")}}
            if _is_slstm_block(cfg, i) else
            {"mlstm": {k: bspec for k in ("C", "n", "m")}}
            for i in range(cfg.num_layers)]}
    if shard_seq:
        kv_spec = (None, None, dp + ("model",), None, None)
    else:
        kv_spec = (None, dp, "model", None, None)
    cache = {"k": kv_spec, "v": kv_spec}
    if cfg.family == "encdec":
        cache["cross_k"] = kv_spec
        cache["cross_v"] = kv_spec
        return cache
    if cfg.hybrid_parallel:
        cache["ssm"] = (None, dp if not shard_seq else None, "model", None)
    return cache


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """One rank's share of a decode step on a process mesh
    (:func:`repro_torch.runtime.serve.build_serve_step` builds it).

    ``tp`` splits Q's columns, the MLP's, the experts and the
    vocabulary over the model group; ``seq`` spreads the self-attention cache's
    positions over a group (the model group in the batched layout, the
    world in the sequence-sharded one), ``cross`` the cross cache's
    frames; ``data`` is the data group when the batch's rows are spread
    over it (a MoE layer dispatches the whole batch, gathered over it).
    """

    tp: TensorParallel | None = None
    seq: L.SeqShard | None = None
    cross: Any = None
    data: Any = None


def _moe_decode(p: dict, h: torch.Tensor, cfg: ModelConfig, data,
                tp: TensorParallel | None = None) -> torch.Tensor:
    """The MoE layer of a decode step.  With ``data`` (the batch's rows
    spread over the data group) the layer's input is gathered over it
    and dispatched as one group, and this rank keeps its rows: the
    capacity is the whole batch's, as in the reference, where a
    dispatch of each rank's rows alone would drop other choices.  With
    ``tp`` the experts run expert-parallel over the model group."""
    if data is None:
        return L.moe_forward(p, h, cfg, tp=tp)
    rows = h.shape[0]
    k = data.rank()[0]
    y = L.moe_forward(p, data.all_gather(h[None]), cfg, tp=tp)
    return y[k * rows:(k + 1) * rows]


def _layer_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                  position, is_global: bool, ctx: dict | None = None,
                  layout: DecodeLayout | None = None):
    """One layer's decode; writes the token's K and V into ``cache``'s
    (B, S_max, K, hd) views of this layer.  ``ctx`` is the step's
    :func:`~repro_torch.models.layers.decode_context`, ``layout`` this
    rank's share of the step on a mesh.  Returns ``(x, state)``: a
    hybrid's new Mamba-head state (its output averaged with the
    attention's), else None."""
    tp = layout.tp if layout is not None else None
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    a = L.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"], position,
                      is_global=is_global, ctx=ctx, tp=tp)
    state = None
    if cfg.hybrid_parallel:
        m, state = S.mamba_decode(p["ssm_head"], h, cfg, cache["ssm"], tp)
        a = 0.5 * (a + m)
    x = x + a
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        data = layout.data if layout is not None else None
        return x + _moe_decode(p["moe"], h, cfg, data, tp), state
    if "mlp" in p:
        return x + L.mlp_forward(p["mlp"], h, cfg, tp=tp,
                                 d_ff=_mlp_width(cfg)), state
    return x, state


def _decoder_xlayer_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: dict, position, ctx: dict | None = None,
                           cross=None,
                           tp: TensorParallel | None = None) -> torch.Tensor:
    """One cross-attending layer's decode: causal self-attention writing
    the token's K and V into this layer's views of ``cache["k"]`` and
    ``cache["v"]``, cross-attention over ``cache["cross_k"]`` and
    ``cache["cross_v"]`` (their frames spread over the group ``cross``,
    where it is given), then the MLP; each on its query columns and
    hidden block under ``tp``."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attn_decode(p["attn"], h, cfg, cache["k"], cache["v"],
                          position, ctx=ctx, tp=tp)
    h = L.rmsnorm(p["norm_x"], x, cfg.norm_eps)
    x = x + L.cross_attn_forward(p["cross"], h, cfg, cache["cross_k"],
                                 cache["cross_v"], group=cross, tp=tp)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h, cfg, tp=tp)


def _ssm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                cache: dict, tp: TensorParallel | None = None
                ) -> tuple[torch.Tensor, dict]:
    """The xLSTM stack's decode: each block's new state replaces its old
    one in a new cache tree (the states whole on every model rank)."""
    blocks = []
    for blk, cb in zip(params["blocks"], cache["blocks"]):
        h = L.rmsnorm(blk["norm1"], x, cfg.norm_eps)
        kind = "slstm" if "slstm" in blk else "mlstm"
        decode = S.slstm_decode if kind == "slstm" else S.mlstm_decode
        y, state = decode(blk[kind], h, cfg, cb[kind], tp)
        blocks.append({kind: state})
        x = x + y
    return x, {"blocks": blocks}


def _attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict, position, layout: DecodeLayout,
                      tp: TensorParallel | None):
    """Every layer of an attention family's decode step: ``(x, cache)``,
    a hybrid's new Mamba states stacked into a new tree."""
    # the positions, RoPE tables and masks, once for every layer
    ctx = L.decode_context(cfg, position, x.shape[0], cache["k"].shape[2],
                           x.device, layout.seq)
    if cfg.family == "encdec":
        for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = _decoder_xlayer_decode(lp, x, cfg, {
                key: cache[key][i]
                for key in ("k", "v", "cross_k", "cross_v")}, position, ctx,
                layout.cross, tp)
        return x, cache
    flags = global_attention_flags(cfg).tolist()
    layers = list(params.get("prefix", [])) + _unstack(
        params["layers"], cfg.num_layers - _n_prefix(cfg))
    states = []
    for i, (lp, is_global) in enumerate(zip(layers, flags)):
        sub = {"k": cache["k"][i], "v": cache["v"][i]}
        if cfg.hybrid_parallel:
            sub["ssm"] = cache["ssm"][i]
        x, state = _layer_decode(lp, x, cfg, sub, position, bool(is_global),
                                 ctx, layout)
        states.append(state)
    if cfg.hybrid_parallel:
        cache = dict(cache, ssm=torch.stack(states))
    return x, cache


@torch.inference_mode()
def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, position,
                layout: DecodeLayout | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode: token (B, 1) integers; ``position`` a Python int
    or a (B,) integer tensor (continuous batching, a depth a row; see
    :func:`~repro_torch.models.layers.attn_decode`).  Returns ``(logits
    (B, V), cache)``: the token's K and V are written into ``cache`` in
    place, and the recurrent states (an xLSTM's blocks, a hybrid's
    ``"ssm"``) come back as new tensors in a new tree, as the
    reference returns them.  An xLSTM reads no position.  The MoE
    family's dense prefix layers decode unrolled on the leading slices
    of the stacked cache, as the reference's do.

    With ``layout`` (:class:`DecodeLayout`) the parameters, the rows
    (token, position) and the cache are this rank's blocks on a mesh,
    and the logits cover this rank's rows and the whole vocabulary
    (gathered over the model group where it is split)."""
    layout = layout or DecodeLayout()
    tp = _splitting(layout.tp)
    x = _embed_tokens(params, cfg, token, tp=tp)
    if cfg.family == "ssm":
        x, cache = _ssm_decode(params, cfg, x, cache, tp)
    else:
        x, cache = _attention_decode(params, cfg, x, cache, position,
                                     layout, tp)
    logits = _logits(params, cfg, x, tp)[:, 0]
    if _vocab_split(params, cfg, tp):
        logits = tp.group.all_gather_dim(logits, -1)
    return logits, cache


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The model as an ``nn.Module`` over the reference's parameter tree.

    Parameters register under their tree path with '/' written as '__'
    (a module name may not hold '/' or '.'); :meth:`tree` gives them back
    as the nested dict the functional code, the fabric and the optimizer
    read.  With ``tp`` (a model axis above 1) the module holds this
    rank's blocks: drawn whole from the seed and sliced, or ``params``
    already sliced (:func:`shard_params`).
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: dict | None = None,
                 tp: TensorParallel | None = None):
        super().__init__()
        self.cfg = cfg
        self.tp = _splitting(tp)
        device = resolve_device(device)
        if params is None:
            # the meta device holds shapes only and draws nothing
            gen = (None if device.type == "meta" else
                   torch.Generator(device=device).manual_seed(seed))
            params = init_params(cfg, generator=gen, device=device)
            if self.tp is not None:
                params = T.map_leaves(torch.Tensor.clone, shard_params(
                    params, cfg, {"model": self.tp.size},
                    {"model": self.tp.index}))
        self._paths = []
        for path, t in T.flatten(params):
            self.register_parameter(path.replace("/", "__"),
                                    nn.Parameter(t.to(device)))
            self._paths.append(path)

    def tree(self) -> dict:
        return T.unflatten([(p, getattr(self, p.replace("/", "__")))
                            for p in self._paths])

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self.tree(), self.cfg, batch, self.tp)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return loss_fn(params, self.cfg, batch, self.tp)


def params_from_jax(tree_of_numpy: Any, *, device="cuda",
                    cfg: ModelConfig | None = None, extents=None,
                    coords=None) -> dict:
    """The reference's parameter tree, as numpy arrays, -> a torch tree
    of the same dicts and lists.

    bfloat16 arrays (``ml_dtypes``) are read bit for bit.  With ``cfg``,
    ``extents`` and ``coords`` (a mesh and a rank's place on it) each
    leaf arrives as that rank's block (:func:`shard_params`).
    """
    device = resolve_device(device)
    if cfg is not None:
        tree_of_numpy = shard_params(tree_of_numpy, cfg, extents, coords)

    def conv(a):
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)
    return T.map_leaves(conv, tree_of_numpy)


def params_to_numpy(params: Any) -> dict:
    """A torch parameter tree (or a :class:`Transformer`) -> numpy tree.

    bfloat16 leaves come back as float32, which holds them exactly.
    """
    if isinstance(params, Transformer):
        params = params.tree()

    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy().copy()
    return T.map_leaves(conv, params)
