"""Decoder-only LMs: dense, MoE and the VLM backbone (port of
``repro/models/transformer.py``).

The parameter tree keeps the reference's layout — stacked ``(L, ...)``
layer tensors, weights ``(in, out)`` used as ``x @ w``, an optional tied
embedding, DeepSeekMoE's dense first layers as a ``prefix`` list of
unstacked layers, the VLM's ``embed/patch_proj`` — so the tree flattens
to the same leaves, in the same order, as ``jax.tree_util`` gives the
reference's (see :mod:`repro_torch.core.tree`), and the bucket layout is
the same.  Per-layer local/global attention follows
:func:`global_attention_flags`.  The SSM, hybrid and encoder-decoder
families are still to port (ROADMAP queue 1 item 5).

    init_params(cfg, generator=..., device=...) -> params tree
    forward(params, cfg, batch)                 -> logits
    loss_fn(params, cfg, batch)                 -> scalar CE loss
    Transformer(cfg, device=..., seed=...)      -> nn.Module over the tree

``init_params(cfg, device="meta")`` gives the tree's shapes and dtypes
without allocating it (what a bucket layout needs).
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import tree as T
from ..core.device import resolve_device
from . import layers as L
from .config import ModelConfig

#: the families this port runs
PORTED_FAMILIES = ("dense", "moe", "vlm")


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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(shape, std, gen, device, dtype) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _init_mlp(cfg: ModelConfig, gen, device, lead: tuple, f: int) -> dict:
    d, dt = cfg.d_model, _dtype(cfg)
    std = 1.0 / math.sqrt(d)
    p = {"w_up": _normal((*lead, d, f), std, gen, device, dt),
         "w_down": _normal((*lead, f, d), 1 / math.sqrt(f), gen, device, dt)}
    if cfg.mlp_variant == "swiglu":
        p["w_gate"] = _normal((*lead, d, f), std, gen, device, dt)
    return p


def _init_moe(cfg: ModelConfig, gen, device, lead: tuple) -> dict:
    m = cfg.moe
    d, de, e, dt = cfg.d_model, m.d_expert, m.num_experts, _dtype(cfg)
    std = 1.0 / math.sqrt(d)
    p = {"router": _normal((*lead, d, e), std, gen, device, torch.float32),
         "w_gate": _normal((*lead, e, d, de), std, gen, device, dt),
         "w_up": _normal((*lead, e, d, de), std, gen, device, dt),
         "w_down": _normal((*lead, e, de, d), 1 / math.sqrt(de), gen, device,
                           dt)}
    if m.num_shared:
        p["shared"] = _init_mlp(cfg, gen, device, lead, de * m.num_shared)
    return p


def _init_layer(cfg: ModelConfig, gen, device, n: int | None,
                dense_ffn: bool = False) -> dict:
    """Parameters of ``n`` decoder layers stacked on a leading axis, or of
    one unstacked layer for ``n=None``.  ``dense_ffn`` gives a MoE
    config's dense layer: an MLP of ``d_expert * (top_k + num_shared)``."""
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt, std = _dtype(cfg), 1.0 / math.sqrt(d)
    lead = () if n is None else (n,)
    ones = lambda m: torch.ones((*lead, m), dtype=torch.float32,  # noqa: E731
                                device=device)
    zeros = lambda m: torch.zeros((*lead, m), dtype=dt,  # noqa: E731
                                  device=device)
    attn = {
        "wq": _normal((*lead, d, h * hd), std, gen, device, dt),
        "wk": _normal((*lead, d, k * hd), std, gen, device, dt),
        "wv": _normal((*lead, d, k * hd), std, gen, device, dt),
        "wo": _normal((*lead, h * hd, d), std, gen, device, dt),
    }
    if cfg.qkv_bias:
        attn.update(bq=zeros(h * hd), bk=zeros(k * hd), bv=zeros(k * hd))
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(hd)}
        attn["k_norm"] = {"scale": ones(hd)}
    p = {"norm1": {"scale": ones(d)}, "attn": attn,
         "norm2": {"scale": ones(d)}}
    if cfg.moe is not None and not dense_ffn:
        p["moe"] = _init_moe(cfg, gen, device, lead)
    elif cfg.d_ff or dense_ffn:
        f = cfg.d_ff
        if dense_ffn and cfg.moe is not None:
            f = cfg.moe.d_expert * (cfg.moe.top_k + cfg.moe.num_shared)
        p["mlp"] = _init_mlp(cfg, gen, device, lead, f)
    return p


def _n_prefix(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random parameters (normal init with the reference's scales; the
    qkv biases zero, as the reference's).  On the ``meta`` device the
    tree holds shapes and dtypes only and ``generator`` may be None."""
    device = resolve_device(device)
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is still to "
                                  f"port (ROADMAP queue 1 item 5)")
    d, v, dt = cfg.d_model, cfg.vocab_size, _dtype(cfg)
    params: dict[str, Any] = {
        "embed": {"tok": _normal((v, d), 0.02, generator, device, dt)},
        "final_norm": {"scale": torch.ones((d,), dtype=torch.float32,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": _normal((d, v), 1 / math.sqrt(d), generator,
                                       device, dt)}
    if cfg.vision_patches:
        f = cfg.vision_feat_dim
        params["embed"]["patch_proj"] = {
            "w": _normal((f, d), 1 / math.sqrt(f), generator, device, dt)}
    n_prefix = _n_prefix(cfg)
    if n_prefix:
        params["prefix"] = [_init_layer(cfg, generator, device, None,
                                        dense_ffn=True)
                            for _ in range(n_prefix)]
    params["layers"] = _init_layer(cfg, generator, device,
                                   cfg.num_layers - n_prefix)
    return params


def _layer_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   is_global: bool, positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attn_forward(p["attn"], h, cfg, is_global=is_global,
                           positions=positions)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        return x + L.moe_forward(p["moe"], h, cfg)
    if "mlp" in p:
        return x + L.mlp_forward(p["mlp"], h, cfg)
    return x


def _embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_feats: torch.Tensor | None = None) -> torch.Tensor:
    x = params["embed"]["tok"][tokens]
    if cfg.vision_patches and patch_feats is not None:
        proj = patch_feats.to(x.dtype) @ params["embed"]["patch_proj"]["w"]
        x = torch.cat([proj, x], dim=1)            # prepend image patches
    return x


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    w = (params["embed"]["tok"].T if cfg.tie_embeddings
         else params["head"]["w"])
    return x @ w


def _unstack(layers: dict, n: int) -> list[dict]:
    """Stacked (L, ...) layer tree -> L per-layer trees of views.

    ``unbind`` keeps one backward pass per stacked leaf (a stack of the
    per-layer gradients) instead of one zero-filled copy per layer.
    """
    items = T.flatten(layers)
    parts = [t.unbind(0) for _, t in items]
    return [T.unflatten([(p, part[i]) for (p, _), part in zip(items, parts)])
            for i in range(n)]


def forward(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B, S)[, 'patch_feats': (B, P, F)]} -> logits
    (B, S_total, V), S_total = P + S with patch features."""
    x = _embed_tokens(params, cfg, batch["tokens"], batch.get("patch_feats"))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    flags = global_attention_flags(cfg)
    n_prefix = _n_prefix(cfg)
    layers = list(params.get("prefix", [])) + _unstack(
        params["layers"], cfg.num_layers - n_prefix)
    for lp, is_global in zip(layers, flags.tolist()):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer_forward, lp, x, cfg, is_global, positions,
                           use_reentrant=False)
        else:
            x = _layer_forward(lp, x, cfg, is_global, positions)
    return _logits(params, cfg, x)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy in float32 over the text positions
    (a VLM's patch positions dropped), weighted by ``loss_mask`` if the
    batch has one."""
    logits = forward(params, cfg, batch).to(torch.float32)
    labels = batch["labels"].long()
    if logits.shape[1] != labels.shape[1]:         # VLM: drop patch positions
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
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
# the module
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The model as an ``nn.Module`` over the reference's parameter tree.

    Parameters register under their tree path with '/' written as '__'
    (a module name may not hold '/' or '.'); :meth:`tree` gives them back
    as the nested dict the functional code, the fabric and the optimizer
    read.
    """

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: dict | None = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=device).manual_seed(seed)
            params = init_params(cfg, generator=gen, device=device)
        self._paths = []
        for path, t in T.flatten(params):
            self.register_parameter(path.replace("/", "__"),
                                    nn.Parameter(t.to(device)))
            self._paths.append(path)

    def tree(self) -> dict:
        return T.unflatten([(p, getattr(self, p.replace("/", "__")))
                            for p in self._paths])

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self.tree(), self.cfg, batch)

    def loss(self, params: dict, batch: dict) -> torch.Tensor:
        return loss_fn(params, self.cfg, batch)


def params_from_jax(tree_of_numpy: Any, *, device="cuda") -> dict:
    """The reference's parameter tree, as numpy arrays, -> a torch tree
    of the same dicts and lists.

    bfloat16 arrays (``ml_dtypes``) are read bit for bit.
    """
    device = resolve_device(device)
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
