"""Decoder-only LM of the dense family (port of ``repro/models/transformer.py``).

The parameter tree keeps the reference's layout — stacked ``(L, ...)``
layer tensors, weights ``(in, out)`` used as ``x @ w``, an optional tied
embedding — so the tree flattens to the same leaves, in the same order,
as ``jax.tree_util`` gives the reference's (see
:mod:`repro_torch.core.tree`), and the bucket layout is the same.

    init_params(cfg, generator=..., device=...) -> params tree
    forward(params, cfg, batch)                 -> logits
    loss_fn(params, cfg, batch)                 -> scalar CE loss
    Transformer(cfg, device=..., seed=...)      -> nn.Module over the tree
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


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(shape, std, gen, device, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _init_layer(cfg: ModelConfig, gen, device, n: int) -> dict:
    """Parameters of ``n`` decoder layers, stacked on a leading axis."""
    d, h, k, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                      cfg.d_ff)
    dt, std = _dtype(cfg), 1.0 / math.sqrt(d)
    ones = lambda m: torch.ones((n, m), dtype=torch.float32, device=device)
    attn = {
        "wq": _normal((n, d, h * hd), std, gen, device, dt),
        "wk": _normal((n, d, k * hd), std, gen, device, dt),
        "wv": _normal((n, d, k * hd), std, gen, device, dt),
        "wo": _normal((n, h * hd, d), std, gen, device, dt),
    }
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(hd)}
        attn["k_norm"] = {"scale": ones(hd)}
    mlp = {"w_gate": _normal((n, d, f), std, gen, device, dt),
           "w_up": _normal((n, d, f), std, gen, device, dt),
           "w_down": _normal((n, f, d), 1 / math.sqrt(f), gen, device, dt)}
    return {"norm1": {"scale": ones(d)}, "attn": attn,
            "norm2": {"scale": ones(d)}, "mlp": mlp}


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters (normal init with the reference's scales)."""
    device = resolve_device(device)
    if cfg.family != "dense":
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
    params["layers"] = _init_layer(cfg, generator, device, cfg.num_layers)
    return params


def _layer_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    x = x + L.attn_forward(p["attn"], h, cfg, positions)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + L.mlp_forward(p["mlp"], h, cfg)


def _embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["tok"][tokens]


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
    """batch: {'tokens': (B, S)} -> logits (B, S, V)."""
    tokens = batch["tokens"]
    x = _embed_tokens(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    for lp in _unstack(params["layers"], cfg.num_layers):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_layer_forward, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _layer_forward(lp, x, cfg, positions)
    return _logits(params, cfg, x)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Mean next-token cross entropy in float32."""
    logits = forward(params, cfg, batch).to(torch.float32)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


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
    """The reference's parameter tree, as numpy arrays, -> a torch tree.

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
