"""Building-block layers: RMSNorm, RoPE, GQA attention, the SwiGLU MLP.

Port of ``repro/models/layers.py`` (dense path).  Plain functions on a
parameter dict, in the reference's layout: weights stored ``(in, out)``
and used as ``x @ w``.  Attention is the short-sequence path of
``attn_forward``: full (B, K, G, S, T) scores in float32 with the
``-1e30`` causal mask.  The blocked flash path the reference takes above
2048 tokens is still to port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig

#: above this sequence length the reference switches to blocked attention
FLASH_SEQ_THRESHOLD = 2048


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, kk, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    q = q.reshape(b, s, h, hd)
    kk = kk.reshape(b, s, k, hd)
    v = v.reshape(b, s, k, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        kk = rmsnorm(p["k_norm"], kk, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta), \
        rope(kk, positions, cfg.rope_theta), v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,K,hd) -> float32 scores (B,K,G,S,T)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, hd).to(torch.float32)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k.to(torch.float32))
    return scores / math.sqrt(hd)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,K,G,S,T) x v (B,T,K,hd) -> (B,S,H*hd)."""
    b, kv, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)
    return out.reshape(b, s, kv * g * v.shape[-1])


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """Causal full-sequence GQA attention (training / prefill)."""
    s = x.shape[1]
    if s > FLASH_SEQ_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {s} > {FLASH_SEQ_THRESHOLD} needs the blocked "
            f"attention path, still to port (ROADMAP queue 1)")
    q, k, v = _qkv(p, x, cfg, positions)
    scores = _gqa_scores(q, k)                              # (B,K,G,S,T)
    i = torch.arange(s, device=x.device)
    mask = i[None, :] <= i[:, None]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return _gqa_out(probs, v) @ p["wo"]


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU MLP."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
