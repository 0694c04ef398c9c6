"""Building-block layers: RMSNorm, RoPE, GQA attention, cross-attention,
MLP, MoE.

Port of ``repro/models/layers.py``.  Plain functions on a parameter
dict, in the reference's layout: weights stored ``(in, out)`` and used
as ``x @ w``.  Attention takes the reference's two paths: up to
``FLASH_SEQ_THRESHOLD`` tokens full (B, K, G, S, T) float32 scores with
the ``-1e30`` mask; above it the reference's double-blocked online
softmax (:func:`_flash_attention`), block by block in plain PyTorch.
Cross-attention (whisper's decoder) takes neither RoPE nor qk-norm, on
the queries or on the encoder's keys and values.  The MoE layer is the
reference's grouped top-k capacity dispatch with shared experts.

Tensor parallelism (``tp=``, a :class:`~repro_torch.models.tp.
TensorParallel`) follows the reference's partition specs
(:func:`attention_pspecs`, :func:`mlp_pspecs`, :func:`moe_pspecs`):
attention runs this rank's query heads against the K/V heads they read,
K and V projected from the replicated ``wk`` / ``wv`` (or, where its
query columns cut a head, the heads that touch them, from Q gathered
over the group), the MLP runs its column block, and a MoE layer routes
every token on every rank and runs this rank's experts; each ends in
the sum over the model group.  Whisper's cross-attention runs its query
columns the same way against K/V heads projected from the replicated
encoder output (:func:`cross_attn_columns`).

The decode path (:func:`attn_decode`) runs one token against a KV cache,
at one depth for the batch or one depth a row; on a mesh the cache's
positions may be spread over a group (:class:`SeqShard`), each rank
attending over its own and the partial softmaxes combined.  A float32
cache under a bf16 model turns the residual stream float32 after the
first attention, as JAX's type promotion does in the reference; so the
products here (:func:`_mm`, :func:`_einsum`) promote their operands to a
common dtype, a no-op where they already share one, as in training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import spans
from ..core.device import resolve_device
from .config import ModelConfig

#: above this sequence length attention runs double-blocked (flash-style)
FLASH_SEQ_THRESHOLD = 2048
FLASH_BLOCK_Q = 1024
FLASH_BLOCK_K = 1024


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their promoted dtype (JAX's promotion of a
    float32 activation against bf16 weights); the tensors themselves
    where they share one."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' promoted dtype."""
    x, w = _promoted(x, w)
    return x @ w


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-operand ``einsum`` in the operands' promoted dtype."""
    a, b = _promoted(a, b)
    return torch.einsum(eq, a, b)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(shape, std, gen, device, dtype) -> torch.Tensor:
    """N(0, std^2) in ``dtype`` (drawn in float32); shapes only on the
    ``meta`` device."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def init_rmsnorm(d: int, device="cuda", *, lead: tuple = ()) -> dict:
    """A norm's float32 scale of ones, ``(*lead, d)``."""
    return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"]).to(dt)


def rope_table(positions: torch.Tensor, hd: int, theta: float, device):
    """The RoPE (cos, sin) of ``positions`` (..., S): two float32 tensors
    (..., S, 1, hd / 2), the same for every layer and for q and k."""
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         table=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer; ``table`` their
    :func:`rope_table`, where the caller has it."""
    hd = x.shape[-1]
    half = hd // 2
    cos, sin = table if table is not None else rope_table(
        positions, hd, theta, x.device)
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen: torch.Generator | None = None,
                   device="cuda", *, lead: tuple = ()) -> dict:
    """An attention block's parameters (the reference's keys and shapes,
    stacked on ``lead``): normal weights with std ``1 / sqrt(d)``, the
    qkv biases zero, the qk-norm scales one.  ``gen`` draws wq, wk, wv,
    wo in that order."""
    device = resolve_device(device)
    d, h, k, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt, std = _dtype(cfg), 1.0 / math.sqrt(d)
    p = {"wq": _normal((*lead, d, h * hd), std, gen, device, dt),
         "wk": _normal((*lead, d, k * hd), std, gen, device, dt),
         "wv": _normal((*lead, d, k * hd), std, gen, device, dt),
         "wo": _normal((*lead, h * hd, d), std, gen, device, dt)}
    if cfg.qkv_bias:
        for name, m in (("bq", h * hd), ("bk", k * hd), ("bv", k * hd)):
            p[name] = torch.zeros((*lead, m), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device, lead=lead)
        p["k_norm"] = init_rmsnorm(hd, device, lead=lead)
    return p


def init_cross_attention(cfg: ModelConfig,
                         gen: torch.Generator | None = None, device="cuda",
                         *, lead: tuple = ()) -> dict:
    """Whisper's decoder cross-attention: an attention block's keys."""
    return init_attention(cfg, gen, device, lead=lead)


def attention_pspecs(cfg: ModelConfig) -> dict:
    """TP specs: Q's columns and O's rows over the model axis (whole
    heads or not, as GSPMD splits them), K and V replicated."""
    p = {"wq": (None, "model"), "wk": (), "wv": (), "wo": ("model", None)}
    if cfg.qkv_bias:
        p.update({"bq": ("model",), "bk": (), "bv": ()})
    if cfg.qk_norm:
        p.update({"q_norm": {"scale": ()}, "k_norm": {"scale": ()}})
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
         heads=None, table=None):
    b, s, _ = x.shape
    h, k = heads or (cfg.num_heads, cfg.num_kv_heads)
    hd = cfg.hd
    q, kk, v = _mm(x, p["wq"]), _mm(x, p["wk"]), _mm(x, p["wv"])
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    return _norm_rope(p, q.reshape(b, s, h, hd), kk.reshape(b, s, k, hd),
                      v.reshape(b, s, k, hd), cfg, positions, table)


def _norm_rope(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig, positions, table=None):
    """The qk-norm (where the config has one) and RoPE of q (B, S, H, hd)
    and k (B, S, K, hd); v passes through."""
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta, table), \
        rope(k, positions, cfg.rope_theta, table), v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,K,hd) -> float32 scores (B,K,G,S,T).

    The reference's einsum takes bf16 operands with a float32 result;
    the products of two bf16 values are exact in float32, so float32
    operands give the same scores up to the order of the sum."""
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


def _mask_block(iq: torch.Tensor, jk: torch.Tensor, *, causal: bool,
                window, is_global: bool) -> torch.Tensor:
    """(bq, bk) bool mask from absolute query/key positions."""
    i, j = iq[:, None], jk[None, :]
    m = (j <= i) if causal else torch.ones(
        (iq.shape[0], jk.shape[0]), dtype=torch.bool, device=iq.device)
    if window is not None and not is_global:
        m = m & (i - j < window)
    return m


def _block_live(i0: int, bq: int, j0: int, bk: int, *, causal: bool,
                window, is_global: bool) -> bool:
    """Does the key block at ``j0`` hold an unmasked key for any query of
    the block at ``i0``?  A causal block with none is skipped, which
    leaves every row exact: before a row's first live block it would set
    the running max to -1e30 and be wiped by ``corr = exp(-1e30 - m)``
    = 0; after it, it adds ``p = 0`` under ``corr = 1``."""
    if not causal:
        return True
    if j0 > i0 + bq - 1:                      # every key after every query
        return False
    if window is not None and not is_global:  # every key out of the window
        return i0 - (j0 + bk - 1) < window
    return True


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, window, is_global: bool, scale: float,
                     block_q: int = FLASH_BLOCK_Q,
                     block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Double-blocked online-softmax attention (memory O(S * block)).

    q: (B,S,KV,G,hd); k, v: (B,T,KV,hd).  Returns (B,S,KV,G,hd) in
    q's dtype.  The reference's recurrence over key blocks, per query
    block: float32 scores (float32 operands, see :func:`_gqa_scores`)
    times ``scale``, masked entries filled with -1e30 and the running max
    started at -inf, ``p`` cast to v's dtype for the PV product and the
    product back to float32, the output ``acc / max(l, 1e-30)``.  S and T
    are padded up to whole blocks.  Non-causal padding keys are not
    masked, as in the reference; no decoder-only layer runs non-causal.
    Blocks with no live pair are skipped (:func:`_block_live`).
    """
    b, s, kv, g, hd = q.shape
    t = k.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    pad_q, pad_k = (-s) % bq, (-t) % bk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (s + pad_q) // bq, (t + pad_k) // bk
    # qb: (nq, B, KV, G, bq, hd); kb / vb: (nk, B, KV, bk, hd)
    qb = q.to(torch.float32).reshape(b, nq, bq, kv, g, hd).permute(
        1, 0, 3, 4, 2, 5)
    kb = k.to(torch.float32).reshape(b, nk, bk, kv, hd).permute(1, 0, 3, 2, 4)
    vb = v.reshape(b, nk, bk, kv, hd).permute(1, 0, 3, 2, 4)
    pos = torch.arange(max(nq * bq, nk * bk), device=q.device)
    outs = []
    for qi in range(nq):
        i0 = qi * bq
        qblk, iq = qb[qi], pos[i0:i0 + bq]
        m_run = torch.full((b, kv, g, bq), -math.inf, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, kv, g, bq), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, kv, g, bq, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            j0 = ki * bk
            if not _block_live(i0, bq, j0, bk, causal=causal, window=window,
                               is_global=is_global):
                continue
            sc = torch.einsum("bkgqh,bkth->bkgqt", qblk, kb[ki]) * scale
            mask = _mask_block(iq, pos[j0:j0 + bk], causal=causal,
                               window=window, is_global=is_global)
            sc = sc.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,bkth->bkgqh", p.to(v.dtype), vb[ki]).to(torch.float32)
            m_run = m_new
        outs.append(acc / torch.clamp(l_run, min=1e-30)[..., None])
    # (nq, B, KV, G, bq, hd) -> (B, S, KV, G, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, nq * bq, kv, g, hd)
    return out[:, :s].to(q.dtype)


def _head_block(cfg: ModelConfig, cols: int):
    """``(heads, kv heads)`` of a rank's ``cols`` query columns when they
    are whole heads that hold whole GQA groups or a part of one group's
    single K/V head; None when they are not (a part of a head, or whole
    heads that straddle groups unevenly), which runs on column blocks
    (:func:`_attn_columns`)."""
    hd, g = cfg.hd, cfg.num_heads // cfg.num_kv_heads
    h_loc = cols // hd
    if cols % hd:
        return None
    if h_loc % g == 0:
        return h_loc, h_loc // g
    if g % h_loc == 0:
        return h_loc, 1
    return None


def _replicated_kv(p: dict, tp, cols: slice) -> dict:
    """``p`` with the K/V weights' (and biases') columns ``cols`` of the
    replicated ``wk`` / ``wv``, and the qk-norm scales, passed through
    :meth:`~repro_torch.models.tp.TensorParallel.copy`: this rank reads
    them for its own heads only, so their gradients, partial, are summed
    over the group."""
    q = dict(p)
    for name in ("wk", "wv"):
        q[name] = tp.copy(p[name])[:, cols]
    for name in ("bk", "bv"):
        if name in p:
            q[name] = tp.copy(p[name])[cols]
    for name in ("q_norm", "k_norm"):
        if name in p:
            q[name] = {"scale": tp.copy(p[name]["scale"])}
    return q


def _tp_heads(p: dict, cfg: ModelConfig, tp, heads: tuple) -> dict:
    """This rank's attention parameters for a block of whole ``heads``
    (:func:`_head_block`).

    Rank ``m`` holds query heads ``[m h/M, (m+1) h/M)``, which read K/V
    heads ``[m h/M / G, ...)`` (``G = h / kv``): whole GQA groups when
    ``G`` divides ``h/M``, else a part of one group's single K/V head.
    """
    h_loc, kv_loc = heads
    g = cfg.num_heads // cfg.num_kv_heads
    k0 = tp.index * h_loc // g
    return _replicated_kv(p, tp, slice(k0 * cfg.hd, (k0 + kv_loc) * cfg.hd))


def _column_heads(cfg: ModelConfig, tp, cols: int) -> tuple[int, int]:
    """The heads ``[h0, h1)`` that touch this rank's query columns
    ``[m cols, (m+1) cols)``."""
    lo = tp.index * cols
    return lo // cfg.hd, -(-(lo + cols) // cfg.hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig, *, causal: bool,
            is_global: bool) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, T, K, hd) -> (B, S, H * hd): the full
    float32 scores up to ``FLASH_SEQ_THRESHOLD`` tokens, the blocked
    path above; the recorder's ``model.attention`` span."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    with spans.span("model.attention"):
        if s > FLASH_SEQ_THRESHOLD:
            out = _flash_attention(q.reshape(b, s, kv, h // kv, hd), k, v,
                                   causal=causal, window=cfg.sliding_window,
                                   is_global=is_global,
                                   scale=1.0 / math.sqrt(hd))
            return out.reshape(b, s, h * hd)
        return _full_attention(q, k, v, causal=causal,
                               window=cfg.sliding_window, is_global=is_global)


def _attn_columns(p: dict, x: torch.Tensor, cfg: ModelConfig, positions,
                  tp, *, causal: bool, is_global: bool) -> torch.Tensor:
    """Attention on this rank's ``c = H hd / M`` query columns where they
    are not whole heads of whole GQA groups (qwen2.5-14B's 40 heads on 16
    ranks: 2.5 a rank).  ``x`` has entered through ``tp.copy``.

    The rank projects its columns of Q; where they cut a head, Q is
    gathered over the group (its gradient summed back, each rank's
    consumers differing) and the rank keeps the heads ``[h0, h1)`` that
    touch its columns.  Those heads read K/V heads ``[h0 / G, (h1 - 1) /
    G]``, projected from the replicated ``wk`` / ``wv``
    (:func:`_replicated_kv`) and repeated to one a query head.  The rank
    keeps the context columns ``[m c, (m+1) c)``, multiplies them by its
    rows of ``wo`` and sums over the group."""
    b, s, _ = x.shape
    hd, g = cfg.hd, cfg.num_heads // cfg.num_kv_heads
    c = p["wq"].shape[-1]
    h0, h1 = _column_heads(cfg, tp, c)
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    q = _mm(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if c % hd:
        q = tp.gather(q, -1)[..., h0 * hd:h1 * hd]
    p = _replicated_kv(p, tp, slice(k0 * hd, k1 * hd))
    kk, v = _mm(x, p["wk"]), _mm(x, p["wv"])
    if cfg.qkv_bias:
        kk, v = kk + p["bk"], v + p["bv"]
    q, kk, v = _norm_rope(p, q.reshape(b, s, h1 - h0, hd),
                          kk.reshape(b, s, k1 - k0, hd),
                          v.reshape(b, s, k1 - k0, hd), cfg, positions)
    own = torch.arange(h0, h1, device=x.device) // g - k0
    out = _attend(q, kk[:, :, own], v[:, :, own], cfg, causal=causal,
                  is_global=is_global)
    lo = tp.index * c - h0 * hd
    return tp.reduce(out[..., lo:lo + c] @ p["wo"])


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 is_global: bool = True, positions=None,
                 causal: bool = True, tp=None) -> torch.Tensor:
    """Full-sequence GQA attention (training / prefill).

    ``is_global`` picks full causal attention over the sliding window on
    a config with one; sequences over ``FLASH_SEQ_THRESHOLD`` take the
    blocked path.  With ``tp`` and Q's columns split over its group, this
    rank's heads (or its column block, :func:`_attn_columns`) run and the
    output is summed over the group."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    heads = (cfg.num_heads, cfg.num_kv_heads)
    split = tp is not None and tp.split(p["wq"].shape[-1],
                                        cfg.num_heads * cfg.hd, "attn/wq")
    if split:
        x = tp.copy(x)
        heads = _head_block(cfg, p["wq"].shape[-1])
        if heads is None:
            return _attn_columns(p, x, cfg, positions, tp, causal=causal,
                                 is_global=is_global)
        p = _tp_heads(p, cfg, tp, heads)
    q, k, v = _qkv(p, x, cfg, positions, heads)
    out = _attend(q, k, v, cfg, causal=causal, is_global=is_global) @ p["wo"]
    return tp.reduce(out) if split else out


def _full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window, is_global: bool) -> torch.Tensor:
    """The short path: q (B,S,H,hd), k, v (B,T,K,hd) -> (B,S,H*hd) from
    the full (B,K,G,S,T) float32 scores, masked entries at -1e30."""
    scores = _gqa_scores(q, k)
    mask = _mask_block(torch.arange(q.shape[1], device=q.device),
                       torch.arange(k.shape[1], device=q.device),
                       causal=causal, window=window, is_global=is_global)
    scores = scores.masked_fill(~mask, -1e30)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


class SeqShard:
    """The cache positions ``[lo, lo + n)`` that this rank holds of a
    sequence spread over ``group`` (a
    :class:`~repro_torch.core.collectives.DistributedGroup`), ``n`` the
    local cache's length: the flash-decode layout, in which each rank
    attends over its own positions and the partial softmaxes are
    combined over the group (:func:`_combine`)."""

    def __init__(self, group, lo: int):
        self.group, self.lo = group, int(lo)

    def __repr__(self) -> str:
        return f"SeqShard(lo={self.lo}, group={self.group!r})"


def decode_context(cfg: ModelConfig, position, batch: int, max_seq: int,
                   device, seq: SeqShard | None = None) -> dict:
    """What every layer of one decode step shares, computed once: the
    rows' write positions, their RoPE tables, and the masked-out cache
    positions of a global and of a window layer.

    ``position`` is a Python int (every row at that depth) or a (B,)
    integer tensor (continuous batching: each row at its own depth).
    ``max_seq`` is the length of the cache this rank holds; with ``seq``
    it holds the global positions ``[seq.lo, seq.lo + max_seq)``, the
    masks are taken at those, and a row's K and V are written only by
    the rank whose positions hold it."""
    lo = seq.lo if seq is not None else 0
    jidx = torch.arange(lo, lo + max_seq, device=device)
    owned = None
    if torch.is_tensor(position) and position.dim() == 1:
        pos = position.reshape(batch, 1).to(device=device, dtype=torch.int64)
        rows = torch.arange(batch, device=device)
        if seq is not None:
            local = pos[:, 0] - lo
            owned = (local >= 0) & (local < max_seq)
            write = (rows, local.clamp(0, max_seq - 1))
        else:
            write = (rows, pos[:, 0])
        valid = jidx[None, :] <= pos                         # (B, T)
        near = pos - jidx[None, :]
        shape = lambda m: m[:, None, None, None, :]          # noqa: E731
    else:
        at = int(position)
        pos = torch.full((batch, 1), at, dtype=torch.int64, device=device)
        write = ((slice(None), at - lo)
                 if seq is None or lo <= at < lo + max_seq else None)
        valid = jidx <= at
        near = at - jidx
        shape = lambda m: m[None, None, None, None]          # noqa: E731
    local = valid
    if cfg.sliding_window is not None:
        local = valid & (near < cfg.sliding_window)
    return {"pos": pos, "write": write, "owned": owned, "seq": seq,
            "rope": rope_table(pos, cfg.hd, cfg.rope_theta, device),
            "masked": {True: shape(~valid), False: shape(~local)}}


def _write_token(cache: torch.Tensor, new: torch.Tensor, ctx: dict) -> None:
    """Write the token's K or V (B, K, hd) at its position, in place:
    every row on one device, or the rows this rank's positions hold."""
    at = ctx["write"]
    if at is None:
        return
    new = new.to(cache.dtype)
    if ctx["owned"] is not None:
        new = torch.where(ctx["owned"][:, None, None], new, cache[at])
    cache[at] = new


def _combine(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, masked,
             group) -> torch.Tensor:
    """Attention of q (B, S, H, hd) over keys and values (B, T, K, hd)
    spread over ``group`` along T, each rank holding its T positions:
    float32 partials of this rank (running max ``m``, ``l = sum exp(s -
    m)``, ``o = sum exp(s - m) v``; masked scores at -1e30), gathered
    over the group in one call; then ``M`` the max of the ``m``, and
    ``o / l`` from ``l exp(m - M)`` and ``o exp(m - M)`` summed over the
    ranks in rank order, the same bits on every rank.  Returns (B, S,
    H * hd) in v's dtype.  A rank whose positions are all masked has
    ``m = -1e30`` and adds exactly 0.  (One gather, not a max and a sum
    all-reduce: each collective is a synchronisation point.)"""
    scores = _gqa_scores(q, k)                               # (B,K,G,S,T)
    if masked is not None:
        scores = scores.masked_fill(masked, -1e30)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bkgst,btkh->bkgsh", p, v.to(torch.float32))
    part = torch.cat([o, p.sum(dim=-1)[..., None], m[..., None]], dim=-1)
    parts = group.all_gather(part[None, None])               # (R, ...)
    m_all = parts[..., -1]
    f = torch.exp(m_all - m_all.amax(dim=0))
    tot = (parts[..., :-1] * f[..., None]).sum(dim=0)
    out = tot[..., :-1] / tot[..., -1:]
    b, kv, g, s, hd = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, kv * g * hd).to(v.dtype)


def _decode_qkv_columns(p: dict, x: torch.Tensor, cfg: ModelConfig,
                        ctx: dict, tp):
    """The token's q, k and v of every head on a model group that splits
    Q's columns, whole heads or not: this rank's ``c`` columns of Q and
    its block of K's and V's ``KV hd`` columns (an M-th of each; the
    whole, projected on every rank and not gathered, where M does not
    divide them), gathered over the group in one call; then qk-norm and
    RoPE on the whole heads."""
    b, s, _ = x.shape
    c, n = p["wq"].shape[-1], cfg.num_kv_heads * cfg.hd
    kv_split = n % tp.size == 0
    nk = n // tp.size if kv_split else n
    cols = slice(tp.index * nk, tp.index * nk + nk) if kv_split \
        else slice(None)
    q = _mm(x, p["wq"])
    kk, v = _mm(x, p["wk"][:, cols]), _mm(x, p["wv"][:, cols])
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"][cols], v + p["bv"][cols]
    parts = (q, kk, v) if kv_split else (q,)
    got = tp.group.all_gather(torch.cat(parts, dim=-1)[None]).reshape(
        tp.size, b, s, -1)

    def whole(lo, hi):
        return got[..., lo:hi].permute(1, 2, 0, 3).reshape(b, s, -1)
    q = whole(0, c)
    if kv_split:
        kk, v = whole(c, c + nk), whole(c + nk, c + 2 * nk)
    kv, hd = cfg.num_kv_heads, cfg.hd
    return _norm_rope(p, q.reshape(b, s, cfg.num_heads, hd),
                      kk.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd),
                      cfg, ctx["pos"], ctx["rope"])


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor, position, *,
                is_global: bool = True, ctx: dict | None = None, tp=None,
                seq: SeqShard | None = None) -> torch.Tensor:
    """One-token decode against a KV cache (port of the reference's
    ``attn_decode``).

    x: (B, 1, d); cache_k / cache_v: (B, S_max, K, hd), written in place
    at the new token's position; ``position`` a Python int (every row at
    that depth) or a (B,) integer tensor (continuous batching: each row
    writes and reads at its own depth, under its own causal and window
    mask); ``ctx`` its :func:`decode_context`, where the caller shares
    one across layers.  Returns the attention output (B, 1, d), in the
    promoted dtype of the cache and the weights.  Each row is computed
    from its own cache row alone (float32 scores, masked entries at
    -1e30 and an exact 0 after the softmax), so its bits do not depend
    on the other rows.

    On a mesh: ``tp`` splits Q's columns over the model group, whose
    ranks gather the token's q, k and v of every head, attend with all
    of them, and keep their columns of the context for the row-parallel
    ``wo`` (summed over the group); ``seq`` (or ``ctx["seq"]``) spreads the
    cache's positions over a group, whose partial softmaxes are gathered
    and combined (:func:`_combine`: float32 sums in another order than
    the one-device softmax, so not bit-equal to it).
    """
    if ctx is None:
        ctx = decode_context(cfg, position, x.shape[0], cache_k.shape[1],
                             x.device, seq)
    split = tp is not None and tp.split(p["wq"].shape[-1],
                                        cfg.num_heads * cfg.hd, "attn/wq")
    if split:
        q, k_new, v_new = _decode_qkv_columns(p, x, cfg, ctx, tp)
    else:
        q, k_new, v_new = _qkv(p, x, cfg, ctx["pos"], table=ctx["rope"])
    _write_token(cache_k, k_new[:, 0], ctx)
    _write_token(cache_v, v_new[:, 0], ctx)
    masked = ctx["masked"][bool(is_global)]
    if ctx["seq"] is None:
        scores = _gqa_scores(q, cache_k).masked_fill(masked, -1e30)
        out = _gqa_out(torch.softmax(scores, dim=-1), cache_v)
    else:
        out = _combine(q, cache_k, cache_v, masked, ctx["seq"].group)
    if not split:
        return _mm(out, p["wo"])
    cols = p["wo"].shape[0]
    out = out[..., tp.index * cols:(tp.index + 1) * cols]
    return tp.reduce(_mm(out, p["wo"]))


def cross_attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       enc_k: torch.Tensor, enc_v: torch.Tensor, *,
                       group=None, tp=None) -> torch.Tensor:
    """Decoder cross-attention over the encoder's projected K/V.

    x: (B,S,d); enc_k / enc_v: (B,T_enc,K,hd) from :func:`cross_kv`.  No
    mask: every query sees every frame.  With ``group`` the frames are
    spread over it, this rank holding its share, and the partial
    softmaxes are combined (:func:`_combine`).  With ``tp`` splitting
    Q's columns (a decode step on a mesh, outside autograd) the token's
    q of every head is gathered over the model group, every head attends
    (each rank's frames hold every K/V head), and the rank keeps its
    context columns for its rows of ``wo``, summed over the group."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    q = _mm(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    split = tp is not None and tp.split(p["wq"].shape[-1], h * hd,
                                        "cross/wq")
    if split:
        q = tp.group.all_gather_dim(q, -1)
    q = q.reshape(b, s, h, hd)
    if group is not None:
        out = _combine(q, enc_k, enc_v, None, group)
    else:
        out = _gqa_out(torch.softmax(_gqa_scores(q, enc_k), dim=-1), enc_v)
    if not split:
        return _mm(out, p["wo"])
    cols = p["wo"].shape[0]
    return tp.reduce(_mm(out[..., tp.index * cols:(tp.index + 1) * cols],
                         p["wo"]))


def cross_attn_columns(p: dict, x: torch.Tensor, enc: torch.Tensor,
                       cfg: ModelConfig, tp) -> torch.Tensor:
    """Cross-attention of this rank's ``c = H hd / M`` query columns over
    the encoder's output ``enc`` (B, T_enc, d), replicated (training on
    a model axis; whisper-tiny's 6 heads on 16 ranks give 24 columns a
    rank).

    As :func:`_attn_columns`: Q's column block, gathered where it cuts a
    head, the heads ``[h0, h1)`` that touch the columns, their K/V heads
    projected from the replicated ``wk`` / ``wv`` (:func:`_replicated_kv`)
    and ``enc`` (through ``tp.copy``: every rank reads it for its own
    heads), then the context columns ``[m c, (m+1) c)`` times this
    rank's rows of ``wo``, summed over the group.  No RoPE, no mask."""
    b, s, _ = x.shape
    hd, g = cfg.hd, cfg.num_heads // cfg.num_kv_heads
    c = p["wq"].shape[-1]
    h0, h1 = _column_heads(cfg, tp, c)
    k0, k1 = h0 // g, (h1 - 1) // g + 1
    q = _mm(tp.copy(x), p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if c % hd:
        q = tp.gather(q, -1)[..., h0 * hd:h1 * hd]
    enc_k, enc_v = cross_kv(_replicated_kv(p, tp, slice(k0 * hd, k1 * hd)),
                            tp.copy(enc), cfg)
    own = torch.arange(h0, h1, device=x.device) // g - k0
    probs = torch.softmax(_gqa_scores(q.reshape(b, s, h1 - h0, hd),
                                      enc_k[:, :, own]), dim=-1)
    out = _gqa_out(probs, enc_v[:, :, own])
    lo = tp.index * c - h0 * hd
    return tp.reduce(_mm(out[..., lo:lo + c], p["wo"]))


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder's output projected to cross-attention K/V, of the K/V
    heads ``wk``'s columns hold (every head, or a rank's block)."""
    b, t, _ = enc_out.shape
    hd = cfg.hd
    k = p["wk"].shape[-1] // hd
    kk = (enc_out @ p["wk"]).reshape(b, t, k, hd)
    v = (enc_out @ p["wv"]).reshape(b, t, k, hd)
    if cfg.qkv_bias:
        kk = kk + p["bk"].reshape(k, hd)
        v = v + p["bv"].reshape(k, hd)
    return kk, v


# ---------------------------------------------------------------------------
# dense MLP and MoE
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(cfg: ModelConfig, gen: torch.Generator | None = None,
             device="cuda", d_ff: int | None = None, *,
             lead: tuple = ()) -> dict:
    """A dense MLP of width ``d_ff`` (the config's by default), stacked on
    ``lead``: ``w_up`` and ``w_gate`` with std ``1 / sqrt(d)``, ``w_down``
    ``1 / sqrt(d_ff)``, drawn w_up, w_down, then a SwiGLU's w_gate."""
    device = resolve_device(device)
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, _dtype(cfg)
    std = 1.0 / math.sqrt(d)
    p = {"w_up": _normal((*lead, d, f), std, gen, device, dt),
         "w_down": _normal((*lead, f, d), 1 / math.sqrt(f), gen, device, dt)}
    if cfg.mlp_variant == "swiglu":
        p["w_gate"] = _normal((*lead, d, f), std, gen, device, dt)
    return p


def init_moe(cfg: ModelConfig, gen: torch.Generator | None = None,
             device="cuda", *, lead: tuple = ()) -> dict:
    """A MoE layer, stacked on ``lead``: the float32 router, the experts'
    SwiGLU weights and, with shared experts, their MLP of width
    ``d_expert * num_shared``."""
    device = resolve_device(device)
    m = cfg.moe
    d, de, e, dt = cfg.d_model, m.d_expert, m.num_experts, _dtype(cfg)
    std = 1.0 / math.sqrt(d)
    p = {"router": _normal((*lead, d, e), std, gen, device, torch.float32),
         "w_gate": _normal((*lead, e, d, de), std, gen, device, dt),
         "w_up": _normal((*lead, e, d, de), std, gen, device, dt),
         "w_down": _normal((*lead, e, de, d), 1 / math.sqrt(de), gen, device,
                           dt)}
    if m.num_shared:
        p["shared"] = init_mlp(cfg, gen, device, de * m.num_shared,
                               lead=lead)
    return p


def mlp_pspecs(cfg: ModelConfig) -> dict:
    """TP specs: column-parallel in, row-parallel out."""
    if cfg.mlp_variant == "swiglu":
        return {"w_gate": (None, "model"), "w_up": (None, "model"),
                "w_down": ("model", None)}
    return {"w_up": (None, "model"), "w_down": ("model", None)}


def moe_pspecs(cfg: ModelConfig) -> dict:
    """The reference's expert-parallel specs: the experts over the model
    axis, the router replicated, the shared experts an MLP's."""
    p = {"router": (), "w_gate": ("model", None, None),
         "w_up": ("model", None, None), "w_down": ("model", None, None)}
    if cfg.moe.num_shared:
        p["shared"] = mlp_pspecs(cfg)
    return p


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                tp=None, d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU MLP, or the GELU MLP where the tree has no ``w_gate``.
    With ``tp`` and the hidden width (``d_ff``, the config's by default;
    a MoE config's shared experts and dense layers have their own) split
    over its group, this rank's columns run and the output is summed
    over the group."""
    split = tp is not None and tp.split(p["w_up"].shape[-1],
                                        d_ff or cfg.d_ff, "mlp/w_up")
    if split:
        x = tp.copy(x)
    if "w_gate" in p:
        h = F.silu(_mm(x, p["w_gate"])) * _mm(x, p["w_up"])
    else:
        h = _gelu(_mm(x, p["w_up"]))
    out = _mm(h, p["w_down"])
    return tp.reduce(out) if split else out


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps equal values in index
    order; ``torch.topk`` promises no order among ties)."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                tp=None) -> torch.Tensor:
    """Top-k capacity-based MoE over groups of ``group_size`` tokens.

    Each group's tokens choose k experts by router softmax; the k
    choices take capacity slots in choice order, token order within a
    choice (a per-group cumulative count), and a choice past an expert's
    ``cap`` slots is dropped.  Shared experts see every token.

    With ``tp`` and the experts split over its group (the model axis
    divides ``num_experts``), rank ``m`` holds experts ``[m E/M, (m+1)
    E/M)``: ``x`` and the replicated router enter through ``tp.copy``,
    the routing, top-k, capacity and ``combine`` are computed whole on
    every rank (the same bits as one device's), each rank runs its
    experts on their slots and combines them with its experts' slice of
    ``combine``, and the routed output is summed over the group; the
    shared experts run column- then row-parallel (:func:`mlp_forward`).
    Experts the axis does not divide are replicated and run whole.

    The recorder's ``model.moe`` span covers the call, its child
    ``model.moe.experts`` the experts' own products (routed and shared),
    so the parent's self time is the routing, the capacity assignment,
    the dispatch and the combine.  While the recorder is on, the device
    counter ``moe.slots_filled`` adds the capacity slots taken (each
    expert's kept choices a group, ``min(counts, cap)``) and the host
    counter ``moe.slots`` the slots there are, ``g * e_loc * cap``."""
    with spans.span("model.moe"):
        return _moe(p, x, cfg, tp)


def _moe(p: dict, x: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    m = cfg.moe
    dt = _dtype(cfg)
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    e_loc = p["w_up"].shape[0]
    split = tp is not None and tp.split(e_loc, e, "moe/w_up")
    xin, router = (tp.copy(x), tp.copy(p["router"])) if split else \
        (x, p["router"])
    gs = min(m.group_size, t)
    pad = (-t) % gs
    xt = xin.reshape(t, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    g = (t + pad) // gs
    xg = xt.reshape(g, gs, d)
    cap = max(4, int(gs * k / e * m.capacity_factor))
    cap = min(cap, gs)

    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32), router)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates, k)                            # (g, gs, k)
    topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    topv = topv.to(dt)

    # capacity assignment: sequential priority over the k choices
    combine = torch.zeros((g, gs, e, cap), dtype=dt, device=x.device)
    counts = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    for i in range(k):
        onehot = F.one_hot(topi[..., i], e)                  # (g, gs, e)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        keep = (pos < cap) & (onehot > 0)
        # class ``cap`` (dropped) is a zero row, as jax.nn.one_hot gives
        pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
        combine = combine + pos_oh.to(dt) * (
            topv[..., i, None, None] * onehot[..., None].to(dt))
    if split:                                   # this rank's experts
        combine = combine[:, :, tp.index * e_loc:(tp.index + 1) * e_loc]
        counts = counts[:, tp.index * e_loc:(tp.index + 1) * e_loc]
    if spans.enabled():
        spans.count_device("moe.slots_filled",
                           torch.clamp(counts, max=cap).sum())
        spans.count("moe.slots", g * e_loc * cap)
    dispatch = (combine > 0).to(dt)

    expert_in = _einsum("gsec,gsd->gecd", dispatch, xg)
    with spans.span("model.moe.experts"):
        if "w_gate" in p:
            h = (F.silu(_einsum("gecd,edf->gecf", expert_in, p["w_gate"]))
                 * _einsum("gecd,edf->gecf", expert_in, p["w_up"]))
        else:
            h = _gelu(_einsum("gecd,edf->gecf", expert_in, p["w_up"]))
        expert_out = _einsum("gecf,efd->gecd", h, p["w_down"])
    y = _einsum("gsec,gecd->gsd", combine, expert_out)
    y = y.reshape(t + pad, d)[:t].reshape(b, s, d)
    if split:
        y = tp.reduce(y)
    if "shared" in p:
        with spans.span("model.moe.experts"):
            y = y + mlp_forward(p["shared"], x, cfg, tp=tp,
                                d_ff=m.d_expert * m.num_shared)
    return y
