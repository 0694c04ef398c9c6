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
(:func:`attention_pspecs`, :func:`mlp_pspecs`): attention runs this
rank's query heads against the K/V heads they read, K and V projected
from the replicated ``wk`` / ``wv``, and the MLP runs its column block;
each ends in the sum over the model group.

The decode path (:func:`attn_decode`) runs one token against a KV cache,
at one depth for the batch or one depth a row.  A float32 cache under a
bf16 model turns the residual stream float32 after the first attention,
as JAX's type promotion does in the reference; so the products here
(:func:`_mm`, :func:`_einsum`) promote their operands to a common dtype,
a no-op where they already share one, as in training.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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

def attention_pspecs(cfg: ModelConfig) -> dict:
    """TP specs: Q and O sharded over heads, K and V replicated."""
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
    q = q.reshape(b, s, h, hd)
    kk = kk.reshape(b, s, k, hd)
    v = v.reshape(b, s, k, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        kk = rmsnorm(p["k_norm"], kk, cfg.norm_eps)
    return rope(q, positions, cfg.rope_theta, table), \
        rope(kk, positions, cfg.rope_theta, table), v


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


def _tp_heads(p: dict, cfg: ModelConfig, tp) -> tuple[dict, tuple]:
    """This rank's attention parameters and ``(heads, kv heads)``.

    Rank ``m`` holds query heads ``[m h/M, (m+1) h/M)``, which read K/V
    heads ``[m h/M / G, ...)`` (``G = h / kv``): whole GQA groups when
    ``G`` divides ``h/M``, else a part of one group's single K/V head.
    The replicated K/V weights (and biases, and the qk-norm scales) pass
    through :meth:`~repro_torch.models.tp.TensorParallel.copy`, so their
    gradients, partial to this rank's heads, are summed over the group.
    """
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    h_loc = p["wq"].shape[-1] // hd
    g = h // kv
    if h_loc % g == 0:
        kv_loc = h_loc // g
    elif g % h_loc == 0:
        kv_loc = 1
    else:
        raise NotImplementedError(
            f"{h_loc} query heads a rank split GQA groups of {g} unevenly; "
            f"the port lays out whole groups or parts of one")
    k0 = tp.index * h_loc // g
    cols = slice(k0 * hd, (k0 + kv_loc) * hd)
    q = dict(p)
    for name in ("wk", "wv"):
        q[name] = tp.copy(p[name])[:, cols]
    for name in ("bk", "bv"):
        if name in p:
            q[name] = tp.copy(p[name])[cols]
    for name in ("q_norm", "k_norm"):
        if name in p:
            q[name] = {"scale": tp.copy(p[name]["scale"])}
    return q, (h_loc, kv_loc)


def attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 is_global: bool = True, positions=None,
                 causal: bool = True, tp=None) -> torch.Tensor:
    """Full-sequence GQA attention (training / prefill).

    ``is_global`` picks full causal attention over the sliding window on
    a config with one; sequences over ``FLASH_SEQ_THRESHOLD`` take the
    blocked path.  With ``tp`` and the heads split over its group, this
    rank's heads run and the output is summed over the group."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    heads = (cfg.num_heads, cfg.num_kv_heads)
    split = tp is not None and tp.split(p["wq"].shape[-1],
                                        cfg.num_heads * cfg.hd, "attn/wq")
    if split:
        x = tp.copy(x)
        p, heads = _tp_heads(p, cfg, tp)
    q, k, v = _qkv(p, x, cfg, positions, heads)
    kv, hd = heads[1], cfg.hd
    g = heads[0] // kv
    if s > FLASH_SEQ_THRESHOLD:
        out = _flash_attention(q.reshape(b, s, kv, g, hd), k, v,
                               causal=causal, window=cfg.sliding_window,
                               is_global=is_global,
                               scale=1.0 / math.sqrt(hd))
        out = out.reshape(b, s, kv * g * hd) @ p["wo"]
    else:
        out = _full_attention(q, k, v, causal=causal,
                              window=cfg.sliding_window,
                              is_global=is_global) @ p["wo"]
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


def decode_context(cfg: ModelConfig, position, batch: int, max_seq: int,
                   device) -> dict:
    """What every layer of one decode step shares, computed once: the
    rows' write positions, their RoPE tables, and the masked-out cache
    positions of a global and of a window layer.

    ``position`` is a Python int (every row at that depth) or a (B,)
    integer tensor (continuous batching: each row at its own depth)."""
    jidx = torch.arange(max_seq, device=device)
    if torch.is_tensor(position) and position.dim() == 1:
        pos = position.reshape(batch, 1).to(device=device, dtype=torch.int64)
        rows, at = torch.arange(batch, device=device), None
        valid = jidx[None, :] <= pos                         # (B, T)
        near = pos - jidx[None, :]
        shape = lambda m: m[:, None, None, None, :]          # noqa: E731
    else:
        at = int(position)
        pos = torch.full((batch, 1), at, dtype=torch.int64, device=device)
        rows = None
        valid = jidx <= at
        near = at - jidx
        shape = lambda m: m[None, None, None, None]          # noqa: E731
    local = valid
    if cfg.sliding_window is not None:
        local = valid & (near < cfg.sliding_window)
    return {"pos": pos, "rows": rows, "at": at,
            "rope": rope_table(pos, cfg.hd, cfg.rope_theta, device),
            "masked": {True: shape(~valid), False: shape(~local)}}


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor, position, *,
                is_global: bool = True, ctx: dict | None = None
                ) -> torch.Tensor:
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
    """
    if ctx is None:
        ctx = decode_context(cfg, position, x.shape[0], cache_k.shape[1],
                             x.device)
    q, k_new, v_new = _qkv(p, x, cfg, ctx["pos"], table=ctx["rope"])
    if ctx["rows"] is not None:
        at = (ctx["rows"], ctx["pos"][:, 0])
    else:
        at = (slice(None), ctx["at"])
    cache_k[at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[at] = v_new[:, 0].to(cache_v.dtype)
    scores = _gqa_scores(q, cache_k).masked_fill(
        ctx["masked"][bool(is_global)], -1e30)
    return _mm(_gqa_out(torch.softmax(scores, dim=-1), cache_v), p["wo"])


def cross_attn_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       enc_k: torch.Tensor,
                       enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention over the encoder's projected K/V.

    x: (B,S,d); enc_k / enc_v: (B,T_enc,K,hd) from :func:`cross_kv`.  No
    mask: every query sees every frame."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, cfg.num_heads, cfg.hd)
    probs = torch.softmax(_gqa_scores(q, enc_k), dim=-1)
    return _gqa_out(probs, enc_v) @ p["wo"]


def cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder's output projected to cross-attention K/V."""
    b, t, _ = enc_out.shape
    k, hd = cfg.num_kv_heads, cfg.hd
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


def mlp_pspecs(cfg: ModelConfig) -> dict:
    """TP specs: column-parallel in, row-parallel out."""
    if cfg.mlp_variant == "swiglu":
        return {"w_gate": (None, "model"), "w_up": (None, "model"),
                "w_down": ("model", None)}
    return {"w_up": (None, "model"), "w_down": ("model", None)}


def moe_pspecs(cfg: ModelConfig) -> dict:
    """The reference's expert-parallel specs (experts over the model
    axis); the port does not run them yet (ROADMAP queue 1)."""
    p = {"router": (), "w_gate": ("model", None, None),
         "w_up": ("model", None, None), "w_down": ("model", None, None)}
    if cfg.moe.num_shared:
        p["shared"] = mlp_pspecs(cfg)
    return p


def mlp_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                tp=None) -> torch.Tensor:
    """SwiGLU MLP, or the GELU MLP where the tree has no ``w_gate``.
    With ``tp`` and the hidden width split over its group, this rank's
    columns run and the output is summed over the group."""
    split = tp is not None and tp.split(p["w_up"].shape[-1], cfg.d_ff,
                                        "mlp/w_up")
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


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k capacity-based MoE over groups of ``group_size`` tokens.

    Each group's tokens choose k experts by router softmax; the k
    choices take capacity slots in choice order, token order within a
    choice (a per-group cumulative count), and a choice past an expert's
    ``cap`` slots is dropped.  Shared experts see every token."""
    m = cfg.moe
    dt = _dtype(cfg)
    b, s, d = x.shape
    t = b * s
    gs = min(m.group_size, t)
    pad = (-t) % gs
    xt = x.reshape(t, d)
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    g = (t + pad) // gs
    xg = xt.reshape(g, gs, d)
    e, k = m.num_experts, m.top_k
    cap = max(4, int(gs * k / e * m.capacity_factor))
    cap = min(cap, gs)

    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32), p["router"])
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
    dispatch = (combine > 0).to(dt)

    expert_in = _einsum("gsec,gsd->gecd", dispatch, xg)
    if "w_gate" in p:
        h = (F.silu(_einsum("gecd,edf->gecf", expert_in, p["w_gate"]))
             * _einsum("gecd,edf->gecf", expert_in, p["w_up"]))
    else:
        h = _gelu(_einsum("gecd,edf->gecf", expert_in, p["w_up"]))
    expert_out = _einsum("gecf,efd->gecd", h, p["w_down"])
    y = _einsum("gsec,gecd->gsd", combine, expert_out)
    y = y.reshape(t + pad, d)[:t].reshape(b, s, d)
    if "shared" in p:
        y = y + mlp_forward(p["shared"], x, cfg)
    return y
