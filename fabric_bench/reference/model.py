"""Dense and MoE decoder LMs in float32, written from their equations.

The parameter tree (paths, shapes, dtypes) is the port's layout, so the
benchmark's seeded weights fill both alike; the arithmetic is written
here from the model's description and shares no code with the port.
The layer: ``x + attn(rmsnorm(x))``, then ``+ ffn(rmsnorm(x))``.
Attention: q, k, v projections (with biases where the config has
them), RoPE on the two halves of each head, grouped-query causal
softmax attention over full scores, the output projection.  FFN: a
tanh-GeLU or SwiGLU MLP, or the MoE layer: a float32 router's softmax,
the top-k gates renormalised, each group of ``group_size`` tokens'
choices given capacity slots in choice order then token order (a choice
past ``cap`` slots is dropped), SwiGLU experts, and shared experts on
every token.  Loss: the mean next-token cross entropy in float32.

``Arith(lower)`` computes every product with its operands rounded to
the precision below the configuration's (``LOWER``; float8 e4m3 under a
scale a tensor), gradients passed straight through: the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the nearest precision below each configuration dtype: the control's
LOWER = {"float32": torch.bfloat16, "bfloat16": torch.float8_e4m3fn,
         "float16": torch.float8_e4m3fn}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back (float8 under one scale a
    tensor, its largest value at the format's largest), the gradient
    passed straight through."""
    d = x.detach()
    if dtype == torch.float8_e4m3fn:
        scale = d.abs().amax().clamp(min=1e-30) / \
            torch.finfo(torch.float8_e4m3fn).max
        q = (d / scale).to(dtype).to(torch.float32) * scale
    else:
        q = d.to(dtype).to(torch.float32)
    return x + (q - d)


class Arith:
    """The products of one run: float32, or with every operand rounded
    to ``lower`` (the control)."""

    def __init__(self, lower: torch.dtype | None = None):
        self.lower = lower

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.lower is None else _round(x, self.lower)

    def mm(self, x, w):
        return self.q(x) @ self.q(w)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def layout(m: dict) -> dict:
    """path -> (shape, dtype name) of the model's parameters."""
    d, v, h, kv = m["d_model"], m["vocab_size"], m["num_heads"], \
        m["num_kv_heads"]
    hd, dt, f32 = head_dim(m), m["dtype"], "float32"
    out = {"embed/tok": ((v, d), dt), "final_norm/scale": ((d,), f32)}
    if not m.get("tie_embeddings", False):
        out["head/w"] = ((d, v), dt)

    def mlp(pre, lead, width, swiglu):
        out[f"{pre}/w_up"] = ((*lead, d, width), dt)
        out[f"{pre}/w_down"] = ((*lead, width, d), dt)
        if swiglu:
            out[f"{pre}/w_gate"] = ((*lead, d, width), dt)

    def layer(pre, lead, ffn):
        out[f"{pre}/norm1/scale"] = ((*lead, d), f32)
        out[f"{pre}/norm2/scale"] = ((*lead, d), f32)
        out[f"{pre}/attn/wq"] = ((*lead, d, h * hd), dt)
        out[f"{pre}/attn/wk"] = ((*lead, d, kv * hd), dt)
        out[f"{pre}/attn/wv"] = ((*lead, d, kv * hd), dt)
        out[f"{pre}/attn/wo"] = ((*lead, h * hd, d), dt)
        if m.get("qkv_bias", False):
            out[f"{pre}/attn/bq"] = ((*lead, h * hd), dt)
            out[f"{pre}/attn/bk"] = ((*lead, kv * hd), dt)
            out[f"{pre}/attn/bv"] = ((*lead, kv * hd), dt)
        ffn(pre, lead)

    swiglu = m.get("mlp_variant", "swiglu") == "swiglu"
    moe = m.get("moe")
    if moe is None:
        layer("layers", (m["num_layers"],),
              lambda pre, lead: mlp(f"{pre}/mlp", lead, m["d_ff"], swiglu))
        return out
    e, de = moe["num_experts"], moe["d_expert"]
    dense_width = de * (moe["top_k"] + moe.get("num_shared", 0))
    for i in range(moe.get("first_dense", 0)):
        layer(f"prefix/{i}", (),
              lambda pre, lead: mlp(f"{pre}/mlp", lead, dense_width, swiglu))

    def moe_ffn(pre, lead):
        out[f"{pre}/moe/router"] = ((*lead, d, e), f32)
        out[f"{pre}/moe/w_gate"] = ((*lead, e, d, de), dt)
        out[f"{pre}/moe/w_up"] = ((*lead, e, d, de), dt)
        out[f"{pre}/moe/w_down"] = ((*lead, e, de, d), dt)
        if moe.get("num_shared", 0):
            mlp(f"{pre}/moe/shared", lead, de * moe["num_shared"], swiglu)
    layer("layers", (m["num_layers"] - moe.get("first_dense", 0),), moe_ffn)
    return out


def empty_params(m: dict, device) -> dict:
    return {p: torch.empty(shape, dtype=getattr(torch, dt), device=device)
            for p, (shape, dt) in layout(m).items()}


def _layers(p: dict, m: dict) -> list[dict]:
    """One dict of leaves a layer (key: the path below the layer), the
    dense first layers then the stacked ones."""
    out = []
    moe = m.get("moe")
    n_prefix = moe.get("first_dense", 0) if moe else 0
    for i in range(n_prefix):
        pre = f"prefix/{i}/"
        out.append({k[len(pre):]: t for k, t in p.items() if k.startswith(pre)})
    stacked = {k[len("layers/"):]: t for k, t in p.items()
               if k.startswith("layers/")}
    for i in range(m["num_layers"] - n_prefix):
        out.append({k: t[i] for k, t in stacked.items()})
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(lp, x, m, ar: Arith, cos, sin):
    b, s, _ = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], head_dim(m)
    q, k, v = (ar.mm(x, lp["attn/wq"]), ar.mm(x, lp["attn/wk"]),
               ar.mm(x, lp["attn/wv"]))
    if "attn/bq" in lp:
        q, k, v = q + lp["attn/bq"], k + lp["attn/bk"], v + lp["attn/bv"]
    q = _rope(q.reshape(b, s, h, hd), cos, sin)
    k = _rope(k.reshape(b, s, kv, hd), cos, sin)
    v = v.reshape(b, s, kv, hd)
    q = q.reshape(b, s, kv, h // kv, hd)
    scores = ar.einsum("bskgh,btkh->bkgst", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = ar.einsum("bkgst,btkh->bskgh", probs, v).reshape(b, s, h * hd)
    return ar.mm(out, lp["attn/wo"])


def mlp(lp, pre, x, ar: Arith):
    if f"{pre}/w_gate" in lp:
        hid = F.silu(ar.mm(x, lp[f"{pre}/w_gate"])) * ar.mm(x, lp[f"{pre}/w_up"])
    else:
        hid = F.gelu(ar.mm(x, lp[f"{pre}/w_up"]), approximate="tanh")
    return ar.mm(hid, lp[f"{pre}/w_down"])


def moe_layer(lp, x, m, ar: Arith):
    cfg = m["moe"]
    b, s, d = x.shape
    t = b * s
    e, k = cfg["num_experts"], cfg["top_k"]
    gs = min(cfg["group_size"], t)
    pad = (-t) % gs
    xt = F.pad(x.reshape(t, d), (0, 0, 0, pad))       # zero rows route too
    g = (t + pad) // gs
    cap = min(max(4, int(gs * k / e * cfg["capacity_factor"])), gs)
    gates = torch.softmax(ar.mm(xt.reshape(g, gs, d), lp["moe/router"]), -1)
    order = torch.sort(gates, dim=-1, descending=True, stable=True)[1]
    top_i = order[..., :k]                             # (g, gs, k)
    top_v = torch.gather(gates, -1, top_i)
    top_v = top_v / (top_v.sum(-1, keepdim=True) + 1e-9)
    # slot of each choice: its rank among the group's choices of that
    # expert, earlier choices first, then tokens in order
    taken = torch.zeros(g, e, dtype=torch.int64, device=x.device)
    slots, keeps = [], []
    for i in range(k):
        onehot = F.one_hot(top_i[..., i], e)           # (g, gs, e)
        rank = torch.cumsum(onehot, dim=1) - 1 + taken[:, None, :]
        slots.append(torch.sum(rank * onehot, dim=-1))
        keeps.append(slots[-1] < cap)
        taken = taken + onehot.sum(dim=1)
    # the token in each (expert, group, slot); an empty slot reads row t+pad
    token = torch.full((e, g, cap), t + pad, dtype=torch.int64,
                       device=x.device)
    rows = torch.arange(t + pad, device=x.device).reshape(g, gs)
    grp = torch.arange(g, device=x.device)[:, None].expand(g, gs)
    for i in range(k):
        kk = keeps[i]
        token[top_i[..., i][kk], grp[kk], slots[i][kk]] = rows[kk]
    xe = torch.cat([xt, xt.new_zeros(1, d)])[token].reshape(e, g * cap, d)
    hid = F.silu(torch.bmm(ar.q(xe), ar.q(lp["moe/w_gate"]))) \
        * torch.bmm(ar.q(xe), ar.q(lp["moe/w_up"]))
    out = torch.bmm(ar.q(hid), ar.q(lp["moe/w_down"])).reshape(e, g, cap, d)
    y = 0
    for i in range(k):
        got = out[top_i[..., i], grp, slots[i].clamp(max=cap - 1)]
        y = y + got * (top_v[..., i] * keeps[i])[..., None]
    y = y.reshape(t + pad, d)[:t].reshape(b, s, d)
    if "moe/shared/w_up" in lp:
        y = y + mlp(lp, "moe/shared", x, ar)
    return y


def _layer(lp, x, m, ar, cos, sin, eps):
    x = x + attention(lp, rmsnorm(x, lp["norm1/scale"], eps), m, ar, cos, sin)
    hn = rmsnorm(x, lp["norm2/scale"], eps)
    return x + (moe_layer(lp, hn, m, ar) if "moe/router" in lp
                else mlp(lp, "mlp", hn, ar))


def loss(p: dict, m: dict, tokens: torch.Tensor, labels: torch.Tensor,
         ar: Arith, remat: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` against ``labels``;
    ``p`` maps paths to float32 tensors.  ``remat`` recomputes each
    layer in the backward (the same values: its memory, not its
    arithmetic, changes)."""
    eps = m.get("norm_eps", 1e-6)
    s = tokens.shape[1]
    hd = head_dim(m)
    half = hd // 2
    freqs = 1.0 / (m["rope_theta"] ** (
        torch.arange(half, dtype=torch.float32, device=tokens.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=tokens.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x = p["embed/tok"][tokens]
    x = ar.q(x)
    for lp in _layers(p, m):
        if remat:
            x = checkpoint(_layer, lp, x, m, ar, cos, sin, eps,
                           use_reentrant=False)
        else:
            x = _layer(lp, x, m, ar, cos, sin, eps)
    x = rmsnorm(x, p["final_norm/scale"], eps)
    w = p["embed/tok"].T if m.get("tie_embeddings", False) else p["head/w"]
    logits = ar.mm(x, w)
    ce = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    return ce.mean()
