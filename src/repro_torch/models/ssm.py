"""State-space and recurrent blocks: xLSTM (mLSTM + sLSTM) and the
Mamba-style heads of Hymba (port of ``repro/models/ssm.py``): the
full-sequence blocks and their one-token decode steps.

  * ``xlstm-125m`` alternates mLSTM blocks (matrix memory, exponential
    gating) with an sLSTM block (scalar memory, recurrent gating) every
    ``slstm_every`` blocks (arXiv:2405.04517);
  * ``hymba-1.5b`` runs a selective-SSM head beside attention in every
    layer (arXiv:2411.13676); the fusion lives in
    :mod:`repro_torch.models.transformer`.

Each recurrence is a Python loop over time (the reference's
``lax.scan``), split into ``int(sqrt(T))``-step chunks under
``torch.utils.checkpoint`` when a backward pass will follow, so that
the backward keeps one state per chunk boundary rather than one per
step (:func:`chunked_scan`).  The reference's float32 leaves and
products stay float32 in a bfloat16 model: ``w_if``, ``if_bias``, ``r``,
``bias``, ``w_dt``, ``dt_bias``, ``w_bc``, ``a_log`` and ``skip_scale``,
and the gate products ``xu @ w_if``, ``x @ w_dt`` and ``x @ w_bc``.

The decode steps (``mlstm_decode``, ``slstm_decode``, ``mamba_decode``)
run one token through the same cells and return the new state in place
of the old, as the reference's do; a state is float32 in any model.

Tensor parallelism (``tp``, a :class:`~repro_torch.models.tp.
TensorParallel`) follows the reference's partition specs
(``repro/models/transformer.py:85-98``, ``:205-219``):

  * mLSTM: ``w_up`` and ``w_ogate`` by columns, ``w_q``, ``w_k``, ``w_v``,
    ``w_if`` and ``w_down`` by rows.  q, k, v and the gate
    pre-activations are this rank's rows' products summed over the group
    (``if_bias`` added once, after the sum), the stabilised scan runs
    whole on every rank (xlstm-125m's 4 heads do not split over 16
    ranks), and its output enters ``w_down``'s rows through
    ``tp.scatter``;
  * sLSTM: ``w_in`` and ``bias`` by blocks of the fused z/i/f/o columns,
    which do not fall on gate boundaries, so the pre-activation (and
    ``bias``, and ``r`` where the heads split) is gathered whole, the
    scan runs whole, and ``w_down`` is row-parallel as above;
  * the Mamba head: channel-parallel.  ``w_in``, ``a_log``,
    ``skip_scale`` and ``w_out`` hold this rank's channels, the
    replicated ``w_dt``, ``dt_bias`` and ``w_bc`` enter through
    ``tp.copy`` (their gradients are partial), and each rank scans its
    channels with a (B, d / M, n) state.

A block whose leaves the model axis does not divide is replicated, as
the reference's ``sanitize_spec`` leaves it, and runs whole.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .layers import _dtype, _normal


# ---------------------------------------------------------------------------
# two-level checkpointed scan (O(sqrt(T)) backward memory)
# ---------------------------------------------------------------------------

def _scan(step, state, xs: tuple):
    """``lax.scan`` over the leading (time) axis of each of ``xs``.

    ``unbind`` gives one backward per input (a stack of the per-step
    gradients) where indexing each step would build one zero-filled
    copy of the whole input per step."""
    ys = []
    for inp in zip(*(x.unbind(0) for x in xs)):
        state, y = step(state, inp)
        ys.append(y)
    return state, torch.stack(ys)


def chunked_scan(step, state0, xs: tuple, seq_len: int, chunk: int = 0):
    """Scan ``step(state, inp) -> (state, y)`` over time, the reference's
    chunking rule: ``chunk = int(sqrt(T))`` unless given, and the scan
    stays flat when ``T <= chunk`` or ``T % chunk != 0``.

    Chunked, each chunk runs under a non-reentrant checkpoint when grad
    is enabled: the backward keeps only the states at chunk boundaries
    and recomputes a chunk's steps when it reaches it, so memory goes as
    ``(T / chunk + chunk)`` states.  The values are the flat scan's.
    ``xs`` is a tuple of time-major tensors; returns ``(state, ys)``
    with ``ys`` stacked on a leading time axis."""
    if chunk <= 0:
        chunk = max(int(math.sqrt(seq_len)), 1)
    if seq_len <= chunk or seq_len % chunk != 0:
        return _scan(step, state0, xs)
    nc = seq_len // chunk
    chunks = zip(*(x.reshape(nc, chunk, *x.shape[1:]).unbind(0) for x in xs))
    remat = torch.is_grad_enabled()
    state, ys = state0, []
    for xc in chunks:
        if remat:
            state, y = checkpoint(_scan, step, state, xc, use_reentrant=False)
        else:
            state, y = _scan(step, state, xc)
        ys.append(y)
    return state, torch.cat(ys)


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory LSTM) block
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, gen, device) -> dict:
    """xLSTM mLSTM block: up-projection by ``proj_factor``, H heads over
    the inner width (the reference's scales and dtypes)."""
    d = cfg.d_model
    di = int(d * cfg.ssm.proj_factor)
    h = cfg.num_heads
    std, stdi, dt = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di), _dtype(cfg)
    f32 = torch.float32
    return {
        "w_up": _normal((d, di), std, gen, device, dt),
        "w_q": _normal((di, di), stdi, gen, device, dt),
        "w_k": _normal((di, di), stdi, gen, device, dt),
        "w_v": _normal((di, di), stdi, gen, device, dt),
        "w_ogate": _normal((d, di), std, gen, device, dt),
        "w_if": _normal((di, 2 * h), stdi, gen, device, f32),
        "if_bias": torch.cat([torch.zeros((h,), device=device),
                              torch.full((h,), 3.0, device=device)]),
        "w_down": _normal((di, d), stdi, gen, device, dt),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    di = int(cfg.d_model * cfg.ssm.proj_factor)
    h = cfg.num_heads
    hd = di // h
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **z),
            "n": torch.zeros((batch, h, hd), **z),
            "m": torch.zeros((batch, h), **z)}


def _mlstm_cell(state: dict, qkvif):
    """One stabilized mLSTM step (arXiv:2405.04517 eqs. 19-27)."""
    q, k, v, it, ft = qkvif          # (B,H,hd) x3, (B,H), (B,H)
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    m_t = torch.maximum(ft + m_prev, it)
    i_p = torch.exp(it - m_t)
    f_p = torch.exp(ft + m_prev - m_t)
    c_t = (f_p[..., None, None] * c_prev
           + i_p[..., None, None] * (v[..., :, None] * k[..., None, :]))
    n_t = f_p[..., None] * n_prev + i_p[..., None] * k
    denom = torch.clamp_min(torch.abs(torch.sum(n_t * q, dim=-1)), 1.0)
    h_t = torch.einsum("bhvk,bhk->bhv", c_t, q) / denom[..., None]
    return {"C": c_t, "n": n_t, "m": m_t}, h_t


def scale_qk(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t / math.sqrt(hd)`` as the reference computes it: JAX casts the
    weakly typed Python float to ``t``'s dtype first (19.625 in bfloat16
    for hd = 384), so the divisor is rounded to that dtype here too.  It
    lies on ``t``'s device: PyTorch's CUDA division multiplies by the
    reciprocal of a divisor held on the host."""
    return t / torch.full((), math.sqrt(hd), dtype=t.dtype, device=t.device)


def _split(tp, local: int, full: int, what: str) -> bool:
    return tp is not None and tp.split(local, full, what)


def _row_parallel(tp, split: bool, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``y @ w`` for a replicated ``y`` (every rank's whole): with
    ``w``'s rows split, this rank's block of ``y`` (``tp.scatter``)
    times its rows, summed over the group."""
    if not split:
        return y @ w
    return tp.reduce(tp.scatter(y, -1) @ w)


def _mlstm_preact(p: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """q, k, v, the input and forget gates' pre-activations (whole on
    every rank), the output gate (this rank's columns under ``tp``) and
    whether the block is split."""
    b, s, _ = x.shape
    di = int(cfg.d_model * cfg.ssm.proj_factor)
    h = cfg.num_heads
    hd = di // h
    split = _split(tp, p["w_up"].shape[1], di, "mlstm/w_up")
    if split:
        x = tp.copy(x)
    xu = x @ p["w_up"]
    if split:       # this rank's rows of each product, summed at once
        qkv = tp.reduce(torch.cat([xu @ p[w] for w in ("w_q", "w_k", "w_v")],
                                  dim=-1))
        q, k, v = qkv.split(di, dim=-1)
        gif = tp.reduce(xu.to(torch.float32) @ p["w_if"]) + p["if_bias"]
    else:
        q, k, v = (xu @ p[w] for w in ("w_q", "w_k", "w_v"))
        gif = (xu.to(torch.float32) @ p["w_if"]) + p["if_bias"]
    q = scale_qk(q.reshape(b, s, h, hd), hd)
    k = scale_qk(k.reshape(b, s, h, hd), hd)
    v = v.reshape(b, s, h, hd)
    it, ft = gif[..., :h], gif[..., h:]
    o = torch.sigmoid(x @ p["w_ogate"])
    return q, k, v, it, ft, o, split


def _mlstm_down(p: dict, o: torch.Tensor, h: torch.Tensor, tp,
                split: bool) -> torch.Tensor:
    """``(o * h) @ w_down``; with ``w_down``'s rows split, ``h`` (whole
    on every rank) cut to this rank's block by ``tp.scatter`` to meet
    ``o``'s columns, and the product summed over the group."""
    if not split:
        return (o * h) @ p["w_down"]
    return tp.reduce((o * tp.scatter(h, -1)) @ p["w_down"])


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    """Full-sequence mLSTM block (training / prefill)."""
    b, s, _ = x.shape
    q, k, v, it, ft, o, split = _mlstm_preact(p, x, cfg, tp)
    f32 = torch.float32
    xs = (q.transpose(0, 1).to(f32), k.transpose(0, 1).to(f32),
          v.transpose(0, 1).to(f32), it.transpose(0, 1), ft.transpose(0, 1))
    _, hs = chunked_scan(_mlstm_cell, mlstm_init_state(cfg, b, x.device), xs,
                         s)
    hs = hs.transpose(0, 1).reshape(b, s, -1).to(x.dtype)       # (B,S,di)
    return _mlstm_down(p, o, hs, tp, split)


def mlstm_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict,
                 tp=None):
    """One-token mLSTM step; x: (B, 1, d) -> ((B, 1, d), new state)."""
    b = x.shape[0]
    q, k, v, it, ft, o, split = _mlstm_preact(p, x, cfg, tp)
    f32 = torch.float32
    new_state, h_t = _mlstm_cell(state, (q[:, 0].to(f32), k[:, 0].to(f32),
                                         v[:, 0].to(f32), it[:, 0], ft[:, 0]))
    h_t = h_t.reshape(b, 1, -1).to(x.dtype)
    return _mlstm_down(p, o, h_t, tp, split), new_state


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory LSTM with recurrent gating) block
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, gen, device) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    std, dt = 1.0 / math.sqrt(d), _dtype(cfg)
    return {
        # input weights for z, i, f, o stacked: (d, 4d)
        "w_in": _normal((d, 4 * d), std, gen, device, dt),
        # block-diagonal recurrent weights per head: (H, hd, 4*hd)
        "r": _normal((h, hd, 4 * hd), 1 / math.sqrt(hd), gen, device,
                     torch.float32),
        "bias": torch.cat([torch.zeros((3 * d,), device=device),
                           torch.ones((d,), device=device)]),
        "w_down": _normal((d, d), std, gen, device, dt),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    z = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), **z), "n": torch.ones((batch, d), **z),
            "h": torch.zeros((batch, d), **z), "m": torch.zeros((batch, d), **z)}


def _slstm_cell(p: dict, cfg: ModelConfig, state: dict, x_in: torch.Tensor):
    """x_in: (B, 4d) preactivation from the input; adds the recurrent
    term.  The recurrent product is reshaped to (B, 4d) and split into
    z, i, f and o along that flat axis, as in the reference, so a gate
    is not a per-head block."""
    b = x_in.shape[0]
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    h_prev = state["h"].reshape(b, h, hd)
    rec = torch.einsum("bhk,hkf->bhf", h_prev, p["r"]).reshape(b, 4 * d)
    pre = x_in + rec + p["bias"]
    z, i_t, f_t, o_t = torch.split(pre, d, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o_t)
    m_t = torch.maximum(f_t + state["m"], i_t)     # exponential-gate stabilizer
    i_p = torch.exp(i_t - m_t)
    f_p = torch.exp(f_t + state["m"] - m_t)
    c_t = f_p * state["c"] + i_p * z
    n_t = f_p * state["n"] + i_p
    h_t = o * (c_t / torch.clamp_min(n_t, 1e-6))
    return {"c": c_t, "n": n_t, "h": h_t, "m": m_t}, h_t


def _slstm_input(p: dict, x: torch.Tensor, cfg: ModelConfig, tp=None):
    """The input pre-activation (..., 4d) float32 and the cell's
    parameters, whole on every rank: under ``tp`` this rank's column
    block of ``x @ w_in`` and of ``bias``, and ``r``'s heads where they
    split, gathered over the group (the scan that reads them runs on
    every rank, so their gradients need no sum)."""
    d, q = cfg.d_model, dict(p)
    if _split(tp, p["w_in"].shape[-1], 4 * d, "slstm/w_in"):
        x_in = tp.gather((tp.copy(x) @ p["w_in"]).to(torch.float32), -1,
                         partial=False)
    else:
        x_in = (x @ p["w_in"]).to(torch.float32)
    if _split(tp, p["bias"].shape[0], 4 * d, "slstm/bias"):
        q["bias"] = tp.gather(p["bias"], 0, partial=False)
    if _split(tp, p["r"].shape[0], cfg.num_heads, "slstm/r"):
        q["r"] = tp.gather(p["r"], 0, partial=False)
    return x_in, q


def _slstm_down(p: dict, y: torch.Tensor, cfg: ModelConfig, tp=None):
    return _row_parallel(tp, _split(tp, p["w_down"].shape[0], cfg.d_model,
                                    "slstm/w_down"), y, p["w_down"])


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    b, s, _ = x.shape
    x_in, p_all = _slstm_input(p, x, cfg, tp)                  # (B,S,4d)

    def step(state, inp):
        return _slstm_cell(p_all, cfg, state, inp[0])

    _, hs = chunked_scan(step, slstm_init_state(cfg, b, x.device),
                         (x_in.transpose(0, 1),), s)
    return _slstm_down(p, hs.transpose(0, 1).to(x.dtype), cfg, tp)


def slstm_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict,
                 tp=None):
    """One-token sLSTM step; x: (B, 1, d) -> ((B, 1, d), new state)."""
    x_in, p_all = _slstm_input(p, x[:, 0], cfg, tp)
    new_state, h_t = _slstm_cell(p_all, cfg, state, x_in)
    return _slstm_down(p, h_t[:, None].to(x.dtype), cfg, tp), new_state


# ---------------------------------------------------------------------------
# Mamba-style selective-SSM head (Hymba's parallel heads)
# ---------------------------------------------------------------------------

def init_mamba_head(cfg: ModelConfig, gen, device, lead: tuple = ()) -> dict:
    """The head's parameters, stacked on ``lead`` (the layer axis)."""
    d, n = cfg.d_model, cfg.ssm.state_size
    std, dt, f32 = 1.0 / math.sqrt(d), _dtype(cfg), torch.float32
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=device))
    return {
        "w_in": _normal((*lead, d, d), std, gen, device, dt),
        "w_dt": _normal((*lead, d, d), std * 0.1, gen, device, f32),
        "dt_bias": torch.full((*lead, d), -2.0, dtype=f32, device=device),
        "w_bc": _normal((*lead, d, 2 * n), std, gen, device, f32),
        "a_log": a_log.expand(*lead, d, n).contiguous(),
        "skip_scale": torch.ones((*lead, d), dtype=f32, device=device),
        "w_out": _normal((*lead, d, d), std, gen, device, dt),
    }


def mamba_init_state(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    """The head's decode state: (B, d, n) float32 zeros."""
    return torch.zeros((batch, cfg.d_model, cfg.ssm.state_size),
                       dtype=torch.float32, device=device)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, the reference's formula
    (``F.softplus`` takes ``log1p(exp(x))`` below 20 and x above)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mamba_split(p: dict, cfg: ModelConfig, tp) -> bool:
    return _split(tp, p["w_in"].shape[-1], cfg.d_model, "ssm_head/w_in")


def _mamba_scan_inputs(p: dict, x: torch.Tensor, cfg: ModelConfig,
                       tp=None):
    """u, exp(dt a), dt b and c of this rank's channels (every channel
    without ``tp``): ``x`` and the replicated ``w_dt``, ``dt_bias`` and
    ``w_bc`` enter through ``tp.copy``, the first two cut to the rank's
    channels."""
    n = cfg.ssm.state_size
    f32 = torch.float32
    w_dt, dt_bias, w_bc = p["w_dt"], p["dt_bias"], p["w_bc"]
    if tp is not None:
        c = p["w_in"].shape[-1]
        cols = slice(tp.index * c, (tp.index + 1) * c)
        x = tp.copy(x)
        w_dt, dt_bias = tp.copy(w_dt)[:, cols], tp.copy(dt_bias)[cols]
        w_bc = tp.copy(w_bc)
    u = (x @ p["w_in"]).to(f32)                                   # (B,S,d)
    dt = softplus(x.to(f32) @ w_dt + dt_bias)
    bc = x.to(f32) @ w_bc
    b_in, c_out = bc[..., :n], bc[..., n:]
    a = -torch.exp(p["a_log"])                                    # (d, n)
    da = torch.exp(dt[..., None] * a)                             # (B,S,d,n)
    db = dt[..., None] * b_in[..., None, :]                       # (B,S,d,n)
    return u, da, db, c_out


def _mamba_step(h, inp):
    u_t, da_t, db_t, c_t = inp
    h = da_t * h + db_t * u_t[..., None]                          # (B,d,n)
    return h, torch.sum(h * c_t[:, None, :], dim=-1)              # (B,d)


def _mamba_out(p: dict, y: torch.Tensor, x: torch.Tensor, tp):
    out = y.to(x.dtype) @ p["w_out"]
    return out if tp is None else tp.reduce(out)


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    b, s, _ = x.shape
    tp = tp if _mamba_split(p, cfg, tp) else None
    u, da, db, c_out = _mamba_scan_inputs(p, x, cfg, tp)
    xs = tuple(t.transpose(0, 1) for t in (u, da, db, c_out))
    state = torch.zeros((b, u.shape[-1], cfg.ssm.state_size),
                        dtype=torch.float32, device=x.device)
    _, ys = chunked_scan(_mamba_step, state, xs, s)
    y = ys.transpose(0, 1) + p["skip_scale"] * u                  # (B,S,d)
    return _mamba_out(p, y, x, tp)


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: torch.Tensor, tp=None):
    """One-token head step; x: (B, 1, d), state (B, d, n) -> ((B, 1, d),
    new state); under ``tp`` the state holds this rank's channels."""
    tp = tp if _mamba_split(p, cfg, tp) else None
    u, da, db, c_out = _mamba_scan_inputs(p, x, cfg, tp)
    h, y = _mamba_step(state, (u[:, 0], da[:, 0], db[:, 0], c_out[:, 0]))
    y = y + p["skip_scale"] * u[:, 0]
    return _mamba_out(p, y[:, None], x, tp), h
