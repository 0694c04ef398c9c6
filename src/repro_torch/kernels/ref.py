"""Plain PyTorch versions of the controller-datapath kernels (the twins).

Same wire format as the reference package's ``kernels/ref.py``:

    flat gradient bucket of N elements
      -> zero-padded to a multiple of LANE * 32
      -> reshaped to (M, LANE) with M a multiple of 32     ("value plane")
      -> sign words of shape (M // 32, LANE)                ("word plane")

Bit ``b`` of word ``w[r, l]`` holds the sign of value ``v[32 * r + b, l]``
(1 = strictly positive, 0 = non-positive, NaN included).

Words are held as ``torch.int32`` bit patterns: PyTorch on the CPU has no
shifts on ``uint32``.  Words are built in int64 and narrowed; every right
shift is masked afterwards, because ``>>`` on int32 is arithmetic.  Tests
compare words as ``np.uint32`` views.

Each function here runs on any device.  The dispatching wrappers
(:mod:`repro_torch.kernels.ops`) call them only for CPU tensors; a CUDA
tensor goes to the hand-written kernel, and ``chip_smoke.py`` calls these
twins directly on the card to hold each kernel against them.
"""
from __future__ import annotations

import numpy as np
import torch

LANE = 128          # words per row; canonical last dim
PACK = 32           # sign bits per 32-bit word
TILE = LANE * PACK  # elements covered by one word row

ALL_ONES = -1       # 0xFFFFFFFF as an int32 bit pattern


def padded_len(n: int) -> int:
    """Canonical padded length for an N-element bucket."""
    return ((n + TILE - 1) // TILE) * TILE


def to_plane(flat: torch.Tensor) -> torch.Tensor:
    """Flat (..., N) -> canonical value plane (..., M, LANE), zero padded."""
    n = flat.shape[-1]
    p = padded_len(n)
    if p != n:
        flat = torch.nn.functional.pad(flat, (0, p - n))
    return flat.reshape(*flat.shape[:-1], p // LANE, LANE)


def from_plane(plane: torch.Tensor, n: int) -> torch.Tensor:
    """Canonical value plane (..., M, LANE) -> flat (..., N), padding dropped."""
    return plane.reshape(*plane.shape[:-2], -1)[..., :n]


def _shifts(device) -> torch.Tensor:
    return torch.arange(PACK, dtype=torch.int64, device=device)


def _narrow(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors with the same bits."""
    return torch.where(words64 >= 2 ** 31, words64 - 2 ** 32,
                       words64).to(torch.int32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1} plane (..., 32R, LANE) -> int32 word plane (..., R, LANE)."""
    *lead, m, lane = bits.shape
    b = bits.to(torch.int64).reshape(*lead, m // PACK, PACK, lane)
    sh = _shifts(bits.device).reshape(PACK, 1)
    return _narrow(torch.sum(b << sh, dim=-2))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Word plane (..., R, LANE) -> {0,1} int32 bit plane (..., 32R, LANE)."""
    *lead, r, lane = words.shape
    sh = _shifts(words.device).reshape(PACK, 1)
    bits = (words.to(torch.int64)[..., :, None, :] >> sh) & 1
    return bits.reshape(*lead, r * PACK, lane).to(torch.int32)


# ---------------------------------------------------------------------------
# the vote stages
# ---------------------------------------------------------------------------

def sign_pack(plane: torch.Tensor) -> torch.Tensor:
    """Value plane (..., M, LANE) -> sign words (..., M//32, LANE) int32.

    Bit b of word [r, l] = 1 iff plane[32*r + b, l] > 0.  Leading axes
    (e.g. W stacked workers) pack independently.
    """
    if plane.shape[-2] % PACK:
        raise ValueError(f"rows {plane.shape[-2]} not a multiple of {PACK}")
    return _pack_bits(plane > 0)


def popcount_stack(packed: torch.Tensor) -> torch.Tensor:
    """(..., W, R, LANE) sign words -> vote counts (..., 32R, LANE) int32.

    Leading axes are independent owner shards (the (owner, worker) view a
    virtual all_to_all returns); the count runs over the worker axis.
    """
    return unpack_bits(packed).sum(dim=-3, dtype=torch.int32)


def majority_decode(counts: torch.Tensor, num_workers: int,
                    gate_words: torch.Tensor | None = None):
    """Vote counts (..., M, LANE) -> ternary packed pair of word planes.

    a_i = 2 c_i - W; sign bit = a_i > 0; mask bit = a_i != 0, and'ed with
    ``gate_words`` when given.
    """
    a = 2 * counts.to(torch.int32) - num_workers
    sign_words = _pack_bits(a > 0)
    mask_words = _pack_bits(a != 0)
    if gate_words is not None:
        mask_words = mask_words & gate_words
    return sign_words, mask_words


# ---------------------------------------------------------------------------
# zero gates (paper: fixed 2-of-3 pattern over flattened elements)
# ---------------------------------------------------------------------------

def gate_words_from_mask(keep, pad_words: int | None = None,
                         device="cpu") -> torch.Tensor:
    """Flat keep mask (N,) -> packed gate word plane (int32) on ``device``.

    ``keep`` is a host array or a tensor; it is packed where ``device``
    is, so a mask built on the card never visits the host.  Elements
    beyond N (canonical padding) keep = 1; ``pad_words`` right-pads the
    word plane with all-ones rows to that row count (the all_to_all row
    padding; dropped on unpack).
    """
    if not isinstance(keep, torch.Tensor):
        keep = torch.from_numpy(np.asarray(keep, bool))
    keep = keep.to(device=device, dtype=torch.bool).reshape(-1)
    n = keep.numel()
    full = torch.ones(padded_len(n), dtype=torch.bool, device=device)
    full[:n] = keep
    words = _pack_bits(full.reshape(-1, LANE))
    if pad_words is not None and pad_words > words.shape[0]:
        pad = torch.full((pad_words - words.shape[0], LANE), ALL_ONES,
                         dtype=torch.int32, device=device)
        words = torch.cat([words, pad])
    return words


def ternary_gate_words(num_rows: int, phase: int = 0,
                       device="cpu") -> torch.Tensor:
    """Packed 2-of-3 zero gate for a (num_rows, LANE) value plane.

    Element i (row-major over the plane) is gated to zero when
    (i + phase) % 3 == 2.
    """
    if num_rows % PACK:
        raise ValueError(f"rows {num_rows} not a multiple of {PACK}")
    idx = torch.arange(num_rows * LANE, device=device)
    return _pack_bits((((idx + phase) % 3) != 2).reshape(num_rows, LANE))


# ---------------------------------------------------------------------------
# decode and the fused-stage references
# ---------------------------------------------------------------------------

def unpack_ternary(sign_words: torch.Tensor, mask_words: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Ternary packed pair -> value plane of {-1, 0, +1} in ``dtype``."""
    s = unpack_bits(sign_words)
    m = unpack_bits(mask_words)
    return ((2 * s - 1) * m).to(dtype)


def vote_combine(routed: torch.Tensor, num_workers: int,
                 gate_words: torch.Tensor):
    """(..., W, R, LANE) routed sign words + gate (..., R, LANE) -> pair.

    Composition of :func:`popcount_stack` and :func:`majority_decode`;
    leading axes are independent owner shards.
    """
    counts = popcount_stack(routed)
    return majority_decode(counts, num_workers, gate_words=gate_words)


def encode_pack_ef(g_plane: torch.Tensor, e_plane: torch.Tensor):
    """EF inject + sign pack: ``(sign words, g_eff plane)``.

    ``g_eff = g + e`` in g's dtype, the residual rounded to that dtype
    first (the reference casts ``ef.astype(g.dtype)`` before the add);
    the words are the packed signs of the rounded ``g_eff``.
    """
    g_eff = g_plane + e_plane.to(g_plane.dtype)
    return sign_pack(g_eff), g_eff


def ef_residual(plane: torch.Tensor, beta) -> torch.Tensor:
    """EF residual ``x - beta * sgn(x)`` on value planes, in x's dtype.

    ``beta`` is a scalar or one value per leading plane (shape (L,) for
    (L, M, LANE) planes), rounded to the plane's dtype as the reference
    does (``jnp.asarray(beta, plane.dtype)``).
    """
    b = _per_plane(beta, plane)
    return plane - b * torch.sign(plane)


def _per_plane(value, planes: torch.Tensor) -> torch.Tensor:
    """A scalar or one value per leading plane, in the planes' dtype and
    shaped to broadcast over (..., M, LANE)."""
    v = torch.as_tensor(value, dtype=planes.dtype, device=planes.device)
    return v.reshape(v.shape + (1,) * (planes.dim() - v.dim()))


def vote_pipeline_dense(stack: torch.Tensor, num_workers: int,
                        gate_words: torch.Tensor) -> torch.Tensor:
    """(W, M, LANE) value planes + gate (M // 32, LANE) -> the decoded
    float32 plane (M, LANE) of {-1, 0, +1}.

    The whole local vote datapath, encode -> PopCount -> majority ->
    gate -> decode, as the composition of the staged twins.
    """
    sw, mw = vote_combine(sign_pack(stack), num_workers, gate_words)
    return unpack_ternary(sw, mw)


def int4_quant_plane(planes: torch.Tensor, levels: float = 7.0,
                     group=None) -> torch.Tensor:
    """Absmax int4 fake-quant, one scale per leading plane.

    ``s = max|x| * float32(1 / levels)`` over each (M, LANE) plane (the
    reference's jitted arithmetic: XLA folds its division by the constant
    ``levels`` into this product), ``safe = s`` where ``s > 0`` else 1
    (so a zero or NaN scale becomes 1), then ``clip(round(x / safe),
    -levels, levels) * safe`` with a true division and round half to
    even; NaN stays NaN through the clip.  With ``group`` the absmax is
    the max over its ranks' planes, taken on the int32 bits as the
    kernel takes it (a tensor-parallel leaf's scale).
    """
    inv = torch.full((), 1.0 / levels, dtype=torch.float32,
                     device=planes.device)
    amax = planes.abs().amax(dim=(-2, -1), keepdim=True)
    if group is not None:
        amax = group.all_reduce(amax.view(torch.int32), "max").view(
            torch.float32)
    scale = amax * inv
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(planes / safe), -levels, levels)
    return q * safe


def threshold_mask_plane(planes: torch.Tensor, thresh) -> torch.Tensor:
    """Magnitude sparsify: keep x where ``|x| >= t``, else +0.

    ``thresh`` is a scalar or one value per leading plane, rounded to
    the planes' dtype; NaN never passes the compare.
    """
    t = _per_plane(thresh, planes)
    return torch.where(planes.abs() >= t, planes,
                       torch.zeros((), dtype=planes.dtype,
                                   device=planes.device))


def apply_sign_update(param_plane: torch.Tensor, sign_words: torch.Tensor,
                      mask_words: torch.Tensor, scale) -> torch.Tensor:
    """``param - scale * u`` with u decoded from the ternary packed pair,
    computed in float32 and rounded once to the parameter's dtype."""
    u = unpack_ternary(sign_words, mask_words)
    s = torch.as_tensor(scale, dtype=torch.float32,
                        device=param_plane.device)
    return (param_plane.to(torch.float32) - s * u).to(param_plane.dtype)


# ---------------------------------------------------------------------------
# end-to-end oracles (paper Section 2, all workers -> aggregate values)
# ---------------------------------------------------------------------------

def gbinary_aggregate_dense(grads: torch.Tensor) -> torch.Tensor:
    """(W, N) worker gradients -> (N,) G-Binary aggregate in {-1, 0, +1}."""
    w = grads.shape[0]
    c = torch.sum((grads > 0).to(torch.int32), dim=0)
    return torch.sign(2 * c - w).to(torch.float32)


def gternary_aggregate_dense(grads: torch.Tensor,
                             phase: int = 0) -> torch.Tensor:
    """(W, N) worker gradients -> (N,) G-Ternary aggregate (2-of-3 gate)."""
    u = gbinary_aggregate_dense(grads)
    idx = torch.arange(grads.shape[1], device=grads.device)
    return u * (((idx + phase) % 3) != 2).to(torch.float32)
