"""Codec-owned fused kernels: the per-bucket kernel chains of the codecs.

Port of ``repro/kernels/fused.py``.  The packed sign vote that the
``packed_a2a`` schedule runs on every low-bit bucket or leaf is

    encode -> all_to_all -> vote_combine -> all_gather -> unpack_ternary
           [-> ef_residual]

with :func:`vote_combine` (``csrc/vote_combine.cu``) and, under error
feedback (EF), :func:`encode_pack_ef` (``csrc/encode_pack_ef.cu``) as
the encode and :func:`ef_residual_plane` (``csrc/ef_residual.cu``) as
the residual update; without EF the encode is ``sign_pack``.  On a
host-local group no collective separates the stages, and the whole
chain is one :func:`vote_pipeline` launch (``csrc/vote_pipeline.cu``).
The mean codecs' kernels are :func:`int4_quant_plane`
(``csrc/int4_quant.cu``) and :func:`threshold_mask_plane`
(``csrc/threshold_mask.cu``).  The gate helpers, the bucket-level entry
point :func:`fused_packed_vote` and the :class:`KernelSet` accounting
(:class:`VoteKernelSet`, :class:`Int4KernelSet`, :class:`TopKKernelSet`)
are here too.  Each wrapper runs its plain twin for CPU tensors and
launches its kernel, or raises, for CUDA tensors.
"""
from __future__ import annotations

import functools

import torch

from . import build, ref
from .apply_update import unpack_ternary
from .ref import ALL_ONES, LANE, PACK
from .ref import ef_residual as ef_residual_plain        # the plain twins
from .ref import encode_pack_ef as encode_pack_ef_plain
from .ref import int4_quant_plane as int4_quant_plane_plain
from .ref import threshold_mask_plane as threshold_mask_plane_plain
from .ref import vote_combine as vote_combine_plain
from .ref import vote_pipeline_dense as vote_pipeline_plain
from .sign_pack import sign_pack


# ---------------------------------------------------------------------------
# gate-word helpers
# ---------------------------------------------------------------------------

def local_gate_words(num_words: int, *, ternary: bool, gate_phase: int = 0,
                     gate_mask=None, device="cpu") -> torch.Tensor:
    """Packed zero gate for an un-routed (num_words, LANE) word plane."""
    if gate_mask is not None:
        return ref.gate_words_from_mask(gate_mask, pad_words=num_words,
                                        device=device)
    if ternary:
        return ref.ternary_gate_words(num_words * PACK, phase=gate_phase,
                                      device=device)
    return torch.full((num_words, LANE), ALL_ONES, dtype=torch.int32,
                      device=device)


def shard_gate_words(ranks, rows_per_shard: int, *, ternary: bool,
                     gate_phase: int = 0, gate_mask=None,
                     total_rows: int | None = None,
                     device="cpu") -> torch.Tensor:
    """Packed zero gates of the owner shards ``ranks``: (len(ranks), rw, LANE).

    Owner ``k`` holds word rows ``[k * rw, (k + 1) * rw)`` of the plane
    after the all_to_all.  ``gate_mask`` (flat keep vector, host array
    or tensor) overrides the flat-index 2-of-3 pattern; ``total_rows``
    right-pads its packed words to the collective's row padding
    (dropped on unpack).
    """
    rw = rows_per_shard
    ranks = list(ranks)
    if not ternary:
        return torch.full((len(ranks), rw, LANE), ALL_ONES,
                          dtype=torch.int32, device=device)
    if gate_mask is not None:
        full = ref.gate_words_from_mask(gate_mask, pad_words=total_rows,
                                        device=device)
        return torch.stack([full[k * rw:(k + 1) * rw] for k in ranks])
    # the 2-of-3 pattern repeats every 3 elements: build the three phase
    # rotations once and pick by each shard's flat element offset
    gates = [ref.ternary_gate_words(rw * PACK, phase=p, device=device)
             for p in range(3)]
    return torch.stack([gates[(k * rw * PACK * LANE + gate_phase) % 3]
                        for k in ranks])


# ---------------------------------------------------------------------------
# the combine kernel
# ---------------------------------------------------------------------------

def vote_combine(routed: torch.Tensor, gate_words: torch.Tensor, *,
                 num_workers: int):
    """Routed words (W, R, LANE) or (B, W, R, LANE) + gate (R or B, R, LANE)
    -> ternary packed pair, each shaped like the gate.

    One kernel for popcount + majority + gate; the counts never reach
    device memory.  The owner (B) and worker (W) axes may have any stride
    that is a multiple of 4 words, so the transposed view a virtual
    all_to_all returns is taken as it is; for CUDA tensors a misaligned
    pointer or stride raises.
    """
    if routed.shape[-3] != num_workers:
        raise ValueError(f"routed words carry {routed.shape[-3]} workers, "
                         f"num_workers={num_workers}")
    if build.on_cpu(routed, gate_words):
        return vote_combine_plain(routed, num_workers, gate_words)
    r4 = routed if routed.dim() == 4 else routed.unsqueeze(0)
    g3 = gate_words if gate_words.dim() == 3 else gate_words.unsqueeze(0)
    b, w, r, lane = r4.shape
    if lane != LANE or g3.shape != (b, r, LANE):
        raise ValueError(f"vote_combine shapes disagree: routed "
                         f"{tuple(routed.shape)}, gate "
                         f"{tuple(gate_words.shape)}")
    if r4.dtype != torch.int32 or g3.dtype != torch.int32:
        raise TypeError("vote_combine takes int32 words")
    if r4.stride(3) != 1 or r4.stride(2) != LANE or not g3.is_contiguous():
        raise ValueError("vote_combine needs rows and lanes contiguous")
    # the kernel moves 4 words (16 bytes) at a time; an axis of one
    # element is never stepped, so its stride does not matter
    strides = [r4.stride(d) if r4.shape[d] > 1 else 0 for d in (0, 1)]
    if (r4.data_ptr() % 16 or g3.data_ptr() % 16
            or any(s % 4 for s in strides)):
        raise ValueError(f"vote_combine needs 16-byte aligned words and "
                         f"owner / worker strides in multiples of 4 words, "
                         f"got strides {tuple(r4.stride())}")
    sign = torch.empty((b, r, LANE), dtype=torch.int32, device=r4.device)
    mask = torch.empty_like(sign)
    if build.meta_call("vote_combine", (r4, g3), (sign, mask)):
        return sign.reshape(gate_words.shape), mask.reshape(gate_words.shape)
    fn = build.bind("vote_combine", "vote_combine_u32", 4, 5)
    build.check(fn(r4.data_ptr(), g3.data_ptr(), sign.data_ptr(),
                   mask.data_ptr(), b, w, r, *strides,
                   build.stream_ptr(r4.device)), "vote_combine")
    vote_combine.launches += 1
    return sign.reshape(gate_words.shape), mask.reshape(gate_words.shape)


vote_combine.launches = 0


# ---------------------------------------------------------------------------
# the error-feedback kernels
# ---------------------------------------------------------------------------

_FLOATS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _decode_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a vote decode kernel writes for a payload of ``dtype``:
    float32 and bfloat16 themselves, anything else float32 (then cast;
    {-1, 0, +1} are exact in every float type)."""
    return dtype if dtype in _FLOATS else torch.float32


def _float_symbol(stem: str, *dtypes) -> str:
    for dt in dtypes:
        if dt not in _FLOATS:
            raise TypeError(f"{stem} takes float32 or bfloat16, got {dt}")
    return "_".join([stem, *(_FLOATS[dt] for dt in dtypes)])


def encode_pack_ef(g_plane: torch.Tensor, e_plane: torch.Tensor):
    """Fused EF inject + sign pack: value planes (..., M, LANE) of g and
    of the residual e -> ``(sign words (..., M // 32, LANE), g_eff plane)``.

    ``g_eff`` is in g's dtype; e (float32 or bfloat16) is rounded to it
    in registers.  Leading axes (the W workers) go in one launch.
    """
    if build.on_cpu(g_plane, e_plane):
        return encode_pack_ef_plain(g_plane, e_plane)
    symbol = _float_symbol("encode_pack_ef", g_plane.dtype, e_plane.dtype)
    if (g_plane.shape != e_plane.shape or g_plane.dim() < 2
            or g_plane.shape[-1] != LANE or g_plane.shape[-2] % PACK):
        raise ValueError(f"encode_pack_ef needs two (..., 32k, {LANE}) "
                         f"planes, got {tuple(g_plane.shape)} and "
                         f"{tuple(e_plane.shape)}")
    if not (g_plane.is_contiguous() and e_plane.is_contiguous()):
        raise ValueError("encode_pack_ef needs contiguous planes")
    words = torch.empty(g_plane.shape[:-2] + (g_plane.shape[-2] // PACK,
                                              LANE),
                        dtype=torch.int32, device=g_plane.device)
    g_eff = torch.empty_like(g_plane)
    if build.meta_call("encode_pack_ef", (g_plane, e_plane), (words, g_eff)):
        return words, g_eff
    fn = build.bind("encode_pack_ef", symbol, 4, 1)
    build.check(fn(g_plane.data_ptr(), e_plane.data_ptr(), words.data_ptr(),
                   g_eff.data_ptr(), words.numel(),
                   build.stream_ptr(g_plane.device)), "encode_pack_ef")
    encode_pack_ef.launches += 1
    return words, g_eff


encode_pack_ef.launches = 0


def ef_residual_plane(plane: torch.Tensor, beta: torch.Tensor, *,
                      out_dtype=None) -> torch.Tensor:
    """EF residual ``x - beta * sgn(x)`` on value planes (L, M, LANE),
    ``beta`` one value per plane (L,), in the planes' dtype; the result
    is stored as ``out_dtype`` (default: the planes' dtype).
    """
    out_dtype = out_dtype or plane.dtype
    if build.on_cpu(plane, beta):
        return ef_residual_plain(plane, beta).to(out_dtype)
    symbol = _float_symbol("ef_residual", plane.dtype, out_dtype)
    if plane.dim() != 3 or plane.shape[-1] != LANE:
        raise ValueError(f"ef_residual_plane needs (L, M, {LANE}) planes, "
                         f"got {tuple(plane.shape)}")
    if beta.shape != plane.shape[:1]:
        raise ValueError(f"ef_residual_plane needs one beta per plane, "
                         f"got {tuple(beta.shape)} for {plane.shape[0]}")
    if not plane.is_contiguous():
        raise ValueError("ef_residual_plane needs contiguous planes")
    # beta rounded to the planes' dtype as the twin rounds it, then
    # widened (exactly) to the float32 the kernel reads
    b32 = beta.to(plane.dtype).to(torch.float32).contiguous()
    out = torch.empty(plane.shape, dtype=out_dtype, device=plane.device)
    if build.meta_call("ef_residual", (plane, b32), out):
        return out
    fn = build.bind("ef_residual", symbol, 3, 2)
    build.check(fn(plane.data_ptr(), b32.data_ptr(), out.data_ptr(),
                   plane.shape[0], plane[0].numel(),
                   build.stream_ptr(plane.device)), "ef_residual")
    ef_residual_plane.launches += 1
    return out


ef_residual_plane.launches = 0


def ef_update_fused(g_eff: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """The EF residual update on the kernel, bit-identical to
    :func:`repro_torch.core.lowbit._ef_update`.

    ``g_eff`` carries the L local ranks on its leading axis.  beta is
    each rank's mean |g_eff| over the leaf's own elements (the same
    reduction as the plain update); the elementwise residual runs as one
    kernel over all L canonical planes and is stored in ``ef``'s dtype.
    """
    lead = g_eff.shape[0]
    flat = g_eff.reshape(lead, -1)
    beta = flat.abs().mean(dim=1)
    resid = ef_residual_plane(ref.to_plane(flat), beta, out_dtype=ef.dtype)
    return ref.from_plane(resid, flat.shape[1]).reshape(g_eff.shape)


# ---------------------------------------------------------------------------
# the host-local vote: the whole chain in one kernel
# ---------------------------------------------------------------------------

def vote_pipeline(stack: torch.Tensor, gate_words: torch.Tensor, *,
                  num_workers: int, dtype=torch.float32) -> torch.Tensor:
    """Stacked value planes (W, M, LANE) + gate (M // 32, LANE) -> the
    decoded plane (M, LANE) of {-1, 0, +1} in ``dtype``, in one launch.

    ``dtype`` is float32 or bfloat16, as in the reference; both hold the
    three values exactly, so the bits equal a float32 decode cast to
    ``dtype``.  ``stack`` must carry exactly ``num_workers`` planes.  The
    reference disagrees with itself there (its Pallas call takes W from
    the stack, its plain path ``num_workers``), so a mismatch raises here.
    """
    if dtype not in _FLOATS:
        raise TypeError(f"vote_pipeline decodes to float32 or bfloat16, "
                        f"got {dtype}")
    if stack.dim() != 3 or stack.shape[0] != num_workers:
        raise ValueError(f"vote_pipeline needs a stack of num_workers="
                         f"{num_workers} planes, got {tuple(stack.shape)}")
    if build.on_cpu(stack, gate_words):
        return vote_pipeline_plain(stack, num_workers, gate_words).to(dtype)
    symbol = _float_symbol("vote_pipeline", stack.dtype, dtype)
    w, m, lane = stack.shape
    if lane != LANE or m % PACK or gate_words.shape != (m // PACK, LANE):
        raise ValueError(f"vote_pipeline shapes disagree: stack "
                         f"{tuple(stack.shape)}, gate "
                         f"{tuple(gate_words.shape)}")
    if gate_words.dtype != torch.int32:
        raise TypeError("vote_pipeline takes int32 gate words")
    if not (stack.is_contiguous() and gate_words.is_contiguous()):
        raise ValueError("vote_pipeline needs contiguous operands")
    if stack.data_ptr() % 16 or gate_words.data_ptr() % 16:
        raise ValueError("vote_pipeline needs 16-byte aligned operands")
    out = torch.empty((m, LANE), dtype=dtype, device=stack.device)
    if build.meta_call("vote_pipeline", (stack, gate_words), out):
        return out
    fn = build.bind("vote_pipeline", symbol, 3, 2)
    build.check(fn(stack.data_ptr(), gate_words.data_ptr(), out.data_ptr(),
                   m * LANE, w, build.stream_ptr(stack.device)),
                "vote_pipeline")
    vote_pipeline.launches += 1
    vote_pipeline.launches_by_dtype[dtype] += 1
    return out


vote_pipeline.launches = 0
#: the same launches split by output dtype
vote_pipeline.launches_by_dtype = dict.fromkeys(_FLOATS, 0)


# ---------------------------------------------------------------------------
# the mean codecs' kernels
# ---------------------------------------------------------------------------

def _planes3(planes: torch.Tensor, what: str) -> torch.Tensor:
    """(M, LANE) or (L, M, LANE) contiguous planes as (L, M, LANE)."""
    p3 = planes if planes.dim() == 3 else planes.unsqueeze(0)
    if p3.dim() != 3 or p3.shape[-1] != LANE:
        raise ValueError(f"{what} needs (L, M, {LANE}) planes, "
                         f"got {tuple(planes.shape)}")
    if not p3.is_contiguous():
        raise ValueError(f"{what} needs contiguous planes")
    return p3


def int4_quant_plane(planes: torch.Tensor, *, levels: float = 7.0,
                     group=None) -> torch.Tensor:
    """Absmax int4 fake-quant of float32 value planes (M, LANE) or
    (L, M, LANE), one scale per plane.

    Two launches, counted as two: the absmax of each plane (an atomic
    max on the bits of |x|, into a per-plane slot on the card), then the
    quantize pass.  With ``group`` (the model group of a
    tensor-parallel leaf, whose ranks hold its blocks) the slots are
    reduced by max over the group between the launches, as int32 (the
    bits of a non-negative float order as the float), so every rank
    quantizes with the whole leaf's absmax.  No scale is read back to
    the host.  For CUDA tensors the planes must start on a 16-byte
    boundary (the quantize launch moves 16 bytes a thread).
    """
    if build.on_cpu(planes):
        return int4_quant_plane_plain(planes, levels, group)
    if planes.dtype != torch.float32:
        raise TypeError(f"int4_quant_plane takes float32, got {planes.dtype}")
    p3 = _planes3(planes, "int4_quant_plane")
    if p3.data_ptr() % 16:
        raise ValueError("int4_quant_plane needs 16-byte aligned planes")
    amax_bits = torch.zeros(p3.shape[0], dtype=torch.int32,
                            device=p3.device)
    out = torch.empty_like(p3)
    if build.meta_call("int4_quant", (p3,), out, launches=2):
        if group is not None:           # the dry-run counts the collective
            group.all_reduce(amax_bits, "max")
        return out.reshape(planes.shape)
    stream = build.stream_ptr(p3.device)
    absmax = build.bind("int4_quant", "int4_absmax_f32", 2, 2)
    build.check(absmax(p3.data_ptr(), amax_bits.data_ptr(), p3.shape[0],
                       p3[0].numel(), stream), "int4_quant")
    if group is not None:
        amax_bits = group.all_reduce(amax_bits, "max")
    quantize = build.bind("int4_quant", "int4_quantize_f32", 3, 2, 1)
    build.check(quantize(p3.data_ptr(), amax_bits.data_ptr(), out.data_ptr(),
                         p3.shape[0], p3[0].numel(), float(levels), stream),
                "int4_quant")
    int4_quant_plane.launches += 2
    return out.reshape(planes.shape)


int4_quant_plane.launches = 0


def threshold_mask_plane(planes: torch.Tensor, thresh) -> torch.Tensor:
    """Keep x where ``|x| >= t``, else +0, on value planes (M, LANE) or
    (L, M, LANE); ``thresh`` is one value or one per plane (L,), rounded
    to the planes' dtype.  For CUDA tensors the planes must start on a
    16-byte boundary (the kernel moves 16 bytes a thread)."""
    if not isinstance(thresh, torch.Tensor):
        thresh = torch.as_tensor(thresh, device=planes.device)
    if build.on_cpu(planes, thresh):
        return threshold_mask_plane_plain(planes, thresh)
    symbol = _float_symbol("threshold_mask", planes.dtype)
    p3 = _planes3(planes, "threshold_mask_plane")
    if thresh.numel() not in (1, p3.shape[0]):
        raise ValueError(f"threshold_mask_plane needs one threshold or one "
                         f"per plane, got {tuple(thresh.shape)} for "
                         f"{p3.shape[0]} planes")
    if p3.data_ptr() % 16:
        raise ValueError("threshold_mask_plane needs 16-byte aligned planes")
    # rounded to the planes' dtype as the twin rounds it; the kernel reads
    # it in that dtype (a no-op here for run D's per-plane thresholds)
    t = thresh.reshape(-1).to(planes.dtype).expand(p3.shape[0]).contiguous()
    out = torch.empty_like(p3)
    if build.meta_call("threshold_mask", (p3, t), out):
        return out.reshape(planes.shape)
    fn = build.bind("threshold_mask", symbol, 3, 2)
    build.check(fn(p3.data_ptr(), t.data_ptr(), out.data_ptr(),
                   p3.shape[0], p3[0].numel(),
                   build.stream_ptr(p3.device)), "threshold_mask")
    threshold_mask_plane.launches += 1
    return out.reshape(planes.shape)


threshold_mask_plane.launches = 0


# ---------------------------------------------------------------------------
# bucket-level entry point: packed_a2a on the fused kernels
# ---------------------------------------------------------------------------

def fused_packed_vote(g: torch.Tensor, group, num_workers: int, *,
                      ternary: bool = False, gate_phase: int = 0,
                      ef: torch.Tensor | None = None, gate_mask=None):
    """The ``packed_a2a`` vote schedule on the fused kernels.

    ``g`` (and ``ef``, when given) carry the group's local ranks on their
    leading axis; the result ``u`` (in {-1, 0, +1}, dtype of ``g``) is
    replicated and has no such axis.  Three launches: encode every local
    plane (:func:`encode_pack_ef` under EF, else ``sign_pack``), combine
    every local owner shard, decode the gathered pair; under EF a fourth,
    :func:`ef_update_fused`.  On a host-local group (``group.host_local``,
    the reference's empty ``dp_axes``) no collective separates the
    stages: one :func:`vote_pipeline` launch, after ``g + ef`` under EF.
    Returns ``(u, new_ef)``.
    """
    w = num_workers
    lead = g.shape[0]
    n = g[0].numel()
    if group.host_local:
        g_eff = g if ef is None else g + ef.to(g.dtype)
        plane = ref.to_plane(g_eff.reshape(lead, n))
        gate = local_gate_words(plane.shape[1] // PACK, ternary=ternary,
                                gate_phase=gate_phase, gate_mask=gate_mask,
                                device=g.device)
        u_plane = vote_pipeline(plane, gate, num_workers=w,
                                dtype=_decode_dtype(g.dtype))
        u = ref.from_plane(u_plane, n).reshape(g.shape[1:]).to(g.dtype)
        return u, None if ef is None else ef_update_fused(g_eff, ef)
    if ef is None:
        words = sign_pack(ref.to_plane(g.reshape(lead, n)))
    else:
        words, geff_plane = encode_pack_ef(ref.to_plane(g.reshape(lead, n)),
                                           ref.to_plane(ef.reshape(lead, n)))
    routed, r, rw = route_words(words, group, w)
    gate = shard_gate_words(group.rank(), rw, ternary=ternary,
                            gate_phase=gate_phase, gate_mask=gate_mask,
                            total_rows=rw * w, device=g.device)
    sw, mw = vote_combine(routed, gate, num_workers=w)
    u = gather_decode(sw, mw, group, r, n, g.dtype).reshape(g.shape[1:])
    if ef is None:
        return u, None
    g_eff = ref.from_plane(geff_plane, n).reshape(g.shape)
    return u, ef_update_fused(g_eff, ef)


def route_words(words: torch.Tensor, group, num_workers: int):
    """Local word planes (L, R, LANE) -> the owner shards this group's
    ranks receive, ``(routed, r, rw)``.

    The rows are zero-padded to a multiple of W and cut into W shards of
    ``rw`` rows; ``all_to_all`` gives each owner its shard of every
    worker, (L, W, rw, LANE).  ``r`` is the unpadded row count.
    """
    lead, r = words.shape[:2]
    pad_r = (-r) % num_workers
    if pad_r:
        words = torch.nn.functional.pad(words, (0, 0, 0, pad_r))
    rw = (r + pad_r) // num_workers
    routed = group.all_to_all(words.reshape(lead, num_workers, rw, LANE))
    return routed, r, rw


def gather_decode(sw: torch.Tensor, mw: torch.Tensor, group, r: int,
                  n: int, dtype: torch.dtype) -> torch.Tensor:
    """Owner pairs -> ``all_gather`` -> the decoded flat aggregate (n,)
    in ``dtype`` (see :func:`_decode_dtype`)."""
    sw_all = group.all_gather(sw)[:r]
    mw_all = group.all_gather(mw)[:r]
    return ref.from_plane(unpack_ternary(sw_all, mw_all, _decode_dtype(dtype)),
                          n).to(dtype)


# ---------------------------------------------------------------------------
# KernelSet protocol + the vote set
# ---------------------------------------------------------------------------

# modeled device-memory bytes per element of a bucket, by representation
_F32 = 4.0          # one float32
_WORDS = 1 / 8.0    # packed sign bits
_PAIR = 1 / 4.0     # ternary packed (sign, mask) pair
_COUNTS = 4.0       # int32 vote counts


class KernelSet:
    """Protocol for a codec's fused kernels.

    ``votes`` sets realize the packed sign-vote chain: the ``packed_a2a``
    backend hands them the whole bucket through :meth:`packed_vote`.
    ``means`` sets realize encode / decode around a mean collective: the
    ``psum`` backend calls :meth:`encode_flat` on the (ranks, N) payload
    and :meth:`decode_apply` on the mean.  ``launches`` / ``hbm_bytes``
    are the modeled accounting (launches and device-memory bytes per
    bucket) of the fused chain and of the staged chain, as in the
    reference.
    """
    name = "kernelset"
    votes = False
    means = False

    def signature(self) -> str:
        return self.name

    def launches(self, *, fused: bool, distributed: bool = True,
                 ef: bool = False) -> int:
        raise NotImplementedError

    def hbm_bytes(self, n: int, *, num_workers: int, fused: bool,
                  distributed: bool = True, ef: bool = False) -> float:
        raise NotImplementedError

    # --- mean-reduction entry points (means=True sets) ---
    def encode_flat(self, flat: torch.Tensor, shard=None) -> torch.Tensor:
        """(ranks, N) payload -> each rank's encoded payload, same shape.
        ``shard`` (a :class:`~repro_torch.runtime.shardings.ShardView`)
        marks the payload as a block of a tensor-parallel leaf: the
        encode's statistic spans the whole leaf, over its model group."""
        raise NotImplementedError

    def decode_apply(self, payload: torch.Tensor) -> torch.Tensor:
        """The decode on the reduced (mean) payload."""
        return payload

    # --- vote-reduction entry point (votes=True sets) ---
    def packed_vote(self, g, group, num_workers, *, ternary, gate_phase,
                    ef, gate_mask=None):
        raise NotImplementedError


class VoteKernelSet(KernelSet):
    """Fused sign-vote chain for ``gbinary`` / ``gternary``."""
    name = "vote"
    votes = True

    def signature(self) -> str:
        return "vote:v1"

    def packed_vote(self, g, group, num_workers, *, ternary, gate_phase,
                    ef, gate_mask=None):
        return fused_packed_vote(g, group, num_workers, ternary=ternary,
                                 gate_phase=gate_phase, ef=ef,
                                 gate_mask=gate_mask)

    def launches(self, *, fused: bool, distributed: bool = True,
                 ef: bool = False) -> int:
        # staged: pack, popcount, majority, decode; fused: encode /
        # combine / decode around the collectives, or one kernel when
        # nothing separates the stages.  As in the reference, the EF
        # residual update is not counted, though here it is a kernel
        # (ef_residual_plane): a per-leaf EF vote launches 4.
        if not fused:
            return 4
        return 3 if distributed else 1

    def hbm_bytes(self, n: int, *, num_workers: int, fused: bool,
                  distributed: bool = True, ef: bool = False) -> float:
        w = num_workers
        if distributed:
            enc = n * (_F32 + _WORDS)                       # read g, write words
            if ef:
                enc += n * (2 * _F32 + _F32) if not fused else n * (2 * _F32)
            dec = n * (_PAIR + _F32)                        # read pair, write u
            if fused:
                comb = n * (w * _WORDS + _WORDS + _PAIR)    # stack+gate -> pair
                return enc + comb + dec
            pop = n * (w * _WORDS + _COUNTS)                # stack -> counts
            maj = n * (_COUNTS + _WORDS + _PAIR)            # counts+gate -> pair
            return enc + pop + maj + dec
        if fused:
            return n * (w * _F32 + _WORDS + _F32)           # stacks+gate -> u
        pack = w * n * (_F32 + _WORDS)
        pop = n * (w * _WORDS + _COUNTS)
        maj = n * (_COUNTS + _WORDS + _PAIR)
        dec = n * (_PAIR + _F32)
        return pack + pop + maj + dec


class Int4KernelSet(KernelSet):
    """Absmax int4 fake-quant for the ``int4`` codec, one scale per rank
    (per tensor-parallel leaf, over its model group)."""
    name = "int4"
    means = True

    def __init__(self, levels: float = 7.0):
        self.levels = float(levels)

    def signature(self) -> str:
        return f"int4:v1:levels={self.levels:g}"

    def encode_flat(self, flat: torch.Tensor, shard=None) -> torch.Tensor:
        n = flat.shape[-1]
        planes = ref.to_plane(flat.to(torch.float32))
        out = int4_quant_plane(planes, levels=self.levels,
                               group=None if shard is None else shard.group)
        return ref.from_plane(out, n).to(flat.dtype)

    def launches(self, *, fused: bool, distributed: bool = True,
                 ef: bool = False) -> int:
        # as in the reference: staged absmax reduce + quantize pass, fused
        # one two-phase kernel.  The port's kernel is two launches (an
        # absmax pass, then the quantize pass): its counter records 2.
        return 1 if fused else 2

    def hbm_bytes(self, n: int, *, num_workers: int, fused: bool,
                  distributed: bool = True, ef: bool = False) -> float:
        # the plane is read twice (scan, quantize) and written once
        return n * (2 * _F32 + _F32)


def kth_largest(x: torch.Tensor, k: int, group) -> torch.Tensor:
    """The ``k``-th largest value of each row of ``x`` (L, n),
    non-negative float32, over the rows of every rank of ``group``
    concatenated: a radix select on the int32 bits (a non-negative
    float's bits order as the float), a byte a pass from the top.  Each
    pass counts the candidates' next byte in 256 bins, sums the counts
    over the group (one all-reduce of L x 256 int64, 2 KiB a row) and
    keeps the bin that holds the k-th; four passes fix the 32 bits, on
    the device, with nothing read back to the host.  The value
    ``torch.topk`` of the rows gathered whole would give."""
    bits = x.contiguous().view(torch.int32)
    lead = bits.shape[0]
    prefix = torch.zeros((lead, 1), dtype=torch.int32, device=x.device)
    rank = torch.full((lead, 1), k, dtype=torch.int64, device=x.device)
    for shift in (24, 16, 8, 0):
        digit = ((bits >> shift) & 0xFF).long()
        if shift == 24:
            cand = torch.ones_like(digit)
        else:
            cand = ((bits >> (shift + 8)) == (prefix >> (shift + 8))).long()
        hist = torch.zeros((lead, 256), dtype=torch.int64, device=x.device)
        hist = group.all_reduce(hist.scatter_add_(1, digit, cand))
        above = hist.flip(1).cumsum(1).flip(1)      # candidates >= each bin
        pick = (above >= rank).sum(1, keepdim=True) - 1
        rank = rank - (above - hist).gather(1, pick)
        prefix = prefix | (pick.to(torch.int32) << shift)
    return prefix.view(torch.float32)[:, 0]


class TopKKernelSet(KernelSet):
    """Magnitude-threshold sparsify for the ``topk`` codec: each rank
    keeps its ``fraction`` largest |x| (ties at the threshold too); a
    tensor-parallel leaf's ranks, the whole leaf's."""
    name = "topk"
    means = True

    def __init__(self, fraction: float):
        self.fraction = float(fraction)

    def signature(self) -> str:
        return f"topk:v1:f={self.fraction:g}"

    def encode_flat(self, flat: torch.Tensor, shard=None) -> torch.Tensor:
        # each rank's threshold: its k-th largest |x| (torch.topk, as the
        # reference's lax.top_k), rounded to the payload's dtype; on a
        # tensor-parallel leaf the whole leaf's k-th over the model group
        f = flat.to(torch.float32).abs()
        if shard is None:
            k = max(1, int(f.shape[-1] * self.fraction))
            thresh = torch.topk(f, k, dim=-1).values[..., -1]
        else:
            k = max(1, int(shard.numel * self.fraction))
            thresh = kth_largest(f, k, shard.group)
        out = threshold_mask_plane(ref.to_plane(flat), thresh.to(flat.dtype))
        return ref.from_plane(out, flat.shape[-1])

    def launches(self, *, fused: bool, distributed: bool = True,
                 ef: bool = False) -> int:
        # staged: |x| pass, top-k select, mask pass; fused: the top-k
        # select reads |x| on the fly, then one mask kernel
        return 2 if fused else 3

    def hbm_bytes(self, n: int, *, num_workers: int, fused: bool,
                  distributed: bool = True, ef: bool = False) -> float:
        select = n * _F32                                   # top-k scan
        mask = n * (2 * _F32)                               # read x, write out
        if fused:
            return select + mask
        return n * (2 * _F32) + select + mask               # + |x| round trip


@functools.cache
def vote_kernel_set() -> VoteKernelSet:
    """Shared instance: gbinary/gternary differ only in the gate operand."""
    return VoteKernelSet()
