"""Low-bit gradient aggregation collectives (the paper's core).

Port of ``repro/core/lowbit.py``.  Per-worker gradients come in with the
group's local ranks on their leading axis (see
:mod:`repro_torch.core.collectives`) and aggregates come out replicated,
without it.  Semantics (paper Section 2, identical across schedules):

    b_{k,i} = 1{ g_{k,i} > 0 }
    c_i     = PopCount_k(b_{k,i})           (vote count over W workers)
    u_i     = sgn(2 c_i - W)                 (G-Binary)
    u_i     = m_i * sgn(2 c_i - W)           (G-Ternary, 2-of-3 zero gate)

  * ``vote_psum``  — dense sign votes, one integer all-reduce.
  * ``packed_a2a`` — the controller schedule on the fused kernels: pack
    sign bits, ``all_to_all`` to the owner of each element range, owner
    PopCount/majority, ``all_gather`` of the packed ternary pair.

FP32 aggregation stays available per bucket (:func:`fp32_allreduce`).
Optional per-worker error feedback (EF-signSGD) is injected before the
vote and updated after it, in plain torch.
"""
from __future__ import annotations

import dataclasses

import torch

from .modes import AggregationMode, Schedule


# ---------------------------------------------------------------------------
# FP32 bypass path
# ---------------------------------------------------------------------------

def fp32_allreduce(g: torch.Tensor, group) -> torch.Tensor:
    """Full-precision mean aggregate; the payload is FP32 whatever the
    gradient's storage dtype (the paper's bypass semantics)."""
    return group.all_reduce_mean(g.to(torch.float32))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _flat_index_gate(shape, phase: int, dtype=torch.float32,
                     device="cpu") -> torch.Tensor:
    """Fixed 2-of-3 zero gate over flattened elements (paper Section 2)."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, device=device).reshape(shape)
    return (((idx + phase) % 3) != 2).to(dtype)


def _ef_inject(g: torch.Tensor, ef: torch.Tensor | None):
    """Error-feedback vote input: votes are taken on g + e."""
    if ef is None:
        return g, None
    return g + ef.to(g.dtype), ef


def _ef_update(g_eff: torch.Tensor, ef: torch.Tensor | None):
    """Residual e' = x - beta * sgn(x), beta = mean|x| per worker."""
    if ef is None:
        return None
    beta = g_eff.abs().reshape(g_eff.shape[0], -1).mean(dim=1)
    beta = beta.reshape((-1,) + (1,) * (g_eff.dim() - 1))
    return (g_eff - beta * torch.sign(g_eff)).to(ef.dtype)


# ---------------------------------------------------------------------------
# vote_psum schedule (dense votes)
# ---------------------------------------------------------------------------

def lowbit_vote_psum(g: torch.Tensor, group, num_workers: int, *,
                     ternary: bool = False, gate_phase: int = 0,
                     ef: torch.Tensor | None = None,
                     gate: torch.Tensor | None = None):
    """Sign votes, one integer all-reduce, majority (+ optional gate).

    The margin accumulates in int32 (int8 wraps at W >= 128).  ``gate``
    overrides the flat-index 2-of-3 gate with an explicit {0, 1} keep
    vector.  Returns ``(u, new_ef)``, ``u`` in {-1, 0, +1} (dtype of g).
    """
    g_eff, ef = _ef_inject(g, ef)
    votes = torch.where(g_eff > 0, 1, -1).to(torch.int32)
    margin = group.psum(votes)
    u = torch.sign(margin.to(torch.float32))
    if ternary:
        u = u * (_flat_index_gate(g.shape[1:], gate_phase, device=g.device)
                 if gate is None else gate.to(u.dtype))
    return u.to(g.dtype), _ef_update(g_eff, ef)


# ---------------------------------------------------------------------------
# packed_a2a schedule (the controller datapath)
# ---------------------------------------------------------------------------

def lowbit_packed_a2a(g: torch.Tensor, group, num_workers: int, *,
                      ternary: bool = False, gate_phase: int = 0,
                      ef: torch.Tensor | None = None, gate_mask=None,
                      kernels=None):
    """Controller-schedule aggregation of a fully local payload.

    The reference's ``_packed_a2a_local`` on its fused path: the codec's
    vote :class:`~repro_torch.kernels.fused.KernelSet` runs the
    pack -> all_to_all -> combine -> all_gather -> decode chain, with EF
    injected before it and updated after it (bit-identical to the
    reference's in-kernel EF by its own contract).  ``gate_mask`` (host
    boolean (N,) array) overrides the flat-index 2-of-3 gate.  The staged
    four-kernel chain and tensor-parallel leaves are still to port.
    """
    if kernels is None or not kernels.votes:
        raise NotImplementedError(
            "packed_a2a runs on a codec's vote kernel set; the staged "
            "popcount_stack/majority_decode chain is still to port "
            "(ROADMAP queue 2)")
    g_eff, ef = _ef_inject(g, ef)
    u, _ = kernels.packed_vote(g_eff, group, num_workers, ternary=ternary,
                               gate_phase=gate_phase, ef=None,
                               gate_mask=gate_mask)
    return u, _ef_update(g_eff, ef)


# ---------------------------------------------------------------------------
# per-leaf policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    """Resolved aggregation policy for one gradient leaf.

    ``mode`` names the codec and ``schedule`` the transport, each a
    built-in enum member or the name of a registered codec / backend.
    """
    mode: AggregationMode | str
    schedule: Schedule | str
    gate_phase: int = 0
    error_feedback: bool = False
