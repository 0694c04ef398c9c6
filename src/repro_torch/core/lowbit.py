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
  * ``packed_a2a`` — the controller schedule on the Hopper kernels: pack
    sign bits, ``all_to_all`` to the owner of each element range, owner
    PopCount/majority, ``all_gather`` of the packed ternary pair.

FP32 aggregation stays available per bucket (:func:`fp32_allreduce`),
and so do the paper's Section 9 baselines (:func:`majority_sign_sgd`,
:func:`sign_of_mean`).

Tensor-parallel leaves (a ``model_spec`` that shards them over the model
axis) arrive as this rank's block.  The two vote schedules see them as
the reference does: ``packed_a2a`` votes the block as a fully local
payload (the reference's inner ``shard_map``: rows padded per block, the
gate's flat index restarting at 0, EF ``beta`` the block's own mean),
``vote_psum`` works on the whole GSPMD leaf (the gate at the block's
global flat indices, ``beta`` the whole leaf's mean, through a
:class:`~repro_torch.runtime.shardings.ShardView`).
Optional per-worker error feedback (EF-signSGD) is injected before the
vote and updated after it: in the fused kernels on ``packed_a2a`` with a
kernel set, in plain torch everywhere else.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import kernels as K
from ..kernels import fused as KF
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

def signum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, 0 or +1, with -0.0 and NaN passed through
    (``torch.sign`` maps both to +0.0)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


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


def _ef_update(g_eff: torch.Tensor, ef: torch.Tensor | None, shard=None):
    """Residual e' = x - beta * sgn(x), beta = mean|x| per worker (over
    the whole leaf for a ``shard`` of it)."""
    if ef is None:
        return None
    if shard is None:
        beta = g_eff.abs().reshape(g_eff.shape[0], -1).mean(dim=1)
    else:
        beta = shard.mean_abs(g_eff)
    beta = beta.reshape((-1,) + (1,) * (g_eff.dim() - 1))
    return (g_eff - beta * torch.sign(g_eff)).to(ef.dtype)


# ---------------------------------------------------------------------------
# vote_psum schedule (dense votes)
# ---------------------------------------------------------------------------

def lowbit_vote_psum(g: torch.Tensor, group, num_workers: int, *,
                     ternary: bool = False, gate_phase: int = 0,
                     ef: torch.Tensor | None = None,
                     gate: torch.Tensor | None = None, shard=None):
    """Sign votes, one integer all-reduce, majority (+ optional gate).

    The margin accumulates in int32 (int8 wraps at W >= 128).  ``gate``
    overrides the flat-index 2-of-3 gate with an explicit {0, 1} keep
    vector.  ``shard`` (a :class:`~repro_torch.runtime.shardings.
    ShardView`) marks ``g`` as a block of a tensor-parallel leaf: the gate
    and the EF ``beta`` are then the whole leaf's, as the reference's
    vote on the GSPMD array gives them.  Returns ``(u, new_ef)``, ``u``
    in {-1, 0, +1} (dtype of g).
    """
    g_eff, ef = _ef_inject(g, ef)
    votes = torch.where(g_eff > 0, 1, -1).to(torch.int32)
    margin = group.psum(votes)
    u = torch.sign(margin.to(torch.float32))
    if ternary:
        if gate is not None:
            u = u * gate.to(u.dtype)
        elif shard is not None:
            u = u * shard.gate(gate_phase, device=g.device)
        else:
            u = u * _flat_index_gate(g.shape[1:], gate_phase,
                                     device=g.device)
    return u.to(g.dtype), _ef_update(g_eff, ef, shard)


# ---------------------------------------------------------------------------
# packed_a2a schedule (the controller datapath)
# ---------------------------------------------------------------------------

def lowbit_packed_a2a(g: torch.Tensor, group, num_workers: int, *,
                      model_spec=None, ternary: bool = False,
                      gate_phase: int = 0, ef: torch.Tensor | None = None,
                      gate_mask=None, kernels=None):
    """Controller-schedule aggregation of a fully local payload.

    The reference's ``_packed_a2a_local``.  ``kernels`` (a codec's vote
    :class:`~repro_torch.kernels.fused.KernelSet`) runs the fused chain,
    EF included.  Without one (``Fabric(fused_kernels=False)``) the
    staged four-kernel chain runs: pack -> all_to_all -> PopCount ->
    majority -> all_gather -> decode, with EF injected before it and
    updated after it in plain torch; both chains give the same bits.
    On a host-local group the fused chain is one ``vote_pipeline``
    launch, and the staged chain runs with identity collectives.
    ``gate_mask`` (boolean (N,) keep vector, host array or tensor)
    overrides the flat-index 2-of-3 gate.  A tensor-parallel leaf
    (``model_spec`` shards it) arrives as this rank's block and is voted
    as a fully local payload, the reference's inner ``shard_map`` over
    the model axis; it takes no ``gate_mask``, as the reference asserts.
    """
    if model_spec is not None and any(e is not None for e in model_spec) \
            and gate_mask is not None:
        raise ValueError("gate_mask requires a fully local payload")
    if kernels is not None and kernels.votes:
        return kernels.packed_vote(g, group, num_workers, ternary=ternary,
                                   gate_phase=gate_phase, ef=ef,
                                   gate_mask=gate_mask)
    w = num_workers
    lead = g.shape[0]
    n = g[0].numel()
    g_eff, ef = _ef_inject(g, ef)
    words = K.pack_signs(K.to_plane(g_eff.reshape(lead, n)))
    routed, r, rw = KF.route_words(words, group, w)
    counts = K.popcount_stack(routed)
    gate = KF.shard_gate_words(group.rank(), rw, ternary=ternary,
                               gate_phase=gate_phase, gate_mask=gate_mask,
                               total_rows=rw * w, device=g.device)
    sw, mw = K.majority_decode(counts, gate, num_workers=w)
    u = KF.gather_decode(sw, mw, group, r, n, g.dtype)
    return u.reshape(g.shape[1:]), _ef_update(g_eff, ef)


# ---------------------------------------------------------------------------
# Section 9 baselines
# ---------------------------------------------------------------------------

def majority_sign_sgd(g: torch.Tensor, group, num_workers: int):
    """MajoritySignSGD: the software sign baseline, G-Binary's update
    rule on the dense vote schedule (paper Section 9)."""
    u, _ = lowbit_vote_psum(g, group, num_workers)
    return u


def sign_of_mean(g: torch.Tensor, group) -> torch.Tensor:
    """SignOfMean: the sign taken after the FP32 mean (the optimizer
    reference; not communication-comparable)."""
    return signum(group.all_reduce_mean(g)).to(g.dtype)


# ---------------------------------------------------------------------------
# per-leaf policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafPolicy:
    """Resolved aggregation policy for one gradient leaf.

    ``mode`` names the codec and ``schedule`` the transport, each a
    built-in enum member or the name of a registered codec / backend.
    ``model_spec`` is the leaf's sanitized partition spec when it is
    tensor-parallel (None for a replicated leaf).
    """
    mode: AggregationMode | str
    schedule: Schedule | str
    model_spec: tuple | None = None     # the leaf's TP spec over "model"
    gate_phase: int = 0
    error_feedback: bool = False


def _group_context(group, num_workers: int):
    """The aggregation context of a worker group standing where the
    reference's ``dp_axes`` stands (an ``int`` W is ``VirtualGroup(W)``);
    ``num_workers`` must be the group's size, as ``Fabric`` requires."""
    from ..fabric.registry import AggregationContext
    from .collectives import VirtualGroup
    if isinstance(group, int):
        group = VirtualGroup(group)
    if num_workers != group.size:
        raise ValueError(f"num_workers={num_workers} disagrees with the "
                         f"group's {group.size} workers")
    return AggregationContext(group=group, num_workers=group.size)


def aggregate_leaf(g: torch.Tensor, policy: LeafPolicy, group,
                   num_workers: int, ef: torch.Tensor | None = None):
    """The reference's free-function leaf shim: one gradient leaf (the
    group's local ranks on its leading axis) through the schedule
    registry under ``policy``, as ``Fabric.aggregate`` runs a leaf.

    ``group`` stands where the reference's ``dp_axes`` stands (a
    :class:`~repro_torch.core.collectives.VirtualGroup`, ``LocalGroup``
    or ``DistributedGroup``; an ``int`` W is ``VirtualGroup(W)``).  There
    is no ``interpret`` argument: the port's kernels have no interpret
    mode, a CPU tensor runs their plain twins and a CUDA tensor the
    kernels.  Returns ``(aggregate, new_ef)``: the FP32 mean, or the
    ternary direction in {-1, 0, +1} for a vote codec.
    """
    from ..fabric.session import aggregate_leaf as dispatch
    return dispatch(_group_context(group, num_workers), g, policy, ef=ef)
