"""Built-in schedule backends: the paper's collectives behind the registry.

Port of ``repro/fabric/backends.py`` (psum, vote_psum, also registered
as the ``majority_sign_sgd`` baseline, packed_a2a, the ``sign_of_mean``
baseline and the per-hop ``hierarchical`` route). Backends are codec-
parametric and all fusable: besides the per-leaf ``aggregate`` they
implement ``aggregate_flat`` over a (ranks, N) bucket payload, one
collective per bucket. A codec's kernel set runs the packed vote
(``packed_a2a``) or the encode around the mean (``psum``, the int4 and
top-k kernels).

A tensor-parallel leaf (its policy's ``model_spec`` shards it over the
model axis) reaches ``aggregate`` as this rank's block
(``repro/fabric/backends.py:150-175``): ``packed_a2a`` votes the block
alone, ``vote_psum`` sees the whole leaf through the session mesh's model
group, and the FP32 mean and ``sign_of_mean`` are elementwise.  A mean
codec with an encode of its own spans the whole leaf, as the reference's
encode on the GSPMD leaf does (``repro/fabric/extra_codecs.py:79-84``,
``:132-138``): int4's absmax and top-k's k-th largest |x| are taken
over the model group.  A hop plan hands every hop the leaf's spec and
the session's mesh, so each hop sees the block as its backend does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.lowbit import (LeafPolicy, _ef_inject, _ef_update,
                           fp32_allreduce, lowbit_packed_a2a,
                           lowbit_vote_psum, sign_of_mean)
from ..core.modes import Schedule, wire_schedule
from .codecs import get_codec, resolve_leaf_gate_mask, ring_wire_bytes
from .registry import AggregationContext, get_schedule, register_schedule


def _codec_kernels(ctx: AggregationContext, codec):
    """The codec's kernel set, or None where the codec brings none or the
    session pinned the staged chain (``fused_kernels=False``) of a vote
    set.  A mean set always runs: its encode has no staged kernels to
    fall back on, so the switch leaves it on its kernels."""
    ks = codec.kernel_set()
    return ks if ks is None or ks.means or ctx.fused_kernels else None


def _shard(ctx: AggregationContext, g, policy):
    """The :class:`~repro_torch.runtime.shardings.ShardView` of a
    tensor-parallel leaf's block (``g`` carries the local ranks on its
    leading axis), or None for a replicated leaf."""
    spec = getattr(policy, "model_spec", None)
    if spec is None:
        return None
    if ctx.mesh is None:
        raise ValueError(f"a leaf specced over the model axis (spec "
                         f"{spec}) needs a session on a mesh")
    return ctx.mesh.shard_view(spec, tuple(g.shape[1:]))


@register_schedule(Schedule.PSUM, "fp32")
class Fp32AllreduceBackend:
    """Mean transport — the paper's bypass / calibration path.

    The payload is ``codec.encode(g)``, the all-reduce averages it, and
    ``codec.decode`` runs on the mean (both identity for fp32/identity).
    """

    name = "psum"
    fusable = True
    threads_ef = False

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        codec = get_codec(policy.mode)
        ks = _codec_kernels(ctx, codec)
        if ks is not None and ks.means:
            u = self._encoded_mean(ctx, g.reshape(g.shape[0], -1), codec, ks,
                                   _shard(ctx, g, policy))
            return u.reshape(g.shape[1:]), ef
        return codec.decode(ctx, fp32_allreduce(codec.encode(ctx, g),
                                                ctx.group)), ef

    def aggregate_flat(self, ctx: AggregationContext, flat, codec, *,
                       gate=None):
        ks = _codec_kernels(ctx, codec)
        if ks is not None and ks.means:
            return self._encoded_mean(ctx, flat, codec, ks)
        return codec.decode(ctx, fp32_allreduce(codec.encode(ctx, flat),
                                                ctx.group))

    @staticmethod
    def _encoded_mean(ctx, flat, codec, ks, shard=None):
        """The codec's encode kernel on each rank's flat payload (the
        same bits as ``codec.encode``; over the whole leaf where ``shard``
        marks a tensor-parallel block), the mean, then the decodes."""
        u = fp32_allreduce(ks.encode_flat(flat, shard), ctx.group)
        return codec.decode(ctx, ks.decode_apply(u))

    def wire_bytes_per_device(self, n_elements: int, mode,
                              num_workers: int) -> float:
        return ring_wire_bytes(get_codec(mode).payload_bytes(n_elements),
                               num_workers)


@register_schedule(Schedule.VOTE_PSUM, "majority_sign_sgd")
class VotePsumBackend:
    """Dense sign votes + one integer all-reduce (uses no kernel).

    Registered as ``majority_sign_sgd`` too: the software baseline has
    G-Binary's update rule on this schedule (paper Section 9).
    """

    name = "vote_psum"
    fusable = True
    threads_ef = True

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        codec = get_codec(policy.mode)
        shard = _shard(ctx, g, policy)
        shape = g.shape[1:] if shard is None else shard.global_shape
        mask = resolve_leaf_gate_mask(codec, shape, policy.gate_phase)
        gate = None
        if mask is not None:
            gate = torch.from_numpy(mask).reshape(shape)
            if shard is not None:       # the whole leaf's mask, this block
                gate = shard.block(gate)
            gate = gate.to(g.device, g.dtype)
        return lowbit_vote_psum(
            g, ctx.group, ctx.num_workers, ternary=codec.gated,
            gate_phase=policy.gate_phase, gate=gate, ef=ef, shard=shard)

    def aggregate_flat(self, ctx: AggregationContext, flat, codec, *,
                       gate=None):
        gv = None if gate is None else gate.vector(torch.float32,
                                                   device=flat.device)
        u, _ = lowbit_vote_psum(flat, ctx.group, ctx.num_workers,
                                ternary=codec.gated, gate=gv)
        return u

    def wire_bytes_per_device(self, n_elements: int, mode,
                              num_workers: int) -> float:
        # the paper's logical 1-byte vote; the realization sums int32
        return ring_wire_bytes(1.0 * n_elements, num_workers)


@register_schedule(Schedule.PACKED_A2A)
class PackedA2ABackend:
    """The controller schedule: pack -> all_to_all -> PopCount -> gather."""

    name = "packed_a2a"
    fusable = True
    threads_ef = True

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        codec = get_codec(policy.mode)
        return lowbit_packed_a2a(
            g, ctx.group, ctx.num_workers,
            model_spec=getattr(policy, "model_spec", None),
            ternary=codec.gated, gate_phase=policy.gate_phase,
            gate_mask=resolve_leaf_gate_mask(codec, g.shape[1:],
                                             policy.gate_phase),
            ef=ef, kernels=_codec_kernels(ctx, codec))

    def aggregate_flat(self, ctx: AggregationContext, flat, codec, *,
                       gate=None):
        # the packed schedule packs the keep vector into gate words, on
        # the payload's device (a host mask of a full-size bucket took
        # seconds a step to build and pack)
        u, _ = lowbit_packed_a2a(flat, ctx.group, ctx.num_workers,
                                 ternary=codec.gated,
                                 gate_mask=None if gate is None
                                 else gate.vector(torch.bool,
                                                  device=flat.device),
                                 kernels=_codec_kernels(ctx, codec))
        return u

    def wire_bytes_per_device(self, n_elements: int, mode,
                              num_workers: int) -> float:
        # all_to_all of packed signs + all_gather of sign+mask words
        return (ring_wire_bytes(n_elements / 8.0, num_workers, trips=1.0)
                + ring_wire_bytes(n_elements / 4.0, num_workers, trips=1.0))


@register_schedule("sign_of_mean")
class SignOfMeanBackend:
    """Sign after the FP32 mean: the optimizer reference, FP32 wire cost."""

    name = "sign_of_mean"
    fusable = True
    threads_ef = False

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        return sign_of_mean(g, ctx.group), ef

    def aggregate_flat(self, ctx: AggregationContext, flat, codec, *,
                       gate=None):
        return sign_of_mean(flat, ctx.group)

    def wire_bytes_per_device(self, n_elements: int, mode,
                              num_workers: int) -> float:
        # the full-precision reduction has already happened, whatever
        # the nominal codec: priced as the psum transport's fp32 payload
        return ring_wire_bytes(get_codec("fp32").payload_bytes(n_elements),
                               num_workers)


def _resolve_hop(hop):
    """(backend, codec, wire-schedule name) for one HopSpec leg."""
    hcodec = get_codec(hop.codec)
    sched = wire_schedule(hop.codec, hop.schedule or hcodec.default_schedule)
    return get_schedule(sched), hcodec, sched


@register_schedule("hierarchical")
class HierarchicalBackend:
    """Per-hop-recompressing route: each hop through its codec's own
    transport, over that hop's worker groups only.

    The policy's codec is a :class:`~repro_torch.fabric.hierarchy.
    HierarchicalCodec`.  Hop 0 runs over the innermost groups (for a
    ``VirtualGroup((outer, inner))`` the ``outer`` groups of ``inner``
    workers, for a ``(pod, data, model)`` mesh the ``data`` group); each
    group's replicated result is one local rank of the next hop, whose
    groups span the next axis out (see ``hop_groups`` in
    :mod:`repro_torch.core.collectives`).  A one-hop plan runs over the
    whole group and equals its codec's flat backend bit for bit; a group
    with no collective (``LocalGroup``) runs every hop as its local round
    trip.  Each hop's group must hold exactly the plan's size for that
    hop (``HopPlan.group_sizes``), which the reference does not check
    (ROADMAP queue 3).

    A tensor-parallel leaf's block takes every hop with the leaf's spec
    and the session's mesh, whose model group is every hop's: each hop's
    backend sees the block as it does on a flat route (the reference
    hands every hop's ``LeafPolicy`` the ``model_spec``).

    EF is threaded around the whole route: injected before hop 0 and
    updated from the injected gradient after the last hop, as the bucket
    layer does around a flat collective.  The bucket zero gate reaches
    only gated hops.  Each hop keeps the session's ``fused_kernels``, so
    a packed G-Binary backbone runs the fused vote kernels over its
    group while an FP32 hop stays on the plain mean.
    """

    name = "hierarchical"
    fusable = True
    threads_ef = True

    @staticmethod
    def _plan_of(codec):
        plan = getattr(codec, "plan", None)
        if plan is None:
            raise TypeError(
                f"codec {codec.name!r} rides the hierarchical schedule but "
                f"carries no HopPlan; register it with "
                f"repro_torch.fabric.register_hop_plan")
        return plan

    @staticmethod
    def _hops(ctx: AggregationContext, plan) -> list:
        """``(HopSpec, [hop context of each group])`` for every hop."""
        sizes = plan.group_sizes(ctx.num_workers)
        try:
            levels = ctx.group.hop_groups(len(plan.hops))
        except ValueError as e:
            raise ValueError(f"hop plan {plan.name!r}: {e}") from None
        extents = tuple(groups[0].size for groups in levels)
        if extents != sizes:
            raise ValueError(
                f"hop plan {plan.name!r} sizes its hops {sizes} for "
                f"{ctx.num_workers} workers, but the group's hops hold "
                f"{extents} (innermost first); register a plan whose fixed "
                f"hops equal the axis extents")
        return [(hop, [dataclasses.replace(ctx, group=g, num_workers=s)
                       for g in groups])
                for hop, groups, s in zip(plan.hops, levels, sizes)]

    @staticmethod
    def _route(ctx, plan, x, run):
        """``x`` (local ranks first) through every hop: ``run(hop,
        backend, hop codec, sched, hop_ctx, block)`` aggregates one
        group's block, and the groups' results stack into the next hop's
        local ranks."""
        hops = HierarchicalBackend._hops(ctx, plan)
        for i, (hop, ctxs) in enumerate(hops):
            backend, hcodec, sched = _resolve_hop(hop)
            blocks = x.split([len(c.group.rank()) for c in ctxs])
            outs = [run(hop, backend, hcodec, sched, c, b)
                    for c, b in zip(ctxs, blocks)]
            x = outs[0] if i == len(hops) - 1 else torch.stack(outs)
        return x

    def aggregate(self, ctx: AggregationContext, g, policy, ef=None):
        codec = get_codec(policy.mode)
        plan = self._plan_of(codec)
        use_ef = (ef is not None and policy.error_feedback
                  and codec.threads_ef)
        g_eff, _ = _ef_inject(g, ef if use_ef else None)

        def run(hop, backend, hcodec, sched, hop_ctx, block):
            hop_policy = LeafPolicy(mode=hop.codec, schedule=sched,
                                    model_spec=policy.model_spec,
                                    gate_phase=policy.gate_phase)
            return backend.aggregate(hop_ctx, block, hop_policy, None)[0]

        u = self._route(ctx, plan, g_eff, run)
        return u, (_ef_update(g_eff, ef) if use_ef else ef)

    def aggregate_flat(self, ctx: AggregationContext, flat, codec, *,
                       gate=None):
        def run(hop, backend, hcodec, sched, hop_ctx, block):
            # the zero gate belongs to a gated hop's majority stage
            return backend.aggregate_flat(
                hop_ctx, block, hcodec, gate=gate if hcodec.gated else None)

        return self._route(ctx, self._plan_of(codec), flat, run)

    def hop_wire_bytes_per_device(self, n_elements: int, mode,
                                  num_workers: int) -> tuple:
        """Per-leg wire bytes: each hop's own model at its group size."""
        plan = self._plan_of(get_codec(mode))
        legs = []
        for hop, size in zip(plan.hops, plan.group_sizes(num_workers)):
            backend, _, _ = _resolve_hop(hop)
            legs.append(backend.wire_bytes_per_device(n_elements, hop.codec,
                                                      size))
        return tuple(legs)

    def wire_bytes_per_device(self, n_elements: int, mode,
                              num_workers: int) -> float:
        return float(sum(self.hop_wire_bytes_per_device(
            n_elements, mode, num_workers)))
