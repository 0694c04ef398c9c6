"""Hop plans: hierarchical, per-hop-recompressing collective routes.

Port of ``repro/fabric/hierarchy.py``.  A :class:`HopPlan` is an ordered
tuple of :class:`HopSpec` legs, each naming a registered codec, a
worker-group size and (optionally) a transport, so the gradient is
re-encoded at every hop: an intra-node FP32 mean first, then a low-bit
vote across the nodes (DynamiQ's shape, PAPERS.md)::

    plan  = HopPlan("hier_fp32_gbinary",
                    (HopSpec("fp32", workers=8),    # hop 0: intra-node
                     HopSpec("gbinary")))           # hop 1: the rest
    codec = register_hop_plan(plan)

Registration puts a :class:`HierarchicalCodec` carrying the plan into the
codec registry under the plan's name, so a route is named like any codec
(``GroupPolicy(mode="hier_fp32_gbinary")``, a preset, a ``Commander``
rung).  Its default schedule is the ``hierarchical`` backend
(:mod:`repro_torch.fabric.backends`), which runs each hop through that
hop codec's own transport.

Hop 0 is the innermost worker group.  ``HopSpec.workers`` is a fixed
count (clamped to the workers still unassigned) or None for the
remaining workers; on a group with one axis per hop (a
``VirtualGroup((outer, inner))`` or a ``(pod, data, model)``
:class:`~repro_torch.core.collectives.ProcessMesh`) hop ``h`` reduces
over the axis ``h`` from the innermost, whose extent must equal the hop's
size.  ``bits_per_element`` counts the backbone (last) hop; per-leg wire
bytes come from :func:`repro_torch.core.traffic.hop_wire_bytes_per_device`.
"""
from __future__ import annotations

import dataclasses

from .codecs import GradientCodec, get_codec, register_codec, \
    unregister_codec

__all__ = [
    "HierarchicalCodec", "HopPlan", "HopSpec", "INTRA_NODE_WORKERS",
    "register_hop_plan", "unregister_hop_plan",
]

#: intra-node group size of the built-in plans, as in the reference;
#: clamped to the session's worker count
INTRA_NODE_WORKERS = 8


@dataclasses.dataclass(frozen=True)
class HopSpec:
    """One leg of a hierarchical route.

    ``codec`` names the hop's representation; ``workers`` is the hop's
    group size, a fixed count or None for the remaining workers;
    ``schedule`` pins the hop's transport (default: the hop codec's
    ``default_schedule``, normalized by
    :func:`~repro_torch.core.modes.wire_schedule`).
    """
    codec: str
    workers: int | None = None
    schedule: str | None = None

    def __post_init__(self):
        if self.workers is not None and int(self.workers) < 1:
            raise ValueError(
                f"hop group size must be >= 1, got {self.workers}")


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """An ordered route of hops; hop 0 is the innermost worker group."""
    name: str
    hops: tuple

    def __post_init__(self):
        object.__setattr__(self, "hops", tuple(self.hops))
        if not self.hops:
            raise ValueError(f"hop plan {self.name!r} needs at least one hop")
        if sum(1 for h in self.hops if h.workers is None) > 1:
            raise ValueError(
                f"hop plan {self.name!r} has more than one remainder hop "
                f"(workers=None); at most one hop may absorb the leftover "
                f"workers")

    def signature(self) -> str:
        """Stable route identity (folded into the bucket fusion key)."""
        legs = ">".join(
            f"{h.codec}:{'*' if h.workers is None else int(h.workers)}"
            + (f"@{h.schedule}" if h.schedule else "")
            for h in self.hops)
        return f"{self.name}[{legs}]"

    def group_sizes(self, num_workers: int) -> tuple:
        """Per-hop worker-group sizes for a ``num_workers`` session.

        Fixed hops are clamped to the workers still unassigned and must
        divide them; the remainder hop absorbs the rest.  The product of
        the sizes is ``max(1, num_workers)``.
        """
        remaining = max(1, int(num_workers))
        sizes: list = [None] * len(self.hops)
        rem_idx = None
        for i, hop in enumerate(self.hops):
            if hop.workers is None:
                rem_idx = i
                continue
            s = min(int(hop.workers), remaining)
            if remaining % s:
                raise ValueError(
                    f"hop plan {self.name!r}: hop {i} group size {s} does "
                    f"not divide the {remaining} unassigned workers "
                    f"(session has {num_workers})")
            sizes[i] = s
            remaining //= s
        if rem_idx is not None:
            sizes[rem_idx] = remaining
            remaining = 1
        if remaining != 1:
            raise ValueError(
                f"hop plan {self.name!r} covers only "
                f"{max(1, int(num_workers)) // remaining} of {num_workers} "
                f"workers; add a remainder hop (workers=None) or size the "
                f"fixed hops to the session")
        return tuple(sizes)


class HierarchicalCodec(GradientCodec):
    """A registered codec carrying a :class:`HopPlan`.

    ``reduction = "hierarchical"`` routes every built-in flat schedule to
    the ``hierarchical`` backend.  ``bits_per_element`` and the sim
    ``lane`` are the backbone (last) hop's, ``gated`` / ``threads_ef``
    hold where any hop has them, and the bucket zero gate is the first
    gated hop's.  ``hop_signature`` is part of
    :class:`~repro_torch.core.buckets.BucketKey`, so buckets never mix
    routes.
    """

    reduction = "hierarchical"
    default_schedule = "hierarchical"
    kv_cache = False

    def __init__(self, plan: HopPlan):
        self.plan = plan
        self.name = plan.name
        self.hop_signature = plan.signature()
        hop_codecs = [get_codec(h.codec) for h in plan.hops]
        for c in hop_codecs:
            if getattr(c, "reduction", "") == "hierarchical":
                raise ValueError(
                    f"hop plan {plan.name!r}: hop codec {c.name!r} is "
                    f"itself hierarchical — hop plans do not nest")
        backbone = hop_codecs[-1]
        self.bits_per_element = backbone.bits_per_element
        self.lane = backbone.lane
        self.gated = any(c.gated for c in hop_codecs)
        self.threads_ef = any(c.threads_ef for c in hop_codecs)

    def bucket_gate(self, bucket):
        """The fused zero gate of the first gated hop codec."""
        for hop in self.plan.hops:
            c = get_codec(hop.codec)
            if c.gated:
                return c.bucket_gate(bucket)
        return None

    def kernel_set(self):
        """None: a route has no single kernel set; each hop runs its own
        codec's through that hop's transport (the session's
        ``fused_kernels`` reaches every hop)."""
        return None

    def kernel_signature(self) -> str | None:
        """The hops' kernel signatures joined along the route (None when
        no hop brings kernels), so swapping a hop codec's kernels
        invalidates built steps as a flat codec swap does."""
        sigs = []
        for hop in self.plan.hops:
            hook = getattr(get_codec(hop.codec), "kernel_signature", None)
            sigs.append(hook() if hook is not None else None)
        if not any(s is not None for s in sigs):
            return None
        return ">".join("-" if s is None else s for s in sigs)


def register_hop_plan(plan: HopPlan, *aliases: str,
                      override: bool = False) -> HierarchicalCodec:
    """Register a :class:`HierarchicalCodec` for ``plan`` under
    ``plan.name`` (+ ``aliases``); :func:`unregister_hop_plan` removes it."""
    codec = HierarchicalCodec(plan)
    register_codec(plan.name, *aliases, override=override)(codec)
    return codec


def unregister_hop_plan(name: str) -> None:
    """Remove a registered hop-plan codec and its aliases."""
    unregister_codec(name)


# ---------------------------------------------------------------------------
# built-in hop plans (intra-node FP32 mean -> inter-node low-bit)
# ---------------------------------------------------------------------------

register_hop_plan(HopPlan("hier_fp32_gbinary", (
    HopSpec("fp32", workers=INTRA_NODE_WORKERS),
    HopSpec("gbinary"))))

register_hop_plan(HopPlan("hier_fp32_gternary", (
    HopSpec("fp32", workers=INTRA_NODE_WORKERS),
    HopSpec("gternary"))))

register_hop_plan(HopPlan("hier_fp32_int4", (
    HopSpec("fp32", workers=INTRA_NODE_WORKERS),
    HopSpec("int4"))))
