"""Gradient bucket manager: groups, admission policies, and bucket layouts.

Port of ``repro/core/buckets.py``:

  parameter tree --(GroupRules)--> named groups --(AdmissionPlan)--> modes
                 --(resolve_policies)--> per-leaf LeafPolicy tree
                 --(plan_buckets)------> BucketLayout (fused flat buckets)

Compatible leaves (same codec / wire schedule / error-feedback flag /
gate phase / model spec / dtype) are concatenated into fixed-budget flat buckets
(32 MiB by default, the paper's bucket size, Section 5.2) so the fabric
runs one collective per bucket instead of one per leaf.  The layout is a
pure function of (leaf order, shapes, dtypes, policies, bucket_bytes).

Trees are nested dicts (:mod:`repro_torch.core.tree`); a leaf only needs
``shape`` and ``dtype`` (a torch dtype, numpy dtype or its name).
A tensor-parallel leaf (a ``model_spec`` that shards it) is never
bucketed: it stays on the per-leaf path, as in the reference.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from . import tree as T
from .lowbit import LeafPolicy
from .modes import (AggregationMode, Schedule, canonical_mode, codec_name,
                    schedule_name, wire_schedule)


def _codec(mode):
    """Resolve a codec lazily (keeps ``core`` importable without fabric)."""
    from ..fabric.codecs import get_codec
    return get_codec(mode)


def path_name(key_path) -> str:
    """A key path -> its '/'-joined name, e.g. ``'layers/3/attn/wq'``.

    The entries are ``str`` / ``int`` keys, or objects that carry one as
    ``key``, ``idx`` or ``name`` (``jax.tree_util``'s ``DictKey``,
    ``SequenceKey`` and ``GetAttrKey``); the names equal
    :func:`~repro_torch.core.tree.flatten`'s paths."""
    parts = []
    for k in key_path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                k = getattr(k, attr)
                break
        parts.append(str(k))
    return "/".join(parts)


def dtype_name(dtype) -> str:
    """'bfloat16', 'float32', ... for torch dtypes, numpy dtypes or names."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return getattr(dtype, "name", None) or str(np.dtype(dtype))


def dtype_itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return getattr(dtype, "itemsize", None) or np.dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class GroupRules:
    """Ordered (regex, group) rules; first match wins, default 'backbone'.

    The classifier / LM head and anything scale-like (norms, biases) stay
    out of the low-bit backbone group; MoE routers are head-like.
    """
    rules: tuple = (
        (r"(^|/)(head|lm_head|classifier|logits)(/|$)", "head"),
        (r"(^|/)(router|gate_weights?)(/|$)", "head"),
        (r"(norm|bias|scale|ln_|layernorm)", "norms"),
        (r"(embed|wte|wpe|patch_proj|frontend)", "embed"),
    )
    default: str = "backbone"

    def group_of(self, name: str) -> str:
        for pattern, group in self.rules:
            if re.search(pattern, name):
                return group
        return self.default


def assign_groups(params: Any, rules: GroupRules | None = None) -> dict:
    """Params tree -> tree of group-name strings (same structure)."""
    rules = rules or GroupRules()
    return T.unflatten([(p, rules.group_of(p)) for p, _ in T.flatten(params)])


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64)) if len(shape) else 1


def group_sizes(params: Any, rules: GroupRules | None = None) -> dict[str, int]:
    """Element counts per group (drives traffic accounting)."""
    rules = rules or GroupRules()
    out: dict[str, int] = {}
    for path, leaf in T.flatten(params):
        g = rules.group_of(path)
        out[g] = out.get(g, 0) + _numel(leaf.shape)
    return out


@dataclasses.dataclass(frozen=True)
class GroupPolicy:
    """Codec + schedule + EF flag for one parameter group.

    ``schedule`` None means the codec's default transport.
    """
    mode: AggregationMode | str = AggregationMode.FP32
    schedule: Schedule | str | None = None
    error_feedback: bool = False

    def resolved_schedule(self) -> Schedule | str:
        return self.schedule or _codec(self.mode).default_schedule


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Controller-visible mode latch: group name -> GroupPolicy."""
    policies: tuple = ()                      # tuple[(group, GroupPolicy)]
    default: GroupPolicy = GroupPolicy()

    @staticmethod
    def from_dict(d: Mapping[str, GroupPolicy],
                  default: GroupPolicy | None = None) -> "AdmissionPlan":
        return AdmissionPlan(policies=tuple(sorted(d.items())),
                             default=default or GroupPolicy())

    def policy_for(self, group: str) -> GroupPolicy:
        for g, pol in self.policies:
            if g == group:
                return pol
        return self.default

    def signature(self) -> str:
        items = [f"{g}:{codec_name(p.mode)}"
                 f":{schedule_name(p.resolved_schedule())}"
                 f":{int(p.error_feedback)}" for g, p in self.policies]
        d = self.default
        items.append(f"*:{codec_name(d.mode)}"
                     f":{schedule_name(d.resolved_schedule())}"
                     f":{int(d.error_feedback)}")
        return "|".join(items)

    # ---- canonical plans from the paper -------------------------------
    @staticmethod
    def fp32_all() -> "AdmissionPlan":
        return AdmissionPlan(default=GroupPolicy(AggregationMode.FP32))

    @staticmethod
    def lowbit_all(mode: AggregationMode | str = AggregationMode.G_BINARY,
                   schedule: Schedule | str | None = None,
                   error_feedback: bool = False) -> "AdmissionPlan":
        """'Full-path' low-bit: every group on the codec."""
        return AdmissionPlan(default=GroupPolicy(mode, schedule, error_feedback))

    @staticmethod
    def lowbit_backbone(mode: AggregationMode | str = AggregationMode.G_BINARY,
                        schedule: Schedule | str | None = None,
                        error_feedback: bool = False) -> "AdmissionPlan":
        """Low-bit backbone; head, norms and embeddings on FP32."""
        return AdmissionPlan.from_dict(
            {"backbone": GroupPolicy(mode, schedule, error_feedback)},
            default=GroupPolicy(AggregationMode.FP32))


def resolve_policies(params: Any, plan: AdmissionPlan,
                     pspecs: Any | None = None,
                     rules: GroupRules | None = None) -> dict:
    """Params tree (+ optional partition-spec tree) -> LeafPolicy tree.

    ``pspecs`` gives each leaf's tensor-parallel spec (tuples, see
    :mod:`repro_torch.runtime.shardings`); a spec that replicates every
    dimension is stored as None."""
    rules = rules or GroupRules()
    items = T.flatten(params)
    if pspecs is None:
        specs = [None] * len(items)
    else:
        specs = T.leaves(pspecs)
    if len(specs) != len(items):
        raise ValueError(f"pspec tree mismatch: {len(specs)} specs vs "
                         f"{len(items)} leaves")
    out = []
    for (path, _), spec in zip(items, specs):
        gp = plan.policy_for(rules.group_of(path))
        out.append((path, LeafPolicy(
            mode=gp.mode, schedule=gp.resolved_schedule(),
            model_spec=None if _trivial(spec) else tuple(spec),
            error_feedback=gp.error_feedback)))
    return T.unflatten(out)


def _trivial(spec) -> bool:
    return spec is None or all(e is None for e in spec)


# ---------------------------------------------------------------------------
# bucket layout planner (paper Section 5.2: fixed-size gradient buckets)
# ---------------------------------------------------------------------------

#: Default flat-bucket payload budget (the paper's 32 MiB buckets).
DEFAULT_BUCKET_BYTES = 32 * 2 ** 20


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Fusion-compatibility key: leaves may share a bucket iff equal.

    ``schedule`` is the *wire* schedule (after
    :func:`~repro_torch.core.modes.wire_schedule`).  ``hops`` is the
    codec's hop-plan signature (None for a flat codec), so buckets never
    mix hierarchical routes.
    """
    mode: AggregationMode | str
    schedule: str
    error_feedback: bool
    gate_phase: int
    model_spec: tuple | None
    dtype: str
    hops: str | None = None


@dataclasses.dataclass(frozen=True)
class BucketSlot:
    """One leaf's placement inside a bucket's flat payload."""
    leaf: int                   # index into the flattened gradient tree
    name: str                   # '/'-joined tree path
    shape: tuple
    size: int                   # element count
    offset: int                 # start offset in the bucket's flat payload


@dataclasses.dataclass(frozen=True)
class BucketGate:
    """Per-bucket ternary zero gate, as (size, phase) leaf segments.

    The 2-of-3 gate is defined over each leaf's own flat index (paper
    Section 2), so the bucket gate is the concatenation of per-leaf
    patterns.  :meth:`vector` builds it on a device for elementwise
    schedules; :meth:`mask` gives the host boolean array the packed-word
    schedules pack into gate words.
    """
    segments: tuple             # ((n_elements, phase), ...) per leaf

    def mask(self) -> np.ndarray:
        return np.concatenate(
            [(((np.arange(n) + p) % 3) != 2) for n, p in self.segments])

    def vector(self, dtype, device="cpu") -> torch.Tensor:
        parts = [(((torch.arange(n, device=device) + p) % 3) != 2).to(dtype)
                 for n, p in self.segments]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A group of compatible leaves aggregated by one fused collective."""
    key: BucketKey
    slots: tuple
    size: int                   # total elements in the flat payload

    def gate(self):
        """The bucket's zero gate (from its codec), None when ungated."""
        return _codec(self.key.mode).bucket_gate(self)


@dataclasses.dataclass(frozen=True)
class UnfusedLeaf:
    """A leaf aggregated per leaf (its backend does not fuse)."""
    leaf: int
    name: str
    key: BucketKey
    size: int


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Leaf -> (bucket, offset) assignment for one (tree, policies) pair."""
    buckets: tuple              # tuple[Bucket]
    unfused: tuple              # tuple[UnfusedLeaf]
    num_leaves: int
    bucket_bytes: int

    @property
    def num_launches(self) -> int:
        """Collectives per aggregation pass: O(buckets), not O(leaves)."""
        return len(self.buckets) + len(self.unfused)

    def launches(self) -> Iterator[tuple]:
        """Yield ``(BucketKey, n_elements)`` per collective launch."""
        for b in self.buckets:
            yield b.key, b.size
        for u in self.unfused:
            yield u.key, u.size


def leaf_bucket_key(policy, dtype) -> BucketKey:
    """Compatibility key for one leaf under its resolved policy."""
    mode = canonical_mode(policy.mode)
    # only gated codecs read the gate phase; normalizing it for the others
    # keeps otherwise-compatible leaves in one bucket
    phase = int(policy.gate_phase) if _codec(mode).gated else 0
    spec = getattr(policy, "model_spec", None)
    return BucketKey(mode=mode,
                     schedule=wire_schedule(policy.mode, policy.schedule),
                     error_feedback=bool(policy.error_feedback),
                     gate_phase=phase,
                     model_spec=None if _trivial(spec) else tuple(spec),
                     dtype=dtype_name(dtype),
                     hops=getattr(_codec(mode), "hop_signature", None))


def plan_buckets(params_like: Any, policies: Any, *,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 fusable: Callable[[str], bool] | None = None) -> BucketLayout:
    """Group gradient leaves into fixed-budget flat buckets.

    Greedy first-fit in leaf order: a bucket closes when adding the next
    leaf would exceed ``bucket_bytes``; a leaf larger than the budget gets
    a bucket of its own.  Leaves whose wire schedule fails ``fusable``,
    or that are tensor-parallel (a ``model_spec``), stay on the per-leaf
    path as :class:`UnfusedLeaf`.
    """
    leaves = T.flatten(params_like)
    pol_leaves = T.leaves(policies)
    if len(pol_leaves) != len(leaves):
        raise ValueError(f"policy tree mismatch: {len(pol_leaves)} policies "
                         f"vs {len(leaves)} leaves")

    open_buckets: dict[BucketKey, list] = {}     # key -> [slots, elems]
    done: list[Bucket] = []
    unfused: list[UnfusedLeaf] = []

    def close(key):
        slots, elems = open_buckets.pop(key)
        done.append(Bucket(key=key, slots=tuple(slots), size=elems))

    for i, ((name, leaf), pol) in enumerate(zip(leaves, pol_leaves)):
        shape = tuple(leaf.shape)
        size = _numel(shape)
        key = leaf_bucket_key(pol, leaf.dtype)
        if key.model_spec is not None or (fusable is not None
                                          and not fusable(key.schedule)):
            unfused.append(UnfusedLeaf(leaf=i, name=name, key=key, size=size))
            continue
        budget = max(1, bucket_bytes // dtype_itemsize(leaf.dtype))
        if key in open_buckets and open_buckets[key][1] + size > budget:
            close(key)
        slots, elems = open_buckets.setdefault(key, [[], 0])
        slots.append(BucketSlot(leaf=i, name=name, shape=shape, size=size,
                                offset=elems))
        open_buckets[key][1] += size
    for key in list(open_buckets):
        close(key)
    # deterministic order: by first leaf index
    done.sort(key=lambda b: b.slots[0].leaf)
    return BucketLayout(buckets=tuple(done), unfused=tuple(unfused),
                        num_leaves=len(leaves), bucket_bytes=bucket_bytes)
