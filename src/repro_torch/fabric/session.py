"""The Fabric session: one control surface over the aggregation fabric.

Port of ``repro/fabric/session.py``.  A :class:`Fabric` owns the worker
group, group assignment, policy resolution, error-feedback state,
schedule dispatch (by default through fused 32 MiB buckets, one
collective per bucket), the train step with its cosine diagnostics and
gradient accumulation, a cache of built steps keyed on the plan
signature, and the attached admission controller.

Gradients reach the session with the group's local ranks on their
leading axis — for the :class:`~repro_torch.core.collectives.VirtualGroup`
all W workers, ``(W, *shape)`` per leaf; for a process of a
:class:`~repro_torch.core.collectives.DistributedGroup` its one rank,
``(1, *shape)`` — and aggregates leave it replicated, ``(*shape)``.
Error-feedback trees hold one residual row per local rank where EF is on
and a scalar 0 sentinel elsewhere; the W rows of a virtual group are the
reference's global EF tree.

On a :class:`~repro_torch.core.collectives.ProcessMesh` with a model axis
above 1 (tensor parallelism) every leaf is this rank's block: the data
group aggregates it, policies carry the leaves' partition specs (a
tensor-parallel leaf stays off the buckets), and the step's norms and
cosines are the whole model's, summed over the model group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..core import spans
from ..core import tree as T
from ..core.aggregate import init_ef_states
from ..core.buckets import (DEFAULT_BUCKET_BYTES, AdmissionPlan,
                            BucketLayout, GroupRules, assign_groups,
                            dtype_name, group_sizes, plan_buckets,
                            resolve_policies)
from ..core.collectives import VirtualGroup
from ..core.diagnostics import group_cosines_from_mean
from ..core.lowbit import _ef_update
from ..core.modes import codec_name, wire_schedule
from ..optim.optimizers import _dp_entry
from .codecs import get_codec
from .registry import AggregationContext, get_schedule


# ---------------------------------------------------------------------------
# leaf- and tree-level aggregation (registry-dispatched)
# ---------------------------------------------------------------------------

def aggregate_leaf(ctx: AggregationContext, g: torch.Tensor, policy,
                   ef: torch.Tensor | None = None):
    """Aggregate one gradient leaf under its policy: ``(u, new_ef)``."""
    backend = get_schedule(wire_schedule(policy.mode, policy.schedule))
    return backend.aggregate(ctx, g, policy, ef)


def _leaf_uses_ef(pol, e) -> bool:
    """The policy flag, a real residual (not the sentinel), and a codec
    that consumes EF — the same gate on the per-leaf and fused paths."""
    return (pol.error_feedback and e is not None and e.dim() > 0
            and get_codec(pol.mode).threads_ef)


def _tree_parts(grads, policies, ef_states):
    g_items = T.flatten(grads)
    p_leaves = T.leaves(policies)
    e_leaves = ([None] * len(g_items) if ef_states is None
                else T.leaves(ef_states))
    if not len(p_leaves) == len(e_leaves) == len(g_items):
        raise ValueError("gradient, policy and EF trees disagree")
    return g_items, p_leaves, e_leaves


def aggregate_tree(ctx: AggregationContext, grads: Any, policies: Any,
                   ef_states: Any | None = None):
    """Aggregate a gradient tree leaf by leaf: ``(aggregates, new_ef)``."""
    g_items, p_leaves, e_leaves = _tree_parts(grads, policies, ef_states)
    agg, new_ef = [], []
    for (path, g), pol, e in zip(g_items, p_leaves, e_leaves):
        use_ef = _leaf_uses_ef(pol, e)
        u, ef_out = aggregate_leaf(ctx, g, pol, ef=e if use_ef else None)
        agg.append((path, u))
        new_ef.append((path, ef_out if use_ef else e))
    if ef_states is None:
        return T.unflatten(agg), None
    return T.unflatten(agg), T.unflatten(new_ef)


# ---------------------------------------------------------------------------
# bucketed (fused) tree aggregation
# ---------------------------------------------------------------------------

def _registry_fusable(schedule: str) -> bool:
    """Layout-planner predicate: does this wire schedule's backend fuse?"""
    try:
        return bool(getattr(get_schedule(schedule), "fusable", False))
    except KeyError:
        return False        # the per-leaf path raises the registry error


def _codec_kernel_sig(mode) -> str | None:
    """A mode's kernel-set signature; None when it brings no kernels (or
    is not registered: the dispatch raises the real error)."""
    try:
        codec = get_codec(mode)
    except KeyError:
        return None
    hook = getattr(codec, "kernel_signature", None)
    return hook() if hook is not None else None


def plan_modes(plan: AdmissionPlan) -> set:
    """Every codec mode an admission plan can route a leaf to."""
    return {pol.mode for _, pol in plan.policies} | {plan.default.mode}


def layout_kernel_stats(layout: BucketLayout, num_workers: int) -> dict:
    """Modeled kernel-launch and device-memory accounting for one layout.

    Sums over every collective launch the launches and modeled bytes of
    the launch codec's :class:`~repro_torch.kernels.fused.KernelSet`
    under the fused and the staged chain: vote sets on ``packed_a2a``,
    mean sets on ``psum`` (which never thread EF in a kernel).  A
    hierarchical route counts each hop at that hop's group size.  Other
    launches count under ``unkernelized``.
    """
    stats = {"launches_fused": 0, "launches_unfused": 0,
             "hbm_bytes_fused": 0.0, "hbm_bytes_unfused": 0.0,
             "collectives": 0, "unkernelized": 0}

    def add(ks, schedule, n, w, ef):
        if ks is not None and ks.means and schedule == "psum":
            ef = False
        elif ks is None or not (ks.votes and schedule == "packed_a2a"):
            stats["unkernelized"] += 1
            return
        for path, fused in (("fused", True), ("unfused", False)):
            stats[f"launches_{path}"] += ks.launches(
                fused=fused, distributed=w > 1, ef=ef)
            stats[f"hbm_bytes_{path}"] += ks.hbm_bytes(
                n, num_workers=w, fused=fused, distributed=w > 1, ef=ef)

    for key, n in layout.launches():
        stats["collectives"] += 1
        try:
            codec = get_codec(key.mode)
        except KeyError:
            stats["unkernelized"] += 1
            continue
        if codec.reduction == "hierarchical":
            sizes = codec.plan.group_sizes(num_workers)
            for hop, w in zip(codec.plan.hops, sizes):
                c = get_codec(hop.codec)
                add(c.kernel_set(),
                    wire_schedule(hop.codec,
                                  hop.schedule or c.default_schedule),
                    n, w, key.error_feedback and c.threads_ef)
        else:
            add(codec.kernel_set(), key.schedule, n, num_workers,
                key.error_feedback and codec.threads_ef)
    return stats


def aggregate_tree_bucketed(ctx: AggregationContext, grads: Any,
                            policies: Any, ef_states: Any | None = None, *,
                            layout: BucketLayout | None = None,
                            bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Aggregate a gradient tree through fused flat buckets.

    Bit-identical to :func:`aggregate_tree` but one collective per bucket:
    compatible leaves are flattened and concatenated per worker, the
    backend's ``aggregate_flat`` runs on the bucket, and results are cut
    back to leaf shapes.  Error feedback is injected (``g + e``) and
    updated (``beta = mean|g_eff|`` is a per-leaf statistic) per leaf
    around the fused collective.
    """
    g_items, p_leaves, e_leaves = _tree_parts(grads, policies, ef_states)
    if layout is None:
        layout = plan_buckets(_per_worker_like(grads), policies,
                              bucket_bytes=bucket_bytes,
                              fusable=_registry_fusable)
    if layout.num_leaves != len(g_items):
        raise ValueError(f"bucket layout planned for {layout.num_leaves} "
                         f"leaves applied to a {len(g_items)}-leaf tree")
    g_leaves = [g for _, g in g_items]
    agg: list = [None] * len(g_items)
    new_ef = list(e_leaves)

    for uf in layout.unfused:
        g, pol, e = g_leaves[uf.leaf], p_leaves[uf.leaf], e_leaves[uf.leaf]
        use_ef = _leaf_uses_ef(pol, e)
        u, ef_out = aggregate_leaf(ctx, g, pol, ef=e if use_ef else None)
        agg[uf.leaf] = u
        if use_ef:
            new_ef[uf.leaf] = ef_out

    for bucket in layout.buckets:
        backend = get_schedule(bucket.key.schedule)
        codec = get_codec(bucket.key.mode)
        threads_ef = getattr(backend, "threads_ef", False) and codec.threads_ef
        flats, g_effs = [], {}
        for slot in bucket.slots:
            g = g_leaves[slot.leaf]
            g = g.reshape(g.shape[0], -1)
            e, pol = e_leaves[slot.leaf], p_leaves[slot.leaf]
            if threads_ef and pol.error_feedback and e is not None \
                    and e.dim() > 0:
                g = g + e.reshape(e.shape[0], -1).to(g.dtype)
                g_effs[slot.leaf] = g
            flats.append(g)
        flat = flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)
        u_flat = backend.aggregate_flat(ctx, flat, codec, gate=bucket.gate())
        for slot in bucket.slots:
            agg[slot.leaf] = u_flat[slot.offset:slot.offset + slot.size] \
                .reshape(slot.shape)
            if slot.leaf in g_effs:
                g_eff = g_effs[slot.leaf]
                new_ef[slot.leaf] = _ef_update(
                    g_eff.reshape(g_eff.shape[:1] + slot.shape),
                    e_leaves[slot.leaf])

    paths = [p for p, _ in g_items]
    aggregates = T.unflatten(list(zip(paths, agg)))
    if ef_states is None:
        return aggregates, None
    return aggregates, T.unflatten(list(zip(paths, new_ef)))


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Shape and dtype of one leaf (what the layout planner reads)."""
    shape: tuple
    dtype: Any


def _per_worker_like(grads: Any) -> dict:
    """Stacked (W, *shape) gradients -> per-worker leaf specs."""
    return T.map_leaves(lambda g: LeafSpec(tuple(g.shape[1:]), g.dtype),
                        grads)


# ---------------------------------------------------------------------------
# train state and the session
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    model: Any                 # the model; its parameters are updated in place
    opt: Any                   # optimizer state (moments updated in place)
    ef: Any                    # error-feedback residuals (sentinel tree)
    step: int = 0


class CompiledStep(NamedTuple):
    """One built train step and its I/O contracts, the reference's
    ``(jitted, state_shardings, batch_sharding, aux)``.

    ``step_fn(state, batch)`` is the port's step, returning ``(state,
    metrics, aggregates)``; calling the tuple returns the reference's
    ``(state, metrics)``, so code that unpacks two values runs as it
    is.  ``state_shardings`` is a :class:`TrainState` of partition specs
    (tuples, :mod:`repro_torch.runtime.shardings`) and
    ``batch_sharding`` the batch's spec, what the reference's
    ``NamedSharding``s hold; ``aux`` carries the reference's keys.
    """
    step_fn: Callable
    state_shardings: Any
    batch_sharding: Any
    aux: dict

    def __call__(self, state, batch):
        state, metrics, _ = self.step_fn(state, batch)
        return state, metrics


def dp_num_workers(mesh, dp_axes) -> int:
    """The data-parallel worker count of a
    :class:`~repro_torch.core.collectives.ProcessMesh`: the product of
    the extents of ``dp_axes`` (a name or a sequence of names)."""
    axes = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)
    return math.prod(int(mesh.extents[a]) for a in axes)


def _group_extents(group) -> tuple:
    """The extents of a worker group's data-parallel axes, outermost
    first: none for the host-local group, a virtual group's shape, a
    distributed group's size (or its axis groups' sizes)."""
    if getattr(group, "host_local", False):
        return ()
    if isinstance(group, VirtualGroup):
        return group.shape
    axes = getattr(group, "axis_groups", None)
    return tuple(g.size for g in axes) if axes else (group.size,)


class Fabric:
    """Aggregation-fabric session over one worker group.

    ``Fabric(num_workers=W)`` runs W virtual data-parallel workers on one
    device (the reference's ``Fabric(dp_axes=("w",), num_workers=W)``
    under ``vmap``).  ``Fabric(group=DistributedGroup(device=...))`` runs
    one rank per process over ``torch.distributed`` (the reference's
    ``shard_map`` over its mesh's data axes): each process computes its
    own shard's gradients and holds its own EF rows, and the aggregates
    are the virtual group's bits (FP32 means to the summation order).
    ``Fabric(group=LocalGroup())`` is the host-local
    session of one worker (the reference's ``Fabric()``, no
    data-parallel axes): gradients keep a leading axis of one, every
    collective is the identity, and a packed vote bucket or leaf is one
    ``vote_pipeline`` launch.  ``fused=False`` aggregates leaf by leaf
    instead of through 32 MiB buckets; a packed leaf with error feedback
    then runs EF inside the kernels (``encode_pack_ef``,
    ``ef_residual_plane``).
    ``fused_kernels=False`` pins the staged four-kernel chain
    (``sign_pack``, ``popcount_stack``, ``majority_decode``,
    ``unpack_ternary``) in place of the vote codecs' fused kernel sets:
    the reference's A/B check, with the same bits.  The mean codecs
    (``int4``, ``topk``) have no staged kernels and run their kernel
    sets either way.  ``Fabric(mesh=ProcessMesh(...))`` aggregates over
    the mesh's data group, and ``Fabric(mesh=VirtualMesh((W, 1)))`` over
    W virtual workers with the same layouts.  The partition specs passed
    as ``pspecs=`` reach the policies, as on the reference's session, so
    a leaf specced over ``"model"`` keeps a launch of its own at any
    model extent; a worker group used directly has no specs from its
    callers and buckets every leaf.
    A hop plan (:mod:`repro_torch.fabric.hierarchy`) of more than one hop
    needs a group with one data axis a hop:
    ``Fabric(group=VirtualGroup((outer, inner)))`` (the reference's
    ``Fabric(dp_axes=("outer", "inner"))`` under nested ``vmap``) or a
    ``(pod, data, model)`` mesh.
    """

    def __init__(self, num_workers: int | None = None, *, group=None,
                 mesh=None, rules: GroupRules | None = None,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 fused: bool = True, fused_kernels: bool = True):
        if mesh is not None:
            if group is not None and group is not mesh.data_group:
                raise ValueError("a session on a mesh aggregates over the "
                                 "mesh's data group")
            group = mesh.data_group
        if group is None:
            group = VirtualGroup(1 if num_workers is None else num_workers)
        elif num_workers is not None and num_workers != group.size:
            raise ValueError(f"num_workers={num_workers} disagrees with "
                             f"the group's {group.size} workers")
        self.group = group
        self.mesh = mesh
        self.num_workers = self.group.size
        self.rules = rules or GroupRules()
        self.bucket_bytes = int(bucket_bytes)
        self.fused = bool(fused)
        self.fused_kernels = bool(fused_kernels)
        self.membership_epoch = 0        # bumped by bind_membership
        self.controller = None           # the attached admission controller
        self._steps: dict[tuple, Callable] = {}
        self._layouts: dict[tuple, BucketLayout] = {}

    # -- elastic membership ---------------------------------------------

    def bind_membership(self, view) -> None:
        """Bind the session to an epoch-numbered worker view (anything
        with ``num_workers`` and ``epoch``, such as
        :class:`repro_torch.elastic.WorkerView`).

        A session of virtual workers rebuilds its one-axis group at the
        view's W; the epoch goes into :meth:`step_for`'s key, so a step
        built for an earlier view is never served after a re-plan, even
        at the same W.  A process group or mesh fixes W when it is made:
        binding another W raises, as on the reference's mesh session.
        """
        w, epoch = int(view.num_workers), int(view.epoch)
        if w != self.group.size:
            if type(self.group) is not VirtualGroup \
                    or len(self.group.shape) > 1 or self.mesh is not None:
                raise ValueError(
                    f"cannot bind a {w}-worker view: {self.group!r} fixes "
                    f"the data-parallel extent at {self.group.size}")
            self.group = VirtualGroup(w)
        self.num_workers = w
        self.membership_epoch = epoch

    # -- admission controller -------------------------------------------

    def attach_controller(self, controller, **kwargs):
        """Attach an admission controller: an instance, or a registered
        name with ``kwargs`` for its factory (``attach_controller("paper",
        warmup_steps=50)``).  A Trainer built on this session picks it
        up.  Returns the controller."""
        from .control import make_controller
        if isinstance(controller, str):
            controller = make_controller(controller, **kwargs)
        elif kwargs:
            raise TypeError("factory kwargs are only valid when attaching "
                            "a controller by registered name")
        self.controller = controller
        return controller

    @property
    def tensor_parallel(self) -> bool:
        """Is this a session on a mesh with a model axis above 1?"""
        return self.mesh is not None and self.mesh.model_size > 1

    @property
    def dp_axes(self) -> tuple:
        """The data axes, as the reference's ``Fabric(mesh, dp_axes)``
        names them: the mesh's own, else ``()`` for the host-local group,
        ``("data",)`` for a group of one axis and ``("pod", "data")`` for
        two.  Only partition specs read them (:meth:`ef_specs`,
        :func:`repro_torch.runtime.build_train_step`)."""
        if self.mesh is not None:
            return self.mesh.data_axes
        n = len(_group_extents(self.group))
        if n > 2:
            raise ValueError(f"{self.group!r} has {n} data axes; partition "
                             f"specs name at most two")
        return ("pod", "data")[2 - n:]

    @property
    def context(self) -> AggregationContext:
        return AggregationContext(
            group=self.group, num_workers=self.num_workers,
            fused_kernels=self.fused_kernels, mesh=self.mesh)

    def resolve(self, params_like: Any, plan: AdmissionPlan,
                pspecs: Any | None = None) -> dict:
        """Params tree (+ the sanitized partition specs) -> LeafPolicy
        tree."""
        return resolve_policies(params_like, plan, pspecs=pspecs,
                                rules=self.rules)

    def group_sizes(self, params_like: Any) -> dict[str, int]:
        return group_sizes(params_like, self.rules)

    def groups(self, params_like: Any) -> dict:
        """Params tree -> tree of group names."""
        return assign_groups(params_like, self.rules)

    def init_ef(self, params: Any, policies: Any,
                dtype=torch.float32) -> dict:
        """EF tree: ``(L, *shape)`` zeros where EF is on, scalar 0 else,
        one row for each of the group's L local ranks (all W workers of
        a :class:`VirtualGroup`, this process's one rank of a
        :class:`~repro_torch.core.collectives.DistributedGroup`): the
        worker-local :func:`~repro_torch.core.aggregate.init_ef_states`
        tree, a row for each."""
        local = len(self.group.rank())
        return T.map_leaves(
            lambda e: e.expand(local, *e.shape[1:]).contiguous()
            if e.dim() else e, init_ef_states(params, policies, dtype))

    def ef_specs(self, policies: Any, pspecs: Any) -> dict:
        """The EF tree's partition specs: the data axes (one axis as its
        name) followed by the leaf's spec where EF is on, ``()``
        elsewhere; the one implementation, for the legacy step's
        ``state_shardings`` and for spec construction elsewhere."""
        dp = _dp_entry(self.dp_axes)
        return T.unflatten([
            (path, (dp, *(spec or ())) if pol.error_feedback else ())
            for (path, pol), spec in zip(T.flatten(policies),
                                         T.leaves(pspecs))])

    def layout_for(self, params_like: Any, plan: AdmissionPlan | Any,
                   pspecs: Any | None = None) -> BucketLayout:
        """Bucket layout for a (tree, plan) pair, cached: it is a pure
        function of leaf order/shapes/dtypes, policies and bucket_bytes,
        and of which backends fuse and the codecs' layout attributes
        (reduction, gate, hop route, kernels), so a backend or codec
        registered anew under the same name is not served a stale
        layout."""
        policies = (self.resolve(params_like, plan, pspecs)
                    if isinstance(plan, AdmissionPlan) else plan)
        pol_leaves = tuple(T.leaves(policies))
        wires = {wire_schedule(p.mode, p.schedule) for p in pol_leaves}
        modes = {codec_name(p.mode) for p in pol_leaves}
        codec_sig = tuple(sorted(
            (m, get_codec(m).reduction, bool(get_codec(m).gated),
             getattr(get_codec(m), "hop_signature", None),
             _codec_kernel_sig(m)) for m in modes))
        key = (tuple((p, tuple(x.shape), dtype_name(x.dtype))
                     for p, x in T.flatten(params_like)),
               pol_leaves, self.bucket_bytes,
               tuple(sorted((w, _registry_fusable(w)) for w in wires)),
               codec_sig)
        if key not in self._layouts:
            self._layouts[key] = plan_buckets(
                params_like, policies, bucket_bytes=self.bucket_bytes,
                fusable=_registry_fusable)
        return self._layouts[key]

    def aggregate(self, grads: Any, plan: AdmissionPlan | Any,
                  ef: Any | None = None, *, pspecs: Any | None = None,
                  fused: bool | None = None):
        """Aggregate per-worker gradients (``(W, *shape)`` leaves) under a
        plan (resolved with ``pspecs``, see :meth:`resolve`) or a resolved
        policy tree: ``(aggregates, new_ef)``.  ``fused`` (default: the
        session's flag) picks the buckets or the per-leaf path."""
        like = _per_worker_like(grads)
        policies = (self.resolve(like, plan, pspecs)
                    if isinstance(plan, AdmissionPlan) else plan)
        if self.fused if fused is None else fused:
            return aggregate_tree_bucketed(
                self.context, grads, policies, ef_states=ef,
                layout=self.layout_for(like, policies))
        return aggregate_tree(self.context, grads, policies, ef_states=ef)

    # -- simulation -----------------------------------------------------

    def simulate(self, params_like: Any, plan: AdmissionPlan | Any, *,
                 pspecs: Any | None = None, topology: Any = "ici_ring",
                 datapath: Any | None = None,
                 overlap_fraction: float = 1.0,
                 compute_time_s: float = 0.0,
                 ready_times: Sequence[float] | None = None,
                 **topology_kwargs):
        """Simulate one aggregation pass of this session's layout.

        Replays the cached bucket layout of ``(params_like, plan)``
        through the :mod:`repro_torch.sim` discrete-event simulator on a
        registered topology (``"cxl_direct"``, ``"cxl_switched"``,
        ``"ici_ring"``, ``"multihop"`` or a ``@register_topology``
        entry), at this session's worker count.  ``compute_time_s`` is
        the backward pass the collectives overlap; ``datapath`` defaults
        to the paper's 5-stage 512-bit
        :class:`~repro_torch.sim.FlitPipeline`.  The times are the
        model's, under the reference's constants, not measurements.
        Returns a :class:`~repro_torch.sim.SimReport`.
        """
        from ..sim import simulate_layout
        layout = self.layout_for(params_like, plan, pspecs=pspecs)
        return simulate_layout(layout, self.num_workers, topology=topology,
                               datapath=datapath,
                               overlap_fraction=overlap_fraction,
                               compute_time_s=compute_time_s,
                               ready_times=ready_times, **topology_kwargs)

    # -- plan autotuning ------------------------------------------------

    def autotune(self, params_like: Any, space: Any | None = None, *,
                 topology: str = "ici_ring", strategy: Any = "grid",
                 shortlist: int = 8, objective: Any | None = None,
                 compute_time_s: float = 0.0,
                 overlap_fraction: float = 1.0,
                 pspecs: Any | None = None, name: str | None = None,
                 error_feedback: bool = False, **topology_kwargs):
        """Search a plan space for this session's best configuration.

        The session's entry point over :func:`repro_torch.tune.autotune`
        (imported here, so the fabric does not depend on the tuner at
        import).  ``params_like`` may be ``meta`` tensors
        (``init_params(cfg, device="meta")``); ``space`` defaults to
        :func:`repro_torch.tune.default_space` (every preset and the
        generated low-bit axes, the classifier head pinned to FP32).
        Returns a :class:`repro_torch.tune.TunedPlan`: ``tuned.apply(self)``
        adopts its bucket budget, ``tuned.install()`` registers it as a
        named preset.  Its prices are the reference's models, not
        measurements.
        """
        from ..tune import autotune as _autotune
        return _autotune(self, params_like, space, topology=topology,
                         strategy=strategy, shortlist=shortlist,
                         objective=objective,
                         compute_time_s=compute_time_s,
                         overlap_fraction=overlap_fraction, pspecs=pspecs,
                         name=name, error_feedback=error_feedback,
                         **topology_kwargs)

    # -- step builder ---------------------------------------------------

    def worker_grads(self, params: dict, batch: dict,
                     loss: Callable[[dict, dict], torch.Tensor],
                     grad_accum: int = 1):
        """Each local rank's gradients on its shard of the global batch.

        Rank ``r`` of W takes rows ``[r * b / W, (r + 1) * b / W)`` of
        the global batch of ``b`` rows, as the reference's ``P(dp)``
        batch sharding lays it out; the group's local ranks
        (``group.rank()``) are computed here, all W for a
        :class:`VirtualGroup`, one for a process of a distributed group.
        Returns ``(grads, loss)``: a tree of ``(L, *shape)`` gradients,
        one row per local rank, and the loss averaged over all W ranks.
        With ``grad_accum > 1`` each
        shard is cut into that many microbatches whose gradients sum in
        float32 and are divided by ``grad_accum``, as is their loss: the
        gradients stay float32 whatever the parameters' dtype, as in the
        reference.
        """
        ranks = self.group.rank()
        shards = _split_batch(batch, self.num_workers)
        items = T.flatten(params)
        leaves = [p for _, p in items]
        accum = grad_accum > 1
        grads = [torch.zeros((len(ranks), *p.shape), dtype=torch.float32,
                             device=p.device) if accum else
                 torch.empty((len(ranks), *p.shape), dtype=p.dtype,
                             device=p.device)
                 for p in leaves]
        losses = []
        for k, shard in enumerate(shards[r] for r in ranks):
            if not accum:
                lval, gs = _loss_and_grads(loss, params, shard, leaves)
                with spans.span("fabric.grad_stack"):
                    for buf, g in zip(grads, gs):
                        buf[k].copy_(g)
                del gs          # a model's worth, gone before the next worker
                losses.append(lval.detach())
                continue
            lacc = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(shard, grad_accum):
                lval, gs = _loss_and_grads(loss, params, mb, leaves)
                with spans.span("fabric.grad_stack"):
                    for buf, g in zip(grads, gs):
                        buf[k].add_(g.to(torch.float32))
                del gs
                lacc = lacc + lval.detach()
            with spans.span("fabric.grad_stack"):
                for buf in grads:
                    buf[k].div_(grad_accum)
            losses.append(lacc / grad_accum)
        gtree = T.unflatten([(p, g) for (p, _), g in zip(items, grads)])
        return gtree, self.group.all_reduce_mean(torch.stack(losses))

    def _shards(self, params_like: Any, policies: Any) -> list | None:
        """The ShardView of each tensor-parallel leaf (None for the
        others), or None off a tensor-parallel session."""
        if not self.tensor_parallel:
            return None
        return [None if pol.model_spec is None else
                self.mesh.shard_view(pol.model_spec, tuple(x.shape))
                for x, pol in zip(T.leaves(params_like), T.leaves(policies))]

    def _norm(self, agg: Any, shards: list | None) -> torch.Tensor:
        """The aggregate's L2 norm over the whole model: a block's sum of
        squares added over the model group, a replicated leaf once."""
        sq = [torch.sum(x.to(torch.float32) ** 2) for x in T.leaves(agg)]
        if shards is None:
            return torch.sqrt(sum(sq))
        rep = sum(x for x, sh in zip(sq, shards) if sh is None)
        blocks = sum(x for x, sh in zip(sq, shards) if sh is not None)
        if isinstance(blocks, torch.Tensor):
            rep = rep + self.mesh.model_group.all_reduce(blocks)
        return torch.sqrt(rep)

    def build_step(self, optimizer, plan: AdmissionPlan, params_like: Any,
                   loss: Callable[[dict, dict], torch.Tensor], *,
                   with_diagnostics: bool = False,
                   grad_accum: int = 1, pspecs: Any | None = None,
                   zero=None, fused: bool | None = None) -> Callable:
        """One data-parallel train step under ``plan``.

        The step computes each virtual worker's loss and gradients on its
        shard of the batch (``loss(params, batch)``), aggregates them
        through the bucket layout (planned on ``params_like``), and
        applies the optimizer once to the one replicated parameter copy.
        The loss is the mean over workers, as ``pmean`` gives.
        ``grad_accum`` cuts each shard into that many microbatches (see
        :meth:`worker_grads`); a step still runs one aggregation.
        ``with_diagnostics`` adds the per-group cosines of the aggregate
        (``metrics["cos/{group}/gbinary"]`` and ``.../gternary``).
        On a tensor-parallel session ``params_like`` holds this rank's
        blocks and ``pspecs`` the sanitized specs of the whole leaves;
        ``zero`` (a :class:`~repro_torch.optim.Zero1`) partitions the
        optimizer's moments over the data group.  ``fused`` (default: the
        session's flag) aggregates through the buckets or leaf by leaf.
        ``plan`` may also be a resolved policy tree.
        Returns ``step(state, batch) -> (state, metrics, aggregates)``.
        """
        policies = (self.resolve(params_like, plan, pspecs)
                    if isinstance(plan, AdmissionPlan) else plan)
        use_fused = self.fused if fused is None else fused
        layout = self.layout_for(params_like, policies) if use_fused else None
        groups = self.groups(params_like)
        shards = self._shards(params_like, policies)
        ctx = self.context

        def step(state: TrainState, batch: dict):
            params = state.model.tree()
            gtree, lval = self.worker_grads(params, batch, loss, grad_accum)
            with spans.span("fabric.aggregate"):
                if layout is not None:
                    agg, new_ef = aggregate_tree_bucketed(
                        ctx, gtree, policies, ef_states=state.ef,
                        layout=layout)
                else:
                    agg, new_ef = aggregate_tree(ctx, gtree, policies,
                                                 ef_states=state.ef)
            del gtree
            metrics = {"loss": lval}
            with spans.span("fabric.agg_norm"):
                if with_diagnostics:
                    cos = group_cosines_from_mean(agg, groups, shards=shards)
                    for g, d in sorted(cos.items()):
                        metrics[f"cos/{g}/gbinary"] = d["gbinary"]
                        metrics[f"cos/{g}/gternary"] = d["gternary"]
                metrics["agg_norm"] = self._norm(agg, shards)
            with torch.no_grad(), spans.span("optim.apply"):
                opt = (optimizer.apply(params, agg, state.opt)
                       if zero is None else
                       optimizer.apply(params, agg, state.opt, zero=zero))
            return (TrainState(model=state.model, opt=opt, ef=new_ef,
                               step=state.step + 1), metrics, agg)

        step.layout = layout
        step.policies = policies
        return step

    def step_for(self, optimizer, plan: AdmissionPlan, params_like: Any,
                 loss: Callable[[dict, dict], torch.Tensor], *,
                 with_diagnostics: bool = False,
                 grad_accum: int = 1, pspecs: Any | None = None,
                 zero=None, fused: bool | None = None) -> Callable:
        """Cached :meth:`build_step`: one built step per plan signature
        (the controller's mode latch), keyed as the reference keys its
        compiled steps, also on the optimizer and the loss, the ``fused``
        switch (this call's, else the session's) and the session's
        ``fused_kernels``, the kernel signatures of the plan's codecs,
        the worker count and membership epoch, the partition specs and
        the ZeRO-1 partition."""
        use_fused = self.fused if fused is None else fused
        kern_sig = tuple(sorted(
            (codec_name(m), _codec_kernel_sig(m)) for m in plan_modes(plan)))
        specs = None if pspecs is None else tuple(T.flatten(pspecs))
        key = (plan.signature(), with_diagnostics, grad_accum, optimizer,
               loss, use_fused, self.fused_kernels, kern_sig,
               self.num_workers, self.membership_epoch, specs, zero)
        if key not in self._steps:
            self._steps[key] = self.build_step(
                optimizer, plan, params_like, loss,
                with_diagnostics=with_diagnostics, grad_accum=grad_accum,
                pspecs=pspecs, zero=zero, fused=use_fused)
        return self._steps[key]

    def clear_cache(self) -> None:
        self._steps.clear()
        self._layouts.clear()

    def __repr__(self) -> str:
        return (f"Fabric(num_workers={self.num_workers}, "
                f"group={self.group!r}, "
                f"mesh={'set' if self.mesh is not None else None})")


def _split_microbatches(batch: dict, grad_accum: int) -> list[dict]:
    """One worker's shard cut into ``grad_accum`` equal microbatches.

    Raises when the shard does not divide: a silent cut would drop its
    trailing samples.
    """
    for x in batch.values():
        if x.shape[0] % grad_accum:
            raise ValueError(
                f"grad_accum={grad_accum} must divide the per-device batch "
                f"size, but got a batch leaf of shape {tuple(x.shape)} "
                f"({x.shape[0]} % {grad_accum} = {x.shape[0] % grad_accum}); "
                f"trailing samples would be silently dropped")
    n = next(iter(batch.values())).shape[0] // grad_accum
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(grad_accum)]


def _loss_and_grads(loss: Callable, params: dict, batch: dict,
                    leaves: list) -> tuple:
    """One worker's loss on ``batch`` and its gradients for every leaf,
    under the recorder's ``fabric.forward`` and ``fabric.backward``
    spans."""
    with spans.span("fabric.forward"):
        lval = loss(params, batch)
    with spans.span("fabric.backward"):
        return lval, _grad(lval, leaves)


def _grad(lval: torch.Tensor, leaves: list) -> tuple:
    """Gradients of ``lval`` for every leaf, zeros for a leaf the loss does
    not reach (a VLM's patch projector on a batch of tokens only), as
    ``jax.grad`` gives them."""
    return torch.autograd.grad(lval, leaves, allow_unused=True,
                               materialize_grads=True)


def _split_batch(batch: dict, w: int) -> list[dict]:
    """The global batch cut into W equal worker shards along dim 0."""
    b = next(iter(batch.values())).shape[0]
    if b % w:
        raise ValueError(f"global batch {b} does not split evenly over "
                         f"{w} workers")
    n = b // w
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(w)]

