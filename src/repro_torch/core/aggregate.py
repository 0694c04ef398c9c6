"""Tree-level aggregation under an admission plan: the reference's free
functions (port of ``repro/core/aggregate.py``).

:class:`~repro_torch.fabric.Fabric` is the session that owns dispatch,
the bucket layouts and EF state; these are thin functions over the same
code.  :func:`init_ef_states` is the worker-local EF tree that
``Fabric.init_ef`` builds its rows from: EF-enabled leaves hold a
``(1, *shape)`` residual, the others a scalar 0 sentinel, so the tree's
structure stays the same across plans.

Where the reference takes ``dp_axes`` (the mesh axes of its
``shard_map``) these take the worker group, as ``Fabric(group=...)``
stands for ``Fabric(dp_axes=...)``; an ``int`` W is ``VirtualGroup(W)``.
The port's kernels have no interpret mode, so there is no ``interpret``
argument: a CPU tensor runs the kernels' plain twins, a CUDA tensor the
kernels.
"""
from __future__ import annotations

from typing import Any

import torch

from . import tree as T
from .buckets import AdmissionPlan, GroupRules, resolve_policies


def init_ef_states(params: Any, policies: Any,
                   dtype=torch.float32) -> Any:
    """Residual tree: zeros ``(1, *shape)`` where EF is on, scalar 0
    elsewhere, on each parameter's device."""
    def make(p, pol):
        shape = (1, *p.shape) if pol.error_feedback else ()
        return torch.zeros(shape, dtype=dtype, device=p.device)
    return T.map_leaves(make, params, policies)


def aggregate_gradients(grads: Any, policies: Any, group, num_workers: int,
                        ef_states: Any | None = None):
    """Aggregate a gradient tree (the group's local ranks on each leaf's
    leading axis) leaf by leaf under resolved policies, as
    ``Fabric(group=group, fused=False).aggregate`` does.  Returns
    ``(aggregates, new_ef_states)``."""
    from ..fabric.session import aggregate_tree
    from .lowbit import _group_context
    return aggregate_tree(_group_context(group, num_workers), grads,
                          policies, ef_states=ef_states)


def make_policy_tree(params: Any, plan: AdmissionPlan,
                     pspecs: Any | None = None,
                     rules: GroupRules | None = None) -> Any:
    """Params (+ partition specs) and a plan -> the LeafPolicy tree."""
    return resolve_policies(params, plan, pspecs=pspecs, rules=rules)
