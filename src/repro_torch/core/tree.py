"""Nested-dict parameter trees, flattened in JAX's leaf order.

The reference keeps parameters and gradients as pytrees of dicts, and
``jax.tree_util`` flattens a dict by its *sorted* keys.  Bucket layouts
depend on leaf order, so the port flattens the same way here rather than
in ``nn.Module`` registration order.  A leaf is anything that is not a
dict; leaf names are the '/'-joined key paths (``layers/attn/wq``).
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Tree -> ``[(path, leaf), ...]`` in JAX's leaf order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        out.extend(flatten(tree[key], path))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(items) -> dict:
    """``[(path, leaf), ...]`` (or a path -> leaf dict) -> nested dict."""
    pairs = items.items() if isinstance(items, dict) else items
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    flat = flatten(tree)
    others = [dict(flatten(t)) for t in rest]
    return unflatten([(p, fn(x, *(o[p] for o in others))) for p, x in flat])
