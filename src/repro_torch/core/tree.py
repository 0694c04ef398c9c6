"""Nested parameter trees of dicts and lists, flattened in JAX's leaf order.

The reference keeps parameters and gradients as pytrees of dicts and
lists: ``jax.tree_util`` flattens a dict by its *sorted* keys and a list
in index order.  Bucket layouts depend on leaf order, so the port
flattens the same way here rather than in ``nn.Module`` registration
order.  A leaf is anything that is neither a dict nor a list; leaf names
are the '/'-joined key paths, a list entry named by its index
(``layers/attn/wq``, ``prefix/0/attn/wq``), as the reference's
``path_name`` writes them.
"""
from __future__ import annotations

from typing import Any, Callable


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Tree -> ``[(path, leaf), ...]`` in JAX's leaf order."""
    if isinstance(tree, dict):
        items = ((key, tree[key]) for key in sorted(tree))
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        path = f"{prefix}/{key}" if prefix else str(key)
        out.extend(flatten(sub, path))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def _lists(node: Any) -> Any:
    """Dicts keyed '0'..'n-1' (written by :func:`unflatten`) -> lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def unflatten(items) -> Any:
    """``[(path, leaf), ...]`` (or a path -> leaf dict) -> nested tree.

    A node whose keys are exactly the indices 0..n-1 comes back as a
    list, as :func:`flatten` names a list's entries."""
    pairs = items.items() if isinstance(items, dict) else items
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return _lists(out)


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure."""
    flat = flatten(tree)
    others = [dict(flatten(t)) for t in rest]
    return unflatten([(p, fn(x, *(o[p] for o in others))) for p, x in flat])
