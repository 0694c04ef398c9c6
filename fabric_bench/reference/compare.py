"""The numbers that decide ``correct``, and their limits.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: over the leaves, the largest gap between the two norms
  of the first aggregate, as a share of the reference's norm of that
  leaf or of the median leaf, whichever is larger.
- ``update_gap``: the same for each leaf's change after the steps,
  leaving out the leaves whose raw gradient in the reference is under a
  thousandth of the median leaf's (nought to rounding, such as a key's
  bias under softmax: the vote moves them by round-off alone).
- ``vote_gap``, where the mix votes: the share of the voted elements,
  over all voted leaves, whose vote in the first aggregate differs from
  the reference's.  A norm is blind to which way a vote points; this
  is not.
"""
from __future__ import annotations

import statistics

#: a leaf's raw gradient under this share of the median leaf's is nought
NOUGHT = 1e-3


def _worst(prog: dict, ref: dict, keep) -> tuple[float, str]:
    if set(prog) != set(ref):
        raise ValueError(f"the two runs' leaves differ: "
                         f"{sorted(set(prog) ^ set(ref))[:5]}")
    keys = [p for p in ref if p in keep]
    med = statistics.median(ref[p] for p in keys)
    gaps = {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in keys}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def numbers(prog, ref) -> dict:
    """name -> (value, where it was read: the steps or the worst leaf)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog.losses, ref.losses))
    med = statistics.median(ref.raw_norms.values())
    moved = {p for p, n in ref.raw_norms.items() if n >= NOUGHT * med}
    grad, grad_leaf = _worst(prog.grad_norms, ref.grad_norms,
                             set(ref.grad_norms))
    upd, upd_leaf = _worst(prog.change_norms, ref.change_norms, moved)
    out = {"loss_gap": (loss, f"steps 0-{len(ref.losses) - 1}"),
           "grad_gap": (grad, grad_leaf),
           "update_gap": (upd, upd_leaf)}
    if ref.votes:
        if set(prog.votes) != set(ref.votes):
            raise ValueError("the two runs voted different leaves")
        differ = sum(int((prog.votes[p] != v).sum())
                     for p, v in ref.votes.items())
        total = sum(v.numel() for v in ref.votes.values())
        out["vote_gap"] = (differ / total, f"{len(ref.votes)} voted leaves")
    return out


def judge(nums: dict, limits: dict | None) -> tuple[bool, dict]:
    """``correct`` and, for each number compared, its value beside its
    limit.  A cell's limits file names, under ``not_compared``, the
    numbers it does not compare (no reading of the control or of a fault
    separates them from sound runs); any other number with no limit, or
    one that is not finite, fails."""
    checks, ok = {}, True
    skip = (limits or {}).get("not_compared", {})
    for name, (value, _) in nums.items():
        if name in skip:
            continue
        limit = (limits or {}).get(name)
        passed = limit is not None and value == value and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
