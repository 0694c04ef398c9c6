"""Search-strategy registry: how the candidate space is explored.

Port of ``repro/tune/search.py``; ``random`` draws with Python's
``random.Random(seed)``, as the reference does, so the sample is the same.

The seventh registry — same :class:`repro_torch.core.registry.Registry`
backbone, same extension idiom as schedules / codecs / controllers /
topologies / serve policies / faults: strategies register under a
string name and ``fabric.autotune(..., strategy="successive_halving")``
addresses them without touching the tuner.

A strategy turns ``(candidates, cost model, objective)`` into a list of
:class:`ScoredCandidate` — every candidate it visited, the shortlist it
chose to certify carrying a full :class:`~repro_torch.tune.cost.SimScore`,
the rest carrying only the analytic :class:`~repro_torch.tune.cost
.CostEstimate`.  One invariant is shared by every built-in and expected
of extensions: **seed candidates are always sim-scored**.  Seeds are
the preset baselines the tuned plan claims to beat; pruning one on the
cheap estimate would turn "never slower than the best preset it
searched over" into a hope instead of a property.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Protocol, Sequence, runtime_checkable

from ..core.registry import Registry
from .cost import CostEstimate, CostModel, Objective, SimScore
from .space import Candidate

__all__ = [
    "GridSearch", "RandomSearch", "ScoredCandidate", "SearchStrategy",
    "SuccessiveHalving", "available_searches", "get_search", "make_search",
    "register_search", "unregister_search",
]


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    """One visited candidate with whatever fidelity it reached.

    ``score``/``objective`` are None for candidates pruned on the
    analytic estimate; ``estimate_objective`` is always present (the
    pruning-fidelity scalar, comparable only to other estimates).
    """
    candidate: Candidate
    cost: CostEstimate
    score: SimScore | None = None
    objective: float | None = None
    estimate_objective: float = math.inf


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@runtime_checkable
class SearchStrategy(Protocol):
    """Protocol every registered strategy implements."""

    name: str

    def search(self, candidates: Sequence[Candidate], model: CostModel,
               objective: Objective, *,
               shortlist: int = 8) -> list[ScoredCandidate]: ...


#: strategies are stateless-per-run but construction-parametric
#: (``random`` takes a sample budget, ``successive_halving`` an eta),
#: so — like controllers — the registry holds factories and
#: :func:`make_search` builds a fresh instance per call.
_SEARCHES = Registry(
    "search strategy", key_fn=str,
    describe=lambda f: getattr(f, "__name__", type(f).__name__),
    register_hint="@register_search({key!r})")


def register_search(name: str, *aliases: str, override: bool = False):
    """Class/factory decorator registering a search strategy."""
    return _SEARCHES.register(name, *aliases, override=override)


def unregister_search(name: str) -> None:
    """Remove a strategy factory and all its aliases."""
    _SEARCHES.unregister(name)


def get_search(name: str):
    """Resolve a strategy name to its registered factory."""
    return _SEARCHES.get(name)


def make_search(name: str, **kwargs) -> SearchStrategy:
    """Construct a fresh strategy instance from its registered name."""
    return get_search(name)(**kwargs)


def available_searches() -> tuple[str, ...]:
    return _SEARCHES.available()


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------

def _estimate_all(cands: Sequence[Candidate], model: CostModel,
                  objective: Objective) -> list[tuple[Candidate,
                                                      CostEstimate, float]]:
    out = []
    for c in cands:
        cost = model.estimate(c)
        out.append((c, cost, objective.of_estimate(cost)))
    # deterministic rank: estimate scalar, then bytes, then name
    out.sort(key=lambda e: (e[2], e[1].wire_bytes, e[0].name))
    return out


def _certify(entries, model: CostModel, objective: Objective, keep: set
             ) -> list[ScoredCandidate]:
    """Full-sim the kept candidates, carry the rest estimate-only."""
    scored: list[ScoredCandidate] = []
    for cand, cost, est in entries:
        if cand.signature() in keep:
            score = model.simulate(cand)
            scored.append(ScoredCandidate(cand, cost, score,
                                          objective.of_score(score), est))
        else:
            scored.append(ScoredCandidate(cand, cost,
                                          estimate_objective=est))
    scored.sort(key=_result_rank)
    return scored


def _result_rank(s: ScoredCandidate):
    """Sim-certified first (by objective), then pruned (by estimate)."""
    if s.objective is not None:
        return (0, s.objective, s.score.wire_bytes, s.candidate.name)
    return (1, s.estimate_objective, s.cost.wire_bytes, s.candidate.name)


def _with_seeds(keep, entries) -> set:
    keep = set(keep)
    keep.update(c.signature() for c, _, _ in entries if c.seed)
    return keep


# ---------------------------------------------------------------------------
# built-in strategies
# ---------------------------------------------------------------------------

@register_search("grid")
class GridSearch:
    """Exhaustive estimate, sim-certify the analytic top-``shortlist``.

    The default: visits every candidate at the cheap fidelity, then
    runs the DES only on the best ``shortlist`` (plus every seed).
    """

    name = "grid"

    def search(self, candidates, model, objective, *, shortlist: int = 8
               ) -> list[ScoredCandidate]:
        entries = _estimate_all(candidates, model, objective)
        keep = _with_seeds(
            (c.signature() for c, _, _ in entries[:max(1, shortlist)]),
            entries)
        return _certify(entries, model, objective, keep)


@register_search("random")
class RandomSearch:
    """Uniform subsample of the generated space (seeds always kept).

    For spaces too large to estimate exhaustively: visits ``samples``
    non-seed candidates drawn with a fixed ``seed`` (deterministic
    artifacts), then behaves like :class:`GridSearch` on the sample.
    """

    name = "random"

    def __init__(self, samples: int = 32, seed: int = 0):
        self.samples = int(samples)
        self.seed = int(seed)

    def search(self, candidates, model, objective, *, shortlist: int = 8
               ) -> list[ScoredCandidate]:
        seeds = [c for c in candidates if c.seed]
        rest = [c for c in candidates if not c.seed]
        if len(rest) > self.samples:
            rng = random.Random(self.seed)
            rest = rng.sample(rest, self.samples)
        entries = _estimate_all(seeds + rest, model, objective)
        keep = _with_seeds(
            (c.signature() for c, _, _ in entries[:max(1, shortlist)]),
            entries)
        return _certify(entries, model, objective, keep)


@register_search("successive_halving", "sha")
class SuccessiveHalving:
    """Multi-fidelity halving: estimate -> transport-only sim -> full sim.

    Rung 0 ranks everything on the closed-form estimate; rung 1 replays
    the top ``1/eta`` through the DES with a zero-cost datapath
    (transport + queueing only — real contention, no flit pipeline);
    the final rung certifies the survivors (never fewer than
    ``shortlist``, seeds always included) with the full 5-stage
    datapath.  The middle rung is what lets a candidate the analytic
    model misranks under queueing claw its way back before the
    expensive fidelity.
    """

    name = "successive_halving"

    def __init__(self, eta: float = 2.0):
        if eta <= 1.0:
            raise ValueError(f"eta must be > 1, got {eta}")
        self.eta = float(eta)

    def search(self, candidates, model, objective, *, shortlist: int = 8
               ) -> list[ScoredCandidate]:
        entries = _estimate_all(candidates, model, objective)
        floor = max(1, shortlist)
        n1 = max(floor, math.ceil(len(entries) / self.eta))
        rung1 = _with_seeds(
            (c.signature() for c, _, _ in entries[:n1]), entries)
        # mid fidelity: transport-only DES on the rung-1 survivors
        mid: list[tuple[Candidate, float]] = []
        for cand, _cost, _est in entries:
            if cand.signature() in rung1:
                s = model.simulate(cand, datapath=None)
                mid.append((cand, objective.of_score(s)))
        mid.sort(key=lambda e: (e[1], e[0].name))
        n2 = max(floor, math.ceil(len(mid) / self.eta))
        keep = _with_seeds(
            (c.signature() for c, _ in mid[:n2]), entries)
        return _certify(entries, model, objective, keep)
