"""The autotune entry point: plan selection as an offline compile step.

Port of ``repro/tune/autotune.py``.

``autotune(fabric, params_like)`` prices every admissible candidate in
a :class:`~repro_torch.tune.space.SearchSpace` against one (model, topology)
pair — analytic models for pruning, the :mod:`repro_torch.sim` DES for
certification — and returns a :class:`~repro_torch.tune.artifact.TunedPlan`:
the winning ``(AdmissionPlan, bucket_bytes)`` plus the full decision
record.  ``rescore`` replays a loaded artifact through the same
machinery and must reproduce it bit-identically; anything else means
the environment drifted (different codecs registered, different sim
constants, different model) and the artifact should not be trusted.
"""
from __future__ import annotations

from typing import Any

from .artifact import RunnerUp, TunedPlan, model_census
from .cost import CostModel, Objective
from .search import ScoredCandidate, make_search
from .space import Candidate, SearchSpace, default_space

__all__ = ["autotune", "rescore"]

#: estimate-pruned candidates recorded in the artifact beyond the
#: sim-certified set — enough to audit the pruning, small enough that
#: artifacts stay readable
_MAX_PRUNED_RECORDED = 8


def _runner_up(s: ScoredCandidate) -> RunnerUp:
    return RunnerUp(name=s.candidate.name, plan=s.candidate.plan,
                    bucket_bytes=s.candidate.bucket_bytes, cost=s.cost,
                    score=s.score, objective=s.objective)


def autotune(fabric, params_like: Any, space: SearchSpace | None = None, *,
             topology: str = "ici_ring", strategy: Any = "grid",
             shortlist: int = 8, objective: Objective | None = None,
             compute_time_s: float = 0.0, overlap_fraction: float = 1.0,
             pspecs: Any | None = None, name: str | None = None,
             error_feedback: bool = False,
             **topology_kwargs) -> TunedPlan:
    """Search ``space`` for the best plan on ``topology``; certify by sim.

    ``fabric``       — the session supplying worker count + group rules
                       (``params_like`` may be ``meta`` tensors).
    ``space``        — a :class:`SearchSpace`; default:
                       :func:`~repro_torch.tune.space.default_space` (all
                       presets + generated low-bit axes, head pinned to
                       FP32).
    ``strategy``     — a registered search-strategy name (``"grid"``,
                       ``"random"``, ``"successive_halving"``) or an
                       instance with a ``search`` method.
    ``objective``    — scalarization to minimize; default pure modeled
                       step time.
    ``topology_kwargs`` flow into the sim topology factory (e.g.
    ``workers_per_node=8`` for ``multihop``).

    The returned :class:`TunedPlan`'s sim-scored step time is never
    worse than any seed preset in the space under the same objective:
    every strategy sim-scores seeds, and the winner is the argmin over
    the sim-scored set.
    """
    space = space if space is not None else default_space(
        error_feedback=error_feedback)
    objective = objective if objective is not None else Objective()
    model = CostModel(fabric, params_like, topology=topology,
                      compute_time_s=compute_time_s,
                      overlap_fraction=overlap_fraction, pspecs=pspecs,
                      **topology_kwargs)
    candidates = list(space.enumerate(model.sizes))
    if not candidates:
        raise ValueError(
            f"search space admitted no candidates for this model "
            f"(constraints: {[c.name for c in space.constraints]}) — "
            f"relax a constraint or add seed plans that satisfy them")
    search = (strategy if hasattr(strategy, "search")
              else make_search(strategy))
    scored = search.search(candidates, model, objective,
                           shortlist=shortlist)
    certified = [s for s in scored if s.score is not None]
    if not certified:
        raise RuntimeError(
            f"search strategy {getattr(search, 'name', search)!r} "
            f"sim-scored no candidates — a strategy must certify at "
            f"least its shortlist")
    best, rest = certified[0], scored[1:]
    pruned_kept = 0
    runners: list[RunnerUp] = []
    for s in rest:
        if s.score is None:
            if pruned_kept >= _MAX_PRUNED_RECORDED:
                continue
            pruned_kept += 1
        runners.append(_runner_up(s))
    provenance = {
        "version": 1,
        "model": model_census(fabric, params_like),
        "sim": model.sim_constants(),
        "objective": objective.to_jsonable(),
        "strategy": getattr(search, "name", type(search).__name__),
        "shortlist": int(shortlist),
        "space": space.signature(),
        "constraints": [c.name for c in space.constraints],
        "candidates": {"enumerated": len(candidates),
                       "estimated": model.estimates,
                       "sim_scored": model.simulations},
    }
    return TunedPlan(
        name=name or f"tuned_{topology}",
        plan=best.candidate.plan,
        bucket_bytes=best.candidate.bucket_bytes,
        topology=topology,
        num_workers=fabric.num_workers,
        objective=float(best.objective),
        score=best.score,
        cost=best.cost,
        runners_up=tuple(runners),
        provenance=provenance)


def rescore(tuned: TunedPlan, fabric, params_like: Any, *,
            pspecs: Any | None = None) -> TunedPlan:
    """Re-derive a :class:`TunedPlan`'s scores in this environment.

    Rebuilds the cost model from the artifact's recorded sim constants,
    re-prices the winner and every sim-certified runner-up, and returns
    a new artifact carrying the recomputed numbers (provenance copied
    verbatim).  Because the analytic models and the DES are
    deterministic, ``rescore(TunedPlan.load(p), fabric, params)
    .to_jsonable() == TunedPlan.load(p).to_jsonable()`` whenever the
    environment matches; a mismatched model census raises instead of
    silently producing scores for the wrong network.
    """
    sim = dict(tuned.provenance.get("sim", {}))
    census = tuned.provenance.get("model")
    here = model_census(fabric, params_like)
    if census is not None and census != here:
        raise ValueError(
            f"model census mismatch: artifact was tuned for "
            f"{census}, this session sees {here}")
    if int(tuned.num_workers) != int(fabric.num_workers):
        raise ValueError(
            f"worker-count mismatch: artifact tuned for "
            f"{tuned.num_workers} workers, session has "
            f"{fabric.num_workers}")
    objective = Objective.from_jsonable(
        tuned.provenance.get("objective", Objective().to_jsonable()))
    model = CostModel(
        fabric, params_like,
        topology=sim.get("topology", tuned.topology),
        compute_time_s=sim.get("compute_time_s", 0.0),
        overlap_fraction=sim.get("overlap_fraction", 1.0),
        pspecs=pspecs, **sim.get("topology_kwargs", {}))

    def reprice(name, plan, bucket_bytes, had_score):
        cand = Candidate(name=name, plan=plan,
                         bucket_bytes=int(bucket_bytes))
        cost = model.estimate(cand)
        score = model.simulate(cand) if had_score else None
        return cost, score

    cost, score = reprice(tuned.name, tuned.plan, tuned.bucket_bytes, True)
    runners = []
    for r in tuned.runners_up:
        r_cost, r_score = reprice(r.name, r.plan, r.bucket_bytes,
                                  r.score is not None)
        runners.append(RunnerUp(
            name=r.name, plan=r.plan, bucket_bytes=r.bucket_bytes,
            cost=r_cost, score=r_score,
            objective=(None if r_score is None
                       else objective.of_score(r_score))))
    return TunedPlan(
        name=tuned.name, plan=tuned.plan,
        bucket_bytes=tuned.bucket_bytes, topology=tuned.topology,
        num_workers=tuned.num_workers,
        objective=float(objective.of_score(score)),
        score=score, cost=cost, runners_up=tuple(runners),
        provenance=dict(tuned.provenance))
