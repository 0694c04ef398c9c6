"""repro_torch.tune — sim-driven plan autotuning: plan selection as
compilation (port of ``repro/tune``; every price, score and artifact
equals the reference's).

The repo exposes a large configuration surface — codecs, schedules, hop
plans, bucket budgets, per-group overrides — and the paper picks one
point in it by hand.  This package searches that surface the way a
compiler searches loop schedules, against the modeling stack the repo
already trusts:

  * :mod:`space`    — :class:`SearchSpace`: declarative candidate
    enumeration (seed presets + generated codec/schedule/EF/group/bucket
    axes) with accuracy guardrails as *admission constraints*
    (:class:`PinGroup`, :class:`MaxLowbitFraction`) — a violating plan
    is never part of the space;
  * :mod:`cost`     — :class:`CostModel`: analytic
    ``modeled_layout_comm_time`` / ``MultiHopModel`` pricing for cheap
    pruning, the :mod:`repro_torch.sim` DES for certification; one
    :class:`Objective` scalarization shared by both fidelities;
  * :mod:`search`   — the seventh registry, ``@register_search``:
    ``grid``, ``random``, ``successive_halving`` built-ins.  Invariant:
    seed presets are always sim-scored, so the tuned result is provably
    no worse than any preset it searched over;
  * :mod:`artifact` — :class:`TunedPlan`: a reproducible JSON record
    (plan + bucket budget + scores + runner-up table + provenance) that
    ``install()``s back into :func:`~repro_torch.fabric.control.plan_presets`
    by name;
  * :mod:`autotune` — the :func:`autotune` orchestration (also exposed
    as ``Fabric.autotune``) and :func:`rescore` bit-identical
    revalidation;
  * :mod:`online`   — the ``"tuned"`` controller: re-ranks the
    sim-certified shortlist from live :class:`Telemetry` step times
    through the standard controller seam.

Importing the package registers the built-in search strategies and the
``"tuned"`` controller.
"""
from .artifact import ARTIFACT_VERSION, RunnerUp, TunedPlan, model_census
from .autotune import autotune, rescore
from .cost import CostEstimate, CostModel, Objective, SimScore
from .online import TunedPlanController
from .search import (GridSearch, RandomSearch, ScoredCandidate,
                     SearchStrategy, SuccessiveHalving, available_searches,
                     get_search, make_search, register_search,
                     unregister_search)
from .space import (Candidate, Constraint, MaxLowbitFraction, PinGroup,
                    SearchSpace, default_space)

__all__ = [
    "ARTIFACT_VERSION", "Candidate", "Constraint", "CostEstimate",
    "CostModel", "GridSearch", "MaxLowbitFraction", "Objective",
    "PinGroup", "RandomSearch", "RunnerUp", "ScoredCandidate",
    "SearchSpace", "SearchStrategy", "SimScore", "SuccessiveHalving",
    "TunedPlan", "TunedPlanController", "autotune", "available_searches",
    "default_space", "get_search", "make_search", "model_census",
    "register_search", "rescore", "unregister_search",
]
