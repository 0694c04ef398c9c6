"""The ``TunedPlan`` artifact: a compiled plan choice with provenance.

Port of ``repro/tune/artifact.py``; the JSON is the reference's, key for
key, and :func:`model_census` counts leaves with
:mod:`repro_torch.core.tree` (the same leaves, in the same order, as
``jax.tree_util`` gives the reference's tree).

Tuning treats plan selection as *compilation*, and a compiler's output
must be reproducible and inspectable.  A :class:`TunedPlan` therefore
carries everything needed to (a) use the plan — the winning
:class:`~repro_torch.core.buckets.AdmissionPlan` plus its bucket budget —
and (b) re-derive the decision — the model census, sim constants,
objective weights, search-space signature, and the runner-up table the
online controller re-ranks at runtime.

The artifact round-trips through JSON bit-identically:
``TunedPlan.from_jsonable(t.to_jsonable()) == t`` and a
:func:`rescore` of the loaded artifact (same session, same model)
reproduces the exact scores — the DES and the analytic models are
deterministic, and every knob they read is in the provenance.

``install()`` registers the winning plan as a named
:func:`~repro_torch.fabric.control.plan_presets` entry, so a tuned plan is
addressed exactly like a hand-written preset — ``--plan`` on the
launcher, ``StaticController(plan="tuned_ici_ring")``, a Commander
ladder target.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from ..core import tree as T
from ..core.buckets import AdmissionPlan
from .cost import CostEstimate, SimScore

__all__ = ["ARTIFACT_VERSION", "RunnerUp", "TunedPlan"]

#: bumped when the JSON schema changes; ``from_jsonable`` rejects
#: artifacts from a newer schema instead of misreading them
ARTIFACT_VERSION = 1


def _plan_to_jsonable(plan: AdmissionPlan) -> dict:
    from ..fabric.control import plan_to_jsonable
    return plan_to_jsonable(plan)


def _plan_from_jsonable(obj: Mapping) -> AdmissionPlan:
    from ..fabric.control import plan_from_jsonable
    return plan_from_jsonable(dict(obj))


@dataclasses.dataclass(frozen=True)
class RunnerUp:
    """One non-winning candidate kept in the artifact.

    Sim-certified runners-up carry a full :class:`SimScore` (these are
    what the online controller may switch to); estimate-pruned ones
    carry only the analytic figures, recorded so a re-run can audit
    what the pruning fidelity claimed.
    """
    name: str
    plan: AdmissionPlan
    bucket_bytes: int
    cost: CostEstimate
    score: SimScore | None = None
    objective: float | None = None

    def to_jsonable(self) -> dict:
        return {"name": self.name,
                "plan": _plan_to_jsonable(self.plan),
                "bucket_bytes": int(self.bucket_bytes),
                "cost": self.cost.to_jsonable(),
                "score": (None if self.score is None
                          else self.score.to_jsonable()),
                "objective": self.objective}

    @staticmethod
    def from_jsonable(d: Mapping) -> "RunnerUp":
        score = d.get("score")
        return RunnerUp(
            name=str(d["name"]),
            plan=_plan_from_jsonable(d["plan"]),
            bucket_bytes=int(d["bucket_bytes"]),
            cost=CostEstimate.from_jsonable(d["cost"]),
            score=None if score is None else SimScore.from_jsonable(score),
            objective=(None if d.get("objective") is None
                       else float(d["objective"])))


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The autotuner's output: one certified plan + its decision record."""
    name: str
    plan: AdmissionPlan
    bucket_bytes: int
    topology: str
    num_workers: int
    objective: float            # the winner's scalarized sim objective
    score: SimScore
    cost: CostEstimate
    runners_up: tuple = ()      # tuple[RunnerUp], best first
    provenance: Mapping = dataclasses.field(default_factory=dict)

    # -- use -------------------------------------------------------------

    def group_policy(self, group: str):
        """The tuned plan's policy for one parameter group."""
        return self.plan.policy_for(group)

    def apply(self, fabric) -> AdmissionPlan:
        """Point a session at this plan: set its bucket budget, clear
        stale layout/step caches, return the plan to train with."""
        fabric.bucket_bytes = int(self.bucket_bytes)
        fabric.clear_cache()
        return self.plan

    def install(self, name: str | None = None, *,
                override: bool = False) -> str:
        """Register the winning plan as a named preset.

        After ``tuned.install()`` the plan resolves anywhere presets
        do: ``plan_presets()[tuned.name]``, the launcher's ``--plan``,
        ``StaticController(plan=tuned.name)``.  Returns the name.
        """
        from ..fabric.control import register_plan_preset
        name = name or self.name
        register_plan_preset(name, self.plan, override=override)
        return name

    # -- persistence -----------------------------------------------------

    def to_jsonable(self) -> dict:
        return {"version": ARTIFACT_VERSION,
                "name": self.name,
                "plan": _plan_to_jsonable(self.plan),
                "plan_signature": self.plan.signature(),
                "bucket_bytes": int(self.bucket_bytes),
                "topology": self.topology,
                "num_workers": int(self.num_workers),
                "objective": float(self.objective),
                "score": self.score.to_jsonable(),
                "cost": self.cost.to_jsonable(),
                "runners_up": [r.to_jsonable() for r in self.runners_up],
                "provenance": dict(self.provenance)}

    @staticmethod
    def from_jsonable(d: Mapping) -> "TunedPlan":
        version = int(d.get("version", 0))
        if version > ARTIFACT_VERSION:
            raise ValueError(
                f"TunedPlan artifact version {version} is newer than this "
                f"build understands ({ARTIFACT_VERSION}); refusing to "
                f"misread it")
        plan = _plan_from_jsonable(d["plan"])
        recorded = d.get("plan_signature")
        if recorded is not None and plan.signature() != recorded:
            raise ValueError(
                f"TunedPlan plan decoded to signature "
                f"{plan.signature()!r} but the artifact recorded "
                f"{recorded!r} — the artifact references codecs/schedules "
                f"not registered in this process, or was edited")
        return TunedPlan(
            name=str(d["name"]), plan=plan,
            bucket_bytes=int(d["bucket_bytes"]),
            topology=str(d["topology"]),
            num_workers=int(d["num_workers"]),
            objective=float(d["objective"]),
            score=SimScore.from_jsonable(d["score"]),
            cost=CostEstimate.from_jsonable(d["cost"]),
            runners_up=tuple(RunnerUp.from_jsonable(r)
                             for r in d.get("runners_up", ())),
            provenance=dict(d.get("provenance", {})))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=1, sort_keys=True)
        return path

    @staticmethod
    def load(path: str) -> "TunedPlan":
        with open(path) as f:
            return TunedPlan.from_jsonable(json.load(f))

    def summary(self) -> dict:
        """Compact scalars for logs / benchmark JSON."""
        return {"name": self.name,
                "plan_signature": self.plan.signature(),
                "bucket_bytes": int(self.bucket_bytes),
                "topology": self.topology,
                "step_time_s": self.score.step_time_s,
                "exposed_pct": self.score.exposed_pct,
                "wire_bytes": self.score.wire_bytes,
                "launches": self.score.launches,
                "traffic_ratio": self.cost.traffic_ratio,
                "objective": float(self.objective)}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TunedPlan({self.name!r}, topology={self.topology!r}, "
                f"step={self.score.step_time_s * 1e6:.1f}us, "
                f"{len(self.runners_up)} runners-up)")


def model_census(fabric, params_like: Any) -> dict:
    """The provenance record tying an artifact to its model.

    Leaf count, total parameters, and the group census — enough for
    :func:`~repro_torch.tune.autotune.rescore` to refuse a mismatched model
    without hashing array contents (the tuner never reads values).
    """
    leaves = T.leaves(params_like)
    sizes = fabric.group_sizes(params_like)
    return {"num_leaves": len(leaves),
            "total_params": int(sum(sizes.values())),
            "group_sizes": {g: int(n) for g, n in sorted(sizes.items())}}
