"""Search-space spec: which plan configurations the tuner may propose.

Port of ``repro/tune/space.py``.

A :class:`SearchSpace` enumerates *candidates* — concrete
``(AdmissionPlan, bucket_bytes)`` pairs — from two sources:

  * **seed plans**: named :func:`~repro_torch.fabric.control.plan_presets`
    entries (or any hand-built plans).  Seeds are the baselines the
    tuned plan must beat, so every search strategy sim-scores them in
    full — a seed can never be pruned away on the analytic estimate and
    then turn out faster than the winner.
  * **generated plans**: the cross product of the codec / schedule /
    error-feedback axes over the backbone group, optionally crossed
    with per-group override axes (``group_axes``) such as "also admit
    the embedding tables" — the paper's layer-group admission ladder
    expressed as a search dimension.

Every candidate — seed or generated — passes the space's *admission
constraints* before it is emitted.  Constraints are the accuracy
guardrails of the controller ladder expressed declaratively (sensitive
groups pinned to FP32, a cap on the admitted low-bit fraction), so the
search can never propose a plan the control plane would reject: a
violating configuration is not "searched and discarded", it simply is
not part of the space.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Mapping, Protocol, runtime_checkable

from ..core.buckets import AdmissionPlan, DEFAULT_BUCKET_BYTES, GroupPolicy
from ..core.modes import canonical_mode, codec_name, schedule_name
from ..fabric.codecs import get_codec

__all__ = [
    "Candidate", "Constraint", "MaxLowbitFraction", "PinGroup",
    "SearchSpace", "default_space",
]


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One concrete configuration the tuner can score.

    ``seed`` marks plans carried in verbatim (presets / user baselines);
    strategies always sim-score seeds so the tuned result is provably
    no worse than any of them under the same objective.
    """
    name: str
    plan: AdmissionPlan
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    seed: bool = False

    def signature(self) -> str:
        """Dedup / artifact identity: plan signature + bucket budget."""
        return f"{self.plan.signature()}@bb={int(self.bucket_bytes)}"


def _bb_tag(bucket_bytes: int) -> str:
    mib = 2 ** 20
    if bucket_bytes % mib == 0:
        return f"{bucket_bytes // mib}MiB"
    return f"{bucket_bytes}B"


# ---------------------------------------------------------------------------
# admission constraints (accuracy guardrails)
# ---------------------------------------------------------------------------

@runtime_checkable
class Constraint(Protocol):
    """A predicate every emitted candidate plan must satisfy.

    ``sizes`` is the model's ``group -> element count`` census (from
    :func:`repro_torch.core.buckets.group_sizes`), so constraints can reason
    about admitted fractions, not just group names.
    """

    name: str

    def admits(self, plan: AdmissionPlan,
               sizes: Mapping[str, int]) -> bool: ...


@dataclasses.dataclass(frozen=True)
class PinGroup:
    """Pin one parameter group to a fixed codec (default: FP32).

    The paper's central guardrail — the classifier head (and anything
    head-like) never rides the low-bit path — as a space constraint:
    ``PinGroup("head")`` removes every plan whose head policy resolves
    to anything but ``fp32`` from the search space.
    """
    group: str
    mode: str = "fp32"

    @property
    def name(self) -> str:
        return f"pin:{self.group}={codec_name(self.mode)}"

    def admits(self, plan: AdmissionPlan, sizes: Mapping[str, int]) -> bool:
        return (codec_name(plan.policy_for(self.group).mode)
                == codec_name(self.mode))


@dataclasses.dataclass(frozen=True)
class MaxLowbitFraction:
    """Cap the parameter fraction admitted to sub-FP32 codecs.

    A group counts as low-bit when its codec's ``bits_per_element`` is
    below 32 (votes, quantizers, sparsifiers, hierarchical routes whose
    backbone hop is low-bit — the same accounting the traffic model
    uses).  ``MaxLowbitFraction(0.0)`` degenerates to "FP32 everywhere".
    """
    max_fraction: float

    @property
    def name(self) -> str:
        return f"lowbit<={self.max_fraction:g}"

    def admits(self, plan: AdmissionPlan, sizes: Mapping[str, int]) -> bool:
        total = sum(sizes.values())
        if total == 0:
            return True
        low = sum(n for g, n in sizes.items()
                  if get_codec(plan.policy_for(g).mode).bits_per_element
                  < 32.0)
        return low / total <= self.max_fraction + 1e-12


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Declarative candidate enumeration for the plan autotuner.

    ``plans``       — seed ``(name, AdmissionPlan)`` pairs (presets).
    ``codecs``      — backbone codec axis for generated plans.
    ``schedules``   — schedule axis (None = the codec's default).
    ``error_feedback`` — EF axis; coerced off per candidate when the
                      backbone codec declares ``threads_ef=False`` (an
                      EF flag on such a codec allocates residuals that
                      never update — the same rule ``plan_presets``
                      applies to ``int4_backbone``).
    ``group_axes``  — per-group override axes for generated plans:
                      ``((group, (codec, ...)), ...)``; ``"fp32"``
                      keeps the group on the default bypass.
    ``bucket_bytes`` — fused-bucket budget axis (applies to seeds too).
    ``constraints`` — admission guardrails every emitted candidate must
                      pass (:class:`PinGroup`, :class:`MaxLowbitFraction`,
                      or any :class:`Constraint`).

    Candidates are deduplicated on ``(plan signature, bucket_bytes)`` —
    a generated plan identical to a seed keeps the seed entry (and its
    always-sim-scored status).
    """
    plans: tuple = ()                 # ((name, AdmissionPlan), ...)
    codecs: tuple = ()
    schedules: tuple = (None,)
    error_feedback: tuple = (False,)
    group_axes: tuple = ()            # ((group, (codec, ...)), ...)
    bucket_bytes: tuple = (DEFAULT_BUCKET_BYTES,)
    constraints: tuple = ()

    def __post_init__(self):
        if not self.bucket_bytes:
            raise ValueError("SearchSpace needs at least one bucket_bytes "
                             "entry")
        if not self.plans and not self.codecs:
            raise ValueError("empty SearchSpace: give seed plans and/or a "
                             "generated codec axis")

    # -- provenance ------------------------------------------------------

    def signature(self) -> str:
        """Stable description of the axes (lands in TunedPlan provenance)."""
        seeds = ",".join(n for n, _ in self.plans)
        sch = ",".join("auto" if s is None else schedule_name(s)
                       for s in self.schedules)
        groups = ";".join(f"{g}:{','.join(codec_name(c) for c in cs)}"
                          for g, cs in self.group_axes)
        cons = ",".join(c.name for c in self.constraints)
        return ("seeds[" + seeds + "]|codecs["
                + ",".join(codec_name(c) for c in self.codecs)
                + f"]|schedules[{sch}]|ef["
                + ",".join(str(int(e)) for e in self.error_feedback)
                + f"]|groups[{groups}]|bb["
                + ",".join(str(int(b)) for b in self.bucket_bytes)
                + f"]|constraints[{cons}]")

    # -- enumeration -----------------------------------------------------

    def admits(self, plan: AdmissionPlan, sizes: Mapping[str, int]) -> bool:
        return all(c.admits(plan, sizes) for c in self.constraints)

    def _generated(self) -> Iterator[tuple[str, AdmissionPlan]]:
        group_axes = tuple((g, tuple(cs)) for g, cs in self.group_axes)
        axis_groups = [g for g, _ in group_axes]
        axis_choices = [cs for _, cs in group_axes]
        for codec, sched, ef in itertools.product(
                self.codecs, self.schedules, self.error_feedback):
            ef = bool(ef) and get_codec(codec).threads_ef
            for choices in itertools.product(*axis_choices):
                d = {"backbone": GroupPolicy(canonical_mode(codec), sched,
                                             ef)}
                tags = []
                for g, choice in zip(axis_groups, choices):
                    if codec_name(choice) == "fp32":
                        continue      # default bypass: no override entry
                    g_ef = bool(ef) and get_codec(choice).threads_ef
                    d[g] = GroupPolicy(canonical_mode(choice), sched, g_ef)
                    tags.append(f"+{g}={codec_name(choice)}")
                plan = AdmissionPlan.from_dict(
                    d, default=GroupPolicy(canonical_mode("fp32")))
                name = (codec_name(codec)
                        + ("" if sched is None
                           else f"@{schedule_name(sched)}")
                        + ("+ef" if ef else "") + "".join(tags))
                yield name, plan

    def enumerate(self, sizes: Mapping[str, int]) -> Iterator[Candidate]:
        """Yield every admissible candidate, seeds first, deduplicated.

        ``sizes`` is the target model's group census — constraints are
        evaluated against it, so the same space can admit different
        plans on different models (a plan whose low-bit fraction is
        fine on one architecture may breach the cap on another).
        """
        seen: set[str] = set()
        entries = ([(n, p, True) for n, p in self.plans]
                   + [(n, p, False) for n, p in self._generated()])
        for name, plan, is_seed in entries:
            if not self.admits(plan, sizes):
                continue
            for bb in self.bucket_bytes:
                cand = Candidate(name=f"{name}/{_bb_tag(int(bb))}",
                                 plan=plan, bucket_bytes=int(bb),
                                 seed=is_seed)
                sig = cand.signature()
                if sig in seen:
                    continue
                seen.add(sig)
                yield cand


# ---------------------------------------------------------------------------
# the default space (presets + the registered extension codecs)
# ---------------------------------------------------------------------------

def default_space(*, error_feedback: bool = False,
                  bucket_bytes: tuple = (8 * 2 ** 20, DEFAULT_BUCKET_BYTES),
                  constraints: tuple | None = None,
                  preset_names: tuple | None = None) -> SearchSpace:
    """The out-of-the-box space ``fabric.autotune`` searches.

    Seeds every :func:`~repro_torch.fabric.control.plan_presets` entry
    (optionally filtered to ``preset_names``), adds a generated backbone
    axis over the low-bit built-ins and extension codecs, and crosses
    both with two bucket budgets (8 MiB / the paper's 32 MiB).  The
    default constraint set pins the classifier head to FP32 — the
    paper's non-negotiable guardrail — which also drops the
    ``lowbit_all`` style full-path presets from the space.
    """
    from ..fabric.control import plan_presets
    presets = plan_presets(error_feedback=error_feedback)
    if preset_names is not None:
        unknown = set(preset_names) - set(presets)
        if unknown:
            raise KeyError(f"unknown plan presets {sorted(unknown)}; "
                           f"available: {tuple(sorted(presets))}")
        presets = {n: presets[n] for n in preset_names}
    if constraints is None:
        constraints = (PinGroup("head"),)
    return SearchSpace(
        plans=tuple(sorted(presets.items())),
        codecs=("gbinary", "gternary", "int4", "topk"),
        schedules=(None,),
        error_feedback=(False, True) if error_feedback else (False,),
        group_axes=(("embed", ("fp32", "gbinary")),),
        bucket_bytes=tuple(int(b) for b in bucket_bytes),
        constraints=tuple(constraints))
