"""Candidate pricing: analytic estimates for pruning, DES sim for truth.

Port of ``repro/tune/cost.py``: every figure is plain Python float
arithmetic in the reference's order, so prices equal the reference's.

Two fidelities, exactly the repo's two modeling layers:

  * :meth:`CostModel.estimate` — closed-form
    :func:`~repro_torch.core.traffic.modeled_layout_comm_time` /
    :func:`~repro_torch.core.traffic.modeled_layout_multihop_time` over the
    candidate's bucket layout.  Cheap (no event loop), monotone in
    bytes and launches — good enough to *rank* candidates for pruning,
    not to certify a winner.
  * :meth:`CostModel.simulate` — the :mod:`repro_torch.sim` discrete-event
    replay of the same layout (queueing, per-bucket pipelining,
    compute overlap, datapath exposure).  This is the score the tuned
    plan is certified against; it agrees within 1% with the analytic
    models on their shared domain (``tests/test_torch_sim.py``), which is
    what makes the offline objective trustworthy.

Layouts are planned once per candidate signature and cached — the
candidate's own ``bucket_bytes`` is part of the plan, so two candidates
differing only in bucket budget price differently (launch-latency
amortization vs emission granularity).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..core.buckets import plan_buckets
from ..core.traffic import (IciModel, MultiHopModel,
                            hop_wire_bytes_per_device,
                            modeled_layout_comm_time,
                            modeled_layout_multihop_time,
                            plan_traffic_ratio)
from .space import Candidate

__all__ = ["CostEstimate", "CostModel", "Objective", "SimScore"]


# ---------------------------------------------------------------------------
# typed results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Closed-form price of one candidate (the pruning fidelity)."""
    comm_time_s: float          # modeled collective time, all launches
    wire_bytes: float           # per-device bytes crossing links
    launches: int
    traffic_ratio: float        # payload accounting vs FP32

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_jsonable(d: Mapping) -> "CostEstimate":
        return CostEstimate(comm_time_s=float(d["comm_time_s"]),
                            wire_bytes=float(d["wire_bytes"]),
                            launches=int(d["launches"]),
                            traffic_ratio=float(d["traffic_ratio"]))


@dataclasses.dataclass(frozen=True)
class SimScore:
    """DES-simulated price of one candidate (the certifying fidelity)."""
    step_time_s: float
    exposed_pct: float
    wire_bytes: float
    launches: int
    hidden: bool

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_jsonable(d: Mapping) -> "SimScore":
        return SimScore(step_time_s=float(d["step_time_s"]),
                        exposed_pct=float(d["exposed_pct"]),
                        wire_bytes=float(d["wire_bytes"]),
                        launches=int(d["launches"]),
                        hidden=bool(d["hidden"]))


@dataclasses.dataclass(frozen=True)
class Objective:
    """Scalarization the tuner minimizes.

    ``value`` is modeled step seconds plus wire traffic priced at
    ``wire_byte_weight`` seconds/byte — the default weights reduce to
    pure step time (the ROADMAP north star), with wire bytes kept as a
    deterministic tiebreak at the selection site rather than in the
    scalar.  The same weights apply to both fidelities, so analytic
    pruning and sim certification optimize the same thing.
    """
    step_time_weight: float = 1.0
    wire_byte_weight: float = 0.0

    def value(self, step_time_s: float, wire_bytes: float) -> float:
        return (self.step_time_weight * step_time_s
                + self.wire_byte_weight * wire_bytes)

    def of_score(self, score: SimScore) -> float:
        return self.value(score.step_time_s, score.wire_bytes)

    def of_estimate(self, cost: CostEstimate) -> float:
        return self.value(cost.comm_time_s, cost.wire_bytes)

    def to_jsonable(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_jsonable(d: Mapping) -> "Objective":
        return Objective(step_time_weight=float(d["step_time_weight"]),
                         wire_byte_weight=float(d["wire_byte_weight"]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class CostModel:
    """Prices candidates for one (session, model, topology) triple.

    ``fabric`` supplies worker count, group rules, and policy
    resolution; ``params_like`` may be concrete arrays or abstract
    ``meta`` tensors (only shapes/dtypes are read).  ``topology`` is a
    registered sim topology name; the analytic fidelity routes
    ``"multihop"`` through :class:`~repro_torch.core.traffic.MultiHopModel`
    and everything else through the ring :class:`IciModel` — an
    approximation for the CXL lanes, which is exactly why seeds and the
    shortlist are re-scored by the DES before anything is certified.
    """

    def __init__(self, fabric, params_like: Any, *,
                 topology: str = "ici_ring",
                 compute_time_s: float = 0.0,
                 overlap_fraction: float = 1.0,
                 pspecs: Any | None = None,
                 ici: IciModel | None = None,
                 multihop: MultiHopModel | None = None,
                 **topology_kwargs):
        self.fabric = fabric
        self.params_like = params_like
        self.topology = str(topology)
        self.compute_time_s = float(compute_time_s)
        self.overlap_fraction = float(overlap_fraction)
        self.pspecs = pspecs
        self.ici = ici or IciModel()
        self.multihop = multihop or MultiHopModel()
        self.topology_kwargs = dict(topology_kwargs)
        self.sizes = fabric.group_sizes(params_like)
        self._layouts: dict[str, Any] = {}
        #: sim fidelity counters (land in TunedPlan provenance)
        self.estimates = 0
        self.simulations = 0

    # -- layout ----------------------------------------------------------

    def layout(self, cand: Candidate):
        """The candidate's bucket layout (cached per signature)."""
        sig = cand.signature()
        if sig not in self._layouts:
            from ..fabric.session import _registry_fusable
            policies = self.fabric.resolve(self.params_like, cand.plan,
                                           pspecs=self.pspecs)
            self._layouts[sig] = plan_buckets(
                self.params_like, policies,
                bucket_bytes=cand.bucket_bytes,
                fusable=_registry_fusable)
        return self._layouts[sig]

    # -- fidelity 1: closed-form estimate --------------------------------

    def estimate(self, cand: Candidate) -> CostEstimate:
        layout = self.layout(cand)
        w = self.fabric.num_workers
        if self.topology == "multihop":
            t = modeled_layout_multihop_time(layout, w, self.multihop)
        else:
            t = modeled_layout_comm_time(layout, w, self.ici)
        wire = sum(
            sum(hop_wire_bytes_per_device(n, key.mode, key.schedule, w))
            for key, n in layout.launches())
        self.estimates += 1
        return CostEstimate(
            comm_time_s=float(t), wire_bytes=float(wire),
            launches=layout.num_launches,
            traffic_ratio=float(plan_traffic_ratio(self.sizes, cand.plan)))

    # -- fidelity 2: discrete-event simulation ---------------------------

    def simulate(self, cand: Candidate, *, datapath: Any = "default"
                 ) -> SimScore:
        """Replay the candidate's layout through :mod:`repro_torch.sim`.

        ``datapath="default"`` uses the paper's 5-stage
        :class:`~repro_torch.sim.FlitPipeline`; ``datapath=None`` simulates
        transport only (the cheaper mid-fidelity rung successive
        halving climbs through — note ``simulate_layout`` would coerce
        None back to the full pipeline, so this goes through
        ``simulate_launches``, which honors it).
        """
        from ..sim import (FlitPipeline, layout_launch_specs,
                           simulate_launches)
        if datapath == "default":
            datapath = FlitPipeline()
        w = self.fabric.num_workers
        specs = layout_launch_specs(self.layout(cand), w,
                                    compute_time_s=self.compute_time_s)
        report = simulate_launches(
            specs, w, topology=self.topology, datapath=datapath,
            overlap_fraction=self.overlap_fraction,
            compute_time_s=self.compute_time_s, **self.topology_kwargs)
        self.simulations += 1
        return SimScore(
            step_time_s=float(report.step_time_s),
            exposed_pct=float(report.exposed_pct),
            wire_bytes=float(report.wire_bytes_total),
            launches=report.num_launches,
            hidden=bool(report.hidden))

    # -- provenance ------------------------------------------------------

    def sim_constants(self) -> dict:
        """The knobs a bit-identical re-score must reproduce."""
        return {"topology": self.topology,
                "compute_time_s": self.compute_time_s,
                "overlap_fraction": self.overlap_fraction,
                "topology_kwargs": dict(self.topology_kwargs)}
