"""Named admission-plan presets (port of ``repro/fabric/control.py:180-246``).

Only the presets whose codecs and schedules this port carries are here;
the admission controllers (paper / static / tuned) and the presets of
the hop-plan codecs are still to port (ROADMAP queue 1).
"""
from __future__ import annotations

from ..core.buckets import AdmissionPlan, GroupPolicy
from ..core.modes import AggregationMode, Schedule


def plan_presets(error_feedback: bool = False) -> dict[str, AdmissionPlan]:
    """Canonical named plans, one source for every launcher.

    ``gbin_vote``/``gter_vote`` pin the dense vote schedule; ``*_packed``
    pin the packed controller schedule; ``gbin_packed_embed`` also admits
    the embedding table while head and norms stay on FP32.  The
    ``*_backbone`` presets leave the schedule to the codec's default.
    ``int4_backbone`` / ``topk_backbone`` name the extension codecs
    (``psum``); they ignore ``error_feedback``, since neither codec
    threads EF.
    """
    ef = error_feedback
    packed = Schedule.PACKED_A2A
    return {
        "fp32": AdmissionPlan.fp32_all(),
        "gbin_backbone": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, error_feedback=ef),
        "gbin_vote": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, schedule=Schedule.VOTE_PSUM,
            error_feedback=ef),
        "gbin_packed": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, schedule=packed, error_feedback=ef),
        "gter_backbone": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, error_feedback=ef),
        "gter_vote": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, schedule=Schedule.VOTE_PSUM,
            error_feedback=ef),
        "lowbit_all": AdmissionPlan.lowbit_all(
            AggregationMode.G_BINARY, error_feedback=ef),
        "gbin_packed_all": AdmissionPlan.lowbit_all(
            AggregationMode.G_BINARY, schedule=packed, error_feedback=ef),
        "gbin_packed_embed": AdmissionPlan.from_dict(
            {"backbone": GroupPolicy(AggregationMode.G_BINARY, packed, ef),
             "embed": GroupPolicy(AggregationMode.G_BINARY, packed, ef)},
            default=GroupPolicy(AggregationMode.FP32)),
        "int4_backbone": AdmissionPlan.lowbit_backbone("int4"),
        "topk_backbone": AdmissionPlan.lowbit_backbone("topk"),
    }
