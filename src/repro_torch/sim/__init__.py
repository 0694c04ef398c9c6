"""repro_torch.sim — discrete-event simulator of the aggregation fabric.

Port of ``repro/sim`` (plain Python float arithmetic, each expression in
the reference's order, so a :class:`SimReport` is equal to the
reference's).  It replays any :class:`~repro_torch.core.buckets.
BucketLayout` / ``AdmissionPlan`` against pluggable interconnect
topologies with queueing, per-bucket pipelining and compute/collective
overlap:

  * :mod:`engine`    — event heap + FIFO clocked resources;
  * :mod:`datapath`  — the paper's 5-stage 512-bit flit pipeline
    (sign-count / ternary-gated / FP32-bypass lanes);
  * :mod:`topology`  — ``@register_topology`` registry with built-ins
    ``cxl_direct``, ``cxl_switched``, ``ici_ring``, ``multihop``;
  * :mod:`trace`     — bucket layout -> launch timeline ->
    :class:`SimReport`;
  * :mod:`scenarios` — the paper's operating points.

Every constant (pipeline clock, link rates, latencies) is the reference's
modeled default, and every time the simulator reports is a model output
under those constants, not a measurement of any card.  On degenerate
single-launch, queue-free configurations it agrees with
``ExposureModel.exposed`` and ``IciModel.collective_time`` within 1%; on
the paper's operating points it gives the <= 1.67%-exposed full-miss
regime and the fully hidden bandwidth-pressure regime.

Quick use::

    report = fabric.simulate(params, plan, topology="cxl_switched",
                             compute_time_s=1e-3)
    print(report.exposed_pct, report.link_utilization)
"""
from .datapath import (FLIT_BITS, PIPELINE_STAGES, FlitPipeline, LaneSpec,
                       datapath_time)
from .engine import Engine, Resource, ResourcePool, ResourceStats
from .scenarios import (PAPER_EXPOSED_BOUND_PCT, bandwidth_pressure_report,
                        full_miss_report, paper_operating_points)
from .topology import (CxlDirect, CxlSwitched, Hop, IciRing, MultiHop,
                       Route, available_topologies, get_topology,
                       register_topology, unregister_topology)
from .trace import (LaunchRecord, LaunchSpec, SimReport,
                    layout_launch_specs, simulate_launches, simulate_layout,
                    timeline_launch_specs)

__all__ = [
    "FLIT_BITS", "PIPELINE_STAGES", "FlitPipeline", "LaneSpec",
    "datapath_time",
    "Engine", "Resource", "ResourcePool", "ResourceStats",
    "PAPER_EXPOSED_BOUND_PCT", "bandwidth_pressure_report",
    "full_miss_report", "paper_operating_points",
    "CxlDirect", "CxlSwitched", "Hop", "IciRing", "MultiHop", "Route",
    "available_topologies", "get_topology", "register_topology",
    "unregister_topology",
    "LaunchRecord", "LaunchSpec", "SimReport", "layout_launch_specs",
    "simulate_launches", "simulate_layout", "timeline_launch_specs",
]
