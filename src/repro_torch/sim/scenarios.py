"""Named simulator scenarios, including the paper's operating points.

Port of ``repro/sim/scenarios.py``.  The two headline regimes of the
paper's Section 5 evaluation, as executable scenarios (model outputs
under the reference's constants):

  * **full_miss** — the full LLC-miss regime: every flit's operand
    fetch stalls the 5-stage pipeline for one memory round-trip
    (``miss_stall_cycles=1``) and only half of the transfer window can
    hide datapath time.  The datapath is *exposed*, but by <= 1.67% of
    the step.
  * **bandwidth_pressure** — large packed buckets on the thin ring:
    the transfer window dwarfs the datapath, which hides entirely
    (0% exposed).

Both use the paper's 8M-element G-Binary bucket over 32 workers with a
1 ms backward pass.
"""
from __future__ import annotations

from ..core.modes import AggregationMode
from .datapath import FlitPipeline
from .trace import LaunchSpec, SimReport, simulate_launches

#: The paper's reference bucket: 8M gradient elements, 32 DP workers.
PAPER_N_ELEMENTS = 8 << 20
PAPER_NUM_WORKERS = 32
PAPER_COMPUTE_S = 1e-3

#: The paper's exposure bound in the full LLC-miss regime (percent).
PAPER_EXPOSED_BOUND_PCT = 1.67


def full_miss_report() -> SimReport:
    """Full LLC-miss regime on direct-attach CXL: exposed, but bounded.

    The wire payload is the raw 1-bit/element sign stream each worker
    writes over its CXL link (the paper's write path — not one of the
    registered collective schedules), hence the ``cxl_write`` schedule
    label.
    """
    n, w = PAPER_N_ELEMENTS, PAPER_NUM_WORKERS
    spec = LaunchSpec(name="bucket:0:gbinary",
                      mode=AggregationMode.G_BINARY, schedule="cxl_write",
                      n_elements=n, wire_bytes=n / 8,    # 1 bit/element
                      ready_s=PAPER_COMPUTE_S)
    return simulate_launches(
        [spec], w, topology="cxl_direct",
        datapath=FlitPipeline(miss_stall_cycles=1.0),
        overlap_fraction=0.5, compute_time_s=PAPER_COMPUTE_S)


def bandwidth_pressure_report() -> SimReport:
    """Packed buckets under ICI bandwidth pressure: fully hidden."""
    from ..core.traffic import wire_bytes_per_device
    n, w = PAPER_N_ELEMENTS, PAPER_NUM_WORKERS
    wb = wire_bytes_per_device(n, AggregationMode.G_BINARY, "packed_a2a", w)
    spec = LaunchSpec(name="bucket:0:gbinary",
                      mode=AggregationMode.G_BINARY, schedule="packed_a2a",
                      n_elements=n, wire_bytes=wb,
                      ready_s=PAPER_COMPUTE_S)
    return simulate_launches(
        [spec], w, topology="ici_ring", datapath=FlitPipeline(),
        overlap_fraction=1.0, compute_time_s=PAPER_COMPUTE_S)


def paper_operating_points() -> dict[str, SimReport]:
    """Both regimes, keyed by scenario name."""
    return {"full_miss": full_miss_report(),
            "bandwidth_pressure": bandwidth_pressure_report()}
