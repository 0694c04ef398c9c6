"""Datapath timing-exposure model (paper Section 5).

Port of ``repro/core/exposure.py``.  The paper's timing question: is the
low-bit aggregation datapath exposed in the communication path, or hidden
behind the link service interval?

    T_exposed = max(0, T_agg - T_overlap)                     (Section 3)

The model is analytic.  Its constants (the datapath's clock, lanes and
op counts; the link and memory rates) are the reference's modeled
defaults, as written in ``repro/core/exposure.py`` for its TPU-v5e-like
target, carried over so the outputs equal the reference's to the bit.
They price no card of this port: every figure here is a model output
under those constants, not a measurement.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TpuDatapathModel:
    """Vector-unit cost model of the controller kernels, with the
    reference's modeled constants: one (8, 128) int32 lanes op a cycle
    at 940 MHz, and per packed word of 32 sign bits roughly

      pack:      ~3 vector ops / 32 values
      popcount:  ~3 ops per worker word
      majority:  ~6 ops (margin, two compares, two shifts, gate)
      unpack:    ~4 ops
    """
    clock_hz: float = 940e6
    vpu_lanes: int = 8 * 128
    ops_per_value_pack: float = 3 / 32
    ops_per_value_popcount_per_worker: float = 3 / 32
    ops_per_value_majority: float = 6 / 32
    ops_per_value_unpack: float = 4 / 32

    def t_agg(self, n_elements: int, num_workers: int) -> float:
        """Modeled seconds of the full aggregation datapath."""
        ops_per_value = (self.ops_per_value_pack
                         + self.ops_per_value_popcount_per_worker * num_workers
                         + self.ops_per_value_majority
                         + self.ops_per_value_unpack)
        total_ops = n_elements * ops_per_value
        return total_ops / (self.vpu_lanes * self.clock_hz)


@dataclasses.dataclass(frozen=True)
class ExposureModel:
    """T_exposed = max(0, T_agg - overlap_fraction * T_service), with the
    reference's modeled link (50e9 B/s) and memory (819e9 B/s) rates."""
    datapath: TpuDatapathModel = dataclasses.field(
        default_factory=TpuDatapathModel)
    link_bw: float = 50e9
    hbm_bw: float = 819e9
    overlap_fraction: float = 1.0

    def t_service(self, wire_bytes_per_device: float) -> float:
        return wire_bytes_per_device / self.link_bw

    def exposed(self, n_elements: int, num_workers: int,
                wire_bytes_per_device: float,
                extra_service_s: float = 0.0) -> dict:
        """Exposure of one aggregation launch.

        ``extra_service_s`` adds fixed service-path latency (ring hops,
        memory access) to the bandwidth term: it widens the window the
        datapath can hide behind, under the same ``overlap_fraction``.
        """
        t_agg = self.datapath.t_agg(n_elements, num_workers)
        t_srv = self.t_service(wire_bytes_per_device) + extra_service_s
        t_exp = max(0.0, t_agg - self.overlap_fraction * t_srv)
        base = t_srv if t_srv > 0 else t_agg
        return {
            "t_agg_s": t_agg,
            "t_service_s": t_srv,
            "t_exposed_s": t_exp,
            "exposed_pct": 100.0 * t_exp / base if base else 0.0,
            "hidden": t_exp == 0.0,
        }

    def exposed_launch(self, n_elements: int, num_workers: int, mode,
                       schedule, extra_service_s: float = 0.0) -> dict:
        """Exposure of one launch, its wire bytes priced by the schedule
        backend for the codec
        (:func:`repro_torch.core.traffic.wire_bytes_per_device`)."""
        from .traffic import wire_bytes_per_device
        wb = wire_bytes_per_device(n_elements, mode, schedule, num_workers)
        return self.exposed(n_elements, num_workers, wb,
                            extra_service_s=extra_service_s)


def envelope_sweep(n_elements: int = 8 << 20, num_workers: int = 32,
                   wire_bytes_per_device: float | None = None):
    """The paper's Fig 3 operating-envelope sweep on the modeled
    constants.

    Panel (a): link bandwidth x datapath depth multiplier.
    Panel (b): hop latency (the analogue of a fixed memory-access latency).
    Panel (c): admitted fraction (the analogue of LLC-filtered load).
    Panel (d): telemetry (mode-latch) staleness in steps.
    Returns {panel: list[dict]}.
    """
    if wire_bytes_per_device is None:
        wire_bytes_per_device = 3 * n_elements / 8   # packed_a2a schedule
    rows: dict[str, list] = {"a": [], "b": [], "c": [], "d": []}

    for bw in (12.5e9, 25e9, 50e9, 100e9, 200e9):
        for depth_mult in (1.0, 2.0, 4.0):
            dp = TpuDatapathModel(
                ops_per_value_pack=3 / 32 * depth_mult,
                ops_per_value_popcount_per_worker=3 / 32 * depth_mult,
                ops_per_value_majority=6 / 32 * depth_mult,
                ops_per_value_unpack=4 / 32 * depth_mult)
            m = ExposureModel(datapath=dp, link_bw=bw)
            r = m.exposed(n_elements, num_workers, wire_bytes_per_device)
            rows["a"].append({"link_GBps": bw / 1e9,
                              "depth_mult": depth_mult, **r})

    for hop_us in (0.5, 1.0, 2.0, 5.0):
        # hop latency is extra service-path time, under overlap_fraction
        m = ExposureModel()
        r = m.exposed(n_elements, num_workers, wire_bytes_per_device,
                      extra_service_s=2 * (num_workers - 1) * hop_us * 1e-6)
        rows["b"].append({"hop_us": hop_us, **r})

    for admitted_frac in (0.25, 0.5, 0.75, 1.0):
        m = ExposureModel()
        n_adm = int(n_elements * admitted_frac)
        r = m.exposed(n_adm, num_workers, wire_bytes_per_device * admitted_frac
                      + (1 - admitted_frac) * 8 * n_elements)
        rows["c"].append({"admitted_frac": admitted_frac, **r})

    for stale_steps in (0, 1, 10, 100):
        # a stale latch only delays the traffic change: one FP32-priced
        # step per stale step, amortized over an epoch-scale run
        step_cost = 8 * n_elements / 50e9
        amortized_pct = 100.0 * stale_steps * step_cost / (1000 * step_cost)
        rows["d"].append({"stale_steps": stale_steps,
                          "amortized_step_cost_pct": amortized_pct})
    return rows
