"""Cycle-level model of the paper's 5-stage 512-bit aggregation datapath.

Port of ``repro/sim/datapath.py``; the pipeline's clock and widths are
the reference's modeled defaults, so its times are model outputs.  The
paper's fabric controller aggregates gradients as 512-bit flits
streaming through a five-stage pipeline (decode -> align -> combine ->
majority/gate -> writeback).  Three lanes share the pipeline:

  * **G-Binary sign-count** — 1 wire bit/element; per-flit popcount of
    worker sign votes into the running count.
  * **G-Ternary gated**     — sign + zero-mask bits; the 2-of-3 zero
    gate adds a gate-word fetch per flit (modelled as stall cycles).
  * **FP32 bypass**         — 32 bits/element forwarded around the
    majority stage (warm-up / head traffic); no reduction work but the
    full 32x flit count.

:class:`FlitPipeline` turns an (n_elements, mode, num_workers) launch
into cycles — pipeline fill + one initiation interval per flit + stall
cycles — and seconds at the fabric clock.  ``miss_stall_cycles`` models
the full LLC-miss regime (paper Section 5): every flit's operand fetch
misses the fabric-side cache and stalls the pipeline for the memory
round-trip, which is how the paper's "<= 1.67% exposed in the full-miss
regime" scenario is reproduced by the simulator.

Any object with a ``t_agg(n_elements, num_workers)`` method (e.g. the
analytic :class:`repro_torch.core.exposure.TpuDatapathModel`) can stand in
for the pipeline in the trace driver — that substitution is exactly how
sim-vs-analytic validation closes the loop.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.modes import AggregationMode, bits_per_element
from ..fabric.codecs import CodecLane

#: Datapath flit width (bits) — the paper's 512-bit CXL-side datapath.
FLIT_BITS = 512

#: Pipeline depth — the paper's five-cycle datapath.
PIPELINE_STAGES = 5

#: Per-codec lane behaviour inside the shared flit pipeline — one
#: dataclass serves both layers: codecs declare their lane as a
#: :class:`~repro_torch.fabric.codecs.CodecLane` and the pipeline consumes it
#: directly; ``LaneSpec`` is the sim-side name for the same type.
LaneSpec = CodecLane


@dataclasses.dataclass(frozen=True)
class FlitPipeline:
    """The 5-stage 512-bit flit pipeline, in cycles and seconds.

    ``worker_ports`` is how many workers' flits the combine stage merges
    per cycle; with ``num_workers > worker_ports`` the initiation
    interval grows by ``ceil(W / worker_ports)`` (the vote fan-in is
    serialized over the ports).  ``miss_stall_cycles`` adds a fixed
    per-flit stall for the full LLC-miss regime.
    """
    clock_hz: float = 1.5e9
    flit_bits: int = FLIT_BITS
    stages: int = PIPELINE_STAGES
    worker_ports: int = 64
    miss_stall_cycles: float = 0.0
    #: pipeline fills charged to a lane whose codec does *not* fuse its
    #: encode -> combine -> decode chain into one kernel
    #: (``CodecLane.fused=False``): each staged pass re-fills the
    #: pipeline.  Every built-in lane is fused, so the default model is
    #: unchanged; only a deliberately-unfused custom lane pays it.
    unfused_passes: int = 4

    def lane(self, mode: AggregationMode | str) -> LaneSpec:
        """Lane descriptor for a codec name — from the codec registry.

        A registered codec's :class:`~repro_torch.fabric.codecs.CodecLane`
        rides the pipeline directly (so new codecs time correctly with
        no edits here).  Unregistered names raise the registry's
        canonical KeyError — the same error :meth:`flits` hits through
        ``bits_per_element`` — rather than silently timing on a
        fallback lane.
        """
        from ..fabric.codecs import get_codec
        return get_codec(mode).lane

    def flits(self, n_elements: int, mode: AggregationMode | str) -> int:
        """512-bit flits needed for one launch's wire payload."""
        bits = n_elements * bits_per_element(mode)
        return max(1, math.ceil(bits / self.flit_bits))

    def cycles(self, n_elements: int, num_workers: int,
               mode: AggregationMode | str = AggregationMode.G_BINARY,
               ) -> dict[str, float]:
        """Cycle breakdown: fill + steady-state issue + stalls."""
        lane = self.lane(mode)
        flits = self.flits(n_elements, mode)
        fanin = max(1, math.ceil(num_workers / self.worker_ports))
        ii = lane.initiation_interval * fanin
        stall = (lane.stall_cycles_per_flit + self.miss_stall_cycles)
        fills = 1 if lane.fused else self.unfused_passes
        return {
            "flits": float(flits),
            "fill_cycles": float(self.stages * fills),
            "issue_cycles": (flits - 1) * ii + 1.0,
            "stall_cycles": flits * stall,
            "initiation_interval": ii,
        }

    def t_agg(self, n_elements: int, num_workers: int,
              mode: AggregationMode | str = AggregationMode.G_BINARY,
              ) -> float:
        """Seconds of datapath time for one launch of ``n_elements``."""
        c = self.cycles(n_elements, num_workers, mode)
        total = c["fill_cycles"] + c["issue_cycles"] + c["stall_cycles"]
        return total / self.clock_hz

    def throughput_bytes_per_s(self, mode=AggregationMode.G_BINARY,
                               num_workers: int = 1) -> float:
        """Steady-state wire-payload drain rate of the pipeline."""
        lane = self.lane(mode)
        fanin = max(1, math.ceil(num_workers / self.worker_ports))
        cycles_per_flit = (lane.initiation_interval * fanin
                           + lane.stall_cycles_per_flit
                           + self.miss_stall_cycles)
        return (self.flit_bits / 8) * self.clock_hz / cycles_per_flit


def datapath_time(datapath, n_elements: int, num_workers: int,
                  mode: AggregationMode | str) -> float:
    """``t_agg`` of any datapath model, mode-aware when supported.

    :class:`FlitPipeline` takes the mode (its lanes differ);
    analytic stand-ins like
    :class:`repro_torch.core.exposure.TpuDatapathModel` only see
    ``(n_elements, num_workers)`` — exactly the substitution the
    sim-vs-analytic validation tests rely on.
    """
    try:
        return float(datapath.t_agg(n_elements, num_workers, mode))
    except TypeError:
        return float(datapath.t_agg(n_elements, num_workers))
