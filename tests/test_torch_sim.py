"""The port's simulator and analytic models against the reference's.

  * the engine's FIFO order and the topology registry round trip;
  * the flit pipeline's lanes, stalls and worker fan-in, equal to the
    reference's pipeline (``==``) for every registered codec;
  * ``SimReport.to_jsonable()`` equal (``==``) to the reference's for the
    paper's operating points and for the SMOKE configs' layouts on all
    four topologies, both sides on the same shapes (``init_params(cfg,
    device="meta")`` and ``jax.eval_shape``);
  * ``Fabric.simulate`` on ``multihop`` with per-hop links;
  * the sim against the analytic models within the reference's 1%
    (``tests/test_sim.py``, ``tests/test_hierarchical.py``);
  * ``ExposureModel``, ``envelope_sweep``, ``IciModel``,
    ``MultiHopModel``, the modeled layout times and
    ``Predictor.forecast`` equal to the reference's.

The sim is plain Python float arithmetic in the reference's order, so
equality is exact, not within a tolerance.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import sim as jsim  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import Predictor as JPredictor  # noqa: E402
from repro.core import exposure as jexposure  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode,  # noqa: E402
                              ExposureModel, IciModel, MultiHopModel,
                              Predictor, Schedule, envelope_sweep,
                              hop_wire_bytes_per_device,
                              modeled_comm_time, modeled_layout_comm_time,
                              modeled_layout_multihop_time, plan_buckets,
                              resolve_policies)
from repro_torch.fabric import Fabric, available_codecs, plan_presets  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.sim import (FlitPipeline, LaunchSpec,  # noqa: E402
                             PAPER_EXPOSED_BOUND_PCT, available_topologies,
                             get_topology, register_topology,
                             simulate_launches, simulate_layout,
                             unregister_topology)
from repro_torch.sim.engine import Engine, Resource  # noqa: E402

REL_TOL = 0.01      # the reference's sim-vs-analytic bar
TOPOLOGIES = ["cxl_direct", "cxl_switched", "ici_ring", "multihop"]
#: presets whose layouts the sim replays: packed votes, a hop plan, a
#: mean codec
PRESETS = ["gbin_packed", "hier_fp32_gbinary", "int4_backbone"]


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _params(leaves=6, n=1 << 18):
    """The reference's ``tests/test_sim.py`` tree, as meta tensors and as
    ShapeDtypeStructs."""
    shapes = {"backbone": {f"w{i}": (n,) for i in range(leaves)},
              "head": {"w": (n, 4)}}
    port = {g: {k: _meta(s) for k, s in d.items()} for g, d in shapes.items()}
    ref = {g: {k: jax.ShapeDtypeStruct(s, "float32") for k, s in d.items()}
           for g, d in shapes.items()}
    return port, ref


@pytest.fixture(scope="module")
def smoke_shapes():
    """Every SMOKE config's parameter shapes in both packages."""
    out = {}
    for arch in ARCH_IDS:
        jcfg = j_get_config(arch, smoke=True)
        out[arch] = (init_params(get_config(arch, smoke=True),
                                 device="meta"),
                     jax.eval_shape(
                         lambda c=jcfg: j_init_params(jax.random.PRNGKey(0),
                                                      c)))
    return out


# ---------------------------------------------------------------------------
# engine and registry
# ---------------------------------------------------------------------------

def test_engine_orders_events_and_resources_fifo():
    eng = Engine()
    order = []
    eng.at(2.0, lambda: order.append("late"))
    eng.at(1.0, lambda: order.append("early"))
    eng.at(1.0, lambda: order.append("early2"))   # a tie: scheduling order
    res = Resource("link", eng)
    grants = []
    res.request(0.0, 3.0, lambda s, e: grants.append((s, e)))
    res.request(1.0, 2.0, lambda s, e: grants.append((s, e)))
    eng.run()
    assert order == ["early", "early2", "late"]
    assert grants == [(0.0, 3.0), (3.0, 5.0)]     # queued behind the first
    assert res.stats.busy_s == 5.0
    assert res.stats.queue_delay_s == 2.0
    assert eng.events_processed == 5


def test_builtin_topologies_registered():
    assert set(TOPOLOGIES) <= set(available_topologies())
    assert available_topologies() == jsim.available_topologies()


def test_register_unregister_roundtrip():
    @register_topology("test_bus")
    @dataclasses.dataclass(frozen=True)
    class Bus:
        name: str = "test_bus"
        bw: float = 1e9

        def route(self, wire_bytes, num_workers, index=0):
            return sim.Route(hops=(sim.Hop("bus", wire_bytes / self.bw),),
                             latency_s=0.0)

    try:
        assert "test_bus" in available_topologies()
        assert get_topology("test_bus", bw=2e9).bw == 2e9
        spec = LaunchSpec("x", AggregationMode.FP32, "psum", 1024, 2e9)
        rep = simulate_launches([spec], 4, topology="test_bus", bw=2e9)
        assert rep.topology == "test_bus"
        assert rep.launches[0].service_s == 1.0
        with pytest.raises(ValueError, match="already registered"):
            register_topology("test_bus")(Bus)
    finally:
        unregister_topology("test_bus")
    with pytest.raises(KeyError, match="unknown topology"):
        get_topology("test_bus")


def test_multihop_compresses_payload_per_hop():
    route = get_topology("multihop", hops=3, compression=0.5).route(1024.0, 8)
    assert [h.bytes for h in route.hops] == [1024.0, 512.0, 256.0]
    assert [h.link for h in route.hops] == ["hop0", "hop1", "hop2"]


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_topology_routes_equal_the_references(topology):
    for wb in (0.0, 1024.0, 3 * (8 << 20) / 8):
        for w in (1, 4, 32):
            got = get_topology(topology).route(wb, w)
            want = jsim.get_topology(topology).route(wb, w)
            assert [(h.link, h.hold_s, h.bytes) for h in got.hops] == \
                [(h.link, h.hold_s, h.bytes) for h in want.hops]
            assert got.latency_s == want.latency_s


# ---------------------------------------------------------------------------
# the flit pipeline
# ---------------------------------------------------------------------------

def test_flit_pipeline_lanes_and_stalls():
    dp = FlitPipeline()
    n, w = 1 << 20, 8
    binary = dp.t_agg(n, w, AggregationMode.G_BINARY)
    ternary = dp.t_agg(n, w, AggregationMode.G_TERNARY)
    fp32 = dp.t_agg(n, w, AggregationMode.FP32)
    assert ternary > binary          # the gate fetch stalls the pipeline
    assert fp32 > binary             # 32x the flits on the bypass lane
    assert FlitPipeline(miss_stall_cycles=2.0).t_agg(
        n, w, AggregationMode.G_BINARY) > binary
    assert dp.flits(n, AggregationMode.G_BINARY) == n // 512
    assert dp.flits(n, AggregationMode.FP32) == n * 32 // 512


def test_flit_pipeline_worker_fanin_serializes():
    dp = FlitPipeline(worker_ports=16)
    n = 1 << 20
    assert dp.t_agg(n, 64, "gbinary") > dp.t_agg(n, 16, "gbinary")
    assert dp.cycles(n, 64, "gbinary")["initiation_interval"] == 4.0


@pytest.mark.parametrize("mode", ["identity", "fp32", "gbinary", "gternary",
                                  "int4", "topk", "hier_fp32_gbinary",
                                  "hier_fp32_gternary", "hier_fp32_int4"])
def test_flit_pipeline_equals_the_references(mode):
    assert set(available_codecs()) >= {mode}
    for kw in ({}, {"miss_stall_cycles": 1.0}, {"worker_ports": 16},
               {"unfused_passes": 2}):
        got, want = FlitPipeline(**kw), jsim.FlitPipeline(**kw)
        assert dataclasses.asdict(got.lane(mode)) == \
            dataclasses.asdict(want.lane(mode))
        for n, w in ((1, 1), (1 << 20, 8), (12345, 64), (8 << 20, 33)):
            assert got.cycles(n, w, mode) == want.cycles(n, w, mode)
            assert got.t_agg(n, w, mode) == want.t_agg(n, w, mode)
        assert got.throughput_bytes_per_s(mode, 33) == \
            want.throughput_bytes_per_s(mode, 33)


def test_datapath_time_takes_either_model():
    tdm = jexposure.TpuDatapathModel()
    from repro_torch.core import TpuDatapathModel
    assert sim.datapath_time(TpuDatapathModel(), 1 << 20, 8, "gbinary") == \
        jsim.datapath_time(tdm, 1 << 20, 8, "gbinary")
    assert sim.datapath_time(FlitPipeline(), 1 << 20, 8, "gternary") == \
        jsim.datapath_time(jsim.FlitPipeline(), 1 << 20, 8, "gternary")


# ---------------------------------------------------------------------------
# SimReport JSON against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["full_miss", "bandwidth_pressure"])
def test_paper_operating_points_equal_the_references(name):
    got = sim.paper_operating_points()[name]
    want = jsim.paper_operating_points()[name]
    assert got.to_jsonable() == want.to_jsonable()
    assert got.summary() == want.summary()
    assert sim.PAPER_EXPOSED_BOUND_PCT == jsim.PAPER_EXPOSED_BOUND_PCT


def test_paper_full_miss_regime_exposed_but_bounded():
    rep = sim.paper_operating_points()["full_miss"]
    assert not rep.hidden
    assert 0.0 < rep.exposed_pct <= PAPER_EXPOSED_BOUND_PCT


def test_paper_bandwidth_pressure_fully_hidden():
    rep = sim.paper_operating_points()["bandwidth_pressure"]
    assert rep.hidden and rep.exposed_pct == 0.0
    assert all(rec.exposed_s == 0.0 for rec in rep.launches)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_smoke_layouts_simulate_as_the_references(smoke_shapes, topology,
                                                  preset):
    """Every SMOKE config's layout at W = 32 (the built-in hop plans'
    sizes (8, 4)), replayed with a 1 ms backward pass: the whole report,
    every launch record included, equals the reference's."""
    w = 32
    for arch, (like, jlike) in smoke_shapes.items():
        got = Fabric(num_workers=w).simulate(
            like, plan_presets()[preset], topology=topology,
            compute_time_s=1e-3)
        want = JFabric(dp_axes=("w",), num_workers=w).simulate(
            jlike, j_plan_presets()[preset], topology=topology,
            compute_time_s=1e-3)
        assert got.to_jsonable() == want.to_jsonable(), (arch, preset)
        json.dumps(got.to_jsonable())


def test_fabric_simulate_multihop_reports_per_hop_links():
    like = {"backbone": {"w1": _meta((4096,))}}
    jlike = {"backbone": {"w1": jax.ShapeDtypeStruct((4096,), "float32")}}
    plan = AdmissionPlan.lowbit_all("hier_fp32_gbinary")
    rep = Fabric(num_workers=32).simulate(like, plan, topology="multihop")
    assert {"hop0", "hop1"} <= set(rep.link_utilization)
    assert rep.launches[0].links == ("hop0", "hop1")
    from repro.core import AdmissionPlan as JPlan
    want = JFabric(dp_axes=("w",), num_workers=32).simulate(
        jlike, JPlan.lowbit_all("hier_fp32_gbinary"), topology="multihop")
    assert rep.to_jsonable() == want.to_jsonable()


def test_sim_report_feeds_telemetry():
    like, _ = _params(leaves=2)
    rep = Fabric(num_workers=4).simulate(like, AdmissionPlan.fp32_all(),
                                         compute_time_s=1e-3)
    t = rep.telemetry(step=7, loss=3.25)
    assert (t.step, t.loss, t.step_time_s) == (7, 3.25, rep.step_time_s)


def test_fabric_simulate_checks_ready_times_and_topology():
    like, _ = _params(leaves=2)
    fabric = Fabric(num_workers=8)
    plan = AdmissionPlan.fp32_all()
    launches = fabric.layout_for(like, plan).num_launches
    with pytest.raises(ValueError, match="ready times"):
        fabric.simulate(like, plan, ready_times=[0.0] * (launches + 1))
    with pytest.raises(KeyError, match="unknown topology"):
        fabric.simulate(like, plan, topology="warp_drive")


# ---------------------------------------------------------------------------
# the sim against the analytic models (the reference's 1% bar)
# ---------------------------------------------------------------------------

def _quiet_ici(link_bw):
    return IciModel(link_bytes_per_s=link_bw, hop_latency_s=0.0,
                    launch_overhead_s=0.0)


@pytest.mark.parametrize("overlap", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("wire_bytes", [1024.0, 3 * (8 << 20) / 8])
def test_degenerate_exposed_matches_exposure_model(overlap, wire_bytes):
    n, w = 8 << 20, 32
    model = ExposureModel(overlap_fraction=overlap)
    ref = model.exposed(n, w, wire_bytes)
    spec = LaunchSpec("b", AggregationMode.G_BINARY, "vote_psum", n,
                      wire_bytes)
    rep = simulate_launches([spec], w, topology="ici_ring",
                            datapath=model.datapath,
                            overlap_fraction=overlap,
                            ici=_quiet_ici(model.link_bw))
    if ref["t_exposed_s"] == 0.0:
        assert rep.launches[0].exposed_s == 0.0 and rep.hidden
    else:
        assert rep.launches[0].exposed_s == pytest.approx(
            ref["t_exposed_s"], rel=REL_TOL)
    assert rep.launches[0].t_agg_s == pytest.approx(ref["t_agg_s"],
                                                    rel=REL_TOL)


@pytest.mark.parametrize("overlap", [1.0, 0.5])
def test_degenerate_exposed_matches_analytic_with_hop_latency(overlap):
    n, w, wire_bytes = 8 << 20, 32, 1024.0
    model = ExposureModel(overlap_fraction=overlap)
    ici = IciModel(link_bytes_per_s=model.link_bw)
    latency = 2 * (w - 1) * ici.hop_latency_s + ici.launch_overhead_s
    ref = model.exposed(n, w, wire_bytes, extra_service_s=latency)
    rep = simulate_launches(
        [LaunchSpec("b", AggregationMode.G_BINARY, "vote_psum", n,
                    wire_bytes)], w, topology="ici_ring",
        datapath=model.datapath, overlap_fraction=overlap, ici=ici)
    if ref["t_exposed_s"] == 0.0:
        assert rep.launches[0].exposed_s == 0.0
    else:
        assert rep.launches[0].exposed_s == pytest.approx(
            ref["t_exposed_s"], rel=REL_TOL)


@pytest.mark.parametrize("num_workers", [2, 8, 32])
def test_degenerate_collective_matches_ici_model(num_workers):
    n = 4 << 20
    ici = IciModel()
    wire_bytes = 3 * n / 8
    ref = ici.collective_time(wire_bytes, num_workers, num_launches=1)
    rep = simulate_launches(
        [LaunchSpec("b", AggregationMode.G_BINARY, "packed_a2a", n,
                    wire_bytes)], num_workers, topology="ici_ring",
        datapath=None, ici=ici)
    assert rep.launches[0].collective_s == pytest.approx(ref, rel=REL_TOL)


def test_layout_sim_bracketed_by_analytic_launch_model():
    w = 8
    like, _ = _params()
    plan = AdmissionPlan.lowbit_all(AggregationMode.G_BINARY,
                                    schedule=Schedule.PACKED_A2A)
    layout = plan_buckets(like, resolve_policies(like, plan),
                          bucket_bytes=1 << 20)
    assert layout.num_launches > 1
    ici = IciModel()
    serial = modeled_layout_comm_time(layout, w, ici)
    rep = simulate_layout(layout, w, topology="ici_ring", datapath=None,
                          ici=ici)
    bw_sum = sum(rec.service_s for rec in rep.launches)
    assert bw_sum + rep.launches[0].latency_s <= rep.step_time_s
    assert rep.step_time_s <= serial * (1 + REL_TOL)
    assert any(rec.queue_delay_s > 0 for rec in rep.launches[1:])
    assert all(0.0 <= u <= 1.0 for u in rep.link_utilization.values())


def test_multihop_sim_matches_analytic_model_single_launch():
    n, w = 1 << 20, 32
    legs = hop_wire_bytes_per_device(n, "hier_fp32_gbinary", "hierarchical",
                                     w)
    spec = LaunchSpec("b", "hier_fp32_gbinary", "hierarchical", n,
                      float(sum(legs)), hop_bytes=tuple(legs))
    rep = simulate_launches([spec], w, topology="multihop", datapath=None)
    assert rep.launches[0].links == ("hop0", "hop1")
    ref = MultiHopModel().route_time(legs, num_launches=1)
    assert rep.launches[0].collective_s == pytest.approx(ref, rel=REL_TOL)


def test_layout_specs_carry_hop_bytes_and_match_layout_model():
    w = 32
    like = {"p": _meta((1 << 16,))}
    plan = AdmissionPlan.lowbit_all("hier_fp32_gbinary")
    layout = plan_buckets(like, resolve_policies(like, plan))
    specs = sim.layout_launch_specs(layout, w)
    legs = hop_wire_bytes_per_device(1 << 16, "hier_fp32_gbinary",
                                     "hierarchical", w)
    assert len(specs) == 1 and specs[0].hop_bytes == tuple(legs)
    assert specs[0].wire_bytes == sum(legs)
    rep = simulate_launches(specs, w, topology="multihop", datapath=None)
    assert rep.launches[0].collective_s == pytest.approx(
        modeled_layout_multihop_time(layout, w), rel=REL_TOL)
    flat = plan_buckets(like, resolve_policies(
        like, AdmissionPlan.lowbit_all("gbinary")))
    assert all(s.hop_bytes is None
               for s in sim.layout_launch_specs(flat, 8))


# ---------------------------------------------------------------------------
# the analytic models against the reference's
# ---------------------------------------------------------------------------

def test_exposure_model_equals_the_references():
    for overlap in (1.0, 0.5, 0.0):
        got = ExposureModel(overlap_fraction=overlap)
        want = jexposure.ExposureModel(overlap_fraction=overlap)
        for n, w, wb, extra in ((8 << 20, 32, 3 * (8 << 20) / 8, 0.0),
                                (1 << 20, 8, 1024.0, 5e-6),
                                (1 << 20, 8, 0.0, 0.0), (1, 1, 0.0, 0.0)):
            assert got.exposed(n, w, wb, extra) == \
                want.exposed(n, w, wb, extra)
        for mode, sched in (("gbinary", "packed_a2a"), ("gternary",
                                                        "vote_psum"),
                            ("int4", "psum"), ("hier_fp32_gbinary",
                                               "hierarchical")):
            assert got.exposed_launch(1 << 20, 32, mode, sched) == \
                want.exposed_launch(1 << 20, 32, mode, sched)


def test_envelope_sweep_equals_the_references():
    assert envelope_sweep() == jexposure.envelope_sweep()
    assert envelope_sweep(1 << 20, 8, 12345.0) == \
        jexposure.envelope_sweep(1 << 20, 8, 12345.0)


def test_ici_and_multihop_models_equal_the_references():
    for kw in ({}, {"link_bytes_per_s": 25e9, "links_per_chip": 2.0}):
        got, want = IciModel(**kw), jtraffic.IciModel(**kw)
        for b, w, k in ((0.0, 1, 1), (1e6, 4, 1), (3e9, 32, 7)):
            assert got.collective_time(b, w, k) == \
                want.collective_time(b, w, k)
    for legs in ((1e6,), (1e6, 2.5e5), (0.0, 0.0, 1.0)):
        assert MultiHopModel().route_time(legs, 3) == \
            jtraffic.MultiHopModel().route_time(legs, 3)
    for mode, sched in (("fp32", "psum"), ("gbinary", "packed_a2a"),
                        ("hier_fp32_int4", "hierarchical")):
        for w in (1, 4, 32):
            assert modeled_comm_time(1 << 20, mode, sched, w, num_launches=2) \
                == jtraffic.modeled_comm_time(1 << 20, mode, sched, w,
                                              num_launches=2)
    assert (jtraffic.GPT2_XL_PARAMS, jtraffic.BERT_LARGE_PARAMS,
            jtraffic.GPT3_PARAMS) == (1_557_611_200, 340_000_000,
                                      175_000_000_000)
    from repro_torch.core import traffic
    assert traffic.GPT2_XL_PARAMS == jtraffic.GPT2_XL_PARAMS
    assert traffic.BERT_LARGE_PARAMS == jtraffic.BERT_LARGE_PARAMS
    assert traffic.GPT3_PARAMS == jtraffic.GPT3_PARAMS


@pytest.mark.parametrize("preset", PRESETS + ["fp32", "gter_vote",
                                              "topk_backbone",
                                              "hier_fp32_gternary"])
def test_layout_times_and_forecasts_equal_the_references(smoke_shapes,
                                                         preset):
    for arch, (like, jlike) in smoke_shapes.items():
        for w in (4, 32):
            fab = Fabric(num_workers=w, bucket_bytes=1 << 16)
            jfab = JFabric(dp_axes=("w",), num_workers=w,
                           bucket_bytes=1 << 16)
            lay = fab.layout_for(like, plan_presets()[preset])
            jlay = jfab.layout_for(jlike, j_plan_presets()[preset])
            assert modeled_layout_comm_time(lay, w) == \
                jtraffic.modeled_layout_comm_time(jlay, w), (arch, preset)
            assert modeled_layout_multihop_time(lay, w) == \
                jtraffic.modeled_layout_multihop_time(jlay, w)
            got = Predictor(w).forecast(fab.group_sizes(like),
                                        plan_presets()[preset])
            want = JPredictor(w).forecast(jfab.group_sizes(jlike),
                                          j_plan_presets()[preset])
            assert got == want, (arch, preset, w)
