"""The span readers: the attribution of device events to the port's
spans, the idle gaps named by span, each span metric on a synthetic
trace, and a CPU run of ``phases.py`` at test size."""
import json

import pytest

from fabric_bench import phases
from fabric_bench.spans import (NO_SPAN, Segments, SpanTrace, attribute,
                                idle_gaps, idle_outside, phase_ms)
from fabric_bench.spec import load_cell, metric_reader
from fabric_bench.tests.tiny import REPO, make_root

torch = pytest.importorskip("torch")

from repro_torch.core.spans import Count, Record, Span  # noqa: E402

MAIN, AUTOGRAD = 11, 22
MS = 1_000_000


def _spans():
    """One step: a forward with an attention, a backward whose kernels
    autograd's thread launches (recomputing the attention there), a MoE
    call with its experts, and the aggregate; all in milliseconds."""
    return [
        Span("trainer.step", 0 * MS, 100 * MS, MAIN, None, 4),       # 0
        Span("fabric.forward", 10 * MS, 30 * MS, MAIN, 0, 4),        # 1
        Span("model.attention", 12 * MS, 16 * MS, MAIN, 1, 4),       # 2
        Span("model.moe", 18 * MS, 28 * MS, MAIN, 1, 4),             # 3
        Span("model.moe.experts", 20 * MS, 24 * MS, MAIN, 3, 4),     # 4
        Span("fabric.backward", 30 * MS, 60 * MS, MAIN, 0, 4),       # 5
        Span("model.attention", 35 * MS, 40 * MS, AUTOGRAD, None, 4),  # 6
        Span("fabric.aggregate", 60 * MS, 80 * MS, MAIN, 0, 4),      # 7
    ]


# (correlation id, runtime call's start, device start, device end), ms
_LAUNCHES = [(1, 11, 11.5, 12),      # forward, outside attention
             (2, 13, 13.5, 15),      # forward > attention
             (3, 19, 30, 31),        # forward > moe, self (runs late)
             (4, 21, 31, 33),        # forward > moe > experts
             (5, 36, 36.5, 38),      # backward + autograd's attention
             (6, 45, 46, 50),        # backward alone
             (7, 61, 62, 70),        # aggregate
             (8, 90, 91, 92),        # the step, no phase
             (9, 150, 151, 152)]     # after the step: no span


def _attributed():
    calls = {c: t * MS for c, t, _, _ in _LAUNCHES}
    events = [(int(a * MS), int(b * MS), c) for c, _, a, b in _LAUNCHES]
    events.append((200 * MS, 201 * MS, 99))       # no call carries it
    return attribute(_spans(), calls, events)


def test_an_event_belongs_to_every_span_open_at_its_call_on_any_thread():
    inclusive, own, under = _attributed()
    ms = {k: round(v * 1e3, 6) for k, v in inclusive.items()}
    assert ms == {"trainer.step": 0.5 + 1.5 + 1 + 2 + 1.5 + 4 + 8 + 1,
                  "fabric.forward": 0.5 + 1.5 + 1 + 2,
                  "model.attention": 1.5 + 1.5,
                  "model.moe": 1 + 2, "model.moe.experts": 2,
                  "fabric.backward": 1.5 + 4, "fabric.aggregate": 8}
    selfs = {k: round(v * 1e3, 6) for k, v in own.items()}
    assert selfs["model.moe"] == 1                 # the experts' 2 left out
    assert selfs["fabric.forward"] == 0.5          # its children left out
    assert selfs["trainer.step"] == 1              # no phase open
    assert selfs["fabric.backward"] == 4 + 1.5   # autograd's span: no child
    assert under[4] == {"trainer.step", "fabric.backward", "model.attention"}
    assert under[8] == frozenset() and under[9] is None


def test_an_idle_gap_is_named_by_the_innermost_span_then_the_call():
    seg = Segments(_spans())
    assert seg.innermost(37 * MS) == "model.attention"  # autograd's, newer
    assert seg.innermost(22 * MS) == "model.moe.experts"
    assert seg.innermost(100 * MS) == NO_SPAN           # [start, end)
    busy = [(0, int(10.5 * MS)), (int(11.5 * MS), 20 * MS),
            (21 * MS, 22 * MS), (120 * MS, 121 * MS)]
    host = [(int(12.5 * MS), int(12.6 * MS), "cudaLaunchKernel")]
    assert idle_gaps(busy, seg, host, top=2) == [
        ("fabric.aggregate > host, between CUDA calls", pytest.approx(0.098)),
        ("fabric.forward > host, between CUDA calls", pytest.approx(0.001))]
    host = [(int(10.9 * MS), int(11.1 * MS), "cudaMemcpyAsync")]
    assert idle_gaps(busy[:2], seg, host) == [
        ("fabric.forward > cudaMemcpyAsync", pytest.approx(0.001))]


def test_loop_idle_is_device_idle_outside_the_steps():
    steps = [Span("trainer.step", 10, 20, MAIN, None, 0),
             Span("trainer.step", 30, 40, MAIN, None, 1),
             Span("trainer.batch", 20, 25, MAIN, None, 1)]
    busy = [(12, 18), (22, 24), (33, 45)]
    # window 0..50: idle outside a step is 0-10, 20-22, 24-30, 45-50
    assert idle_outside(busy, steps, "trainer.step", 0, 50) == 10 + 2 + 6 + 5


def _trace(cell, **kw):
    base = dict(cell=cell, steps=2, window_s=1.0, busy_s=0.9, kernels={},
                port={}, launch_calls=0, idle_gaps=[], device_kind="cpu")
    return SpanTrace(**base, **kw)


@pytest.fixture(scope="module")
def cell():
    return load_cell(REPO, "dsmoe16b_l4.gbin_packed.s4096")


def test_each_span_metric_reads_its_spans_and_counters(cell):
    spans = _spans()
    rec = Record(spans=spans, counts=[
        Count("collective.all_to_all.bytes", 3 * 2 ** 20, 7),
        Count("collective.all_gather.bytes", 2 ** 20, 7),
        Count("collective.all_reduce.bytes", 2 ** 19, 7),
        Count("collective.all_reduce.bytes", 4, 0),    # the loss, outside
        Count("moe.slots", 7680, 3)], device={"moe.slots_filled": 6000})
    inclusive, own, _ = _attributed()
    t = _trace(cell, record=rec, inclusive=inclusive, self_time=own,
               loop_idle_s=0.004)
    want = {"forward_ms": 5 / 2, "backward_ms": 5.5 / 2,
            "grad_stack_ms": None, "aggregate_ms": 8 / 2,
            "agg_norm_ms": None, "optimizer_ms": None,
            "attention_ms": 3 / 2, "moe_routing_ms": 1 / 2,
            "moe_slot_fill_pct": 100 * 6000 / 7680,
            "exchange_bytes_per_step": 4.5 / 2, "loop_idle_ms": 2.0}
    assert set(want) == set(phases.SPAN_METRICS)
    for name, value in want.items():
        got = metric_reader(cell, name)(t)
        assert got == (None if value is None else pytest.approx(value)), name


def test_no_span_metric_reads_a_trace_without_the_recorder(cell):
    from fabric_bench.trace import Trace
    t = Trace(cell=cell, steps=2, window_s=1.0, busy_s=0.9, kernels={},
              port={}, launch_calls=0, idle_gaps=[], device_kind="cpu")
    for name in phases.SPAN_METRICS:
        assert metric_reader(cell, name)(t) is None, name
    assert phase_ms(_trace(cell), "fabric.forward") is None


@pytest.mark.parametrize("workload", ["sc2_15b_l4.gbin_packed.s2048",
                                      "dsmoe16b_l4.gbin_packed.s4096"])
def test_a_cpu_run_reads_the_counters_and_no_device_time(workload, tmp_path,
                                                        capsys):
    root = make_root(tmp_path)
    assert phases.main(["--workload", workload, "--seed", "3000000019"],
                       root=root, device="cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = out["metrics"]
    want = {"exchange_bytes_per_step"}
    if workload.startswith("dsmoe"):
        want.add("moe_slot_fill_pct")
        assert 0 < got["moe_slot_fill_pct"]["value"] <= 100
    assert set(got) == want
    assert got["exchange_bytes_per_step"]["unit"] == "MiB/step"
    assert out["steps"] == load_cell(root, workload).traffic["trace_steps"]
    assert out["coverage_pct"] is None
