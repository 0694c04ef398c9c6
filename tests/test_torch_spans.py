"""The span recorder (``repro_torch.core.spans``) and its sites in the
train step, on the SMOKE configs with W = 4 virtual workers:

  * off, a step records nothing, and its losses, parameters and moments
    are bit for bit those of a step with the recorder on;
  * on, a dense and a MoE step record each phase's span with its parent
    and step, W of each worker span, and ``model.attention`` once a
    layer and worker (twice under ``remat``: the recompute);
  * ``moe.slots_filled`` equals a recount of the routing's kept choices;
  * ``VirtualGroup`` tells its observers one rank's input, as a
    ``DistributedGroup`` process counts it;
  * the bytes a step exchanges under ``fabric.aggregate`` are those of
    its bucket layout, and fewer under ``gbin_packed`` than under FP32;
  * ``launch/profile.py``'s busy share is the union of the device's
    intervals.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DistributedGroup, VirtualGroup  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import Fabric, plan_presets  # noqa: E402
from repro_torch.kernels.ref import LANE, TILE  # noqa: E402
from repro_torch.launch.profile import span_totals, union_ns  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402

W = 4
ARCHS = {"dense": "starcoder2_15b", "moe": "deepseek_moe_16b"}
WORKER_SPANS = ("fabric.forward", "fabric.backward", "fabric.grad_stack")
STEP_SPANS = WORKER_SPANS + ("fabric.aggregate", "fabric.agg_norm",
                             "optim.apply")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's SMOKE shapes (more gain
    nothing, and the suite's workers share the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def trainer(kind: str, plan: str = "gbin_packed", remat: bool = False):
    cfg = dataclasses.replace(get_config(ARCHS[kind], smoke=True),
                              remat=remat)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=32, batch=2 * W,
                             seed=3, learnable=False)
    return Trainer(cfg, AdamW(total_steps=10), data,
                   plan=plan_presets()[plan], fabric=Fabric(num_workers=W),
                   seed=0, device="cpu")


def state_tensors(tr) -> list:
    s = tr.state
    return [x for _, x in T.flatten(s.model.tree())] + \
        [x for _, x in T.flatten(s.opt.mu)] + \
        [x for _, x in T.flatten(s.opt.nu)]


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_off_records_nothing_and_on_gives_the_same_bits(kind):
    off = trainer(kind)
    off.run(2)
    rec = spans.take()
    assert rec.spans == [] and rec.counts == [] and rec.device == {}
    on = trainer(kind)
    spans.enable()
    on.run(2)
    spans.disable()
    assert spans.take().spans
    assert [h["loss"] for h in off.history] == \
        [h["loss"] for h in on.history]
    for a, b in zip(state_tensors(off), state_tensors(on), strict=True):
        assert torch.equal(a, b)


def _names(rec, i):
    """The names of span ``i`` and its ancestors, innermost first."""
    out = []
    while i is not None:
        out.append(rec.spans[i].name)
        i = rec.spans[i].parent
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_a_step_records_its_spans_with_parents_and_steps(kind, remat):
    tr = trainer(kind, remat=remat)
    tr.run(1)                        # builds the step, outside the record
    spans.enable()
    tr.run(3)
    spans.disable()
    rec = spans.take()
    cfg = tr.cfg
    by = {}
    for i, sp in enumerate(rec.spans):
        assert sp.end_ns is not None and sp.end_ns >= sp.start_ns
        by.setdefault((sp.name, sp.step), []).append(i)
    assert {s for _, s in by} == {1, 2}
    moe_layers = cfg.num_layers - cfg.moe.first_dense if kind == "moe" else 0
    twice = 2 if remat else 1
    for step in (1, 2):
        (batch,), (whole,) = by["trainer.batch", step], \
            by["trainer.step", step]
        assert rec.spans[batch].parent is None
        assert rec.spans[whole].parent is None
        assert rec.spans[batch].end_ns <= rec.spans[whole].start_ns
        for name in STEP_SPANS:
            got = by[name, step]
            assert len(got) == (W if name in WORKER_SPANS else 1), name
            assert all(rec.spans[i].parent == whole for i in got), name
        attn = by["model.attention", step]
        assert len(attn) == cfg.num_layers * W * twice
        where = sorted(_names(rec, i)[1] for i in attn)
        assert where.count("fabric.forward") == cfg.num_layers * W
        # the CPU's backward runs on the calling thread
        assert where.count("fabric.backward") == \
            cfg.num_layers * W * (twice - 1)
        moe = by.get(("model.moe", step), [])
        assert len(moe) == moe_layers * W * twice
        experts = by.get(("model.moe.experts", step), [])
        assert all(rec.spans[rec.spans[i].parent].name == "model.moe"
                   for i in experts)
        if kind == "moe":
            # routed and shared experts, a call (a recompute may stop
            # early, once the backward has what it saved)
            assert moe_layers * W * 2 <= len(experts) <= len(moe) * 2
    assert rec.counter("moe.slots") > 0 if kind == "moe" \
        else "moe.slots" not in {c.name for c in rec.counts}


def _recount_kept(x, router, moe) -> tuple[int, int]:
    """Kept choices and slots of one ``moe_forward`` call, recounted in
    numpy: each group's tokens take their top-k experts by softmax
    gate, choice by choice and token by token, while the expert has a
    free slot."""
    xs = x.reshape(-1, x.shape[-1]).double().numpy()
    logits = xs @ router.double().numpy()
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    order = np.argsort(-gates, axis=-1, kind="stable")[:, :moe.top_k]
    gs = min(moe.group_size, xs.shape[0])
    cap = min(max(4, int(gs * moe.top_k / moe.num_experts
                         * moe.capacity_factor)), gs)
    groups, kept = xs.shape[0] // gs, 0
    for g in range(groups):
        used = np.zeros(moe.num_experts, dtype=int)
        for i in range(moe.top_k):
            for tok in range(g * gs, (g + 1) * gs):
                e = order[tok, i]
                used[e] += 1
                kept += used[e] <= cap
    return kept, groups * moe.num_experts * cap


@pytest.mark.parametrize("skew", [0.0, 0.1])
def test_moe_slots_filled_equals_a_recount_of_the_routing(skew):
    cfg = get_config("deepseek_moe_16b", smoke=True)
    g = torch.Generator().manual_seed(5)
    p = L.init_moe(cfg, g, device="cpu")
    x = torch.randn(2, 64, cfg.d_model, generator=g)
    if skew:                                  # every token prefers expert 0
        x = x.abs()
        p["router"] = p["router"].clone()
        p["router"][:, 0] += skew
    kept, slots = _recount_kept(x, p["router"], cfg.moe)
    if skew:                                  # choices were dropped
        assert kept < x.shape[0] * x.shape[1] * cfg.moe.top_k
    spans.enable()
    L.moe_forward(p, x, cfg)
    rec = spans.take()
    assert rec.device["moe.slots_filled"] == kept
    assert rec.counter("moe.slots") == slots
    assert [s.name for s in rec.spans] == ["model.moe", "model.moe.experts",
                                           "model.moe.experts"]


def _per_rank_inputs():
    g = torch.Generator().manual_seed(1)
    return {"psum": torch.randn(10, generator=g),
            "all_reduce_mean": torch.randn(3, 5, generator=g).bfloat16(),
            "all_to_all": torch.randint(0, 9, (1, 2, LANE), generator=g,
                                        dtype=torch.int32),
            "all_gather": torch.randint(0, 9, (6, LANE), generator=g,
                                        dtype=torch.int32)}


@pytest.mark.parametrize("op", sorted(_per_rank_inputs()))
def test_virtual_group_counts_one_ranks_input_as_a_process_does(op, tmp_path):
    import torch.distributed as dist
    from repro_torch.core import collectives
    x = _per_rank_inputs()[op]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        dg = DistributedGroup(device="cpu")
        getattr(dg, op)(x[None])
        (kind, n), = dg.bytes_by_op.items()
        assert dg.calls_by_op == {kind: 1}
    finally:
        dist.destroy_process_group()
    if op == "all_to_all":
        # a rank sends one chunk to each of W ranks, where the one-rank
        # world sends one in all
        x = x.expand(W, *x.shape[1:]).contiguous()
        n *= W
    vg = VirtualGroup(W)
    seen = []
    collectives.COLLECTIVE_OBSERVERS.append(
        lambda grp, o, t: seen.append((grp, o, t.numel() * t.element_size())))
    try:
        getattr(vg, op)(x[None].expand(W, *x.shape))
    finally:
        collectives.COLLECTIVE_OBSERVERS.pop()
    assert seen == [(vg, kind, n)]


def _layout_bytes(layout, workers: int) -> int:
    """One rank's collective input bytes of an aggregation through
    ``layout``: an FP32 bucket's float32 mean, a packed vote's word
    shards to every owner and its two owner planes gathered back."""
    total = 0
    for b in layout.buckets:
        if b.key.schedule == "psum":
            total += 4 * b.size
        else:
            assert b.key.schedule == "packed_a2a", b.key
            rows = math.ceil(b.size / TILE)
            rw = math.ceil(rows / workers)
            total += 4 * LANE * rw * (workers + 2)
    assert not layout.unfused
    return total


def test_the_bytes_a_step_exchanges_follow_its_layout():
    got = {}
    for plan in ("gbin_packed", "fp32"):
        tr = trainer("dense", plan=plan)
        tr.run(1)
        spans.enable()
        tr.run(3)
        spans.disable()
        rec = spans.take()
        step = next(iter(tr.fabric._steps.values()))
        want = _layout_bytes(step.layout, W)
        got[plan] = sum(rec.counter(f"collective.{op}.bytes",
                                    under="fabric.aggregate")
                        for op in ("all_reduce", "all_to_all", "all_gather"))
        assert got[plan] == 2 * want, plan
        # the loss's mean is the one collective outside the aggregate
        assert rec.counter("collective.all_reduce.calls") - rec.counter(
            "collective.all_reduce.calls", under="fabric.aggregate") == 2
    assert got["gbin_packed"] < got["fp32"] / 2


def test_a_span_closes_on_an_exception_and_counts_stay_by_span():
    spans.enable()
    spans.at_step(7)
    with pytest.raises(RuntimeError):
        with spans.span("outer"):
            spans.count("n", 2)
            with spans.span("inner"):
                spans.count("n", 3)
                raise RuntimeError
    spans.count("n", 5)
    spans.count_device("d", torch.tensor(4))
    spans.count_device("d", torch.tensor(6))
    rec = spans.take()
    assert [(s.name, s.parent, s.step) for s in rec.spans] == \
        [("outer", None, 7), ("inner", 0, 7)]
    assert all(s.end_ns is not None for s in rec.spans)
    assert rec.counter("n") == 10
    assert rec.counter("n", under="outer") == 5
    assert rec.counter("n", under="inner") == 3
    assert rec.counter("d") == 10
    spans.disable()
    assert spans.span("x") is spans.span("y")       # off: one no-op
    spans.at_step(None)


def test_the_step_timer_is_its_span_on_the_epoch_clock():
    import time
    from repro_torch.runtime import StepTimer
    spans.enable()
    before = time.time_ns()
    with StepTimer() as t:
        time.sleep(0.002)
    after = time.time_ns()
    (sp,) = spans.take().spans
    assert sp.name == "trainer.step"
    # one reading: the duration is the span's length to the nanosecond
    assert sp.end_ns - sp.start_ns == round(t.duration * 1e9)
    # stamped on the monotonic clock and shifted onto the profiler's
    # epoch clock (the offset read once, within a millisecond)
    ms = 1_000_000
    assert before - ms <= sp.start_ns < sp.end_ns <= after + ms
    spans.disable()
    with StepTimer() as t:
        pass
    assert t.duration >= 0 and spans.take().spans == []


def test_threads_recording_at_once_lose_no_span_or_count():
    import sys
    import threading
    n_threads, n = 8, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()

    def work(k):
        for _ in range(n):
            with spans.span(f"outer{k}"):
                with spans.span(f"inner{k}"):
                    spans.count("n", 1)
                    spans.count_device("d", torch.tensor(1))

    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    rec = spans.take()
    assert len(rec.spans) == 2 * n_threads * n
    for sp in rec.spans:
        if sp.name.startswith("inner"):
            parent = rec.spans[sp.parent]
            assert parent.name == "outer" + sp.name[5:]
            assert parent.thread == sp.thread
        else:
            assert sp.parent is None
    assert rec.counter("n") == rec.counter("d") == n_threads * n
    assert all(rec.spans[c.span].name.startswith("inner")
               for c in rec.counts)


def test_profile_busy_share_is_the_union_and_spans_sum_by_name():
    assert union_ns([(0, 10), (5, 15), (20, 30), (21, 22)]) == 25
    assert union_ns([]) == 0
    spans.enable()
    for _ in range(2):
        with spans.span("a"):
            pass
    rec = spans.take()
    (n, ns), = span_totals(rec).values()
    assert n == 2 and ns == sum(s.end_ns - s.start_ns for s in rec.spans)
