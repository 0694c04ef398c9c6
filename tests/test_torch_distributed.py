"""The port's data parallelism across processes, on the CPU over gloo.

W = 2, 3 and 4 ranks are spawned once per W (``python -c`` with
``PYTHONPATH=src`` and the rank's env, a ``file://`` store in the test's
temporary directory, a 60 s timeout on every collective and a time limit
on every process).  Each rank runs every case of its W through
``DistributedGroup``; after the group is torn down, rank 0 runs the same
cases on ``VirtualGroup(W)`` (or ``Fabric(num_workers=W)``) in the same
process, so both sides run with the same thread settings.  The parent
compares:

  * the schedules on an unaligned leaf of ``32 * 128 * 2 + 77`` elements
    (vote_psum and packed_a2a, G-Binary and G-Ternary, fused and staged,
    per-leaf EF with its residual rows, int4 and top-k on psum, fp32,
    sign_of_mean): every rank's aggregate and EF row byte-equal to the
    virtual group's, FP32 means held to :func:`same_mean`; at W = 4 also
    to the reference's ``lowbit_vote_psum`` / ``lowbit_packed_a2a`` /
    ``fp32_allreduce`` / ``sign_of_mean`` under ``jax.shard_map`` on a
    4-device CPU mesh (a subprocess with a forced host device count);
  * a bucketed step on the smoke tree: worker gradients and aggregates
    as the virtual group's, and the group's traffic: one ``all_to_all``
    of the padded packed words and two ``all_gather`` per packed bucket,
    one ``all_reduce`` per FP32 bucket plus the loss;
  * that ``psum`` and ``all_reduce_mean`` leave their input unchanged;
  * the Trainer, on the reference's distributed-test config (2 layers,
    d 64, float32): gbin_packed as the virtual run, bit for bit at
    W = 2 and within the tolerance below at W = 4; the paper controller
    latching the same plans at the same steps on every rank, and the
    tuned controller too where the ranks' step times differ; an
    injected failure at step 12 of 18 restored and replayed to a
    bit-equal last loss; a fp32_all SGD-momentum checkpoint written at
    W = 4 restored at W = 2; error-feedback rows written at W = 4
    refused at W = 2; the EF checkpoint of W = 2 processes equal to the
    virtual run's; ``grad_accum=4`` against 1 under fp32_all.

FP32 means: gloo adds the ranks in its own order (at W >= 3 a third
order besides the virtual sum and the reference's), and a sum of ranks
keeps the sign of a zero sum, where the virtual sum starts from +0.0.
So FP32 means are compared as numbers (zeros as zeros) within
``(W - 1) * eps * sum|e| / W``, the bound two summation orders of W
float32 values keep; votes, EF rows and everything at W = 2 (one order
only) are compared byte for byte or as numbers where only zero signs
may part.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: seconds a spawn of W ranks may take before it is killed
SPAWN_TIMEOUT = 300
N = 32 * 128 * 2 + 77                    # deliberately unaligned
CASES = ("vote_psum/gbinary", "vote_psum/gternary",
         "packed_a2a/gbinary/fused", "packed_a2a/gternary/fused",
         "packed_a2a/gbinary/staged", "packed_a2a/gternary/staged",
         "packed_a2a/gbinary/fused/ef", "packed_a2a/gternary/staged/ef",
         "vote_psum/gbinary/ef")
MEAN_CASES = ("psum/int4", "psum/topk", "psum/fp32", "sign_of_mean")

RANK_PROGRAM = r'''
import json, os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
W, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT, SHARED = os.environ["OUT_DIR"], os.environ["SHARED_DIR"]
N = int(os.environ["LEAF_N"])
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=W, timeout=timedelta(seconds=60))

from repro_torch.checkpoint import restore_latest
from repro_torch.configs import get_config
from repro_torch.core import (AdmissionPlan, Commander, DistributedGroup,
                              LeafPolicy, Schedule, VirtualGroup,
                              fp32_allreduce, sign_of_mean, wire_schedule)
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMStream
from repro_torch.fabric import (AggregationContext, Fabric, aggregate_leaf,
                                get_codec, make_controller, plan_presets)
from repro_torch.models import ModelConfig, Transformer, init_params
from repro_torch.optim import AdamW, SgdMomentum
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig
import repro_torch.runtime.train as runtime_train

group = DistributedGroup(device="cpu")
arrays, info = {}, {}

# -- schedules on one unaligned leaf ----------------------------------------
rng = np.random.RandomState(0)
GS = torch.from_numpy(rng.randn(W, N).astype(np.float32))
EF = torch.from_numpy((0.1 * rng.randn(W, N)).astype(np.float32))
SCHEDULES = {
    "vote_psum/gbinary": ("gbinary", "vote_psum", True, False),
    "vote_psum/gternary": ("gternary", "vote_psum", True, False),
    "packed_a2a/gbinary/fused": ("gbinary", "packed_a2a", True, False),
    "packed_a2a/gternary/fused": ("gternary", "packed_a2a", True, False),
    "packed_a2a/gbinary/staged": ("gbinary", "packed_a2a", False, False),
    "packed_a2a/gternary/staged": ("gternary", "packed_a2a", False, False),
    "packed_a2a/gbinary/fused/ef": ("gbinary", "packed_a2a", True, True),
    "packed_a2a/gternary/staged/ef": ("gternary", "packed_a2a", False, True),
    "vote_psum/gbinary/ef": ("gbinary", "vote_psum", True, True),
    "psum/int4": ("int4", "psum", True, False),
    "psum/topk": ("topk", "psum", True, False),
    "psum/fp32": ("fp32", "psum", True, False),
}


def schedules(grp, rows, prefix):
    for name, (mode, sched, fused, ef) in SCHEDULES.items():
        ctx = AggregationContext(group=grp, num_workers=W,
                                 fused_kernels=fused)
        pol = LeafPolicy(mode, sched, gate_phase=1 if "gternary" in name
                         else 0, error_feedback=ef)
        u, e = aggregate_leaf(ctx, GS[rows].clone(), pol,
                              ef=EF[rows].clone() if ef else None)
        arrays[f"{prefix}{name}"] = u.numpy()
        if ef:
            arrays[f"{prefix}{name}/new_ef"] = e.numpy()
    arrays[f"{prefix}sign_of_mean"] = sign_of_mean(GS[rows].clone(),
                                                   grp).numpy()


schedules(group, slice(R, R + 1), "")

# -- psum and all_reduce_mean leave their input unchanged ------------------
for dt in (torch.float32, torch.bfloat16, torch.int32):
    x = (GS[R:R + 1] * 100).to(dt)
    keep = x.clone()
    for fn in (group.psum, group.all_reduce_mean):
        fn(x)
    if dt == torch.float32:
        fp32_allreduce(x, group)          # g.to(float32) is x itself
    info[f"inplace/{dt}"] = bool(torch.equal(x.view(torch.uint8),
                                             keep.view(torch.uint8)))

# -- a bucketed step on the smoke tree ---------------------------------------
SMOKE = get_config("qwen3_0p6b", smoke=True)
SMOKE_DATA = SyntheticLMStream(vocab=SMOKE.vocab_size, seq_len=16, batch=12,
                               seed=0)
TERNARY = AdmissionPlan.lowbit_backbone("gternary",
                                        schedule=Schedule.PACKED_A2A)
BUCKET_PLANS = {"gbin_packed": (plan_presets()["gbin_packed"], True, True),
                "gternary_staged": (TERNARY, True, False),
                "gbin_packed_ef_per_leaf":
                    (plan_presets(error_feedback=True)["gbin_packed"],
                     False, True)}


def bucketed(make_fabric, prefix):
    model = Transformer(SMOKE, device="cpu", seed=0)
    batch = {k: torch.as_tensor(v) for k, v in
             SMOKE_DATA.batch_at(0).items()}
    for name, (plan, fused, kern) in BUCKET_PLANS.items():
        fabric = make_fabric(fused, kern)
        grp = fabric.group
        if isinstance(grp, DistributedGroup):
            grp.reset_counts()
        grads, loss = fabric.worker_grads(model.tree(), batch, model.loss)
        like = T.map_leaves(lambda g: g[0], grads)
        ef = fabric.init_ef(like, fabric.resolve(like, plan))
        for k, (p, e) in enumerate(T.flatten(ef)):   # nonzero residuals
            if e.dim():
                full = 0.01 * torch.randn(
                    (W, *e.shape[1:]),
                    generator=torch.Generator().manual_seed(k))
                e.copy_(full[list(grp.rank())])
        agg, new_ef = fabric.aggregate(grads, plan, ef=ef)
        layout = fabric.layout_for(like, plan)
        info[f"{prefix}bucketed/{name}/votes"] = sorted(
            p for (p, _), pol in zip(T.flatten(like),
                                     T.leaves(fabric.resolve(like, plan)))
            if wire_schedule(pol.mode, pol.schedule) == "packed_a2a")
        arrays[f"{prefix}bucketed/{name}/loss"] = loss.numpy()
        for p, g in T.flatten(grads):
            arrays[f"{prefix}bucketed/{name}/grad/{p}"] = g.numpy()
        for p, u in T.flatten(agg):
            arrays[f"{prefix}bucketed/{name}/agg/{p}"] = u.numpy()
        for p, e in T.flatten(new_ef):
            arrays[f"{prefix}bucketed/{name}/ef/{p}"] = e.numpy()
        if isinstance(grp, DistributedGroup):
            pols = fabric.resolve(like, plan)
            launches = ([[k.schedule, n] for k, n in layout.launches()]
                        if fused else
                        [[wire_schedule(pol.mode, pol.schedule), x.numel()]
                         for x, pol in zip(T.leaves(like), T.leaves(pols))])
            info[f"bucketed/{name}/traffic"] = {
                "calls": dict(grp.calls_by_op),
                "bytes": dict(grp.bytes_by_op), "launches": launches}


bucketed(lambda fused, kern: Fabric(group=group, fused=fused,
                                    fused_kernels=kern), "")

# -- the Trainer --------------------------------------------------------------
CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                  dtype="float32", remat=False)
DATA = SyntheticLMStream(vocab=256, seq_len=32, batch=16, seed=0)
ADAM = AdamW(peak_lr=3e-3, warmup_steps=5, total_steps=100)

QUIET = TrainerConfig(log_interval=1000)


def dist_fabric():
    return Fabric(group=group)


def virt_fabric():
    return Fabric(num_workers=W)


def train(tag, make_fabric, steps, **kw):
    tr = Trainer(CFG, kw.pop("opt", ADAM), DATA, fabric=make_fabric(),
                 device="cpu", tcfg=kw.pop("tcfg", QUIET), **kw)
    tr.run(steps)
    info[f"{tag}/losses"] = [h["loss"] for h in tr.history]
    info[f"{tag}/plans"] = [h["plan"] for h in tr.history]
    info[f"{tag}/restarts"] = tr.restarts
    info[f"{tag}/step"] = tr.state.step
    for p, x in T.flatten(tr.state.model.tree()):
        arrays[f"{tag}/params/{p}"] = x.detach().numpy().copy()
    return tr


def paper(tag, make_fabric):
    ctl = make_controller("paper", warmup_steps=2,
                          commander=Commander(schedule=Schedule.PACKED_A2A))
    train(tag, make_fabric, 6, controller=ctl)
    info[f"{tag}/events"] = [[e.step, e.kind, e.plan_signature]
                             for e in ctl.events]


class SkewedTimer(runtime_train.StepTimer):
    """Rank 0's steps take no time, every other rank's 10 s: far
    outside any modeled step's band."""

    def __exit__(self, *exc):
        self.duration = 0.0 if R == 0 else 10.0


def tuned(tag):
    """The tuned controller on step times that differ by rank: the
    Trainer must hand every rank's controller the same (slowest) time."""
    fab = dist_fabric()
    art = fab.autotune(init_params(CFG, device="meta"))
    art.apply(fab)
    ctl = fab.attach_controller("tuned", tuned=art, patience=2)
    timer = runtime_train.StepTimer
    runtime_train.StepTimer = SkewedTimer
    try:
        train(tag, lambda: fab, 6)
    finally:
        runtime_train.StepTimer = timer
    info[f"{tag}/events"] = [[e.step, e.kind, e.plan_signature]
                             for e in ctl.events]


def ckpt_arrays(directory):
    step, got, extra = restore_latest(directory)
    for name, x in got.items():
        arrays[f"ckpt/{name}"] = x.numpy()
    info["ckpt/step"] = step


GBIN = plan_presets()["gbin_packed"]
GBIN_EF = plan_presets(error_feedback=True)["gbin_packed"]
FP32 = AdmissionPlan.fp32_all()
SGDM = SgdMomentum(peak_lr=1e-2)
EVERY5 = TrainerConfig(checkpoint_interval=5, log_interval=1000)



def stepwise(tag, steps):
    """The Trainer over the group, one step at a time; before each step
    the ranks' gradients (the step's own, recomputed) are gathered, so
    that rank 0 can aggregate the same gradients on VirtualGroup(W)."""
    tr = Trainer(CFG, ADAM, DATA, plan=GBIN, fabric=dist_fabric(),
                 device="cpu", tcfg=QUIET)
    tr.init_state()
    for k in range(steps):
        model = tr.state.model
        batch = {n: torch.as_tensor(v) for n, v in DATA.batch_at(k).items()}
        grads, _ = tr.fabric.worker_grads(model.tree(), batch, model.loss)
        for p, g in T.flatten(grads):           # (1, *shape) -> (W, *shape)
            arrays[f"{tag}/{k}/grads/{p}"] = group.all_gather(g[None]).numpy()
        tr.run(k + 1)
        for p, u in T.flatten(tr.last_aggregates):
            arrays[f"{tag}/{k}/agg/{p}"] = u.numpy()
    info[f"{tag}/losses"] = [h["loss"] for h in tr.history]
    for p, x in T.flatten(tr.state.model.tree()):
        arrays[f"{tag}/params/{p}"] = x.detach().numpy().copy()


if W == 4:
    stepwise("trainer", 6)
    for fail in (False, True):
        train(f"replay/{int(fail)}", dist_fabric, 18, plan=GBIN, tcfg=EVERY5,
              ckpt_dir=os.path.join(OUT, f"replay{int(fail)}"),
              failure_injector=FailureInjector(at_steps=[12]) if fail
              else None)
    train("elastic", dist_fabric, 10, plan=FP32, opt=SGDM, tcfg=EVERY5,
          ckpt_dir=os.path.join(SHARED, "elastic"))
    train("ef_write", dist_fabric, 1, plan=GBIN_EF,
          ckpt_dir=os.path.join(SHARED, "ef"))
    for ga in (1, 4):
        tr = Trainer(CFG, ADAM, DATA, plan=FP32, fabric=dist_fabric(),
                     device="cpu", tcfg=QUIET)
        st = tr.init_state()
        model = st.model
        step = tr.fabric.build_step(ADAM, FP32, model.tree(), model.loss,
                                    grad_accum=ga)
        for k in range(6):
            batch = {n: torch.as_tensor(v) for n, v in
                     DATA.batch_at(k).items()}
            st, m, _ = step(st, batch)
        info[f"grad_accum/{ga}"] = float(m["loss"])
if W == 2:
    train("trainer", dist_fabric, 6, plan=GBIN)
    paper("paper", dist_fabric)
    tuned("tuned")
    tr = train("elastic", dist_fabric, 10, plan=FP32, opt=SGDM, tcfg=EVERY5,
               ckpt_dir=os.path.join(SHARED, "elastic"))
    try:
        train("ef_mismatch", dist_fabric, 2, plan=GBIN_EF,
              ckpt_dir=os.path.join(SHARED, "ef"))
        info["ef_mismatch/error"] = None
    except ValueError as e:
        info["ef_mismatch/error"] = str(e)
    train("ef_ckpt", dist_fabric, 3, plan=GBIN_EF,
          ckpt_dir=os.path.join(OUT, "ef_dist"))
info["calls_total"] = sum(group.calls_by_op.values())
dist.barrier()
dist.destroy_process_group()

# -- the virtual group, in the same process ----------------------------------
if R == 0:
    V = VirtualGroup(W)
    schedules(V, slice(0, W), "virtual/")
    bucketed(lambda fused, kern: Fabric(num_workers=W, fused=fused,
                                        fused_kernels=kern), "virtual/")
    for name, (mode, *_rest) in SCHEDULES.items():
        if mode in ("int4", "topk"):
            codec = get_codec(mode)
            arrays[f"virtual/{name}/enc"] = codec.encode(
                AggregationContext(group=V, num_workers=W), GS.clone()).numpy()
    if W in (2, 4):
        train("virtual/trainer", virt_fabric, 6, plan=GBIN)
    if W == 4:
        fab = virt_fabric()
        for k in range(6):
            pre = f"trainer/{k}/grads/"
            grads = T.unflatten([(n[len(pre):], torch.from_numpy(x))
                                 for n, x in arrays.items()
                                 if n.startswith(pre)])
            for p, u in T.flatten(fab.aggregate(grads, GBIN)[0]):
                arrays[f"virtual/trainer/{k}/agg/{p}"] = u.numpy()
            info["virtual/trainer/votes"] = sorted(
                p for (p, _), pol in zip(
                    T.flatten(grads),
                    T.leaves(fab.resolve(T.map_leaves(lambda g: g[0], grads),
                                         GBIN)))
                if wire_schedule(pol.mode, pol.schedule) == "packed_a2a")
    if W == 2:
        paper("virtual/paper", virt_fabric)
        ckpt_arrays(os.path.join(OUT, "ef_dist"))
        for name in list(arrays):
            if name.startswith("ckpt/"):
                arrays["dist_" + name] = arrays.pop(name)
        train("virtual/ef_ckpt", virt_fabric, 3, plan=GBIN_EF,
              ckpt_dir=os.path.join(OUT, "ef_virt"))
        ckpt_arrays(os.path.join(OUT, "ef_virt"))

np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
'''

REFERENCE_PROGRAM = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import functools
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import (fp32_allreduce, lowbit_packed_a2a, lowbit_vote_psum,
                        sign_of_mean)

W, N = 4, int(os.environ["LEAF_N"])
rng = np.random.RandomState(0)
gs = rng.randn(W, N).astype(np.float32)
mesh = jax.make_mesh((4,), ("data",))


def agg(fn):
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P(("data",)),
                       out_specs=P(), axis_names=frozenset({"data"}),
                       check_vma=False)
    def run(stacked):
        return fn(stacked[0])
    return np.asarray(jax.jit(run)(jnp.asarray(gs)))


out = {
    "vote_psum/gbinary": agg(lambda g: lowbit_vote_psum(g, ("data",), W)[0]),
    "vote_psum/gternary": agg(lambda g: lowbit_vote_psum(
        g, ("data",), W, ternary=True, gate_phase=1)[0]),
    "packed_a2a/gbinary": agg(lambda g: lowbit_packed_a2a(
        g, ("data",), W)[0]),
    "packed_a2a/gternary": agg(lambda g: lowbit_packed_a2a(
        g, ("data",), W, ternary=True, gate_phase=1)[0]),
    "psum/fp32": agg(lambda g: fp32_allreduce(g, ("data",))),
    "sign_of_mean": agg(lambda g: sign_of_mean(g, ("data",))),
}
np.savez(os.environ["OUT_FILE"], **out)
'''


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env["PYTHONPATH"] = SRC
    env["LEAF_N"] = str(N)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def spawn(w: int, out, shared) -> dict:
    """Run RANK_PROGRAM on ``w`` ranks; return each rank's results."""
    out.mkdir()
    logs = [open(out / f"rank{r}.log", "w") for r in range(w)]
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM],
            env=_env(WORLD_SIZE=w, RANK=r, OUT_DIR=out, SHARED_DIR=shared),
            stdout=log, stderr=subprocess.STDOUT)
            for r, log in enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=SPAWN_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        text = (out / f"rank{r}.log").read_text()
        assert p.returncode == 0, f"rank {r} of {w}:\n{text[-4000:]}"
    ranks = []
    for r in range(w):
        with np.load(out / f"rank{r}.npz") as data:
            arrays = {k: data[k] for k in data.files}
        with open(out / f"rank{r}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    return tmp_path_factory.mktemp("shared")


@pytest.fixture(scope="module")
def world4(tmp_path_factory, shared):
    return spawn(4, tmp_path_factory.mktemp("w4") / "out", shared)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, shared, world4):
    # after W = 4: restores the checkpoints it wrote
    return spawn(2, tmp_path_factory.mktemp("w2") / "out", shared)


@pytest.fixture(scope="module")
def world3(tmp_path_factory, shared):
    return spawn(3, tmp_path_factory.mktemp("w3") / "out", shared)


@pytest.fixture
def world(request):
    return request.getfixturevalue(f"world{request.param}")


@pytest.fixture(scope="module")
def reference4(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    r = subprocess.run([sys.executable, "-c", REFERENCE_PROGRAM],
                       env=_env(OUT_FILE=out, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    return (got.shape == want.shape and got.dtype == want.dtype
            and got.tobytes() == want.tobytes())


def same_mean(got, want, encs: np.ndarray) -> None:
    """Equal as numbers (zeros as zeros), except where W float32 values
    summed in two orders part: there within (W - 1) * eps * sum|e| / W."""
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    w = encs.shape[0]
    bound = (w - 1) * np.finfo(np.float32).eps * \
        np.abs(encs).sum(axis=0).reshape(-1) / w
    differ = got != want
    assert (np.abs(got - want)[differ] <= bound[differ]).all()


def _grads(w: int) -> np.ndarray:
    return np.random.RandomState(0).randn(w, N).astype(np.float32)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_vote_schedules_equal_the_virtual_group(world, case):
    virtual = world[0][0]
    for arrays, _ in world:
        assert same_bits(arrays[case], virtual[f"virtual/{case}"]), case
        assert set(np.unique(arrays[case])) <= {-1.0, 0.0, 1.0}
    if case.endswith("/ef"):
        for r, (arrays, _) in enumerate(world):
            assert same_bits(arrays[f"{case}/new_ef"],
                             virtual[f"virtual/{case}/new_ef"][r:r + 1])


@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
@pytest.mark.parametrize("case", MEAN_CASES)
def test_mean_schedules_equal_the_virtual_group(world, case):
    virtual = world[0][0]
    w = len(world)
    encs = virtual.get(f"virtual/{case}/enc", _grads(w))
    want = virtual[f"virtual/{case}"]
    for arrays, _ in world:
        got = arrays[case]
        if case == "sign_of_mean":
            _sign_of_means_agree(got, want, _grads(w))
        else:
            same_mean(got, want, encs)
    if w == 2:          # one summation order: the same numbers
        for arrays, _ in world:
            np.testing.assert_array_equal(arrays[case], want)


REFERENCE_CASES = {
    "vote_psum/gbinary": ["vote_psum/gbinary"],
    "vote_psum/gternary": ["vote_psum/gternary"],
    "packed_a2a/gbinary": ["packed_a2a/gbinary/fused",
                           "packed_a2a/gbinary/staged"],
    "packed_a2a/gternary": ["packed_a2a/gternary/fused",
                            "packed_a2a/gternary/staged"],
    "psum/fp32": ["psum/fp32"],
    "sign_of_mean": ["sign_of_mean"],
}


def _sign_of_means_agree(got, want, grads) -> None:
    """Two signs of one mean part only where one of the means lies
    within the summation-order bound of zero."""
    w = grads.shape[0]
    mean = grads.mean(axis=0)
    bound = (w - 1) * np.finfo(np.float32).eps * \
        np.abs(grads).sum(axis=0) / w
    differ = got != want
    assert (np.abs(mean[differ]) <= 2 * bound[differ]).all()


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_w4_schedules_equal_the_reference_under_shard_map(world4, reference4,
                                                          case):
    want = reference4[case]
    for arrays, _ in world4:
        for name in REFERENCE_CASES[case]:
            got = arrays[name]
            if case == "psum/fp32":
                same_mean(got, want, _grads(4))
            elif case == "sign_of_mean":
                _sign_of_means_agree(got, want, _grads(4))
            else:
                # as numbers: the reference's jitted ``sign * gate`` may
                # come out of XLA as a select that writes +0.0 where the
                # port's product (and the virtual group's) gives -0.0
                np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
def test_collectives_leave_their_input_unchanged(world):
    for _, info in world:
        for dt in ("torch.float32", "torch.bfloat16", "torch.int32"):
            assert info[f"inplace/{dt}"], dt


# ---------------------------------------------------------------------------
# a bucketed step on the smoke tree
# ---------------------------------------------------------------------------

BUCKET_PLANS = ("gbin_packed", "gternary_staged", "gbin_packed_ef_per_leaf")


@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
@pytest.mark.parametrize("plan", BUCKET_PLANS)
def test_bucketed_step_equals_the_virtual_group(world, plan):
    """Each rank's gradients and EF rows are the virtual group's rows,
    bit for bit; vote aggregates are the same bits and FP32 means within
    same_mean's bound of the virtual ones.  The loss is the mean of W
    losses, each under 8 (ln 512 = 6.24 at random init)."""
    virtual, vinfo = world[0]
    w = len(world)
    pre = f"bucketed/{plan}/"
    votes = set(vinfo[f"virtual/{pre}votes"])
    assert votes
    for r, (arrays, info) in enumerate(world):
        assert set(info[f"{pre}votes"]) == votes
        keys = [k for k in arrays if k.startswith(pre)]
        assert keys
        for key in keys:
            got, want = arrays[key], virtual[f"virtual/{key}"]
            kind, leaf = key[len(pre):].split("/", 1) if "/" in \
                key[len(pre):] else (key[len(pre):], None)
            if kind in ("grad", "ef"):
                if want.ndim:                    # one row per local rank
                    want = want[r:r + 1]
                assert same_bits(got, want), key
            elif kind == "loss":
                assert got < 8
                same_mean(got, want, np.full((w, 1), 8.0, np.float32))
            elif leaf in votes:
                assert same_bits(got, want), key
            else:
                encs = virtual[f"virtual/{pre}grad/{leaf}"]
                same_mean(got, want, encs.reshape(w, -1))


@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
@pytest.mark.parametrize("plan", BUCKET_PLANS)
def test_group_counts_a_step_of_traffic(world, plan):
    w = len(world)
    for _, info in world:
        t = info[f"bucketed/{plan}/traffic"]
        launches = t["launches"]
        packed = [n for s, n in launches if s == "packed_a2a"]
        means = [n for s, n in launches if s == "psum"]
        assert packed and means and len(packed) + len(means) == len(launches)
        # packed words: ceil(n / (32 * 128)) rows, padded to a multiple of W
        rws = [-(-(-(-n // 4096)) // w) for n in packed]
        want_calls = {"all_to_all": len(packed),
                      "all_gather": 2 * len(packed),
                      "all_reduce": len(means) + 1}
        want_bytes = {"all_to_all": sum(w * rw * 128 * 4 for rw in rws),
                      "all_gather": sum(2 * rw * 128 * 4 for rw in rws),
                      "all_reduce": sum(4 * n for n in means) + 4}
        assert t["calls"] == want_calls
        assert t["bytes"] == want_bytes


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _params(arrays, tag):
    pre = f"{tag}/params/"
    return {k[len(pre):]: v for k, v in arrays.items() if k.startswith(pre)}


def test_trainer_w2_equals_the_virtual_trainer_bit_for_bit(world2):
    virtual = world2[0]
    want = _params(virtual[0], "virtual/trainer")
    for arrays, info in world2:
        assert info["trainer/losses"] == virtual[1]["virtual/trainer/losses"]
        got = _params(arrays, "trainer")
        assert got.keys() == want.keys() and len(got) == 12
        for p in want:                  # zeros as zeros
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)


def test_trainer_w4_aggregates_every_step_as_the_virtual_group(world4):
    """W = 4: at every step of the Trainer over gloo, its aggregates are
    what VirtualGroup(4) makes of the same four ranks' gradients: votes
    bit for bit, FP32 means within same_mean's bound.

    The two Trainers' own trajectories part, though: the FP32 means
    part by a few float32 ulps (gloo's summation order), the next
    step's gradients by as little, and a G-Binary vote flips wherever a
    worker's gradient element lies that close to zero (a few elements of
    the 73,728 a worker from step 2 on).  A flip moves one element by
    about one step's learning rate, so over 6 steps the losses, which
    fall by ~0.1 a step, stay within 1e-4 relative of the virtual run's,
    and agree to rtol 1e-6 over the first two steps, before any flip.
    """
    virtual, vinfo = world4[0]
    votes = set(vinfo["virtual/trainer/votes"])
    assert votes
    for arrays, info in world4:
        for k in range(6):
            pre = f"trainer/{k}/agg/"
            leaves = [n[len(pre):] for n in arrays if n.startswith(pre)]
            assert len(leaves) == 12
            for p in leaves:
                got = arrays[pre + p]
                want = virtual[f"virtual/{pre}{p}"]
                if p in votes:
                    assert same_bits(got, want), (k, p)
                else:
                    encs = virtual[f"trainer/{k}/grads/{p}"]
                    same_mean(got, want, encs.reshape(4, -1))
        losses = info["trainer/losses"]
        want = vinfo["virtual/trainer/losses"]
        np.testing.assert_allclose(losses[:2], want[:2], rtol=1e-6)
        np.testing.assert_allclose(losses, want, rtol=1e-4)
    # the ranks themselves hold one replicated copy
    first = _params(world4[0][0], "trainer")
    for arrays, _ in world4[1:]:
        for p, x in _params(arrays, "trainer").items():
            assert same_bits(x, first[p]), p


def test_paper_controller_latches_the_same_plans_on_every_rank(world2):
    virtual = world2[0][1]
    plans, events = virtual["virtual/paper/plans"], \
        virtual["virtual/paper/events"]
    assert [e[:2] for e in events] == [[1, "warmup_end"], [1, "admitted"]]
    assert "packed_a2a" in plans[-1] and plans[0] != plans[-1]
    for _, info in world2:
        assert info["paper/plans"] == plans
        assert info["paper/events"] == events
        assert info["paper/losses"] == virtual["virtual/paper/losses"]


def test_tuned_controller_latches_the_same_plans_on_skewed_ranks(world2):
    """Rank 0 times its steps at 0 s, rank 1 at 10 s: both controllers
    see the slowest rank's time, so both retune at the same steps."""
    (_, first), (_, second) = world2
    events = first["tuned/events"]
    # patience 2: every second step is out of band on the slowest rank
    assert events and all(e[1] == "retune" and e[0] in (1, 3, 5)
                          for e in events)
    assert len(set(first["tuned/plans"])) > 1
    assert second["tuned/events"] == events
    assert second["tuned/plans"] == first["tuned/plans"]
    assert second["tuned/losses"] == first["tuned/losses"]


def test_failure_is_restored_and_replayed_bit_for_bit(world4):
    for _, info in world4:
        a, b = info["replay/0/losses"], info["replay/1/losses"]
        assert info["replay/0/restarts"] == 0
        assert info["replay/1/restarts"] == 1
        assert a[-1] == b[-1]
        assert a[-1] < a[0]
        # steps 10 and 11 ran twice: the last checkpoint was step 10
        assert len(b) == len(a) + 2 and b[12:14] == a[10:12]


def test_fp32_checkpoint_written_at_w4_restores_at_w2(world4, world2):
    want = _params(world4[0][0], "elastic")
    for arrays, info in world2:
        assert info["elastic/step"] == 10
        assert info["elastic/losses"] == []         # restored, no step run
        got = _params(arrays, "elastic")
        for p in want:
            assert same_bits(got[p], want[p]), p


def test_error_feedback_rows_refuse_another_world_size(world2):
    for _, info in world2:
        msg = info["ef_mismatch/error"]
        assert msg is not None and "another world size" in msg


def test_w2_ef_checkpoint_equals_the_virtual_ones(world2):
    arrays, info = world2[0]
    dist = {k[len("dist_ckpt/"):]: v for k, v in arrays.items()
            if k.startswith("dist_ckpt/")}
    virt = {k[len("ckpt/"):]: v for k, v in arrays.items()
            if k.startswith("ckpt/")}
    assert list(dist) == list(virt) and info["ckpt/step"] == 3
    rows = [k for k, v in dist.items() if k.startswith("ef/") and v.ndim]
    assert rows and all(dist[k].shape[0] == 2 for k in rows)
    for k in dist:
        assert dist[k].dtype == virt[k].dtype, k
        np.testing.assert_array_equal(dist[k], virt[k], err_msg=k)


def test_grad_accum_equals_one_pass_over_gloo(world4):
    for _, info in world4:
        assert abs(info["grad_accum/1"] - info["grad_accum/4"]) < 2e-4


@pytest.mark.parametrize("world", [2, 3, 4], indirect=True)
def test_every_rank_ran_its_collectives(world):
    counts = {info["calls_total"] for _, info in world}
    assert len(counts) == 1 and counts.pop() > 0


def test_launcher_under_torchrun_trains_on_both_ranks(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "qwen3_0p6b", "--smoke", "--device", "cpu", "--mesh",
           "2,1", "--steps", "2", "--plan", "gbin_packed",
           "--global-batch", "4", "--seq-len", "16"]
    env = _env(OMP_NUM_THREADS=1, TMPDIR=tmp_path)
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=SPAWN_TIMEOUT, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    finals = sorted(line for line in r.stdout.splitlines()
                    if line.startswith("final:"))
    assert len(finals) == 2, r.stdout
    losses = {line.split("loss=")[1].split()[0] for line in finals}
    assert len(losses) == 1
    assert {line.rsplit("rank=", 1)[1] for line in finals} == {"0", "1"}
