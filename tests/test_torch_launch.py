"""The port's launch tooling against the reference's, on the CPU.

  * ``input_specs`` and ``state_specs`` give the reference's
    ``jax.eval_shape`` trees (structure, shapes and dtypes) for every
    architecture's FULL config and every cell; ``dp_axes_of``,
    ``cell_skipped`` and ``model_flops_per_device`` the reference's
    values on both production meshes;
  * the ring model, ``summarize_collectives`` and ``fmt_table`` equal
    the reference's on the same inputs; ``roofline_terms`` has the
    reference's form under one H100's constants;
  * the trace of an eager loop of 7 matmuls, each with an ``all_reduce``
    over a fake group of 4, counts 7 x the FLOPs and 7 x the ring
    model's wire bytes (the counterpart of ``tests/test_hlo_walk.py``);
  * the dry-run CLI traces qwen3-0.6B's ``decode_32k`` on the 16 x 16
    mesh, and the dry-run in this process full deepseek-moe-16b's, its
    experts over the 16 model ranks, with its collectives by group;
  * the dry-run's trace of rank 0 of a fake (2, 2) mesh (the qwen3 SMOKE
    model, gbin_packed, AdamW with ZeRO-1) equals one step of four real
    gloo ranks: collective calls and bytes by group and op, FLOPs
    (``FlopCounterMode`` around the real step) and kernel calls (the
    real ranks count their plain twins' calls);
  * the kernel wrappers' ``meta`` route: the CPU route's shapes and
    dtypes, a recorded call, no ``launches``.

Spawned processes run one intra-op thread.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.launch import hlo_analysis as JA  # noqa: E402
from repro.launch import report as JR  # noqa: E402
from repro.launch.specs import input_specs as j_input_specs  # noqa: E402
from repro.launch.specs import state_specs as j_state_specs  # noqa: E402
from repro.models import SHAPES as J_SHAPES  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import DistributedGroup  # noqa: E402
from repro_torch.fabric import plan_presets  # noqa: E402
from repro_torch.launch import analysis as A  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.mesh import (dp_axes_of,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.specs import input_specs, state_specs  # noqa: E402
from repro_torch.models import SHAPES, ShapeCell  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: seconds a spawn may take before it is killed
SPAWN_TIMEOUT = 300


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without its side effect on this
    process's environment (it appends a forced device count to
    ``XLA_FLAGS`` for processes started later; this one's backend is up
    already)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdryrun


def _leaves(tree, path=()):
    """(path, shape, dtype name) of every array leaf, the paths by field
    name, dict key and sequence index; None is an empty subtree."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        dt = str(tree.dtype).replace("torch.", "")
        return [(path, tuple(tree.shape), dt)]
    return [leaf for k, v in items for leaf in _leaves(v, path + (k,))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_state_specs_equal_the_references(arch):
    """Every cell's abstract inputs (the whole decode cache, the VLM's
    patch features, whisper's frames) and the abstract train state of 16
    workers under gbin_packed with error feedback, on the FULL config."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for cell, jcell in zip(SHAPES, J_SHAPES):
        got = input_specs(cfg, cell)
        assert all(x.device.type == "meta" for x in
                   A.tensors_of(got)), (arch, cell.name)
        assert _leaves(got) == _leaves(j_input_specs(jcfg, jcell)), \
            (arch, cell.name)
    got = state_specs(cfg, AdamW(peak_lr=1e-4),
                      plan_presets(error_feedback=True)["gbin_packed"],
                      dp_size=16)
    want = j_state_specs(jcfg, JAdamW(peak_lr=1e-4),
                         j_plan_presets(error_feedback=True)["gbin_packed"],
                         dp_size=16)
    assert all(x.device.type == "meta" for x in A.tensors_of(got))
    assert _leaves(got) == _leaves(want), arch


def test_mesh_axes_skips_and_model_flops_equal_the_references():
    jd = _reference_dryrun()
    from jax.sharding import AbstractMesh
    for multi in (False, True):
        ext = make_production_mesh(multi_pod=multi)
        assert ext == ({"pod": 2, "data": 16, "model": 16} if multi
                       else {"data": 16, "model": 16})
        jmesh = AbstractMesh(tuple(ext.values()), tuple(ext))
        assert dp_axes_of(ext) == jd.dp_axes_of(jmesh)
    assert dryrun.SIM_TOPOLOGIES == jd.SIM_TOPOLOGIES
    assert dryrun.SIM_MFU == jd.SIM_MFU
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for cell, jcell in zip(SHAPES, J_SHAPES):
            assert dryrun.cell_skipped(cfg, cell) == \
                jd.cell_skipped(jcfg, jcell), (arch, cell.name)
            for n in (256, 512):
                assert dryrun.model_flops_per_device(cfg, cell, n) == \
                    jd.model_flops_per_device(jcfg, jcell, n), \
                    (arch, cell.name, n)


OPS = [("all-reduce", 1000, 4, "f32", False), ("all-gather", 4096, 16, "bf16",
       True), ("all-to-all", 77, 2, "s32", False),
       ("reduce-scatter", 25, 8, "f32", True),
       ("collective-permute", 100, 2, "u8", False),
       ("all-reduce", 12, 1, "f32", False), ("broadcast", 50, 4, "f32", True)]


def test_ring_model_and_summary_equal_the_references():
    for kind, payload, g, _, _ in OPS:
        for gs in (1, 2, 3, 4, 16, 256, g):
            assert A._wire_bytes(kind, payload, gs) == \
                JA._wire_bytes(kind, payload, gs), (kind, gs)
    assert A.DTYPE_BYTES == JA.DTYPE_BYTES
    ours = [A.CollectiveOp(k, b, g, A._wire_bytes(k, b, g), c, dt)
            for k, b, g, dt, c in OPS]
    theirs = [JA.CollectiveOp(k, b, g, JA._wire_bytes(k, b, g), c, dt)
              for k, b, g, dt, c in OPS]
    assert A.summarize_collectives(ours) == JA.summarize_collectives(theirs)


def test_roofline_terms_under_the_h100():
    """The reference's keys and arithmetic, with one H100 SXM's data-sheet
    numbers in place of the v5e's."""
    for args in ((1e12, 1e9, 1e8), (1e9, 1e12, 1e8), (1e9, 1e9, 1e12),
                 (0.0, 0.0, 0.0)):
        got, ref = A.roofline_terms(*args), JA.roofline_terms(*args)
        assert got.keys() == ref.keys()
        want = {"compute_s": args[0] / 989e12, "memory_s": args[1] / 3.35e12,
                "collective_s": args[2] / 450e9}
        for k, v in want.items():
            assert got[k] == v
        bound = max(want.values())
        assert got["step_time_lower_bound_s"] == bound
        assert got["dominant"] == max(want, key=want.get)[:-2]
        assert got["roofline_fraction"] == (
            want["compute_s"] / bound if bound else 0.0)
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        assert not hasattr(A, name)
    assert not hasattr(dryrun, "V5E_PEAK_FLOPS")


def _cells():
    ok = {"arch": "qwen3_0p6b", "shape": "train_4k", "mesh_name": "pod_16x16",
          "plan": "gbin_packed",
          "roofline": {"compute_s": 0.12345, "memory_s": 0.5,
                       "collective_s": 0.25, "dominant": "memory",
                       "roofline_fraction": 0.2469, "useful_flop_ratio": 0.71},
          "memory": {"peak_estimate_bytes": 3 * 2 ** 30},
          "collectives": {"pod_crossing_wire_bytes": 2 ** 29}}
    return [ok, dict(ok, plan="fp32"), dict(ok, mesh_name="multipod_2x16x16"),
            {"arch": "gemma3_27b", "shape": "long_500k", "skipped": "x",
             "mesh_name": "pod_16x16"},
            {"arch": "xlstm_125m", "shape": "decode_32k", "error": "E",
             "mesh_name": "pod_16x16"}]


def test_report_equals_the_references(tmp_path):
    cells = _cells()
    for mesh in ("pod_16x16", "multipod_2x16x16"):
        for pf in (None, ["gbin_packed"]):
            assert report.fmt_table(cells, mesh, pf) == \
                JR.fmt_table(cells, mesh, pf)
    for i, c in enumerate(cells):
        d = tmp_path / c["mesh_name"] / c["arch"]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{c['shape']}.{i}.json").write_text(json.dumps(c))
    assert report.load_cells(str(tmp_path)) == JR.load_cells(str(tmp_path))


def test_trace_counts_every_iteration_of_a_loop():
    """Seven (8 x 16) @ (16 x 4) products, each all-reduced over a fake
    group of four: 7 x 1024 FLOPs and 7 x the ring model's bytes."""
    with dryrun.fake_world(4):
        group = DistributedGroup(device="meta")
        a = torch.empty((8, 16), device="meta")
        b = torch.empty((16, 4), device="meta")
        with A.StepTrace(arguments=(a, b), groups={"world": group}) as tr:
            for _ in range(7):
                group.all_reduce(a @ b)
    assert tr.flops == 7 * 2 * 8 * 4 * 16
    wire = sum(o.wire_bytes for o in tr.collectives)
    assert wire == 7 * JA._wire_bytes("all-reduce", 8 * 4 * 4, 4)
    assert tr.wire_breakdown() == {"all-reduce/f32/g4": wire}
    assert tr.by_group() == {"world": {"calls": {"all_reduce": 7},
                                       "bytes": {"all_reduce": 7 * 128}}}
    # each product reads its operands and writes its output; the group's
    # clone of it, and the all-reduce on that clone, each read and write
    # the 128 bytes once
    assert tr.hbm_bytes == 7 * ((8 * 16 + 16 * 4 + 8 * 4) * 4
                                + 2 * 2 * 8 * 4 * 4)
    mem = tr.memory()
    assert mem["argument_bytes"] == (8 * 16 + 16 * 4) * 4
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"] + 128
    assert not dist.is_initialized()


def test_dryrun_cli_decode_32k_on_the_production_mesh(tmp_path):
    """The reference's ``test_dryrun_entrypoint_full_size_cell``, on the
    port: full qwen3-0.6B, ``decode_32k``, 256 ranks."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3_0p6b", "--shape", "decode_32k", "--mesh", "single", "--out",
         str(tmp_path), "--force"],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    data = json.load(open(tmp_path / "pod_16x16" / "qwen3_0p6b"
                          / "decode_32k.decode.json"))
    assert data["num_devices"] == 256
    assert data["mesh"] == {"data": 16, "model": 16}
    assert data["flops_per_device"] > 0
    assert data["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert data["memory"]["argument_bytes"] > 0
    assert data["collectives"]["num_ops"] > 0
    assert "qwen3_0p6b" in subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--results",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=SPAWN_TIMEOUT).stdout


def test_dryrun_traces_expert_parallel_decode_on_the_production_mesh(
        tmp_path):
    """Full deepseek-moe-16b's ``decode_32k`` on a fake 16 x 16 mesh, in
    this process on ``meta``: ``ok``, its 64 experts 4 a model rank.
    Rank 0's collectives by group: a layer's heads and partials gathered
    over the model group and its attention summed, the dense first
    layer's MLP summed, each of the 27 MoE layers' input gathered over
    the data group and its routed and shared experts summed over the
    model group; the embedding summed, the vocabulary gathered over the
    model group and the logits' rows over the data group."""
    res = dryrun.run_cell("deepseek_moe_16b", "decode_32k", False,
                          "gbin_packed", str(tmp_path), force=True)
    assert "error" not in res, res.get("traceback")
    assert res["mesh"] == {"data": 16, "model": 16}
    layers, moe = 28, 27
    by_group = res["collectives"]["by_group"]
    assert by_group["model"]["calls"] == {
        "all_reduce": layers + 1 + 2 * moe + 1, "all_gather": 2 * layers + 1}
    assert by_group["data"]["calls"] == {"all_gather": moe + 1}
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the dry-run's trace against four real ranks
# ---------------------------------------------------------------------------

Y_CELL = ShapeCell("y_smoke", 16, 8, "train")      # 2 data ranks x 4 x 16


def _y_config():
    return dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                               dtype="bfloat16", remat=True)


RANK_PROGRAM = r'''
import dataclasses, json, os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

torch.set_num_threads(1)
WORLD, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT = os.environ["OUT_DIR"]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=WORLD, timeout=timedelta(seconds=60))

from repro_torch.configs import get_config
from repro_torch.core import ProcessMesh
from repro_torch.kernels import apply_update, fused, sign_pack
from repro_torch.launch import dryrun

calls = {}

def counted(name, fn):
    def run(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    return run

# the CPU route runs the plain twins: count their calls
sign_pack.sign_pack_plain = counted("sign_pack", sign_pack.sign_pack_plain)
fused.vote_combine_plain = counted("vote_combine", fused.vote_combine_plain)
apply_update.unpack_ternary_plain = counted(
    "unpack_ternary", apply_update.unpack_ternary_plain)

cfg = dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                          dtype="bfloat16", remat=True)
mesh = ProcessMesh((2, 2), device="cpu")
trainer, step = dryrun.train_step(cfg, mesh, "gbin_packed", device="cpu")
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab_size, (8, 16), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
mesh.reset_counts()
with FlopCounterMode(display=False) as fc:
    state, metrics, agg = step(trainer.state, batch)
groups = dryrun.mesh_groups(mesh)
out = {"flops": fc.get_total_flops(), "kernels": calls,
       "loss": float(metrics["loss"]),
       "by_group": {n: {"calls": dict(g.calls_by_op),
                        "bytes": dict(g.bytes_by_op)}
                    for n, g in groups.items()}}
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _spawn(program: str, world: int, out) -> list:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", OUT_DIR=str(out),
               WORLD_SIZE=str(world))
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    try:
        procs = [subprocess.Popen([sys.executable, "-c", program],
                                  env=dict(env, RANK=str(r)), stdout=log,
                                  stderr=subprocess.STDOUT)
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
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()[-4000:]
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def test_fake_trace_equals_four_gloo_ranks(tmp_path):
    """The dry-run's train cell on a fake (2, 2) mesh against one step of
    four gloo ranks on the same step builders: collective calls and
    bytes by group and op, FLOPs and kernel calls, all equal."""
    with dryrun.fake_world(4):
        from repro_torch.core import ProcessMesh
        mesh = ProcessMesh((2, 2), device="meta")
        got = dryrun.run_train_cell(_y_config(), Y_CELL, mesh, "gbin_packed")
    ranks = _spawn(RANK_PROGRAM, 4, tmp_path)
    real = ranks[0]
    assert got["collectives"]["by_group"] == real["by_group"]
    assert got["flops_per_device"] == real["flops"] > 0
    assert {n: k["calls"] for n, k in got["kernels"].items()} == \
        real["kernels"]
    assert {n: k["launches"] for n, k in got["kernels"].items()} == \
        real["kernels"]
    assert set(real["kernels"]) == {"sign_pack", "vote_combine",
                                    "unpack_ternary"}
    for r in ranks[1:]:
        assert r["flops"] == real["flops"] and r["kernels"] == real["kernels"]
    assert got["num_workers"] == 2 and got["num_devices"] == 4
    mem = got["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_estimate_bytes"]
    assert got["roofline"]["step_time_lower_bound_s"] > 0
    assert set(got["sim"]) == set(dryrun.SIM_TOPOLOGIES)


def test_failing_family_records_its_error(tmp_path):
    """A family without tensor parallelism fails its 16-wide cell with
    the NotImplementedError of its model axis, recorded in the cell's
    JSON; the skip rule writes its reason."""
    r = dryrun.run_cell("xlstm_125m", "decode_32k", False, "gbin_packed",
                        str(tmp_path), force=True)
    assert r["error"].startswith("NotImplementedError: xlstm")
    assert json.load(open(tmp_path / "pod_16x16" / "xlstm_125m"
                          / "decode_32k.decode.json"))["error"] == r["error"]
    r = dryrun.run_cell("qwen3_0p6b", "long_500k", True, "gbin_packed",
                        str(tmp_path), force=True)
    assert r["skipped"].startswith("long_500k skipped")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the kernel wrappers' meta route
# ---------------------------------------------------------------------------

def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _route_cases():
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import LANE
    g = torch.Generator().manual_seed(0)
    plane = torch.randn((2, 64, LANE), generator=g)
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (2, 4, 2, LANE),
                          generator=g, dtype=torch.int32)
    gate = torch.full((2, 2, LANE), -1, dtype=torch.int32)
    return {
        "sign_pack": (ops.pack_signs, (plane,), {}),
        "vote_combine": (ops.vote_combine, (words, gate),
                         {"num_workers": 4}),
        "unpack_ternary": (ops.unpack_ternary, (gate, gate,
                                                torch.bfloat16), {}),
        "encode_pack_ef": (ops.encode_pack_ef, (plane, plane), {}),
        "ef_residual": (ops.ef_residual_plane, (plane, torch.ones(2)), {}),
        "popcount_stack": (ops.popcount_stack, (words,), {}),
        "majority_decode": (ops.majority_decode,
                            (torch.zeros((2, 64, LANE), dtype=torch.int32),
                             gate), {"num_workers": 4}),
        "vote_pipeline": (ops.vote_pipeline, (plane, gate[0]),
                          {"num_workers": 2, "dtype": torch.bfloat16}),
        "apply_sign_update": (ops.apply_sign_update,
                              (plane[0], gate[0], gate[0], 0.5), {}),
        "int4_quant": (ops.int4_quant_plane, (plane,), {}),
        "threshold_mask": (ops.threshold_mask_plane,
                           (plane, torch.full((2,), 0.5)), {}),
    }


def test_kernel_wrappers_meta_route():
    """On ``meta`` operands every wrapper returns the CPU route's shapes
    and dtypes, records one call (int4_quant's two launches), runs no
    twin and leaves ``launches`` as it was."""
    from repro_torch.kernels import build, kernel_wrappers
    cases = _route_cases()
    assert set(cases) == set(kernel_wrappers())
    build.META_CALLS.clear()
    for name, (fn, args, kw) in cases.items():
        before = fn.launches
        want = fn(*args, **kw)
        got = fn(*map(_meta, args), **kw)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        assert [(x.shape, x.dtype) for x in got] == \
            [(x.shape, x.dtype) for x in want], name
        assert all(x.device.type == "meta" for x in got)
        assert fn.launches == before, name
        rec = build.META_CALLS[name]
        assert rec["calls"] == 1, name
        assert rec["launches"] == (2 if name == "int4_quant" else 1)
        assert rec["output_bytes"] == sum(x.numel() * x.element_size()
                                          for x in want), name
        assert rec["operand_bytes"] > 0
    build.META_CALLS.clear()
    fn, (words, gate), kw = cases["vote_combine"]
    with pytest.raises(ValueError, match="several devices"):
        fn(_meta(words), gate, **kw)
    assert not build.META_CALLS
