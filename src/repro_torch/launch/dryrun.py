"""Production dry-run: trace one step of rank 0 of every (architecture x
input-shape x mesh) cell, on ``meta`` tensors, and record its memory,
FLOPs, HBM bytes and collective inventory for the roofline.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles
each cell against 512 placeholder host devices.  Here one process plays
rank 0 of the whole mesh, 16 x 16 (256 ranks) or 2 x 16 x 16 (512),
under a fake process group (``torch.distributed``'s ``fake`` backend):
the port's own :class:`~repro_torch.core.ProcessMesh` on the ``meta``
device, and the step builders the real ranks run (the
:class:`~repro_torch.runtime.Trainer`'s step on the mesh with ZeRO-1,
:func:`~repro_torch.runtime.serve.build_serve_step` and
:func:`~repro_torch.runtime.serve.build_prefill`), traced by
:class:`~repro_torch.launch.analysis.StepTrace`.  Nothing is allocated
on any device.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --plans fp32,gbin_vote --out results/dryrun

Each cell writes ``<out>/<mesh_name>/<arch>/<shape>.<tag>.json`` with
the reference's keys (``compile_s`` holds the trace's seconds); a cell
that fails records its error there, and the CLI exits 1.  Every
family traces on the 16-wide model axis.
``python -m repro_torch.launch.report`` tabulates the JSONs.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..core import tree as T
from ..fabric.control import plan_presets
from ..models import SHAPES, SHAPES_BY_NAME, init_params
from ..models.transformer import shard_params
from ..optim import AdamW
from .analysis import (H100_PEAK_FLOPS, StepTrace, roofline_terms,
                       summarize_collectives)
from .mesh import dp_axes_of, make_production_mesh
from .specs import decode_input_specs, train_batch_specs

#: one source of named plans for every launcher (repro_torch.fabric.control);
#: the dry-run traces any subset of them per (arch x shape x mesh) cell
PLANS = plan_presets()

#: the traced loop's note, in place of the reference's loop trip counts
NO_LOOPS = ("not applicable: eager torch runs every loop unrolled, so each "
            "iteration is traced and counted")


def cell_skipped(cfg, cell) -> str | None:
    """Assignment skip rules (documented in DESIGN.md §Arch-applicability)."""
    if cell.name == "long_500k" and not cfg.is_subquadratic:
        return "long_500k skipped: pure full-attention architecture"
    return None


#: crude per-device compute estimate for the simulated timeline: one
#: H100's dense bf16 peak, derated to a realistic MFU
SIM_MFU = 0.4
#: topologies the dry-run's simulated-timeline section replays per cell
SIM_TOPOLOGIES = ("ici_ring", "cxl_switched", "multihop")


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in which this process is
    rank 0: collectives return at once and move nothing."""
    # imported here alone: torch's fake backend lives in its test helpers
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run plays its own process group; one "
                           "is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_groups(mesh) -> dict:
    """A ProcessMesh's groups by name (the collectives' ``by_group``)."""
    groups = {"data": mesh.data_group, "model": mesh.model_group,
              "world": mesh.world}
    groups.update({f"axis:{n}": g for n, g in mesh.axis_groups.items()})
    return groups


def _pod_size(mesh) -> int:
    n = math.prod(mesh.extents.values())
    return n // mesh.extents["pod"] if "pod" in mesh.extents else 0


def _trace(mesh, fn, *args) -> StepTrace:
    mesh.reset_counts()
    with StepTrace(arguments=args, groups=mesh_groups(mesh),
                   pod_size=_pod_size(mesh)) as tr:
        tr.set_outputs(fn(*args))
    return tr


def _rank_params(cfg, mesh) -> dict:
    """This rank's blocks of the parameters, as storages of their own."""
    whole = init_params(cfg, device="meta")
    return T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))


def train_step(cfg, mesh, plan_name: str, optimizer=None,
               grad_accum: int = 1, device="meta"):
    """The Trainer of a real rank on ``mesh`` (ZeRO-1 moments), its state
    initialised: ``(trainer, step)`` with ``step(state, batch)`` the
    function its loop runs."""
    from ..fabric import Fabric
    from ..runtime import Trainer
    trainer = Trainer(cfg, optimizer or AdamW(peak_lr=1e-4), None,
                      plan=PLANS[plan_name], fabric=Fabric(mesh=mesh),
                      device=device)
    trainer.init_state()
    return trainer, trainer.step_function(PLANS[plan_name],
                                          grad_accum=grad_accum)


def run_train_cell(cfg, cell, mesh, plan_name: str,
                   grad_accum: int = 1, optimizer=None) -> dict:
    plan = PLANS[plan_name]
    trainer, step = train_step(cfg, mesh, plan_name, optimizer,
                               grad_accum=grad_accum)
    batch = train_batch_specs(cfg, cell)
    t0 = time.time()
    tr = _trace(mesh, step, trainer.state, batch)
    result = analyze(tr, mesh, t0, cfg, cell, extra={
        "plan": plan_name, "num_workers": trainer.fabric.num_workers})
    # simulated collective timeline (repro_torch.sim): the cell's bucket
    # layout replayed per topology against an MFU-derated compute estimate
    compute_s = (model_flops_per_device(cfg, cell, result["num_devices"])
                 / (H100_PEAK_FLOPS * SIM_MFU))
    whole = init_params(cfg, device="meta")
    result["sim"] = {
        topo: trainer.fabric.simulate(whole, plan, topology=topo,
                                      compute_time_s=compute_s).summary()
        for topo in SIM_TOPOLOGIES}
    return result


def run_decode_cell(cfg, cell, mesh) -> dict:
    from ..runtime.serve import build_serve_step
    dp = dp_axes_of(mesh)
    step, sh = build_serve_step(cfg, mesh, batch=cell.global_batch,
                                max_seq=cell.seq_len, dp_axes=dp,
                                donate=False)
    spec = decode_input_specs(cfg, cell, mesh=mesh)
    params = _rank_params(cfg, mesh)
    t0 = time.time()
    # the position of the last cached token (its value moves no shape)
    with torch.no_grad():
        tr = _trace(mesh, step, params, spec["token"], spec["cache"],
                    cell.seq_len - 1)
    return analyze(tr, mesh, t0, cfg, cell, extra={
        "plan": "serve", "shard_seq": bool(sh["shard_seq"])})


def run_prefill_cell(cfg, cell, mesh) -> dict:
    from ..runtime.serve import build_prefill
    dp = dp_axes_of(mesh)
    batch = train_batch_specs(cfg, cell)
    batch.pop("labels")
    run = build_prefill(cfg, mesh, dp_axes=dp)
    params = _rank_params(cfg, mesh)
    t0 = time.time()
    tr = _trace(mesh, run, params, batch)
    return analyze(tr, mesh, t0, cfg, cell, extra={"plan": "prefill"})


def model_flops_per_device(cfg, cell, num_devices: int) -> float:
    """MODEL_FLOPS: 6*N_active*D (train) / 2*N_active*tokens (inference)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens / num_devices
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens / num_devices
    return 2.0 * n * cell.global_batch / num_devices   # decode: 1 new token


def analyze(tr: StepTrace, mesh, t0: float, cfg, cell, extra: dict) -> dict:
    compile_s = time.time() - t0
    num_devices = math.prod(mesh.extents.values())
    csum = summarize_collectives(tr.collectives)
    csum["wire_breakdown_top"] = dict(
        list(tr.wire_breakdown().items())[:10])
    csum["by_group"] = tr.by_group()
    flops = float(tr.flops)
    hbm_bytes = float(tr.hbm_bytes)
    roof = roofline_terms(flops, hbm_bytes, csum["total_wire_bytes"])
    mflops = model_flops_per_device(cfg, cell, num_devices)
    roof["model_flops_per_device"] = mflops
    roof["useful_flop_ratio"] = mflops / flops if flops else 0.0
    return {
        **extra,
        "mesh": dict(mesh.extents),
        "num_devices": int(num_devices),
        "compile_s": compile_s,
        "memory": tr.memory(),
        "flops_per_device": flops,
        "hbm_bytes_per_device": hbm_bytes,
        "loop_trip_counts": NO_LOOPS,
        "collectives": csum,
        "kernels": tr.kernels,
        "roofline": roof,
    }


def run_cell(arch: str, shape: str, multi_pod: bool, plan: str,
             out_dir: str, force: bool = False,
             grad_accum: int = 1, tag_suffix: str = "",
             moe_cf: float = 0.0, remat_policy: str = "") -> dict | None:
    cfg = get_config(arch)
    if moe_cf and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=moe_cf))
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    cell = SHAPES_BY_NAME[shape]
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    tag = (plan if cell.is_train else cell.kind) + tag_suffix
    path = os.path.join(out_dir, mesh_name, arch, f"{shape}.{tag}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path) and not force:
        print(f"[skip-cached] {mesh_name}/{arch}/{shape}.{tag}")
        with open(path) as f:
            return json.load(f)

    skip = cell_skipped(cfg, cell)
    if skip:
        result = {"skipped": skip}
    else:
        try:
            with fake_world(512 if multi_pod else 256):
                mesh = make_production_mesh(multi_pod=multi_pod)
                if cell.kind == "train":
                    result = run_train_cell(cfg, cell, mesh, plan,
                                            grad_accum=grad_accum)
                elif cell.kind == "prefill":
                    result = run_prefill_cell(cfg, cell, mesh)
                else:
                    result = run_decode_cell(cfg, cell, mesh)
        except Exception as e:  # record failures; they are bugs to fix
            result = {"error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}
    result.update({"arch": arch, "shape": shape, "mesh_name": mesh_name})
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    status = ("SKIP" if "skipped" in result
              else "FAIL" if "error" in result else
              f"ok {result['compile_s']:.0f}s dom={result['roofline']['dominant']}")
    print(f"[{mesh_name}] {arch} {shape} ({tag}): {status}", flush=True)
    if "error" in result:
        print(result["error"], flush=True)
    return result


def _run_task(task: tuple, **kw) -> dict | None:
    arch, shape, multi_pod, plan = task
    return run_cell(arch, shape, multi_pod, plan, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--plans", default="gbin_vote",
                    help="comma-separated train plans (fp32,gbin_vote,...)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--moe-cf", type=float, default=0.0)
    ap.add_argument("--remat-policy", default="")
    ap.add_argument("--tag-suffix", default="")
    ap.add_argument("--jobs", type=int, default=0,
                    help="cells traced at once, one process each (0: one "
                         "a CPU core)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    plans = args.plans.split(",")

    tasks = [(arch, shape, mp, plan)
             for mp in meshes for arch in archs for shape in shapes
             for plan in (plans if SHAPES_BY_NAME[shape].is_train
                          else ["serve"])]
    cell = functools.partial(_run_task, out_dir=args.out, force=args.force,
                             grad_accum=args.grad_accum, moe_cf=args.moe_cf,
                             remat_policy=args.remat_policy,
                             tag_suffix=args.tag_suffix)
    jobs = min(args.jobs or os.cpu_count() or 1, len(tasks))
    if jobs <= 1:
        results = [cell(t) for t in tasks]
    else:
        # a cell's trace is single-threaded Python: the cells run side by
        # side, each in a fresh process with its own fake process group
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
            results = list(ex.map(cell, tasks))
    failures = sum(1 for r in results if r and "error" in r)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
