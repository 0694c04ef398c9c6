"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Same flags as ``python -m repro.launch.train``.  ``--arch`` takes the
ported architectures (``repro_torch.configs.ARCH_IDS``, or their
published names), ``--smoke`` their reduced configs; a VLM is fed tokens
only, as the reference's launcher feeds it.  An encoder-decoder
(``whisper_tiny``) is refused: its forward reads ``frames``, which the
launcher's token stream does not carry, in the reference as here.
``--mesh W,1`` runs W data-parallel workers on one data axis;
``--mesh P,D,1`` runs W = P*D of them on two data axes, ``pod`` and
``data``, which the two hops of a ``hier_*`` plan run over (hop 0, the
intra-node FP32 mean, over ``data``; hop 1 over ``pod``; the hops'
sizes must equal the extents, so for the built-in plans, whose intra
hop is 8 wide and clamped to W, ``D`` is 8, or ``P`` is 1 and ``D``
at most 8);
``--mesh D,M`` (or ``P,D,M``) with M > 1 adds tensor parallelism over a
model axis of M and runs only under ``torchrun`` (one rank a process).
``--device`` picks the device (``cuda`` by default).  Started by
``torchrun`` (which sets ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``),
each process is one rank of a ``torch.distributed`` group — NCCL on
``cuda:LOCAL_RANK`` for ``--device cuda``, gloo for ``--device cpu`` —
on a :class:`~repro_torch.core.ProcessMesh` whose size (P*D*M) must
equal ``WORLD_SIZE``, with ZeRO-1 moments over the data axes; otherwise
the W workers are virtual, on the one device, on a
:class:`~repro_torch.core.VirtualMesh`.  Either way the session is on
the mesh, as the reference's launcher's is, so the model's partition
specs reach the policies.  Examples, on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b \\
      --smoke --device cpu --mesh 4,1 --steps 2 --plan gbin_packed

  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch qwen3_0p6b --smoke \\
      --device cpu --mesh 2,1 --steps 2 --plan gbin_packed

  # tensor parallelism: a (data 2) x (model 2) mesh of four ranks
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3_0p6b --smoke \\
      --device cpu --mesh 2,2 --steps 1 --plan gbin_packed

  # expert parallelism: the MoE's experts over the model axis, the four
  # ranks started by the launcher itself (every family runs on a model
  # axis: --arch xlstm_125m or hymba_1p5b the same way)
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek_moe_16b --smoke --device cpu --mesh 2,2 \\
      --device-count 4 --steps 2

  # a hop plan: FP32 means over 8 workers, a G-Binary vote over 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b \\
      --smoke --device cpu --mesh 2,8,1 --steps 2 --plan hier_fp32_gbinary

  # the paper controller (warm-up -> calibrate -> admit -> guarded):
  ... --controller paper --warmup-steps 1    # equivalent: --plan adaptive

  # autotune against the simulator, then train under the tuned controller:
  ... --autotune --autotune-topology ici_ring --autotune-strategy grid \
      --autotune-out tuned.json

``--controller`` accepts any registered controller: ``paper``
(``adaptive``), ``static`` (with a concrete ``--plan``) and ``fp32``.
``--autotune`` searches the presets and the generated
low-bit plans offline (:mod:`repro_torch.tune`, on the model's ``meta``
parameters), adopts the winner's bucket budget and trains under the
``tuned`` controller, which re-ranks the sim-certified shortlist from
the measured step times; it overrides ``--plan`` and ``--controller``.
``--ckpt-dir`` checkpoints every ``--ckpt-interval`` steps and restores
the newest checkpoint on start.  ``--device-count N`` is the port's
counterpart of the reference's forced host device count: outside
``torchrun`` the launcher starts the N ranks of the mesh itself (one
process each, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set as
``torchrun`` sets them, a rendezvous on a free ``localhost`` port) and
waits for them; N must equal the mesh's size, and under ``torchrun``
``WORLD_SIZE``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0p6b \
      --smoke --device cpu --mesh 2,2 --steps 1 --device-count 4
"""
import argparse
import logging
import os
import socket
import subprocess
import sys
from datetime import timedelta

#: the plan presets this port carries (repro_torch.fabric.plan_presets)
_PLAN_CHOICES = ["fp32", "gbin_backbone", "gbin_vote", "gbin_packed",
                 "gter_backbone", "gter_vote", "lowbit_all",
                 "gbin_packed_all", "gbin_packed_embed", "int4_backbone",
                 "topk_backbone", "hier_fp32_gbinary", "hier_fp32_gternary",
                 "hier_fp32_int4", "adaptive"]

#: how long a collective may wait for the other ranks before it fails
_GROUP_TIMEOUT = timedelta(seconds=60)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--mesh", default="1,1",
                    help="data,model (or pod,data,model) mesh shape; a "
                         "model axis above 1 runs under torchrun")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--plan", default="gbin_backbone", choices=_PLAN_CHOICES)
    ap.add_argument("--controller", default=None,
                    help="registered admission controller driving the run "
                         "(paper, adaptive, static, fp32); overrides --plan")
    ap.add_argument("--autotune", action="store_true",
                    help="search plan_presets + generated low-bit plans "
                         "offline (repro_torch.tune) and train on the "
                         "winner; overrides --plan / --controller")
    ap.add_argument("--autotune-topology", default="ici_ring",
                    help="sim topology the autotuner certifies against")
    ap.add_argument("--autotune-strategy", default="grid",
                    help="registered search strategy (grid, random, "
                         "successive_halving)")
    ap.add_argument("--autotune-out", default=None,
                    help="write the TunedPlan artifact JSON here")
    ap.add_argument("--warmup-steps", type=int, default=20,
                    help="FP32 calibration window of the paper controller")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: save every "
                         "--ckpt-interval steps, restore on start")
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-count", type=int, default=0,
                    help="start this many ranks of the mesh (its size) "
                         "when not under torchrun")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) not in (2, 3) or min(shape) < 1:
        ap.error(f"--mesh {args.mesh}: give data,model or pod,data,model")
    workers = 1
    for s in shape[:-1]:
        workers *= s
    world = os.environ.get("WORLD_SIZE")
    ranks = workers * shape[-1]
    if args.device_count:
        if args.device_count != ranks:
            ap.error(f"--device-count {args.device_count}: the mesh "
                     f"{args.mesh} holds {ranks} ranks")
        if world is None:
            raise SystemExit(_spawn(ranks, sys.argv[1:] if argv is None
                                    else list(argv)))
        if int(world) != args.device_count:
            ap.error(f"--device-count {args.device_count}, but torchrun "
                     f"started WORLD_SIZE={world} processes")
    if world is None and shape[-1] != 1:
        ap.error(f"--mesh {args.mesh}: a model axis above 1 runs one rank "
                 f"a process; start the launcher under torchrun with "
                 f"{workers * shape[-1]} processes")
    if world is not None and int(world) != workers * shape[-1]:
        ap.error(f"--mesh {args.mesh} holds {workers * shape[-1]} ranks, but "
                 f"torchrun started WORLD_SIZE={world} processes")

    import torch
    import torch.distributed as dist

    from ..configs import get_config
    from ..core import ProcessMesh, VirtualMesh, rank_device
    from ..data import SyntheticLMStream
    from ..fabric import Fabric, plan_presets
    from ..optim import AdamW, SgdMomentum
    from ..runtime import Trainer, TrainerConfig

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: an encoder-decoder model reads "
                 f"batch['frames'] of shape (B, {cfg.encoder_seq}, "
                 f"{cfg.d_model}), and this launcher's SyntheticLMStream "
                 f"carries tokens only, as the reference's launcher's "
                 f"does; train it through Trainer with a stream whose "
                 f"batches carry frames")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=args.seq_len,
                             batch=args.global_batch, seed=args.seed)
    opt_cls = AdamW if args.optimizer == "adamw" else SgdMomentum
    optimizer = opt_cls(peak_lr=args.lr, total_steps=args.steps)
    plans = plan_presets(error_feedback=args.error_feedback)
    if world is not None:
        device = rank_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=_GROUP_TIMEOUT)
        mesh = ProcessMesh(shape, device=device)
    else:
        device = args.device
        mesh = VirtualMesh(shape)
    fabric = Fabric(mesh=mesh)
    plan = None
    controller = args.controller or (
        "paper" if args.plan == "adaptive" else None)
    if args.autotune:
        from ..models import init_params
        tuned = fabric.autotune(init_params(cfg, device="meta"),
                                topology=args.autotune_topology,
                                strategy=args.autotune_strategy,
                                error_feedback=args.error_feedback)
        if args.autotune_out and (world is None or os.environ["RANK"] == "0"):
            tuned.save(args.autotune_out)
        logging.getLogger("repro_torch.launch").info(
            "autotuned plan %s (%s): modeled step %.1f us, %d runners-up",
            tuned.name, tuned.plan.signature(),
            tuned.score.step_time_s * 1e6, len(tuned.runners_up))
        tuned.apply(fabric)     # adopt the tuned bucket budget
        # the "tuned" controller latches the winner and re-ranks the
        # sim-certified shortlist from the measured step times
        fabric.attach_controller("tuned", tuned=tuned)
    elif controller in ("paper", "adaptive"):
        fabric.attach_controller(controller, warmup_steps=args.warmup_steps)
    elif controller == "static":
        if args.plan == "adaptive":
            ap.error("--controller static needs a concrete --plan preset")
        fabric.attach_controller("static", plan=plans[args.plan])
    elif controller is not None:
        fabric.attach_controller(controller)
    else:
        plan = plans[args.plan]
    trainer = Trainer(cfg, optimizer, data, plan=plan, fabric=fabric,
                      seed=args.seed, device=device, ckpt_dir=args.ckpt_dir,
                      tcfg=TrainerConfig(
                          checkpoint_interval=args.ckpt_interval))
    try:
        history = trainer.run(args.steps)
    finally:
        if world is not None:
            dist.destroy_process_group()
    last = history[-1]
    rank = "" if world is None else f" rank={os.environ['RANK']}"
    # one write a line: under torchrun the ranks share one stdout, and an
    # unbuffered print writes the line and its newline apart
    print(f"final: step={last['step']} loss={last['loss']:.4f} "
          f"traffic={last['traffic_ratio']:.4f} workers={workers} "
          f"model={shape[-1]} "
          f"device={trainer.device}{rank}\n", end="", flush=True)
    return history


def _spawn(n: int, argv: list) -> int:
    """Run this launcher as the ``n`` ranks of one job, as ``torchrun
    --standalone --nproc-per-node n`` would, and return the worst exit
    code."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                PYTHONPATH=os.pathsep.join(
                    [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # torchrun's default for more than one process a node
    base.setdefault("OMP_NUM_THREADS", "1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
        for r in range(n)]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(codes, key=abs)


if __name__ == "__main__":
    main()
