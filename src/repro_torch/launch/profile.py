"""Profile the port's train step on a CUDA device.

    python -m repro_torch.launch.profile --arch qwen3_0p6b --mesh 4,1

Builds the same run as the launcher (random weights from ``--seed``,
``SyntheticLMStream(learnable=False)``), takes ``--warmup`` steps, then
traces ``--steps`` steps with ``torch.profiler`` and prints: the card's
name and power limit, each traced step's wall time, the device busy
share (kernel time over wall time), the kernel time of the three
aggregation kernels and of the rest, and the top kernels by device time.
Writes a Chrome trace to the path ``--trace`` names, when given.
"""
import argparse
import subprocess
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="4,1")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--plan", default="gbin_packed")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace to this path")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..configs import get_config
    from ..data import SyntheticLMStream
    from ..fabric import Fabric, plan_presets
    from ..optim import AdamW
    from ..runtime import Trainer

    shape = tuple(int(x) for x in args.mesh.split(","))
    if shape[-1] != 1:
        ap.error("the port runs data parallelism only: give W,1")
    workers = 1
    for s in shape[:-1]:
        workers *= s
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cfg = get_config(args.arch, smoke=args.smoke)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=args.seq_len,
                             batch=args.global_batch, seed=args.seed,
                             learnable=False)
    trainer = Trainer(cfg, AdamW(total_steps=100), data,
                      plan=plan_presets()[args.plan],
                      fabric=Fabric(num_workers=workers), seed=args.seed)
    trainer.run(args.warmup)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(args.warmup + args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = [h["step_time_s"] for h in trainer.history[args.warmup:]]
    print(f"traced steps: {steps} s, wall {wall:.4f} s")

    events = prof.key_averages()
    dev = [(e.key, e.device_time_total, e.count) for e in events
           if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    if not dev:
        dev = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.self_device_time_total > 0]
    total_us = sum(t for _, t, _ in dev)
    ours = {"sign_pack_kernel", "vote_combine_kernel",
            "unpack_ternary_kernel"}
    agg_us = sum(t for k, t, _ in dev if any(o in k for o in ours))
    print(f"device kernel time {total_us / 1e3:.3f} ms over {len(steps)} "
          f"steps; busy share {total_us / 1e6 / wall:.4f}; aggregation "
          f"kernels {agg_us / 1e3:.3f} ms")
    for key, t, n in sorted(dev, key=lambda x: -x[1])[:args.top]:
        print(f"  {t / 1e3:10.3f} ms  {n:6d}x  {key[:110]}")
    cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:args.top]
    print("top host ops by self CPU time:")
    for e in cpu:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:6d}x  "
              f"{e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
