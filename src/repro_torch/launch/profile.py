"""Profile the port's train step on a CUDA device.

    python -m repro_torch.launch.profile --arch qwen3_0p6b --mesh 4,1
    python -m repro_torch.launch.profile --arch hymba_1p5b --num-layers 5 \
        --mesh 2,1 --global-batch 4 --seq-len 2048 --warmup 1 --steps 1

Builds the same run as the launcher (random weights from ``--seed``,
``SyntheticLMStream(learnable=False)``; an encoder-decoder's batches
also carry seeded ``frames``, :class:`~repro_torch.data.FramesStream`),
takes ``--warmup`` steps, then
traces ``--steps`` steps with ``torch.profiler`` and the span recorder
(:mod:`repro_torch.core.spans`) on, and prints: the card's name and
power limit, each traced step's wall time, the host's kernel launch
calls (``cudaLaunchKernel`` and its variants) a step, the device busy
share (the union of the device's intervals over the wall time, so
overlapping work counts once), each span's count and host time a step,
and the top kernels by device time and host operators by self time.
Writes a Chrome trace to the path ``--trace`` names, when given.
"""
import argparse
import dataclasses
import subprocess
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="4,1")
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the config to this depth (0: the config's)")
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
    from ..core import spans
    from ..data import FramesStream, SyntheticLMStream
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
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=args.seq_len,
                             batch=args.global_batch, seed=args.seed,
                             learnable=False)
    if cfg.family == "encdec":
        data = FramesStream(data, cfg.encoder_seq, cfg.d_model)
    trainer = Trainer(cfg, AdamW(total_steps=100), data,
                      plan=plan_presets()[args.plan],
                      fabric=Fabric(num_workers=workers), seed=args.seed)
    trainer.run(args.warmup)
    torch.cuda.synchronize()
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(args.warmup + args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans.disable()
    rec = spans.take()
    steps = [h["step_time_s"] for h in trainer.history[args.warmup:]]
    print(f"traced steps: {steps} s, wall {wall:.4f} s")

    # one pass over the events: key_averages() takes ~80 us an event, and
    # a recurrent model's step holds millions
    dev, host, launch_calls = {}, {}, 0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            t, n = dev.get(e.key, (0.0, 0))
            dev[e.key] = (t + e.device_time_total, n + 1)
            continue
        launch_calls += e.key.startswith(("cudaLaunchKernel",
                                          "cuLaunchKernel"))
        t, n = host.get(e.key, (0.0, 0))
        host[e.key] = (t + e.self_cpu_time_total, n + 1)
    print(f"kernel launch calls {launch_calls} in {len(steps)} steps: "
          f"{launch_calls / len(steps):.0f} a step")
    total_us = sum(t for t, _ in dev.values())
    busy_ns = union_ns([(e.start_ns(), e.end_ns())
                        for e in prof.profiler.kineto_results.events()
                        if e.device_type().name == "CUDA"])
    print(f"device kernel time {total_us / 1e3:.3f} ms over {len(steps)} "
          f"steps; busy share {busy_ns / 1e9 / wall:.4f}")
    print("spans a step: count, host ms")
    for name, (n, ns) in sorted(span_totals(rec).items()):
        print(f"  {n / len(steps):8.1f}  {ns / 1e6 / len(steps):10.3f} ms  "
              f"{name}")
    for key, (t, n) in sorted(dev.items(), key=lambda x: -x[1][0])[:args.top]:
        print(f"  {t / 1e3:10.3f} ms  {n:6d}x  {key[:110]}")
    print("top host ops by self CPU time:")
    for key, (t, n) in sorted(host.items(),
                              key=lambda x: -x[1][0])[:args.top]:
        print(f"  {t / 1e3:10.3f} ms  {n:6d}x  {key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


def union_ns(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def span_totals(rec) -> dict:
    """Each closed span name's count and summed host nanoseconds."""
    out = {}
    for sp in rec.spans:
        if sp.end_ns is not None:
            n, ns = out.get(sp.name, (0, 0))
            out[sp.name] = (n + 1, ns + sp.end_ns - sp.start_ns)
    return out


if __name__ == "__main__":
    main()
