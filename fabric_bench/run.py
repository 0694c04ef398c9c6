"""Run one cell of the port's benchmark and print its result line.

    python3 fabric_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up builds the port's kernels (into
``build/kernels/`` of the checkout), the port's Trainer with the
benchmark's seeded weights and batches, and runs the mix's set-up steps
through ``Trainer.run``, keeping their losses, the first aggregate's
norms and votes (from AdamW's state) and each leaf's change.  With
``--trace 0`` the same Trainer then trains for ``--seconds`` and the run
reports the cell's end-to-end metrics; with ``--trace 1`` it traces the
mix's ``trace_steps`` steps and reports the per-layer metrics.  Then the
program's state is freed and the plain reference follows the set-up
steps from the same weights and batches; the comparison decides
``correct``.  The last line of standard output is the result as JSON,
the last lines of standard error each number compared beside its limit.

Exits 2 without a result when there is no CUDA card (or fewer than the
cell asks for), 3 when JAX or the JAX package is loaded by the time the
result would be printed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CODE_ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, *, root: Path = CODE_ROOT, device: str = "cuda",
         t0: float = T0) -> int:
    """Run a cell; returns the exit code.  ``root`` holds BENCHMARK.json
    and the data files; ``device="cpu"`` skips the look for a card (the
    harness's own tests)."""
    args = parse(argv)
    for p in (str(CODE_ROOT), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from fabric_bench import program
    from fabric_bench import trace as tracing
    from fabric_bench.reference import compare
    from fabric_bench.reference import train as reference
    from fabric_bench.spec import load_cell, metric_reader

    cell = load_cell(root, args.workload)
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            _say(f"{args.workload} needs {cell.chips} CUDA card(s); this "
                 f"machine has {torch.cuda.device_count()}")
            return 2
        _say(f"card: {_card_line()}")
        from repro_torch.kernels import build
        built = build.build_all()
        if built:
            _say(f"built {len(built)} kernel sources")
    kind = torch.cuda.get_device_name() if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # set-up: the Trainer, its seeded weights, the set-up steps
    tr = cell.traffic
    trainer = program.build_trainer(cell, args.seed, device)
    n_ref = int(tr["reference_steps"])
    grad_norms = change = votes = None
    for step in range(int(tr["setup_steps"])):
        trainer.run(step + 1)
        if step == 0:
            grad_norms = program.first_grad_norms(trainer)
            votes = program.first_votes(trainer, reference.voted_paths(
                program.leaves(trainer), tr))
        if step + 1 == n_ref:
            change = program.change_norms(trainer, args.seed)
    prog = reference.Readings(losses=program.losses(trainer, n_ref),
                              grad_norms=grad_norms, change_norms=change,
                              votes=votes)
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics, device_info, breakdown = {}, {}, None
    if args.trace == 0:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        setup_s = start - t0
        first = trainer.state.step
        while True:
            trainer.run(trainer.state.step + 1)
            end = time.perf_counter()
            if end - start >= args.seconds:
                break
        steps = trainer.state.step - first
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        times = sorted(h["step_time_s"] for h in trainer.history[-steps:])
        _say(f"window: {steps} steps in {end - start!r} s, step_time_s "
             f"min {times[0]!r} median {times[len(times) // 2]!r} "
             f"max {times[-1]!r}")
        values = {"train_tokens_per_s": steps * cell.tokens_per_step
                  / (end - start),
                  "peak_mem_gib": window_peak / 2 ** 30,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        peak = max(setup_peak, window_peak)
    else:
        t = tracing.record(trainer, cell, int(tr["trace_steps"]), kind,
                           on_card)
        steps = t.steps
        for m in cell.per_layer:
            v = metric_reader(cell, m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        peak = max(setup_peak, torch.cuda.max_memory_allocated()
                   if on_card else 0)
        device_info = {"busy_s": t.busy_s, "window_s": t.window_s}
        breakdown = t.breakdown()
        _say(f"traced: {t.steps} steps in {t.window_s!r} s, device busy "
             f"{t.busy_s!r} s; by kind {t.kinds()!r}")
    window_losses = [h["loss"] for h in trainer.history[-steps:]]
    failed = sum(not math.isfinite(x) for x in window_losses)

    # the program's state goes before the reference runs
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = reference.run(cell.config["model"], tr, cell.workers, args.seed,
                        device, steps=n_ref)
    nums = compare.numbers(prog, ref)
    correct, checks = compare.judge(nums, cell.limits)
    correct = correct and failed == 0

    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    _say(f"losses program {prog.losses} reference {ref.losses}")
    for name, (value, where) in nums.items():
        if name not in checks:
            _say(f"{name} {value!r} not compared ({where})")
    for name, (value, where) in nums.items():
        if name in checks:
            _say(f"{name} {value!r} limit {checks[name]['limit']!r} "
                 f"({where})")
    found = forbidden_modules()
    if found:
        _say(f"JAX or the JAX package was loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
