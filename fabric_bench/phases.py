"""Lay the port's spans over a traced window of one cell and print the
per-layer metrics that read them.

    python3 fabric_bench/phases.py --workload <cell> --seed <n>

From the root of a checkout, on a CUDA card.  Set-up is ``run.py``'s:
the port's kernels built, the cell's Trainer with the benchmark's seeded
weights and batches, the mix's set-up steps.  Then the mix's
``trace_steps`` steps are traced with the port's span
recorder on (:func:`fabric_bench.spans.record`).  Standard error gets
the card, the share of the device's busy time under the step's six
phase spans, the port kernels' launches that fall inside
``fabric.aggregate`` (all of them, where the spans and the device trace
share a clock), each span name's device time a step, inclusive and
self, and the longest idle gaps named by span.  The last line of
standard output is JSON: each reader of :data:`SPAN_METRICS` on that
trace, in its unit, where it finds something to read.  No reference
runs here: ``run.py`` decides ``correct``.
"""
import argparse
import json
import sys
from pathlib import Path

CODE_ROOT = Path(__file__).resolve().parent.parent

#: the readers in ``metrics/`` of the program's spans and counters
SPAN_METRICS = {"forward_ms": "ms/step", "backward_ms": "ms/step",
                "grad_stack_ms": "ms/step", "aggregate_ms": "ms/step",
                "agg_norm_ms": "ms/step", "optimizer_ms": "ms/step",
                "attention_ms": "ms/step", "moe_routing_ms": "ms/step",
                "moe_slot_fill_pct": "%",
                "exchange_bytes_per_step": "MiB/step",
                "loop_idle_ms": "ms/step"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    return ap.parse_args(argv)


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def trace_cell(cell, seed: int, device: str):
    """The cell's Trainer after its set-up steps and a traced window of
    the mix's ``trace_steps`` more: ``(trainer, SpanTrace)``."""
    import torch
    from fabric_bench import program
    from fabric_bench import spans
    on_card = device == "cuda"
    trainer = program.build_trainer(cell, seed, device)
    trainer.run(int(cell.traffic["setup_steps"]))
    kind = torch.cuda.get_device_name() if on_card else "cpu"
    t = spans.record(trainer, cell, int(cell.traffic["trace_steps"]), kind,
                     on_card)
    return trainer, t


def main(argv=None, *, root: Path = CODE_ROOT, device: str = "cuda") -> int:
    """Trace a cell; returns the exit code (2 without a CUDA card where
    ``device`` is ``"cuda"``)."""
    args = parse(argv)
    for p in (str(CODE_ROOT), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from fabric_bench import run
    from fabric_bench.spans import PHASES
    from fabric_bench.spec import load_cell, metric_reader

    cell = load_cell(root, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            _say(f"{args.workload} needs a CUDA card")
            return 2
        _say(f"card: {run._card_line()}")
        from repro_torch.kernels import build
        build.build_all()
    _, t = trace_cell(cell, args.seed, device)
    metrics = {}
    for name, unit in SPAN_METRICS.items():
        v = metric_reader(cell, name)(t)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    inside, ports = t.port_in_aggregate
    phase_s = sum(t.inclusive.get(p, 0.0) for p in PHASES)
    _say(f"traced: {t.steps} steps in {t.window_s!r} s, device busy "
         f"{t.busy_s!r} s, under a phase span {t.covered_s!r} s; the six "
         f"phases sum to {phase_s!r} s; port kernel launches inside "
         f"fabric.aggregate {inside} of {ports}")
    for name in sorted(t.inclusive):
        _say(f"span {name}: {t.inclusive[name] / t.steps * 1e3!r} ms a step"
             f" inclusive, {t.self_time.get(name, 0.0) / t.steps * 1e3!r} "
             f"self")
    for name in sorted({c.name for c in t.record.counts} | set(
            t.record.device)):
        _say(f"counter {name}: {t.record.counter(name) / t.steps!r} a step")
    result = {"workload": args.workload, "steps": t.steps,
              "metrics": metrics,
              "coverage_pct": (100.0 * t.covered_s / t.busy_s
                               if t.busy_s > 0 else None),
              "port_launches_in_aggregate": [inside, ports],
              "window_s": t.window_s, "busy_s": t.busy_s,
              "idle_gaps": t.breakdown()["idle_gaps"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
