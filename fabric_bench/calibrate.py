"""The upper readings that the comparison's limits are set from, at a
cell's size.

    python3 fabric_bench/calibrate.py --workload <cell> \
        --seeds 4,5,6 [--out file.jsonl]

For each seed: the reference in the precision below the
configuration's (the control: float8 for bfloat16), with half of the
batch left out, and with the exchange left out, each put in the
program's place against the float32 reference.  A state left unchanged
reads 1 on ``grad_gap`` and ``update_gap`` without a run.  The sound
program's readings (the lower end of each limit) are the harness's own:
``run.py`` prints each number on standard error and under ``checks``.
One JSON line a reading, on standard output and appended to ``--out``,
with both runs' losses and each leaf's norms (the first aggregate's and
the change's, the run's then the reference's, and the reference's raw
first gradient).  The benchmark's runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

CODE_ROOT = Path(__file__).resolve().parent.parent


def main(argv=None, *, root: Path = CODE_ROOT, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(CODE_ROOT), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from fabric_bench.reference import compare
    from fabric_bench.reference import train as reference
    from fabric_bench.spec import load_cell

    cell = load_cell(root, args.workload)
    tr = cell.traffic
    n_ref = int(tr["reference_steps"])
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    def ref(seed, **kw):
        t = time.perf_counter()
        if device == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        r = reference.run(cell.config["model"], tr, cell.workers, seed,
                          device, steps=n_ref, **kw)
        free()
        return r, time.perf_counter() - t

    def emit(kind, seed, run, ref_run, **extra):
        nums = compare.numbers(run, ref_run)
        line = {"workload": cell.name, "kind": kind, "seed": seed,
                **{k: v for k, (v, _) in nums.items()},
                "where": {k: w for k, (_, w) in nums.items()},
                "losses": run.losses, "ref_losses": ref_run.losses,
                "leaves": {p: [run.grad_norms[p], ref_run.grad_norms[p],
                               run.change_norms[p], ref_run.change_norms[p],
                               ref_run.raw_norms[p]]
                           for p in ref_run.grad_norms}, **extra}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    for seed in seeds(args.seeds):
        r, t_ref = ref(seed)
        for kind, kw in (("control", {"control": True}),
                         ("fault_half_batch", {"fault": "half"}),
                         ("fault_no_exchange", {"fault": "exchange"})):
            c, t_c = ref(seed, **kw)
            emit(kind, seed, c, r, run_s=t_c, reference_s=t_ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
