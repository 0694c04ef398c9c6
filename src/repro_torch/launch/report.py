"""Roofline report generator: dry-run JSONs -> markdown tables.

Counterpart of ``repro/launch/report.py``, kept in the port: it reads the
dry-run JSONs of either package (the same keys).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--mesh pod_16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(results_dir: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(results_dir, "*", "*", "*.json"))):
        d = json.load(open(f))
        d["_file"] = f
        cells.append(d)
    return cells


def fmt_table(cells: list[dict], mesh_name: str, plan_filter=None) -> str:
    rows = [
        "| arch | shape | plan | compute s | memory s | collective s | "
        "dominant | roofline frac | useful | peak GiB | pod-wire GiB |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in cells:
        if d.get("mesh_name") != mesh_name:
            continue
        if "skipped" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | "
                        f"skipped | — | — | — | — |")
            continue
        if "error" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | ? | ERROR | | | | | | | |")
            continue
        plan = d.get("plan", "?")
        if plan_filter and plan not in plan_filter:
            continue
        r = d["roofline"]
        mem = d["memory"]["peak_estimate_bytes"] / 2**30
        podw = d["collectives"].get("pod_crossing_wire_bytes", 0) / 2**30
        rows.append(
            f"| {d['arch']} | {d['shape']} | {plan} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['dominant']}** "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r.get('useful_flop_ratio', 0):.2f} | {mem:.1f} "
            f"| {podw:.1f} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--mesh", default="pod_16x16")
    ap.add_argument("--plans", default=None)
    args = ap.parse_args()
    cells = load_cells(args.results)
    pf = args.plans.split(",") if args.plans else None
    print(fmt_table(cells, args.mesh, plan_filter=pf))


if __name__ == "__main__":
    main()
