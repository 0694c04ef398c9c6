"""A cell of ``BENCHMARK.json``, found by name from data files alone.

A workload names a configuration (its ``file``, given in
``BENCHMARK.json``) and a traffic mix (``traffic/<mix>.json`` beside
this module); its per-layer metrics are read by ``metrics/<name>.py``
and its correctness is held to ``limits/<workload>.json``.  Adding a
cell, a mix or a metric adds files: no module here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HARNESS = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict            # configs/<config>.json
    traffic_name: str
    traffic: dict           # traffic/<mix>.json
    end_to_end: tuple       # the BENCHMARK.json entries this cell reports
    per_layer: tuple
    limits: dict | None     # limits/<workload>.json, None where absent
    harness: Path           # the directory holding traffic/, metrics/, ...

    @property
    def workers(self) -> int:
        return int(self.config["workers"])

    @property
    def seq_len(self) -> int:
        return int(self.traffic["seq_len"])

    @property
    def global_batch(self) -> int:
        """Rows a step: every worker's sequences."""
        return self.workers * int(self.traffic["seqs_per_worker"])

    @property
    def tokens_per_step(self) -> int:
        return self.global_batch * self.seq_len


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises KeyError
    for a name the file does not hold."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    harness = root / HARNESS.name
    limits_file = harness / "limits" / f"{workload}.json"
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads(
            (harness / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reports(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reports(m, workload)),
        limits=(json.loads(limits_file.read_text())
                if limits_file.exists() else None),
        harness=harness)


def metric_reader(cell: Cell, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = cell.harness / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"fabric_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
