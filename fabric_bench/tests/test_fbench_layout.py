"""The benchmark's files: BENCHMARK.json within its schema, a cell, a
mix or a metric added by adding files alone, and no result without a
card."""
import json
import re
import time

import pytest

from fabric_bench import run
from fabric_bench.tests.tiny import HARNESS, REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_to_its_schema():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == [HARNESS.name]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(HARNESS.name + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (HARNESS / "traffic" / f"{w['traffic']}.json").exists()
        used.add(w["config"])
    assert used == {c["name"] for c in b["configs"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (HARNESS / "metrics" / f"{m['name']}.py").exists()
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


def test_limits_sit_between_their_readings():
    """Each cell's limit lies above the sound runs' largest reading and
    below the least upper reading it was set from."""
    for w in _bench()["workloads"]:
        lim = json.loads((HARNESS / "limits" / f"{w['name']}.json")
                         .read_text())
        for name, r in lim["readings"].items():
            if name in lim.get("not_compared", {}):
                assert r["upper"] is None and name not in lim
                continue
            assert r["lower"] < lim[name] < r["upper"], (w["name"], name)


def test_a_cell_a_mix_and_a_metric_are_added_as_files(tmp_path, capsys):
    root = make_root(tmp_path)
    h = root / HARNESS.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((h / "traffic" / "gbin_packed.s2048.json").read_text())
    mix["seqs_per_worker"] = 1
    (h / "traffic" / "gbin_packed.one_row.json").write_text(json.dumps(mix))
    (h / "metrics" / "traced_steps.py").write_text(
        "def read(t):\n    return float(t.steps)\n")
    (h / "limits" / "sc2.one_row.json").write_text(
        (h / "limits" / "sc2_15b_l4.gbin_packed.s2048.json").read_text())
    bench["workloads"].append({"name": "sc2.one_row",
                               "config": "starcoder2-15b_l4",
                               "traffic": "gbin_packed.one_row", "chips": 1,
                               "why": "one row a worker"})
    bench["per_layer"].append({"name": "traced_steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "whole step",
                               "moves": "train_tokens_per_s",
                               "workloads": ["sc2.one_row"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run.main(["--workload", "sc2.one_row", "--seed", "9",
                     "--seconds", "0.1", "--trace", "1"], root=root,
                    device="cpu", t0=time.perf_counter()) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metrics"]["traced_steps"]["value"] == mix["trace_steps"]
    assert result["correct"], result["checks"]


def test_no_result_without_a_card(capsys):
    """This sandbox has no CUDA card: the run exits 2 and prints nothing
    on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert run.main(["--workload", _bench()["workloads"][0]["name"],
                     "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
