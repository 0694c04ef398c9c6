"""The reference's examples, ported (``repro_torch.examples``), on the CPU.

  * ``serving`` and ``autotune_plan`` in this process against the
    reference's ``examples/serving.py`` and ``examples/autotune_plan.py``
    run once in a JAX subprocess: every printed line equal but the
    timings and the artifact's path (the engine's on the reference's
    ``PRNGKey(0)`` weights, carried across by ``params_from_jax``), and
    the tuned artifact's JSON equal;
  * ``elastic_training`` whole, ``layer_aware_admission`` and
    ``guarded_recovery`` at fewer steps, each with its own assertions;
  * ``quickstart``, ``train_lm`` and ``serve_lm`` once each under
    ``torchrun --standalone --nproc-per-node 8`` on gloo (the three at
    once), on their (data 4) x (model 2) mesh at 2 steps or 4 tokens;
  * the examples default to the card, and a mesh example refuses to
    start outside ``torchrun``.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    autotune_plan, elastic_training, guarded_recovery, layer_aware_admission,
    quickstart, serve_lm, serving, train_lm)
from repro_torch.models import params_from_jax  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT = 300
MARK = "=== next example ==="


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _timeless(text: str) -> list:
    """Printed lines with the wall-clock figures and the artifact's path
    taken out."""
    out = []
    for line in text.splitlines():
        line = re.sub(r" / [0-9.]+s \([0-9.]+ tok/s on [^)]*\)", "", line)
        if line.startswith("artifact: "):
            line = "artifact:"
        out.append(line)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the examples' tiny shapes (more gain
    nothing, and the suite's workers share the cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's serving and autotune examples, one subprocess."""
    out = tmp_path_factory.mktemp("examples_ref")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_PROGRAM],
                          env=_env(OUT_DIR=out, JAX_PLATFORMS="cpu",
                                   EXAMPLES=os.path.join(ROOT, "examples")),
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    serving_out, tune_out = proc.stdout.split(MARK + "\n")
    with open(out / "tuned_plan.json") as f:
        return {"serving": serving_out, "autotune_plan": tune_out,
                "tuned": json.load(f)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The three mesh examples under torchrun, started together."""
    out = tmp_path_factory.mktemp("examples_mesh")
    runs = {"quickstart": ["--steps", "2"],
            "train_lm": ["--steps", "2"],
            "serve_lm": ["--tokens", "4"]}
    procs = {}
    for name, args in runs.items():
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "8", "-m", f"repro_torch.examples.{name}",
             "--device", "cpu", *args],
            env=_env(), stdout=log, stderr=subprocess.STDOUT), log)
    try:
        for p, _ in procs.values():
            p.wait(timeout=TIMEOUT)
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return {name: (p.returncode, (out / f"{name}.log").read_text())
            for name, (p, _) in procs.items()}


def test_serving_prints_the_references_records(reference, capsys):
    """The reference's engine draws its weights from ``PRNGKey(0)``."""
    jcfg = JModelConfig(name="serving_toy", family="dense", num_layers=2,
                        d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                        vocab_size=97, dtype="float32", remat=False)
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    serving.main(["--device", "cpu"], params=params)
    got = capsys.readouterr().out
    assert _timeless(got) == _timeless(reference["serving"])
    assert "preemptions=1" in got and got.rstrip().endswith("OK")


def test_autotune_plan_prints_the_references_records(reference, capsys,
                                                     tmp_path):
    path = tmp_path / "tuned.json"
    autotune_plan.main(["--device", "cpu", "--out", str(path)])
    got = capsys.readouterr().out
    assert _timeless(got) == _timeless(reference["autotune_plan"])
    with open(path) as f:
        assert json.load(f) == reference["tuned"]


def test_elastic_training_recovers_and_replays(capsys):
    history = elastic_training.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert [h["num_workers"] for h in history][8:10] == [4, 3]
    assert "restarts=1 " in out and "crash at step 9" in out
    assert "controller demoted" in out and "controller recovered" in out
    assert "replay: 5 phases" in out


def test_layer_aware_admission_at_few_steps(capsys):
    """Past the 50-step FP32 warm-up, so that every phase is entered."""
    layer_aware_admission.main(["--device", "cpu"], steps=(60, 110))
    out = capsys.readouterr().out
    for k in range(1, 6):
        assert f"== {k}." in out
    assert "phases=['all_lowbit', 'head_fp32']" in out


def test_guarded_recovery_recovers_and_readmits(capsys):
    kinds = guarded_recovery.main(["--device", "cpu"], steps=330)
    assert kinds[:4] == ["warmup_end", "admitted", "recovery", "readmitted"]
    assert capsys.readouterr().out.rstrip().endswith("OK")


@pytest.mark.parametrize("name", ["quickstart", "train_lm", "serve_lm"])
def test_mesh_examples_under_torchrun(mesh_runs, name):
    rc, log = mesh_runs[name]
    assert rc == 0, log[-4000:]
    if name == "quickstart":
        assert "[kernels] buckets=" in log and "\nOK" in log
        assert re.search(r"loss [0-9.]+ -> [0-9.]+ over 2 steps", log)
    elif name == "train_lm":
        assert re.search(r"tiny-lm: loss [0-9.]+ -> [0-9.]+ \(2 steps", log)
    else:
        assert "decoded 4 tokens x 8 seqs" in log and "\nOK" in log


@pytest.mark.parametrize("module", [quickstart, train_lm, serve_lm,
                                    serving, elastic_training,
                                    layer_aware_admission,
                                    guarded_recovery])
def test_examples_default_to_the_card(module, monkeypatch):
    """``--device`` defaults to ``cuda``: without a card an example
    raises (or a mesh example, outside torchrun, refuses to start)
    rather than running on the CPU."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, SystemExit),
                       match="CUDA|cuda|torchrun"):
        module.main([])


REFERENCE_PROGRAM = r'''
import os, runpy, sys
sys.path.insert(0, os.environ["PYTHONPATH"])
import repro.tune.artifact as A

out = os.environ["OUT_DIR"]
save = A.TunedPlan.save
A.TunedPlan.save = lambda self, path: save(
    self, os.path.join(out, "tuned_plan.json"))
runpy.run_path(os.path.join(os.environ["EXAMPLES"], "serving.py"),
               run_name="__main__")
print("%s", flush=True)
runpy.run_path(os.path.join(os.environ["EXAMPLES"], "autotune_plan.py"),
               run_name="__main__")
''' % MARK
