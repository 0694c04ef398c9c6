"""Nothing the harness runs loads JAX or the JAX package."""
import subprocess
import sys

from fabric_bench.tests.tiny import HARNESS, REPO

PROBE = """
import sys
sys.path[:0] = [{repo!r}, {src!r}]
import importlib, pathlib
from fabric_bench import calibrate, program, run, spec, stream, trace, weights
from fabric_bench.reference import compare, model, train
from fabric_bench.counts import flops, kernel_bytes, peaks, port_kernels
cell = spec.load_cell(pathlib.Path({repo!r}), "sc2_15b_l4.gbin_packed.s2048")
for f in sorted(pathlib.Path({harness!r}, "metrics").glob("*.py")):
    spec.metric_reader(cell, f.stem)
import repro_torch.runtime, repro_torch.fabric, repro_torch.optim
import repro_torch.kernels.ops, repro_torch.models
print(run.forbidden_modules())
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(repo=str(REPO),
                                            src=str(REPO / "src"),
                                            harness=str(HARNESS))],
        capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from fabric_bench import run
    before = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert set(run.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(run.forbidden_modules()) == before | {"repro", "jax"}


def test_no_result_once_the_jax_package_is_loaded(tmp_path, monkeypatch,
                                                  capsys):
    """A forbidden module loaded after the window, here by the
    reference's run, still keeps the result from being printed."""
    import time
    import torch
    from fabric_bench import run
    from fabric_bench.reference import train as reference
    from fabric_bench.tests.tiny import make_root
    follow = reference.run

    def loads_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax.numpy", sys)
        return follow(*args, **kw)
    monkeypatch.setattr(reference, "run", loads_jax)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = run.main(["--workload", "sc2_15b_l4.gbin_packed.s2048",
                       "--seed", "4", "--seconds", "0.1", "--trace", "0"],
                      root=make_root(tmp_path), device="cpu",
                      t0=time.perf_counter())
    finally:
        torch.set_num_threads(n)
    assert rc == 3
    assert capsys.readouterr().out == ""
