"""The plain reference against the port at SMOKE widths on the CPU.

In the configuration's own precision (float32 here) the port's losses,
first aggregates and changes after three steps agree with the
reference's to float32 rounding; run in bfloat16, a lower precision than
the configuration states, the port fails the same limits."""
import json

import pytest
import torch

from fabric_bench import program
from fabric_bench.reference import compare
from fabric_bench.reference import train as reference
from fabric_bench.spec import load_cell
from fabric_bench.tests.tiny import TINY_LIMITS, make_root

CELLS = ["sc2_15b_l4.gbin_packed.s2048", "dsmoe16b_l4.gbin_packed.s4096",
         "sc2_15b_l4.fp32.s2048"]


def readings(cell, seed):
    torch.manual_seed(0)
    trainer = program.build_trainer(cell, seed, "cpu")
    n = cell.traffic["reference_steps"]
    trainer.run(1)
    grads = program.first_grad_norms(trainer)
    votes = program.first_votes(trainer, reference.voted_paths(
        program.leaves(trainer), cell.traffic))
    trainer.run(n)
    prog = reference.Readings(program.losses(trainer, n), grads,
                              program.change_norms(trainer, seed), votes)
    ref = reference.run(cell.config["model"], cell.traffic, cell.workers,
                        seed, "cpu", steps=n)
    return compare.numbers(prog, ref)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference_in_float32(tmp_path, workload):
    cell = load_cell(make_root(tmp_path, dtype="float32"), workload)
    ok, checks = compare.judge(readings(cell, 2 ** 31 + 11), TINY_LIMITS)
    assert ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_port_in_a_lower_precision_fails(tmp_path, workload):
    """The float32 configuration run by the port in bfloat16."""
    root = make_root(tmp_path, dtype="float32")
    cell = load_cell(root, workload)
    lower = json.loads(json.dumps(cell.config))
    lower["model"]["dtype"] = "bfloat16"
    port = type(cell)(**{**cell.__dict__, "config": lower})
    nums = readings(port, 2 ** 31 + 11)
    ok, checks = compare.judge(nums, TINY_LIMITS)
    assert not ok, checks
