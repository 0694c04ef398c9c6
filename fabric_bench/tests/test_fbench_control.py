"""The lower-precision control, the reference in the precision below
the configuration's put in the program's place, fails the comparison:
here in bfloat16 against float32 configurations at CPU-test size; on the
card in float8 against the cells' bfloat16, by ``calibrate.py``."""
import pytest
import torch

from fabric_bench.reference import compare
from fabric_bench.reference import train as reference
from fabric_bench.spec import load_cell
from fabric_bench.tests.tiny import make_root

CELLS = ["sc2_15b_l4.gbin_packed.s2048", "dsmoe16b_l4.gbin_packed.s4096",
         "sc2_15b_l4.fp32.s2048"]


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tmp_path, workload, seed):
    torch.set_num_threads(1)
    cell = load_cell(make_root(tmp_path), workload)
    n = cell.traffic["reference_steps"]
    ref = reference.run(cell.config["model"], cell.traffic, cell.workers,
                        seed, "cpu", steps=n)
    control = reference.run(cell.config["model"], cell.traffic,
                            cell.workers, seed, "cpu", steps=n, control=True)
    ok, checks = compare.judge(compare.numbers(control, ref), cell.limits)
    assert not ok, checks
