"""The yardstick's counts against hand counts."""
import math

import pytest

from fabric_bench.counts import flops, kernel_bytes, peaks
from fabric_bench.reference import model as M
from fabric_bench.spec import load_cell
from fabric_bench.tests.tiny import REPO

SC2 = "sc2_15b_l4.gbin_packed.s2048"
DSMOE = "dsmoe16b_l4.gbin_packed.s4096"

# starcoder2-15b, 4 layers: q and o 6144^2, k and v 6144 x 512, the GeLU
# MLP 2 x 6144 x 24576, the head 6144 x 49152
SC2_MATMUL = 4 * (2 * 6144 * 6144 + 2 * 6144 * 512 + 2 * 6144 * 24576) \
    + 6144 * 49152
# deepseek-moe-16b, 4 layers: attention 4 x 2048^2 a layer; the dense
# layer's SwiGLU 3 x 2048 x 11264; a MoE layer's router 2048 x 64 and 6
# routed + 2 shared SwiGLU experts of 1408; the head 2048 x 102400
DSMOE_MATMUL = 4 * 4 * 2048 * 2048 + 3 * 2048 * 11264 \
    + 3 * (2048 * 64 + 8 * 3 * 2048 * 1408) + 2048 * 102400


@pytest.mark.parametrize("workload,matmul,params", [
    (SC2, SC2_MATMUL, 2_139_179_008),
    (DSMOE, DSMOE_MATMUL, 2_269_005_824)])
def test_six_n_t_and_the_parameter_count(workload, matmul, params):
    cell = load_cell(REPO, workload)
    m = cell.config["model"]
    assert flops.matmul_params_per_token(m) == matmul
    t, s = cell.tokens_per_step, cell.seq_len
    attn = 6 * m["num_layers"] * m["num_heads"] * (m["d_model"]
                                                   // m["num_heads"]) * s
    assert flops.train_flops(m, t, s) == (6 * matmul + attn) * t
    assert sum(math.prod(shape) for shape, _ in M.layout(m).values()) \
        == params


@pytest.mark.parametrize("fn,bound_ms", [
    (lambda n, w: kernel_bytes.sign_pack_bytes(n, w), 0.2235),
    (lambda n, w: kernel_bytes.vote_combine_bytes(n, w), 0.0230),
    (lambda n, w: kernel_bytes.unpack_ternary_bytes(n), 0.0592)])
def test_vote_kernel_bounds_at_the_largest_qwen3_leaf(fn, bound_ms):
    bw = peaks.PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
    assert round(kernel_bytes.least_ms(fn(88_080_384, 4), bw), 4) \
        == bound_ms


def test_vote_bytes_is_the_three_kernels():
    n, w = 1 << 20, 4
    assert kernel_bytes.vote_bytes(n, w) == (
        kernel_bytes.sign_pack_bytes(n, w)
        + kernel_bytes.vote_combine_bytes(n, w)
        + kernel_bytes.unpack_ternary_bytes(n))
