"""The packed vote's share of its bandwidth roofline: the least time
for the bytes ``sign_pack``, ``vote_combine`` and ``unpack_ternary``
need on the step's voted elements (``counts.kernel_bytes``, from the
configuration's layout and the mix's voted groups) at the card's HBM
bandwidth, over those kernels' measured device time."""
import math

from fabric_bench.counts import kernel_bytes, peaks
from fabric_bench.counts.port_kernels import VOTE
from fabric_bench.reference import model as M
from fabric_bench.reference.train import group_of


def read(t):
    pk = peaks.peaks_of(t.device_kind)
    spent = sum(t.port.get(k, (0.0, 0))[0] for k in VOTE)
    if pk is None or spent <= 0:
        return None
    c = t.cell
    m = c.config["model"]
    votes = {g for g, how in c.traffic["reference_plan"].items()
             if how == "gbinary"}
    n = sum(math.prod(shape) for p, (shape, _) in M.layout(m).items()
            if group_of(p) in votes)
    value_bytes = 2 if m["dtype"] in ("bfloat16", "float16") else 4
    need = kernel_bytes.vote_bytes(n, c.workers, value_bytes) * t.steps
    return 100.0 * need / pk["hbm_bytes_per_s"] / spent
