"""Model FLOPs of the traced steps (``counts.flops``) over the traced
window's time, as a share of the card's bf16 peak."""
from fabric_bench.counts import flops, peaks


def read(t):
    pk = peaks.peaks_of(t.device_kind)
    if pk is None or t.window_s <= 0:
        return None
    c = t.cell
    work = flops.train_flops(c.config["model"], c.tokens_per_step * t.steps,
                             c.seq_len)
    return 100.0 * work / t.window_s / pk["bf16_flops"]
