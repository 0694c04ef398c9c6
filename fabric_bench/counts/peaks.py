"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the full
700 W power limit: 989 TFLOP/s bf16 and 3.35 TB/s of HBM3.  A card set
below 700 W runs slower; the harness prints the power limit beside
every run.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str) -> dict | None:
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or
    None for a card the table lacks (its rooflines are then not read)."""
    return PEAKS.get(device_name)
