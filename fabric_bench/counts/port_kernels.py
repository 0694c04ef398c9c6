"""The port's own CUDA kernels, by the device function each ``csrc/*.cu``
defines: a profiler's kernel name holds one of these as a whole word."""
from __future__ import annotations

import re

KERNELS = {
    "sign_pack": "sign_pack_kernel",
    "vote_combine": "vote_combine_kernel",
    "unpack_ternary": "unpack_ternary_kernel",
    "encode_pack_ef": "encode_pack_ef_kernel",
    "ef_residual": "ef_residual_kernel",
    "popcount_stack": "popcount_stack_kernel",
    "majority_decode": "majority_decode_kernel",
    "vote_pipeline": "vote_pipeline_kernel",
    "apply_sign_update": "apply_sign_update_kernel",
    "int4_absmax": "absmax_bits_kernel",
    "int4_quantize": "quantize_kernel",
    "threshold_mask": "threshold_mask_kernel",
}

#: the packed G-Binary vote's kernels, encode to decode
VOTE = ("sign_pack", "vote_combine", "unpack_ternary")

_PATTERNS = {k: re.compile(rf"\b{v}\b") for k, v in KERNELS.items()}


def port_kernel(device_name: str) -> str | None:
    """Which port kernel a device event is, or None."""
    for k, pat in _PATTERNS.items():
        if pat.search(device_name):
            return k
    return None
