"""Public entry points of the controller-datapath kernels, and the dispatch.

Every wrapper dispatches on where its operands lie: a CPU tensor goes to
the plain twin in :mod:`repro_torch.kernels.ref`, a CUDA tensor to the
hand-written Hopper kernel (built at first use by
:mod:`repro_torch.kernels.build`).  There is no third mode and no
fallback: a kernel that fails to build or launch raises.  Counterpart of
``repro/kernels/ops.py``, whose ``interpret`` switch has no analogue
here.
"""
from __future__ import annotations

from .apply_update import apply_sign_update, unpack_ternary
from .fused import (Int4KernelSet, KernelSet, TopKKernelSet, VoteKernelSet,
                    ef_residual_plane, encode_pack_ef, int4_quant_plane,
                    threshold_mask_plane, vote_combine, vote_kernel_set,
                    vote_pipeline)
from .popcount_majority import majority_decode, popcount_stack
from .ref import (LANE, PACK, from_plane, gate_words_from_mask, padded_len,
                  ternary_gate_words, to_plane)
from .sign_pack import sign_pack as pack_signs

__all__ = [
    "Int4KernelSet", "KernelSet", "LANE", "PACK", "TopKKernelSet",
    "VoteKernelSet", "apply_sign_update", "ef_residual_plane",
    "encode_pack_ef", "from_plane", "gate_words_from_mask",
    "int4_quant_plane", "kernel_wrappers", "majority_decode", "pack_signs",
    "padded_len", "popcount_stack", "ternary_gate_words",
    "threshold_mask_plane", "to_plane", "unpack_ternary", "vote_combine",
    "vote_kernel_set", "vote_pipeline",
]


def kernel_wrappers() -> dict:
    """name -> wrapper, for every kernel of the port (each carries an
    integer ``launches`` count, bumped only where it launches)."""
    return {"sign_pack": pack_signs, "vote_combine": vote_combine,
            "unpack_ternary": unpack_ternary,
            "encode_pack_ef": encode_pack_ef,
            "ef_residual": ef_residual_plane,
            "popcount_stack": popcount_stack,
            "majority_decode": majority_decode,
            "vote_pipeline": vote_pipeline,
            "apply_sign_update": apply_sign_update,
            "int4_quant": int4_quant_plane,
            "threshold_mask": threshold_mask_plane}
