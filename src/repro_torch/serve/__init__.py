"""repro_torch.serve — continuous-batching serving over a paged KV cache.

Port of ``repro/serve``: a block-paged, codec-quantized KV cache
(:mod:`cache`, :mod:`blocks`, :mod:`evictor`), a continuous-batching
scheduler with pluggable policies (:mod:`scheduler`) and the
:class:`ServeEngine` (:mod:`engine`) that drives the runtime's
``build_cached_prefill`` / ``build_serve_step`` over it, emitting a
per-step traffic timeline replayable through :mod:`repro_torch.sim`.
The block pool and the dense decode cache are tensors on the engine's
device; spilled blocks wait in host memory, the modeled CXL tier.

Quick use (``device="cpu"`` on a machine without a card)::

    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, max_batch=4, num_blocks=64, block_size=16,
                      kv_codec="int4", device="cuda")
    outputs = eng.serve([{"prompt": [3, 5, 7], "max_new_tokens": 8},
                         {"prompt": [11, 2], "max_new_tokens": 8,
                          "arrival_step": 2}])
    report = eng.simulate(topology="cxl_switched")
"""
from .blocks import BlockAllocator, BlockStats, NoFreeBlocks
from .cache import PagedKVCache
from .engine import (PAGEABLE_FAMILIES, DecodeTimeline, ServeEngine,
                     StepRecord)
from .evictor import CxlTier, LRUEvictor
from .scheduler import (FcfsPolicy, Request, RequestState, Scheduler,
                        SjfPolicy, available_policies, get_policy,
                        register_policy, unregister_policy)

__all__ = [
    "BlockAllocator", "BlockStats", "NoFreeBlocks",
    "PagedKVCache",
    "PAGEABLE_FAMILIES", "DecodeTimeline", "ServeEngine", "StepRecord",
    "CxlTier", "LRUEvictor",
    "FcfsPolicy", "Request", "RequestState", "Scheduler", "SjfPolicy",
    "available_policies", "get_policy", "register_policy",
    "unregister_policy",
]
