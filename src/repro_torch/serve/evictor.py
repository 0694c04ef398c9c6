"""LRU eviction of cold KV blocks into a modeled CXL memory tier.

Port of ``repro/serve/evictor.py``.  Preempted requests do not lose
their KV state: their blocks turn *cold* (registered with
:class:`LRUEvictor`) and stay resident until the allocator needs the
space, when the least-recently-used cold block spills, a whole block at
a time, into :class:`CxlTier`, the modeled far-memory pool.  Resuming a
request fetches its spilled blocks back.  The tier prices spill and
fetch traffic at the KV codec's wire price (``kv_bytes``), which is
what :meth:`ServeEngine.simulate` replays through ``repro_torch.sim``.

In the port the resident pool is a tensor on the engine's device and
the tier is host memory: a spill copies the block to the host, a fetch
copies it back.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


class LRUEvictor:
    """Tracks evictable (cold) blocks ordered by last-use tick."""

    def __init__(self):
        self._cold: dict[int, int] = {}     # block_id -> last_use tick

    def add(self, block_id: int, tick: int) -> None:
        """Mark a block cold (evictable) as of ``tick``."""
        self._cold[block_id] = int(tick)

    def remove(self, block_id: int) -> None:
        """A cold block became hot again (its request resumed)."""
        self._cold.pop(block_id, None)

    def pop_lru(self):
        """Evict the least-recently-used cold block (None when empty)."""
        if not self._cold:
            return None
        bid = min(self._cold, key=lambda b: (self._cold[b], b))
        del self._cold[bid]
        return bid

    def __contains__(self, block_id: int) -> bool:
        return block_id in self._cold

    def __len__(self) -> int:
        return len(self._cold)


@dataclasses.dataclass
class CxlTier:
    """Modeled CXL far-memory pool holding spilled KV blocks in host
    memory.

    Blocks are stored verbatim (quantization happened when the cache was
    written, so spill and fetch round trips are lossless) but priced at
    the codec's wire cost: a spilled int4 block moves 8x fewer bytes
    across the CXL link than an fp32 one.
    """
    codec: Any                              # resolved codec with kv_cache
    store: dict = dataclasses.field(default_factory=dict)
    spilled_bytes: float = 0.0
    fetched_bytes: float = 0.0
    spills: int = 0
    fetches: int = 0

    def spill(self, key, block: torch.Tensor) -> None:
        """Copy one block out of the resident pool into host memory (the
        pool slot is reused right after)."""
        self.store[key] = block.to("cpu", copy=True)
        self.spilled_bytes += self.codec.kv_bytes(block.numel())
        self.spills += 1

    def fetch(self, key) -> torch.Tensor:
        """Bring a spilled block back (a host tensor); removes it from
        the tier."""
        block = self.store.pop(key)
        self.fetched_bytes += self.codec.kv_bytes(block.numel())
        self.fetches += 1
        return block

    def drop(self, key) -> None:
        """Discard a spilled block (its request finished while out)."""
        self.store.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self.store

    def __len__(self) -> int:
        return len(self.store)
