"""Fixed-size KV block allocator: free list + reference counting.

Port of ``repro/serve/blocks.py`` (plain Python; the block IDs only).

The physical unit of the paged KV cache is a *block* — ``block_size``
token positions across every layer and both K/V planes.  The allocator
owns the block IDs only; the backing storage lives in
:class:`~repro_torch.serve.cache.PagedKVCache`.  Reference counting makes
prefix sharing copy-on-write-free: forking a sequence increments the
refcount of its shared blocks instead of copying them, and a block
returns to the free list only when its last holder releases it.

Invariants (property-tested in ``tests/test_torch_serve.py``):

  * a block ID is either on the free list or has ``ref_count >= 1`` —
    never both, never neither;
  * ``free`` on an unallocated block raises (no double-free);
  * refcounts never go negative.
"""
from __future__ import annotations

import dataclasses


class NoFreeBlocks(RuntimeError):
    """The pool is exhausted — caller must evict or preempt."""


@dataclasses.dataclass
class BlockStats:
    """Cumulative allocator counters (monotonic except ``peak_in_use``)."""
    allocations: int = 0
    releases: int = 0
    forks: int = 0
    peak_in_use: int = 0


class BlockAllocator:
    """LIFO free list over ``num_blocks`` block IDs with refcounts."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"need at least one block, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        # LIFO so freshly freed (cache-warm) blocks are reused first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self.stats = BlockStats()

    # -- queries ----------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def ref_count(self, block_id: int) -> int:
        return self._ref[block_id]

    # -- lifecycle --------------------------------------------------------

    def allocate(self) -> int:
        """Take a free block (refcount 1) or raise :class:`NoFreeBlocks`."""
        if not self._free:
            raise NoFreeBlocks(
                f"all {self.num_blocks} KV blocks are in use")
        bid = self._free.pop()
        self._ref[bid] = 1
        self.stats.allocations += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.num_in_use)
        return bid

    def fork(self, block_id: int) -> int:
        """Share a block (copy-on-write-free): one more holder, no copy."""
        if self._ref[block_id] < 1:
            raise ValueError(f"cannot fork unallocated block {block_id}")
        self._ref[block_id] += 1
        self.stats.forks += 1
        return block_id

    def free(self, block_id: int) -> bool:
        """Drop one holder; returns True when the block was released.

        Raises on a block that has no holders (double-free guard).
        """
        if not 0 <= block_id < self.num_blocks:
            raise ValueError(f"block {block_id} out of range "
                             f"[0, {self.num_blocks})")
        if self._ref[block_id] < 1:
            raise ValueError(f"double free of block {block_id}")
        self._ref[block_id] -= 1
        if self._ref[block_id] == 0:
            self._free.append(block_id)
            self.stats.releases += 1
            return True
        return False

    def __repr__(self) -> str:
        return (f"BlockAllocator(num_blocks={self.num_blocks}, "
                f"in_use={self.num_in_use})")
