"""Paged KV cache: logical block tables over a physical block pool.

Port of ``repro/serve/cache.py``.  The reference keeps its pool in host
numpy; here the pool is one tensor on the engine's device, and every
gather and scatter runs there:

  * the *pool* holds ``num_blocks`` physical blocks, each ``block_size``
    token positions of every layer and both the K and V planes, shape
    ``(num_blocks, 2, L, block_size, KV, hd)``;
  * each request owns a *block table*: logical block index -> physical
    block ID (or None while that block is spilled to the CXL tier);
  * :class:`~repro_torch.serve.blocks.BlockAllocator` hands out IDs;
    :class:`~repro_torch.serve.evictor.LRUEvictor` and
    :class:`~repro_torch.serve.evictor.CxlTier` (host memory, the
    modeled far tier) give preempted requests a place to keep state
    without holding the pool.

Every write passes through the KV codec's ``kv_encode`` (any registered
codec with ``kv_cache = True``), so the pool holds the values a
quantized cache decodes to, and gather, scatter and spill traffic is
priced at the codec's ``kv_bytes``, block by block as the reference
counts it.  Quantization granularity is the written fragment: one
block-aligned chunk during prefill, one token slice during decode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.device import resolve_device
from ..fabric.codecs import get_codec
from .blocks import BlockAllocator, NoFreeBlocks
from .evictor import CxlTier, LRUEvictor


class PagedKVCache:
    """Block-paged KV storage for attention decoder models."""

    def __init__(self, cfg, *, num_blocks: int, block_size: int,
                 kv_codec: str = "fp32", dtype=torch.float32,
                 device="cuda"):
        codec = get_codec(kv_codec)
        if not getattr(codec, "kv_cache", False):
            raise ValueError(
                f"codec {codec.name!r} does not support KV-cache payloads "
                f"(kv_cache=False); its alphabet cannot carry cache values")
        self.cfg = cfg
        self.codec = codec
        self.block_size = int(block_size)
        self.device = resolve_device(device)
        self.allocator = BlockAllocator(num_blocks)
        self.evictor = LRUEvictor()
        self.tier = CxlTier(codec)
        shape = (num_blocks, 2, cfg.num_layers, self.block_size,
                 cfg.num_kv_heads, cfg.hd)
        self.pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.block_elements = math.prod(shape[1:])
        self._tables: dict[int, list[Optional[int]]] = {}
        self._lengths: dict[int, int] = {}
        self._owner: dict[int, tuple[int, int]] = {}   # bid -> (rid, idx)
        # cumulative traffic counters (the simulate() seam)
        self.gathered_elements = 0
        self.scattered_elements = 0
        self.gathered_bytes = 0.0
        self.scattered_bytes = 0.0

    # -- request lifecycle ------------------------------------------------

    def add_request(self, rid: int) -> None:
        if rid in self._tables:
            raise ValueError(f"request {rid} already has a block table")
        self._tables[rid] = []
        self._lengths[rid] = 0

    def release(self, rid: int) -> None:
        """Free every block (resident or spilled) a request holds."""
        for idx, bid in enumerate(self._tables.pop(rid)):
            if bid is None:
                self.tier.drop((rid, idx))
            else:
                self.evictor.remove(bid)
                del self._owner[bid]
                self.allocator.free(bid)
        del self._lengths[rid]

    def length(self, rid: int) -> int:
        return self._lengths[rid]

    def __contains__(self, rid: int) -> bool:
        return rid in self._tables

    # -- allocation / eviction --------------------------------------------

    def _take_block(self) -> int:
        """Allocate a block, spilling the LRU cold block if needed."""
        try:
            return self.allocator.allocate()
        except NoFreeBlocks:
            victim = self.evictor.pop_lru()
            if victim is None:
                raise
            vrid, vidx = self._owner.pop(victim)
            self.tier.spill((vrid, vidx), self.pool[victim])
            self._tables[vrid][vidx] = None
            self.allocator.free(victim)
            return self.allocator.allocate()

    def ensure_capacity(self, rid: int, n_tokens: int) -> None:
        """Grow the request's table to cover ``n_tokens`` positions.

        Raises :class:`NoFreeBlocks` when the pool is exhausted and no
        cold block can be spilled: the scheduler's cue to preempt.
        """
        table = self._tables[rid]
        needed = -(-int(n_tokens) // self.block_size)      # ceil div
        while len(table) < needed:
            bid = self._take_block()
            self._owner[bid] = (rid, len(table))
            table.append(bid)

    def deactivate(self, rid: int, tick: int) -> None:
        """Preemption: mark the request's resident blocks cold (LRU-
        evictable) as of ``tick``; nothing moves until space is needed."""
        for bid in self._tables[rid]:
            if bid is not None:
                self.evictor.add(bid, tick)

    def activate(self, rid: int, tick: int) -> bool:
        """Resume: re-pin resident blocks, fetch spilled ones back.

        Returns False (leaving the request deactivated) when the pool
        cannot hold the working set right now.
        """
        table = self._tables[rid]
        for bid in table:
            if bid is not None:
                self.evictor.remove(bid)
        for idx, bid in enumerate(table):
            if bid is None:
                try:
                    new = self._take_block()
                except NoFreeBlocks:
                    self.deactivate(rid, tick)
                    return False
                self.pool[new] = self.tier.fetch((rid, idx))
                self._owner[new] = (rid, idx)
                table[idx] = new
        return True

    # -- data plane -------------------------------------------------------

    def _block(self, rid: int, idx: int) -> int:
        bid = self._tables[rid][idx]
        if bid is None:
            raise RuntimeError(
                f"request {rid} block {idx} is spilled; activate() first")
        return bid

    def write_prompt(self, rid: int, k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """Scatter prefill KV.  k / v: (L, P, KV, hd) on the device."""
        p = k.shape[1]
        self.ensure_capacity(rid, p)
        bs = self.block_size
        for idx in range(-(-p // bs)):
            lo, hi = idx * bs, min((idx + 1) * bs, p)
            bid = self._block(rid, idx)
            self.pool[bid, 0, :, :hi - lo] = self.codec.kv_encode(
                k[:, lo:hi])
            self.pool[bid, 1, :, :hi - lo] = self.codec.kv_encode(
                v[:, lo:hi])
            self._count_scatter(2 * k[:, lo:hi].numel())
        self._lengths[rid] = max(self._lengths[rid], p)

    def write_token(self, rid: int, pos: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Scatter one decoded token's KV.  k / v: (L, KV, hd)."""
        idx, off = divmod(int(pos), self.block_size)
        bid = self._block(rid, idx)
        self.pool[bid, 0, :, off] = self.codec.kv_encode(k)
        self.pool[bid, 1, :, off] = self.codec.kv_encode(v)
        self._count_scatter(2 * k.numel())
        self._lengths[rid] = max(self._lengths[rid], int(pos) + 1)

    def gather_into(self, rid: int, out_k: torch.Tensor,
                    out_v: torch.Tensor) -> int:
        """Densify a request's pages into (L, S_max, KV, hd) buffers.

        Returns the number of valid token positions copied; positions
        beyond it are left untouched (the decode mask hides them).
        """
        n = self._lengths[rid]
        bs = self.block_size
        for idx in range(-(-n // bs)):
            lo, hi = idx * bs, min((idx + 1) * bs, n)
            bid = self._block(rid, idx)
            out_k[:, lo:hi] = self.codec.kv_decode(
                self.pool[bid, 0, :, :hi - lo])
            out_v[:, lo:hi] = self.codec.kv_decode(
                self.pool[bid, 1, :, :hi - lo])
            self._count_gather(2 * out_k[:, lo:hi].numel())
        return n

    def _count_gather(self, elements: int) -> None:
        self.gathered_elements += elements
        self.gathered_bytes += self.codec.kv_bytes(elements)

    def _count_scatter(self, elements: int) -> None:
        self.scattered_elements += elements
        self.scattered_bytes += self.codec.kv_bytes(elements)

    # -- reporting --------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.num_in_use

    def utilization(self) -> float:
        """Fraction of pool blocks currently allocated."""
        return self.allocator.num_in_use / self.allocator.num_blocks

    def resident_bytes(self) -> float:
        """Codec-priced bytes of all resident (in-use) blocks."""
        return self.allocator.num_in_use * self.codec.kv_bytes(
            self.block_elements)
