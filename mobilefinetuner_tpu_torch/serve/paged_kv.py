"""Block-paged KV cache: one preallocated pool, a host-side allocator (port
of mobilefinetuner_tpu/serve/paged_kv.py).

    pool_k / pool_v : [num_blocks, L, KV, block_T, D]

Request r's logical column t lives at physical page `tbl[r, t // block_T]`,
offset `t % block_T`, and every page holds ALL layers' K/V for its span.
Block 0 is reserved as the TRASH page: idle slots' writes and padded
block-table rows land there, so the decode step needs no branches.

Pages are refcounted: `free` drops one reference and returns a page to the
free list on its last one. Parking pages whose contents a prefix cache
still maps (`acquire`/`adopt`/`flush_parked`) comes with the prefix-cache
slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, List

import torch

# physical page 0 is never allocated: idle slots write their garbage K/V
# there and padded block-table rows point at it (always masked)
TRASH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool cannot hold another request (admission-time signal)."""


def blocks_for(tokens: int, block_T: int) -> int:
    """Pages needed to cache `tokens` columns."""
    return max(0, -(-int(tokens) // block_T))


def init_pools(num_blocks: int, L: int, KV: int, block_T: int, D: int,
               dtype=torch.float32, device=None):
    """The two pools, zero-filled: the trash page must hold finite values,
    because a masked column's probability 0 times NaN is NaN."""
    shape = (num_blocks, L, KV, block_T, D)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def write_prompt_blocks(pool_k, pool_v, k, v, block_ids):
    """Scatter one prefilled request's K/V into its pages, in place.

    k/v: [L, KV, Ppad, D] (batch squeezed), Ppad a block_T multiple;
    block_ids: [Ppad // block_T] int tensor of physical pages, TRASH-padded
    past the prompt's real pages (their columns are never attendable, and
    which duplicate trash write wins does not matter)."""
    NB, L, KV, bT, D = pool_k.shape
    M = k.shape[2] // bT

    def pages(t):   # [L, KV, M, bT, D] -> [M, L, KV, bT, D]
        return t.reshape(L, KV, M, bT, D).permute(2, 0, 1, 3, 4)

    idx = block_ids.long()
    pool_k[idx] = pages(k).to(pool_k.dtype)
    pool_v[idx] = pages(v).to(pool_v.dtype)
    return pool_k, pool_v


class BlockAllocator:
    """Refcounted free-list allocator over the pool's pages (block 0
    reserved). `alloc(n)` takes the prompt's pages at admission, `append()`
    one more when decode crosses a page boundary, `retain(b)` adds a
    reference, `free(ids)` drops one reference per page. LIFO reuse."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 data + reserved trash block "
                f"{TRASH_BLOCK}), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Referenced pages: 0 once every request is terminal."""
        return len(self._ref)

    @property
    def refcounts(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise OutOfBlocks(
                f"asked for {n} pages, {self.free_blocks} free "
                f"(pool has {self.num_blocks - 1} allocatable)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def append(self) -> int:
        return self.alloc(1)[0]

    def retain(self, b: int) -> None:
        """One more reference on an in-use page."""
        b = int(b)
        if b not in self._ref:
            raise ValueError(f"retain of un-referenced block {b}")
        self._ref[b] += 1

    def free(self, ids) -> None:
        """Drop one reference per page; at zero the page is free again."""
        for b in ids:
            b = int(b)
            if b == TRASH_BLOCK:
                raise ValueError("freeing the reserved trash block")
            if b not in self._ref or not 0 < b < self.num_blocks:
                raise ValueError(f"double/invalid free of block {b}")
            self._ref[b] -= 1
            if not self._ref[b]:
                del self._ref[b]
                self._free.append(b)
