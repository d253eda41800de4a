"""Block-paged KV cache: one preallocated pool, a host-side allocator (port
of mobilefinetuner_tpu/serve/paged_kv.py).

    pool_k / pool_v : [num_blocks, L, KV, block_T, D]

Request r's logical column t lives at physical page `tbl[r, t // block_T]`,
offset `t % block_T`, and every page holds ALL layers' K/V for its span.
Block 0 is reserved as the TRASH page: idle slots' writes and padded
block-table rows land there, so the decode step needs no branches.

Pages are refcounted: requests whose prompts share a hashed full-block
prefix (serve/prefix_cache.py) map the same physical pages, so a page is
released only on its last reference. A page whose refcount reaches zero
while a prefix cache still maps its contents is PARKED instead of freed:
it counts as free (reclaimable at any moment, least recently parked
first) but keeps its contents until the allocator needs it, which is what
turns a finished request's prompt pages into the next request's prefix
hit. `in_use` counts only referenced pages, so "every request terminal
=> in_use == 0" holds whether or not a cache parks pages on top.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

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
    one more when decode crosses a page boundary, `free(ids)` drops one
    reference per page. LIFO reuse. Shared-prefix reuse adds:

      retain(b)   one more reference on an in-use page;
      adopt(b)    revive a parked page (ref 0, contents cached) to ref 1;
      acquire(b)  retain or adopt, whichever state the page is in;
      free(ids, park=fn)   at ref 0, `park(b)` returns the page's cache
                  key (the page parks, most recently used last) or None
                  (plain free). Reclaiming a parked page calls
                  `on_evict(b, key)` so the cache forgets it first;
      flush_parked()  forget every parked page.

    A page is never referenced and parked at once."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 data + reserved trash block "
                f"{TRASH_BLOCK}), got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        # ref 0 pages whose contents a prefix cache maps; insertion order
        # is the LRU order (oldest first)
        self._parked: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()
        self.on_evict: Optional[Callable[[int, object], None]] = None

    @property
    def free_blocks(self) -> int:
        """Allocatable pages: truly free + parked."""
        return len(self._free) + len(self._parked)

    @property
    def in_use(self) -> int:
        """Referenced pages: 0 once every request is terminal."""
        return len(self._ref)

    @property
    def parked_blocks(self) -> int:
        return len(self._parked)

    @property
    def parked(self) -> List[int]:
        """The parked pages, least recently parked first."""
        return list(self._parked)

    @property
    def refcounts(self) -> Dict[int, int]:
        return dict(self._ref)

    def alloc(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise OutOfBlocks(
                f"asked for {n} pages, {self.free_blocks} free "
                f"(pool has {self.num_blocks - 1} allocatable)")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                # reclaim the least recently parked page; the cache
                # forgets it before the new owner writes
                b, key = self._parked.popitem(last=False)
                if self.on_evict is not None:
                    self.on_evict(b, key)
            self._ref[b] = 1
            out.append(b)
        return out

    def append(self) -> int:
        return self.alloc(1)[0]

    def retain(self, b: int) -> None:
        """One more reference on an in-use page."""
        b = int(b)
        if b not in self._ref:
            raise ValueError(f"retain of un-referenced block {b}")
        self._ref[b] += 1

    def acquire(self, b: int) -> None:
        """One reference on a cached page, in use or parked. Acquired
        pages cannot be evicted, so acquire every cached page before
        alloc() takes fresh ones."""
        b = int(b)
        if b in self._ref:
            self._ref[b] += 1
        else:
            self.adopt(b)

    def adopt(self, b: int) -> None:
        """Revive a parked page to ref 1."""
        b = int(b)
        if b not in self._parked:
            raise ValueError(f"adopt of un-parked block {b}")
        del self._parked[b]
        self._ref[b] = 1

    def free(self, ids, park: Optional[Callable[[int], object]] = None
             ) -> None:
        """Drop one reference per page; at zero the page parks (when
        `park(b)` returns its cache key) or is free again."""
        for b in ids:
            b = int(b)
            if b == TRASH_BLOCK:
                raise ValueError("freeing the reserved trash block")
            if b not in self._ref or not 0 < b < self.num_blocks:
                raise ValueError(f"double/invalid free of block {b}")
            self._ref[b] -= 1
            if self._ref[b]:
                continue
            del self._ref[b]
            key = park(b) if park is not None else None
            if key is not None:
                self._parked[b] = key       # the most recently used end
            else:
                self._free.append(b)

    def flush_parked(self) -> int:
        """Forget every parked page (the pools were rebuilt, so cached
        contents no longer exist); returns how many."""
        n = len(self._parked)
        while self._parked:
            b, _ = self._parked.popitem()
            self._free.append(b)
        return n
