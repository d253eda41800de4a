"""Shared-prefix KV cache: hashed full prompt blocks -> physical pages
(port of mobilefinetuner_tpu/serve/prefix_cache.py).

Prompts at tenant fan-out share a head (system prompts, few-shot
templates). The block-paged pool (serve/paged_kv.py) gives KV pages
identity, so reuse is bookkeeping: every FULL prompt block is hashed into
a position-chained key, and a later request whose prompt starts with the
same blocks maps the same physical pages instead of recomputing them.
Prefill then starts at the first uncached block (the engine chunk-
prefills only the suffix).

Keys form a chain, not independent block hashes:

    h_0 = H(identity)                 identity = KV-producing weights:
    h_i = H(h_{i-1} || tokens_i)      "base", or "<adapter>:<generation>"

so block i's key commits to the whole prefix through block i and to the
weights that produced the K/V. An adapter reload bumps its generation, so
its stale entries become unreachable and drain through the allocator's
LRU parking, never served. The keys are byte-equal to the JAX package's
(blake2b-128, tokens as 4-byte little-endian signed ints).

The allocator owns the memory, this module the map:
  * register(key, block)  a freshly computed full prompt block;
  * lookup(keys)          the longest cached chain prefix -> its pages;
  * park(block)           the allocator's free(..., park=) callback;
  * _on_evict             the allocator reclaimed a parked page: the
    mapping is forgotten before the new owner writes.

Only FULL blocks are shared. The one page two requests could both write,
a full hit's last block, is copied first by the engine (copy-on-write),
so shared page contents never change.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence


def chain_keys(prompt: Sequence[int], block_T: int,
               identity: str) -> List[bytes]:
    """Position-chained hash per FULL block of `prompt` (len(prompt) //
    block_T keys; a partial tail block is never keyed)."""
    h = hashlib.blake2b(identity.encode("utf-8"), digest_size=16).digest()
    out: List[bytes] = []
    for i in range(len(prompt) // block_T):
        blk = prompt[i * block_T:(i + 1) * block_T]
        raw = b"".join(int(t).to_bytes(4, "little", signed=True)
                       for t in blk)
        h = hashlib.blake2b(h + raw, digest_size=16).digest()
        out.append(h)
    return out


class PrefixCache:
    """The key <-> block bijection over one engine's BlockAllocator."""

    def __init__(self, alloc, block_T: int):
        self.alloc = alloc
        self.block_T = int(block_T)
        self._key_to_block: Dict[bytes, int] = {}
        self._block_to_key: Dict[int, bytes] = {}
        self.hit_tokens = 0
        self.lookup_tokens = 0
        alloc.on_evict = self._on_evict

    def __len__(self) -> int:
        return len(self._key_to_block)

    @property
    def blocks(self) -> List[int]:
        """Every page the cache maps."""
        return sorted(self._block_to_key)

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Pages of the longest cached chain prefix of `keys` (a gap makes
        the rest of a chain a miss)."""
        blocks: List[int] = []
        for k in keys:
            b = self._key_to_block.get(k)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def register(self, key: bytes, block: int) -> bool:
        """Map a freshly computed full block. First writer wins: a key
        already mapped keeps its page, and the newcomer's stays private."""
        if key in self._key_to_block:
            return False
        self._key_to_block[key] = int(block)
        self._block_to_key[int(block)] = key
        return True

    def park(self, block: int) -> Optional[bytes]:
        """The allocator's free(..., park=) callback: a registered page's
        key (it parks, contents kept), None otherwise."""
        return self._block_to_key.get(int(block))

    def _on_evict(self, block: int, key: bytes) -> None:
        self._key_to_block.pop(key, None)
        self._block_to_key.pop(int(block), None)

    def flush(self) -> None:
        """Drop every mapping and every parked page (the pools were
        rebuilt: cached contents no longer exist)."""
        self._key_to_block.clear()
        self._block_to_key.clear()
        self.alloc.flush_parked()

    def note_lookup(self, hit_tokens: int, total_tokens: int) -> None:
        self.hit_tokens += int(hit_tokens)
        self.lookup_tokens += int(total_tokens)

    @property
    def hit_rate(self) -> Optional[float]:
        """Share of looked-up prompt tokens served from cached pages (None
        before any lookup)."""
        if not self.lookup_tokens:
            return None
        return round(self.hit_tokens / self.lookup_tokens, 4)

    def check_consistent(self) -> None:
        """The bijection holds, and every parked page is a mapped one;
        AssertionError otherwise."""
        if len(self._key_to_block) != len(self._block_to_key):
            raise AssertionError("key<->block maps out of sync")
        for k, b in self._key_to_block.items():
            if self._block_to_key.get(b) != k:
                raise AssertionError(
                    f"block {b} maps back to a different key")
        for b in self.alloc.parked:
            if b not in self._block_to_key:
                raise AssertionError(
                    f"parked block {b} unknown to the cache")
