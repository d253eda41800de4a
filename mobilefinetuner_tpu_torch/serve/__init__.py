"""Decode service: continuous batching over static slots, a block-paged KV
cache shared by every resident request, the shared-prefix cache, chunked
prefill, per-slot sampling and multi-adapter hot-swap off one frozen base
(port of mobilefinetuner_tpu/serve/)."""

from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.serve.engine import (Request, ServeConfig,
                                                    ServeEngine)
from mobilefinetuner_tpu_torch.serve.paged_kv import (TRASH_BLOCK,
                                                      BlockAllocator,
                                                      OutOfBlocks, blocks_for,
                                                      init_pools,
                                                      write_prompt_blocks)
from mobilefinetuner_tpu_torch.serve.prefix_cache import (PrefixCache,
                                                          chain_keys)

__all__ = [
    "AdapterBank", "BlockAllocator", "OutOfBlocks", "PrefixCache", "Request",
    "ServeConfig", "ServeEngine", "TRASH_BLOCK", "blocks_for", "chain_keys",
    "init_pools", "write_prompt_blocks",
]
