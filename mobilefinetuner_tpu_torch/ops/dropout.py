"""Inverted dropout, shared by every site that needs train-mode masking
(model embd/resid dropout, attention-probs dropout on the plain path, the
LoRA branch): port of mobilefinetuner_tpu/ops/dropout.py.

Randomness is an explicit integer seed per site, not a global generator:
`fold_in(seed, data)` derives a site's seed from its parent's (as
jax.random.fold_in derives keys), and `inverted_dropout` draws its mask
from a torch.Generator seeded with it on the tensor's device. A seed
regenerates its mask exactly, so a block recomputed under
torch.utils.checkpoint (remat) sees the masks of its first forward.
The bits are not jax.random's: parity with the JAX package is tested with
dropout off, except the flash kernels' hash mask (ops/flash_attention.py
keep_mask), which is bit-exact.
"""

from __future__ import annotations

from typing import Optional

import torch

_M64 = (1 << 64) - 1


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from (seed, data): a splitmix64 finalizer over
    their combination. Pure host arithmetic (no device work)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def inverted_dropout(x: torch.Tensor, rate: float,
                     seed: Optional[int]) -> torch.Tensor:
    """x scaled by 1/keep on surviving elements; identity when rate == 0
    or seed is None (eval mode)."""
    if rate <= 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
