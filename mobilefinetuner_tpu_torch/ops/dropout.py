"""Inverted dropout, shared by every site that needs train-mode masking
(model embd/resid dropout, attention-probs dropout on the plain path, the
LoRA branch): port of mobilefinetuner_tpu/ops/dropout.py.

Randomness is an explicit integer seed per site, not a global generator:
`fold_in(seed, data)` derives a site's seed from its parent's (as
jax.random.fold_in derives keys), and `inverted_dropout` draws its mask
from a torch.Generator seeded with it on the tensor's device.
`fold_in_tensor` is the same function elementwise over int64 tensors, on
any device: the serve engine's per-row sampling draws its uniforms from
it (models/generate.sample_per_row). A seed
regenerates its mask exactly, so a block recomputed under
torch.utils.checkpoint (remat) sees the masks of its first forward.
The bits are not jax.random's: parity with the JAX package is tested with
dropout off, except the flash kernels' hash mask (ops/flash_attention.py
keep_mask), which is bit-exact.

`row_dropout` is the ids-routed LoRA path's: row b's mask is a function
of (seed, b) alone, hashed elementwise by fold_in_tensor on the tensor's
device (one mask per row, so a row's mask does not depend on which other
rows share its batch, and no host value is read).
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


def _signed(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >> 63 else c


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def fold_in_tensor(seed: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """fold_in elementwise: int64 tensors (broadcast) -> the int64 tensor of
    63-bit seeds that fold_in returns for each pair. int64 products wrap
    mod 2^64 on the CPU and the card alike, so the bits are the host
    function's."""
    z = seed.long() * _signed(0x9E3779B97F4A7C15) + data.long() + 1
    z = (z ^ _shr(z, 30)) * _signed(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _signed(0x94D049BB133111EB)
    return _shr(z ^ _shr(z, 31), 1)


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


def row_dropout(x: torch.Tensor, rate: float,
                seed: Optional[int]) -> torch.Tensor:
    """inverted_dropout with one mask per leading-axis row: element e of
    row b is kept when the top 24 bits of fold_in(fold_in(seed, b), e),
    as a fraction of 2^24, are below 1 - rate. Identity when rate == 0 or
    seed is None."""
    if rate <= 0.0 or seed is None:
        return x
    keep = 1.0 - rate
    rows = x.shape[0]
    n = x.numel() // max(rows, 1)
    dev = x.device
    row_seeds = fold_in_tensor(
        torch.full((1,), int(seed), dtype=torch.int64, device=dev),
        torch.arange(rows, device=dev))
    bits = fold_in_tensor(row_seeds[:, None],
                          torch.arange(n, device=dev)[None, :])
    u = _shr(bits, 39).to(torch.float32) * (1.0 / (1 << 24))
    mask = (u < keep).reshape(x.shape)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
