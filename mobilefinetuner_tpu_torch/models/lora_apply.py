"""Functional LoRA application (port of mobilefinetuner_tpu/models/
lora_apply.py).

y = base(x) + scale * ((dropout(x) @ A) @ B), PEFT semantics: dropout on
the LoRA branch's input only, and `scale` carries no gradient. Both
products accumulate in f32 and the bottleneck x @ A is rounded once to
x's dtype.

`impl` picks how a single-adapter site adds its delta:
  naive  the parity oracle: delta = xa @ B in f32, then
         y + (scale * delta) cast once to y's dtype, all in torch.
  fused  the LoRA epilogue kernel (ops/lora_fused.lora_epilogue_add):
         y + (scale * xa) @ B in one pass over y. On a CPU tensor it
         runs the kernel's plain version.
  auto   the port's own rule: `fused` for every site on a CUDA tensor,
         `naive` on the CPU. A CUDA site the kernel does not take (a rank
         above 128, a dtype it was not built for) raises rather than run
         the naive order on the card; pass impl="naive" for one.

An entry with an "ids" leaf is a MULTI-adapter stack (lora.stack_adapters
+ assign_adapters, serving): row b uses adapter ids[b] through a per-row
gather, in the naive order whatever `impl` says (the JAX package's
cost-model dense order for it is not ported; the serve engine refuses
lora_impl="fused"). Serving runs no dropout.
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilefinetuner_tpu_torch.ops.dropout import inverted_dropout
from mobilefinetuner_tpu_torch.ops.lora_fused import lora_epilogue_add

LORA_IMPLS = ("auto", "naive", "fused")


def validate_lora_impl(impl: str) -> str:
    if impl not in LORA_IMPLS:
        raise ValueError(f"lora_impl must be one of {'/'.join(LORA_IMPLS)}, "
                         f"got {impl!r}")
    return impl


def resolve_lora_impl(impl: str, y: torch.Tensor) -> str:
    """`auto` on this card: fused for a CUDA tensor, naive on the CPU."""
    if impl == "auto":
        return "naive" if y.device.type == "cpu" else "fused"
    return impl


def _finish(y, scale, delta):
    """y + scale*delta, f32 until the single cast back to y's dtype."""
    return y + (scale * delta).to(y.dtype)


def _multi_lora(y, x, entry, layer_idx):
    """Per-row adapter routing: A [N,(L,)in,r], B [N,(L,)r,out],
    scale [N], ids [B] -> row b's delta uses adapter ids[b]."""
    ids = entry["ids"]
    A, B = entry["A"], entry["B"]
    if layer_idx is not None and A.ndim == 4:
        A, B = A[:, layer_idx], B[:, layer_idx]
    A = A.to(x.dtype)                              # [k, in, r]
    B = B.to(x.dtype)                              # [k, r, out]
    scale = entry["scale"].float()[ids]
    scale = scale.reshape((-1,) + (1,) * (y.ndim - 1))
    t1 = torch.einsum("b...i,bir->b...r", x.float(), A[ids].float())
    delta = torch.einsum("b...r,bro->b...o", t1.to(x.dtype).float(),
                         B[ids].float())
    return _finish(y, scale, delta)


def maybe_lora(y, x, lora_entry, layer_idx=None, dropout: float = 0.0,
               seed: Optional[int] = None, impl: str = "auto"):
    """Add the LoRA delta to y if an entry exists. lora_entry: {"A": [in,r]
    or [L,in,r], "B": [r,out] or [L,r,out], "scale": scalar}, stacked
    leaves indexed by layer_idx; an "ids" leaf routes rows to a stack of
    adapters. dropout > 0 with a seed (ops/dropout.py) drops the branch
    input in train mode."""
    if lora_entry is None:
        return y
    if "ids" in lora_entry:
        if dropout > 0.0 and seed is not None:
            raise NotImplementedError(
                "LoRA dropout on the multi-adapter path belongs to "
                "multi-tenant training (ROADMAP.md port item P8)")
        return _multi_lora(y, x, lora_entry, layer_idx)
    A, B = lora_entry["A"], lora_entry["B"]
    if layer_idx is not None and A.ndim == 3:
        A, B = A[layer_idx], B[layer_idx]
    A, B = A.to(x.dtype), B.to(x.dtype)
    d_in, r = A.shape
    d_out = B.shape[-1]
    if r * (d_in + d_out) > d_in * d_out:
        raise ValueError(
            f"r={r} exceeds the harmonic-mean bound for d_in={d_in}, "
            f"d_out={d_out}: the factored form does more work than the "
            f"dense product — merge the adapter instead")
    scale = lora_entry["scale"].detach().float()
    xb = inverted_dropout(x, dropout, seed)
    xa = (xb.float() @ A.float()).to(x.dtype)
    if resolve_lora_impl(impl, y) == "fused":
        return lora_epilogue_add(y, xa, B, scale)
    delta = xa.float() @ B.float()
    return _finish(y, scale, delta)
