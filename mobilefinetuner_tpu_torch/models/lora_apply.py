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
+ assign_adapters: serving, and multi-tenant training): row b uses adapter
ids[b], by the per-row A / B gather and two batched rank-r products, both
in f32. Every impl takes that order: the JAX package's cost-model dense
order (every adapter's delta for every row, routed by a one-hot) lost to
the gather at every shape measured on an H100 (PERF.md), so the port has
none (ROADMAP.md, Differences). Dropout on this path draws one mask per
row (ops/dropout.row_dropout), each from (site seed, row).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from mobilefinetuner_tpu_torch.ops.dropout import (inverted_dropout,
                                                   row_dropout)
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


def impl_summary(targets: Iterable[str], impl: str, device="cuda",
                 routed: bool = False) -> str:
    """'target=resolved,...' logged into the run_start manifest: a
    single-adapter site resolves to naive / fused (resolve_lora_impl), an
    ids-routed one (`routed`) to gather under every impl."""
    validate_lora_impl(impl)
    on_card = torch.device(device).type == "cuda"
    if routed:
        site = "gather"
    elif impl == "auto":
        site = "fused" if on_card else "naive"
    else:
        site = impl
    return ",".join(f"{name}={site}" for name in sorted(targets))


def _multi_lora(y, x, entry, layer_idx, dropout: float = 0.0,
                seed: Optional[int] = None):
    """Per-row adapter routing: A [k,(L,)in,r], B [k,(L,)r,out], scale
    [k], ids [B] -> row b's delta is (x[b] @ A[ids[b]]) @ B[ids[b]], the
    bottleneck rounded once to x's dtype."""
    ids = entry["ids"]
    A, B = entry["A"], entry["B"]
    if layer_idx is not None and A.ndim == 4:
        A, B = A[:, layer_idx], B[:, layer_idx]
    A = A.to(x.dtype)                              # [k, in, r]
    B = B.to(x.dtype)                              # [k, r, out]
    scale = entry["scale"].detach().float()[ids]
    scale = scale.reshape((-1,) + (1,) * (y.ndim - 1))
    xb = row_dropout(x, dropout, seed)
    t1 = torch.einsum("b...i,bir->b...r", xb.float(), A[ids].float())
    delta = torch.einsum("b...r,bro->b...o", t1.to(x.dtype).float(),
                         B[ids].float())
    return _finish(y, scale, delta)


def maybe_lora(y, x, lora_entry, layer_idx=None, dropout: float = 0.0,
               seed: Optional[int] = None, impl: str = "auto"):
    """Add the LoRA delta to y if an entry exists. lora_entry: {"A": [in,r]
    or [L,in,r], "B": [r,out] or [L,r,out], "scale": scalar}, stacked
    leaves indexed by layer_idx; an "ids" leaf routes rows to a stack of
    adapters. dropout > 0 with a seed (ops/dropout.py) drops the branch
    input in train mode (one mask per row on the routed path)."""
    if lora_entry is None:
        return y
    if "ids" in lora_entry:
        return _multi_lora(y, x, lora_entry, layer_idx, dropout, seed)
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
