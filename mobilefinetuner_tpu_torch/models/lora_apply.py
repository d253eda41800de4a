"""Functional LoRA application (port of mobilefinetuner_tpu/models/
lora_apply.py, the `naive` order: the JAX package's parity oracle).

y = base(x) + scale * ((x @ A) @ B), each product accumulated in f32 and
the bottleneck x @ A rounded once to x's dtype; the delta is added in f32
and cast to y's dtype once. An entry with an "ids" leaf is a MULTI-adapter
stack (lora.stack_adapters + assign_adapters): row b uses adapter ids[b]
through a per-row gather. The cost-model orders (`fused` with its Pallas
epilogue, `dense`) come with the training slice; asking for them raises.
Serving runs no dropout, so the branch input is x itself.
"""

from __future__ import annotations

import torch

LORA_IMPLS = ("auto", "naive")


def validate_lora_impl(impl: str) -> str:
    """The serve engine's `lora_impl` knob (the JAX name): both values run
    the naive order; checked once, when the engine's config is."""
    if impl == "fused":
        raise NotImplementedError(
            "lora_impl='fused' needs the LoRA epilogue kernel, which comes "
            "with the GPT-2 LoRA training slice (ROADMAP.md port kernel "
            "queue: LoRA epilogue)")
    if impl not in LORA_IMPLS:
        raise ValueError(f"lora_impl must be one of {'/'.join(LORA_IMPLS)}, "
                         f"got {impl!r}")
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


def maybe_lora(y, x, lora_entry, layer_idx=None):
    """Add the LoRA delta to y if an entry exists. lora_entry: {"A": [in,r]
    or [L,in,r], "B": [r,out] or [L,r,out], "scale": scalar}, stacked
    leaves indexed by layer_idx; an "ids" leaf routes rows to a stack of
    adapters."""
    if lora_entry is None:
        return y
    if "ids" in lora_entry:
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
    scale = lora_entry["scale"].float()
    xa = (x.float() @ A.float()).to(x.dtype)
    delta = xa.float() @ B.float()
    return _finish(y, scale, delta)
