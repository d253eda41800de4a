"""Attention: the plain PyTorch version with causal + sliding-window +
padding masks and GQA, and the dispatch to the flash kernel (port of
mobilefinetuner_tpu/ops/attention.py).

The dispatch rule is the port's own, not the JAX package's TPU
thresholds. impl="auto" sends a CPU tensor to the plain version and any
other tensor to the flash kernels (ops/flash_attention.flash_attention,
differentiable through the backward kernels), which launch or raise for
a shape, dtype or device they do not take; an explicit `attn_mask`
matrix on a CUDA tensor raises too. impl="plain" runs the plain version
on any device: it is the kernels' reference on the card. impl="flash"
runs the flash path on any device (on the CPU, the kernels' plain
blocked versions, as the JAX package runs its Pallas kernels in
interpret mode there).

Train-mode probs dropout takes an integer `dropout_seed` (ops/dropout.py):
the plain path draws its mask from a generator seeded with it, the flash
kernels hash (seed, b, h, row, col) as the TPU kernel does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mobilefinetuner_tpu_torch.ops import flash_attention as _flash
from mobilefinetuner_tpu_torch.ops.dropout import inverted_dropout


def causal_mask(q_len: int, kv_len: int,
                sliding_window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """[q_len, kv_len] bool, True = attend: key j visible to query i iff
    j <= i (+ offset when kv_len > q_len), and j > i - window."""
    offset = kv_len - q_len
    qi = torch.arange(q_len, device=device)[:, None] + offset
    kj = torch.arange(kv_len, device=device)[None, :]
    mask = kj <= qi
    if sliding_window is not None:
        mask &= kj > qi - sliding_window
    return mask


def dot_product_attention(q, k, v, *, scale: Optional[float] = None,
                          is_causal: bool = True,
                          sliding_window: Optional[int] = None,
                          padding_mask=None, attn_mask=None,
                          attn_dropout: float = 0.0,
                          dropout_seed: Optional[int] = None):
    """Scaled dot-product attention with GQA: q [B,Hq,S,D], k/v
    [B,Hkv,S,D]; scores and softmax in f32, probabilities (dropped when
    a dropout_seed is given) cast to v's dtype before the f32-accumulated
    P.V, output in v's dtype. Masked scores take finfo(f32).min, as the
    JAX oracle does."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Hkv, G, S, D)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if attn_mask is not None:
        scores = scores.masked_fill(~attn_mask.bool()[None, None, None],
                                    neg)
    elif is_causal or sliding_window is not None:
        m = causal_mask(S, S, sliding_window, device=q.device)
        scores = scores.masked_fill(~m[None, None, None], neg)
    if padding_mask is not None:
        pm = padding_mask.bool()
        scores = scores.masked_fill(~pm[:, None, None, None, :], neg)
    probs = torch.softmax(scores, dim=-1)
    probs = inverted_dropout(probs, attn_dropout, dropout_seed)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(B, Hq, S, D)


ATTN_IMPLS = ("auto", "plain", "flash")


def validate_attn_impl(impl: str) -> str:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {impl!r}")
    return impl


def attention(q, k, v, *, impl: str = "auto", attn_mask=None, **kwargs):
    """Dispatch between the plain version and the flash kernels (module
    docstring): impl is "auto", "plain" or "flash"."""
    validate_attn_impl(impl)
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return dot_product_attention(q, k, v, attn_mask=attn_mask, **kwargs)
    if attn_mask is not None:
        raise ValueError("the flash kernel takes masks by flags "
                         "(is_causal, sliding_window, padding_mask), not an "
                         "attn_mask matrix; pass impl='plain' for one")
    return _flash.flash_attention(q, k, v, **kwargs)
