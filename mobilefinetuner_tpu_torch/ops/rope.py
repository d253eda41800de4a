"""Rotary position embeddings, HF rotate-half convention (port of
mobilefinetuner_tpu/ops/rope.py). Computed in f32 and cast back to the
input's dtype."""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [..., S, head_dim] for integer positions [..., S]
    ([S] shared across the batch, or [B, S] per row). inv_freq over the
    even dims, each frequency repeated across the two halves."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device) / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, D]; cos/sin [S, D] or [B, S, D] (broadcast over the
    head axis) -> x's shape and dtype."""
    xf = x.float()
    c = cos.unsqueeze(-3)
    s = sin.unsqueeze(-3)
    return (xf * c + _rotate_half(xf) * s).to(x.dtype)
