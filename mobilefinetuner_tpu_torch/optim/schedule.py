"""LR schedules: warmup, then cosine or linear decay to a floor, or
constant (port of mobilefinetuner_tpu/optim/schedule.py).

The value is computed on `device` in float32 from a Python step, with
the JAX package's formula and rounding points, so a schedule costs the
train step no host-device transfer: every constant enters as a kernel
argument.
"""

from __future__ import annotations

import math

import torch


def lr_schedule(step, total_steps: int, base_lr: float,
                warmup_ratio: float = 0.03, kind: str = "cosine",
                min_lr_ratio: float = 0.1, device="cpu") -> torch.Tensor:
    """LR at the 0-based `step`, a float32 scalar tensor on `device`.

    kind: "cosine" (decay to min_lr_ratio * base_lr), "linear" (the
    same floor), "constant"; linear warmup over floor(total *
    warmup_ratio) steps first."""
    if kind not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule kind {kind!r}")

    def f32(x):
        return torch.full((), float(x), dtype=torch.float32, device=device)

    step = step.float() if torch.is_tensor(step) else f32(step)
    total = f32(max(total_steps, 1))
    warmup = torch.clamp_min(torch.floor(total * warmup_ratio), 0.0)
    warm_lr = base_lr * (step + 1.0) / torch.clamp_min(warmup, 1.0)
    progress = torch.clamp((step - warmup)
                           / torch.clamp_min(total - warmup, 1.0), 0.0, 1.0)
    floor = base_lr * min_lr_ratio
    if kind == "cosine":
        decayed = floor + (base_lr - floor) * 0.5 * (
            1.0 + torch.cos(math.pi * progress))
    elif kind == "linear":
        decayed = base_lr + (floor - base_lr) * progress
    else:
        decayed = f32(base_lr)
    return torch.where(step < warmup, warm_lr, decayed)
