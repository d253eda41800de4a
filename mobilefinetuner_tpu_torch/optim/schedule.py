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
    def f32(x):
        return torch.full((), float(x), dtype=torch.float32, device=device)

    step = step.float() if torch.is_tensor(step) else f32(step)
    return _schedule_value(step, f32(max(total_steps, 1)), base_lr,
                           warmup_ratio, kind, min_lr_ratio)


def multi_lr_schedule(step_k, total_k, base_lr_k, warmup_ratio_k,
                      kind: str = "cosine",
                      min_lr_ratio: float = 0.1) -> torch.Tensor:
    """The multi-tenant engine's schedule: per-slot [k] tensors of
    (tenant-local step, step budget, peak LR, warmup ratio), all on one
    device, through lr_schedule's formula (the k-adapter-vs-solo parity
    rests on the identity). `kind` and `min_lr_ratio` are engine-wide."""
    step = step_k.float()
    total = torch.clamp_min(total_k.float(), 1.0)
    return _schedule_value(step, total, base_lr_k.float(),
                           warmup_ratio_k.float(), kind, min_lr_ratio)


def _schedule_value(step, total, base_lr, warmup_ratio, kind,
                    min_lr_ratio):
    """The schedule over f32 tensors step and total; base_lr and
    warmup_ratio are Python floats or tensors broadcasting with them."""
    if kind not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule kind {kind!r}")
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
    elif torch.is_tensor(base_lr):
        decayed = base_lr * torch.ones_like(step)
    else:
        decayed = torch.full_like(step, float(base_lr))
    return torch.where(step < warmup, warm_lr, decayed)
