"""The optimizer step: gradient accumulation, clipping, LR schedule and
Adam in one call (port of mobilefinetuner_tpu/train/trainer.py), for one
adapter or model (make_train_step) or for k stacked adapter jobs at once
(make_multi_train_step, the multi-tenant engine's step).

Generic over what is trainable: LoRA passes the adapter tree as
`trainable` and the frozen base params as `frozen`. The loss contract is
loss_fn(trainable, frozen, micro_batch) -> (sum_loss, weight): the SUM
of per-token losses and the token count. The step sums both over the
micro-batches and divides once, so the update is the gradient of
total_loss / total_weight over the whole batch, exact for micro-batches
with unequal valid-token counts.

Every metric stays a device tensor: the step reads nothing back to the
host, so the loop decides when to synchronise (cli/common.run_training
reads the buffered metrics once per log interval).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from mobilefinetuner_tpu_torch.optim.adam import (AdamConfig, _bsel,
                                                  _slot_sum, adam_update,
                                                  clip_by_global_norm,
                                                  clip_by_slot_norm,
                                                  flatten, global_norm,
                                                  init_state,
                                                  multi_adam_update,
                                                  slot_norms, tree_map)
from mobilefinetuner_tpu_torch.optim.schedule import (lr_schedule,
                                                      multi_lr_schedule)

# The step loop's timing window (the flush-interval synced per-step time,
# the hang watchdog's deadline median) lives in core/telemetry and is
# re-exported here as the training-facing surface, as in the JAX package.
from mobilefinetuner_tpu_torch.core.telemetry import StepClock  # noqa: F401


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    lr: float = 1e-4
    warmup_ratio: float = 0.03
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1
    clip_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    weight_decay: float = 0.0
    coupled_weight_decay: bool = False
    amsgrad: bool = False
    # guarded update: a step whose gradients hold a non-finite element
    # (or whose grad norm is non-finite) leaves params AND optimizer
    # state (its step counter too) as they were, selected on the device;
    # the `skipped` metric says so
    skip_nonfinite: bool = False

    def adam(self) -> AdamConfig:
        return AdamConfig(lr=self.lr, weight_decay=self.weight_decay,
                          coupled_weight_decay=self.coupled_weight_decay,
                          amsgrad=self.amsgrad)


def reshape_for_accum(batch: dict, accum: int) -> dict:
    """[accum * micro_b, ...] tensors -> [accum, micro_b, ...]."""
    def r(x):
        total = x.shape[0]
        if total % accum:
            raise ValueError(f"batch of {total} rows does not split into "
                             f"{accum} micro-batches")
        return x.reshape(accum, total // accum, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def make_train_step(loss_fn: Callable[[Any, Any, dict], tuple],
                    train_cfg: TrainConfig, mask: Optional[Any] = None):
    """step_fn(trainable, frozen, opt_state, batch, step) ->
    (trainable, opt_state, metrics). batch leaves are [accum*micro_b,
    ...]; step is the 0-based optimizer step (drives the schedule).
    metrics: loss, grad_norm (pre-clip), lr, param_norm (pre-update),
    update_ratio (||dw|| / ||w||), nonfinite_count (of the gradient
    elements, before clipping) and skipped, all device scalars."""
    accum = train_cfg.grad_accum_steps
    adam_cfg = train_cfg.adam()

    def step_fn(trainable, frozen, opt_state, batch, step):
        # the fault-injection seam (--inject grad_nan, cli/common.py): an
        # armed run's batches carry a [rows] "grad_scale" (1.0, or NaN in
        # the poison window) that multiplies the averaged gradients, so
        # the non-finite values come through the real backward
        batch = dict(batch)
        gscale = batch.pop("grad_scale", None)
        m = mask if mask is not None else tree_map(lambda _: True,
                                                   trainable)
        leaves = tree_map(lambda t, on: t.detach().requires_grad_(bool(on)),
                          trainable, m)
        flat = flatten(leaves)
        paths = [p for p, on in flatten(m).items() if on]
        device = flat[paths[0]].device
        g_sum = {p: torch.zeros_like(flat[p], dtype=torch.float32)
                 for p in paths}
        loss_sum = torch.zeros((), device=device)
        w_sum = torch.zeros((), device=device)
        micro = reshape_for_accum(batch, accum)
        for i in range(accum):
            s, w = loss_fn(leaves, frozen, {k: v[i] for k, v in micro.items()})
            for p, g in zip(paths, torch.autograd.grad(
                    s, [flat[p] for p in paths], allow_unused=True)):
                if g is not None:   # a leaf the loss never reached: 0
                    g_sum[p] += g.float()
            loss_sum += s.detach().float()
            w_sum += w.float()
        with torch.no_grad():
            inv = 1.0 / torch.clamp_min(w_sum, 1.0)
            scale = inv if gscale is None \
                else inv * gscale.reshape(-1)[0].float()
            scaled = {p: g * scale for p, g in g_sum.items()}
            del g_sum
            grads = _tree_like(trainable, scaled)
            # counted before clipping: a NaN norm would smear one bad
            # element over every element
            nonfinite = sum(torch.sum(~torch.isfinite(g))
                            for g in scaled.values())
            if train_cfg.clip_grad_norm and train_cfg.clip_grad_norm > 0:
                grads, norm = clip_by_global_norm(grads,
                                                  train_cfg.clip_grad_norm)
            else:
                norm = global_norm(grads)
            lr = lr_schedule(step, train_cfg.total_steps, train_cfg.lr,
                             train_cfg.warmup_ratio, train_cfg.schedule,
                             train_cfg.min_lr_ratio, device=device)
            new_t, new_opt, (upd_norm, w_norm) = adam_update(
                grads, opt_state, trainable, adam_cfg, lr, m,
                with_norms=True)
            if train_cfg.skip_nonfinite:
                bad = (nonfinite > 0) | ~torch.isfinite(norm)
                keep = lambda old, new: torch.where(  # noqa: E731
                    bad, old, new)
                new_t = tree_map(keep, trainable, new_t)
                new_opt = tree_map(keep, opt_state, new_opt)
                skipped = bad.to(torch.int32)
            else:
                skipped = torch.zeros((), dtype=torch.int32, device=device)
            metrics = {"loss": loss_sum * inv, "grad_norm": norm, "lr": lr,
                       "param_norm": w_norm,
                       "update_ratio": upd_norm / torch.clamp_min(w_norm,
                                                                  1e-20),
                       "nonfinite_count": nonfinite.to(torch.int32),
                       "skipped": skipped}
        return new_t, new_opt, metrics

    return step_fn


def make_multi_train_step(loss_rows_fn: Callable[[Any, Any, dict], tuple],
                          train_cfg: TrainConfig, k: int,
                          mask: Optional[Any] = None):
    """The multi-tenant optimizer step: k LoRA jobs, stacked [k, ...]
    along the adapter axis, through one forward and backward per
    micro-batch.

    loss_rows_fn(stacked_trainable, frozen, micro_batch) -> (row_nll_sums
    [R], row_token_counts [R]), every row of the micro-batch routed to its
    adapter by micro_batch["adapter_ids"] [R] (the ids-routed
    models/lora_apply._multi_lora: slot j's gradient is the sum of its
    own rows' contributions).

    step_fn(trainable, frozen, opt_state, batch, sched) -> (trainable,
    opt_state, metrics): the step writes the new adapters and Adam state
    into the tensors of `trainable` and `opt_state` (their storage never
    moves) and returns those trees. batch: tensors [accum * R, ...] with
    "adapter_ids", and optionally "dropout_seeds", one int per
    micro-batch (handed to loss_rows_fn as micro_batch["dropout_seed"]).
    sched: per-slot [k] tensors {step, total, lr, warmup_ratio, active}
    on the bank's device, so tenants joining and leaving change data,
    never the step. Per slot, as a solo step would: the loss and token
    sums over the micro-batches, the gradient over the slot's own tokens,
    the non-finite census before clipping, the clip by the slot's own
    norm, its own LR from its own step, and Adam with its own bias
    correction. An inactive slot's params and state pass through; with
    skip_nonfinite so does an active slot whose gradients are not
    finite. metrics: per-slot [k] device tensors loss, grad_norm, lr,
    tokens, param_norm, update_ratio, nonfinite_count, skipped and
    active; nothing is read back to the host."""
    accum = train_cfg.grad_accum_steps
    adam_cfg = train_cfg.adam()

    def step_fn(trainable, frozen, opt_state, batch, sched):
        batch = dict(batch)
        seeds = batch.pop("dropout_seeds", None)
        m = mask if mask is not None else tree_map(lambda _: True,
                                                   trainable)
        leaves = tree_map(lambda t, on: t.detach().requires_grad_(bool(on)),
                          trainable, m)
        flat = flatten(leaves)
        paths = [p for p, on in flatten(m).items() if on]
        device = flat[paths[0]].device
        g_sum = {p: torch.zeros_like(flat[p], dtype=torch.float32)
                 for p in paths}
        loss_k = torch.zeros(k, device=device)
        w_k = torch.zeros(k, device=device)
        micro = reshape_for_accum(batch, accum)
        for i in range(accum):
            mb = {key: v[i] for key, v in micro.items()}
            if seeds is not None:
                mb["dropout_seed"] = seeds[i]
            s_rows, w_rows = loss_rows_fn(leaves, frozen, mb)
            for p, g in zip(paths, torch.autograd.grad(
                    s_rows.sum(), [flat[p] for p in paths],
                    allow_unused=True)):
                if g is not None:
                    g_sum[p] += g.float()
            ids = mb["adapter_ids"]
            loss_k.index_add_(0, ids, s_rows.detach().float())
            w_k.index_add_(0, ids, w_rows.float())
        with torch.no_grad():
            inv = 1.0 / torch.clamp_min(w_k, 1.0)
            scaled = {p: g * _bsel(inv, g) for p, g in g_sum.items()}
            del g_sum
            # per slot, before clipping: slot j's NaN must neither smear
            # over its own tree nor gate slot i's update
            nonfinite_k = sum(_slot_sum((~torch.isfinite(g)).to(torch.int32))
                              for g in scaled.values())
            if train_cfg.clip_grad_norm and train_cfg.clip_grad_norm > 0:
                scaled, norm_k = clip_by_slot_norm(scaled,
                                                   train_cfg.clip_grad_norm)
            else:
                norm_k = slot_norms(scaled)
            grads = _tree_like(trainable, scaled)
            lr_k = multi_lr_schedule(sched["step"], sched["total"],
                                     sched["lr"], sched["warmup_ratio"],
                                     train_cfg.schedule,
                                     train_cfg.min_lr_ratio)
            active = sched["active"].bool()
            apply_k = active
            if train_cfg.skip_nonfinite:
                bad = (nonfinite_k > 0) | ~torch.isfinite(norm_k)
                apply_k = active & ~bad
                skipped = (active & bad).to(torch.int32)
            else:
                skipped = torch.zeros(k, dtype=torch.int32, device=device)
            new_t, new_opt, (upd_k, wn_k) = multi_adam_update(
                grads, opt_state, trainable, adam_cfg, lr_k, apply_k, m,
                with_norms=True)
            metrics = {"loss": loss_k * inv, "grad_norm": norm_k,
                       "lr": lr_k, "tokens": w_k, "param_norm": wn_k,
                       "update_ratio": upd_k / torch.clamp_min(wn_k, 1e-20),
                       "nonfinite_count": nonfinite_k.to(torch.int32),
                       "skipped": skipped,
                       "active": active.to(torch.int32)}
        return new_t, new_opt, metrics

    return step_fn


def _tree_like(template, flat_grads):
    """The grad tree: each trainable path's gradient, a zero-size
    placeholder for every frozen leaf (no norm, no update)."""
    def build(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = build(v, path)
            else:
                out[k] = flat_grads.get(path, v.new_zeros((0,)))
        return out
    return build(template, "")


def make_eval_step(nll_fn: Callable[[Any, Any, dict], tuple]):
    """eval_step(trainable, frozen, batch) -> nll_fn's (sum_nll,
    token_count), without autograd."""
    def eval_step(trainable, frozen, batch):
        with torch.no_grad():
            return nll_fn(trainable, frozen, batch)
    return eval_step


def init_optimizer(trainable, train_cfg: TrainConfig,
                   mask: Optional[Any] = None) -> dict:
    return init_state(trainable, train_cfg.adam(), mask)
