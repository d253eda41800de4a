"""Adam / AdamW over nested dicts of tensors, with the `.opt` state file
(port of mobilefinetuner_tpu/optim/adam.py), and the stacked multi-slot
Adam of the multi-tenant engine.

Weight decay: decoupled AdamW by default; `coupled_weight_decay=True`
adds the decay into the gradient, the reference's L2 semantics. The
update is functional (new tensors, the inputs untouched), which is what
lets the train step's non-finite guard select the old tree.

State: {"step": int32 scalar, "m": tree, "v": tree[, "v_hat": tree]},
trees shaped like the params, with a zero-size placeholder for every
leaf the mask freezes. `save_state` writes it as a safetensors file whose
keys are the tree paths ("m/blocks/attn_qkv/A", "step", ...) and whose
metadata carries the AdamConfig, byte-compatible with the JAX package's
sidecar: either package loads the other's file.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mobilefinetuner_tpu_torch.io.safetensors_io import (SafeTensorsReader,
                                                         save_safetensors,
                                                         verify_file)


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    coupled_weight_decay: bool = False
    amsgrad: bool = False


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/c": leaf} in sorted key order (the JAX package's tree paths)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(flatten(tree[k], path))
        else:
            out[path] = tree[k]
    return out


def _leaves(tree):
    return list(flatten(tree).values())


def init_state(params, config: AdamConfig,
               mask: Optional[Any] = None) -> dict:
    """Adam state for `params`; frozen leaves (mask False) get zero-size
    placeholders."""
    if mask is None:
        mask = tree_map(lambda _: True, params)

    def zeros(p, m):
        return torch.zeros_like(p) if m else p.new_zeros((0,))

    first = _leaves(params)[0]
    state = {"step": torch.zeros((), dtype=torch.int32, device=first.device),
             "m": tree_map(zeros, params, mask),
             "v": tree_map(zeros, params, mask)}
    if config.amsgrad:
        state["v_hat"] = tree_map(zeros, params, mask)
    return state


def adam_update(grads, state: dict, params, config: AdamConfig, lr,
                mask: Optional[Any] = None, with_norms: bool = False):
    """One Adam step -> (new_params, new_state), or with with_norms
    (new_params, new_state, (update_norm, param_norm)): the norm of the
    applied update -lr * (m_hat / (sqrt(v_hat) + eps) [+ wd * w]) and of
    the pre-update params, over the trainable leaves. lr is a scalar
    tensor (lr_schedule); nothing here reads a value back to the host."""
    if mask is None:
        mask = tree_map(lambda _: True, params)
    step = state["step"] + 1
    b1, b2 = config.beta1, config.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    wd = config.weight_decay
    sums = {"u": [], "p": []}

    def keep(sel, new, old):
        """new where sel, else old, into old's storage."""
        return torch.where(sel, new, old, out=old)

    def leaf(p, g, m, v, vh, do):
        if not do:
            return p, m, v, vh
        g = g.float()
        pf = p.float()
        if config.coupled_weight_decay and wd:
            g = g + wd * pf
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        if config.amsgrad:
            vh2 = torch.maximum(vh, v2)
            denom = torch.sqrt(vh2 / bc2) + config.eps
        else:
            vh2 = vh
            denom = torch.sqrt(v2 / bc2) + config.eps
        upd = (m2 / bc1) / denom
        if not config.coupled_weight_decay and wd:
            upd = upd + wd * pf
        delta = lr * upd
        if with_norms:
            sums["u"].append(torch.sum(delta * delta))
            sums["p"].append(torch.sum(pf * pf))
        return (pf - delta).to(p.dtype), m2, v2, vh2

    vh_tree = state["v_hat"] if config.amsgrad \
        else tree_map(lambda _: None, params)
    out = tree_map(leaf, params, grads, state["m"], state["v"], vh_tree,
                   mask)
    pick = lambda i: _pick(out, i)  # noqa: E731
    new_state = {"step": step, "m": pick(1), "v": pick(2)}
    if config.amsgrad:
        new_state["v_hat"] = pick(3)
    if with_norms:
        zero = torch.zeros((), device=step.device)
        upd = torch.sqrt(torch.stack(sums["u"]).sum()) if sums["u"] else zero
        w = torch.sqrt(torch.stack(sums["p"]).sum()) if sums["p"] else zero
        return pick(0), new_state, (upd, w)
    return pick(0), new_state


def _pick(out, i):
    """Element i of every 4-tuple leaf of `out`."""
    if isinstance(out, dict):
        return {k: _pick(v, i) for k, v in out.items()}
    return out[i]


def global_norm(grads) -> torch.Tensor:
    """Global L2 norm over a grad tree, in f32."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(g.float()))
                                   for g in _leaves(grads)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(clipped grads, pre-clip norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


# ------------------------- multi-adapter (stacked) Adam ---------------------
# The multi-tenant engine (multitenant/engine.py) stacks k LoRA jobs'
# trainables along a leading adapter axis (lora.stack_adapters). m / v
# stack the same way and `step` is a per-slot [k] counter, so per-slot bias
# correction, LR and the apply mask are tensors: each slot's update is
# adam_update's formula broadcast over the leading axis.


def init_multi_state(stacked_params, config: AdamConfig, k: int,
                     mask: Optional[Any] = None) -> dict:
    """Adam state for a stacked [k, ...] bank: init_state's m / v (and
    v_hat), with `step` a per-slot [k] int32 counter."""
    state = init_state(stacked_params, config, mask)
    state["step"] = torch.zeros(k, dtype=torch.int32,
                                device=state["step"].device)
    return state


def _bsel(vec, x):
    """A per-slot [k] vector broadcast over a stacked [k, ...] leaf."""
    return vec.reshape(vec.shape[:1] + (1,) * (x.dim() - 1))


def multi_adam_update(grads, state: dict, params, config: AdamConfig,
                      lr_k, apply_k, mask: Optional[Any] = None,
                      with_norms: bool = False):
    """One stacked Adam step over a [k, ...] bank -> (params, state), or
    with with_norms (..., (update_norm [k], param_norm [k])). The step
    writes its results into the tensors of `params` and `state` (call it
    under torch.no_grad) and returns those trees: the multi-tenant
    engine's storage never moves.

    lr_k: per-slot f32 LRs [k]; apply_k: per-slot bools [k]. A False slot
    passes its params, m, v, v_hat and step counter through untouched (an
    idle slot, or one the non-finite guard skips), so a refilled slot
    starts from a fresh state. Bias correction uses each slot's own step.
    The norms are of the would-be update, for skipped slots too."""
    if mask is None:
        mask = tree_map(lambda _: True, params)
    app = apply_k.bool()
    step2 = state["step"] + 1
    b1, b2 = config.beta1, config.beta2
    bc1 = 1.0 - b1 ** step2.float()
    bc2 = 1.0 - b2 ** step2.float()
    wd = config.weight_decay
    sums = {"u": [], "p": []}

    def keep(sel, new, old):
        """new where sel, else old, into old's storage."""
        return torch.where(sel, new, old, out=old)

    def leaf(p, g, m, v, vh, do):
        if not do:
            return p, m, v, vh
        g = g.float()
        pf = p.float()
        if config.coupled_weight_decay and wd:
            g = g + wd * pf
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        if config.amsgrad:
            vh2 = torch.maximum(vh, v2)
            denom = torch.sqrt(vh2 / _bsel(bc2, vh2)) + config.eps
        else:
            vh2 = vh
            denom = torch.sqrt(v2 / _bsel(bc2, v2)) + config.eps
        upd = (m2 / _bsel(bc1, m2)) / denom
        if not config.coupled_weight_decay and wd:
            upd = upd + wd * pf
        delta = _bsel(lr_k, upd) * upd
        if with_norms:
            sums["u"].append(_slot_sum(delta * delta))
            sums["p"].append(_slot_sum(pf * pf))
        sel = _bsel(app, p)
        new_p = keep(sel, (pf - delta).to(p.dtype), p)
        m2 = keep(sel, m2, m)
        v2 = keep(sel, v2, v)
        if config.amsgrad:
            vh2 = keep(sel, vh2, vh)
        return new_p, m2, v2, vh2

    vh_tree = state["v_hat"] if config.amsgrad \
        else tree_map(lambda _: None, params)
    out = tree_map(leaf, params, grads, state["m"], state["v"], vh_tree,
                   mask)
    pick = lambda i: _pick(out, i)  # noqa: E731
    new_state = {"step": keep(app, step2, state["step"]),
                 "m": pick(1), "v": pick(2)}
    if config.amsgrad:
        new_state["v_hat"] = pick(3)
    if with_norms:
        zero = torch.zeros(step2.shape, device=step2.device)
        upd = torch.sqrt(sum(sums["u"])) if sums["u"] else zero
        w = torch.sqrt(sum(sums["p"])) if sums["p"] else zero
        return pick(0), new_state, (upd, w)
    return pick(0), new_state


def _slot_sum(x):
    """[k, ...] -> [k]: the sum over every axis but the leading one."""
    return x.reshape(x.shape[0], -1).sum(1) if x.dim() > 1 else x


def slot_norms(grads) -> torch.Tensor:
    """Per-slot L2 norms [k] over a stacked [k, ...] grad tree: slot j's
    norm over its own adapter only, global_norm of its solo tree.
    Zero-size placeholders (frozen leaves) are skipped."""
    return torch.sqrt(sum(_slot_sum(torch.square(g.float()))
                          for g in _leaves(grads) if g.numel()))


def clip_by_slot_norm(grads, max_norm: float):
    """Per-slot clip-by-global-norm over a stacked grad tree -> (clipped
    grads, pre-clip norms [k]): slot j's scale is clip_by_global_norm's
    for its solo tree."""
    norms = slot_norms(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norms, 1e-12), max=1.0)
    return tree_map(lambda g: (g * _bsel(scale, g)).to(g.dtype)
                    if g.numel() else g, grads), norms


# ----------------------------- state I/O ------------------------------------

def save_state(path: str, state: dict, config: AdamConfig,
               extra_metadata: Optional[Dict[str, str]] = None):
    """The `.opt` sidecar: every state leaf under its tree path, the
    AdamConfig (and e.g. the loop step) in the metadata; published
    atomically with its checksum manifest."""
    flat = {k: v.detach().cpu().numpy() for k, v in flatten(state).items()}
    md = {f"adam_{f.name}": str(getattr(config, f.name))
          for f in dataclasses.fields(config)}
    if extra_metadata:
        md.update({str(k): str(v) for k, v in extra_metadata.items()})
    save_safetensors(path, flat, metadata=md)


def load_state(path: str, state_template: dict,
               verify: bool = False) -> Tuple[dict, AdamConfig]:
    """Restore a `.opt` file into the template's structure, each leaf with
    the template leaf's shape, dtype and device. verify=True checks the
    checksum manifest first (CheckpointIntegrityError on a mismatch)."""
    if verify:
        verify_file(path)
    reader = SafeTensorsReader(path)
    raw = reader.load_all()
    flat = flatten(state_template)

    def restore(key, t):
        a = np.asarray(raw[key]).reshape(tuple(t.shape))
        return torch.from_numpy(np.array(a)).to(device=t.device,
                                                dtype=t.dtype)

    restored = {k: restore(k, t) for k, t in flat.items()}
    md = reader.metadata
    cfg = AdamConfig(
        lr=float(md["adam_lr"]), beta1=float(md["adam_beta1"]),
        beta2=float(md["adam_beta2"]), eps=float(md["adam_eps"]),
        weight_decay=float(md["adam_weight_decay"]),
        coupled_weight_decay=md["adam_coupled_weight_decay"] == "True",
        amsgrad=md["adam_amsgrad"] == "True")
    return _unflatten(state_template, restored), cfg


def _unflatten(template, flat, prefix: str = ""):
    out = {}
    for k, v in template.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out[k] = _unflatten(v, flat, path) if isinstance(v, dict) \
            else flat[path]
    return out
