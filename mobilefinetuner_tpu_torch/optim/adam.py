"""Adam / AdamW over nested dicts of tensors, with the `.opt` state file
(port of mobilefinetuner_tpu/optim/adam.py, the single-adapter part; the
stacked multi-tenant Adam comes with ROADMAP.md port item P8).

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
