"""Carry parameter, adapter and optimizer-state trees between numpy and
the port.

The JAX package keeps GPT-2 and Gemma-3 weights, LoRA adapters and Adam state as
nested dicts of arrays; `jax.tree.map(np.asarray, tree)` turns one into
numpy, and these functions turn that into the port's nested dict of torch
tensors with the same keys and shapes (and back, `to_numpy`), so both
packages compute the same function from the same state. `device=None` is
the CUDA card (core/device.py).
"""

from __future__ import annotations

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.device import resolve_device


def _tree_from_numpy(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def gpt2_params_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """A GPT-2 parameter tree (models/gpt2.py layout) as torch tensors."""
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def gemma3_params_from_numpy(tree, device=None,
                             dtype=torch.float32) -> dict:
    """A Gemma-3 parameter tree (models/gemma3.py layout) as torch
    tensors."""
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def lora_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """A LoRA tree {"blocks": {target: {"A", "B", "scale"}}} (single or
    stack_adapters-stacked) as torch tensors; integer leaves such as
    routing "ids" keep their dtype."""
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def adam_state_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """An Adam state {"step", "m", "v"[, "v_hat"]} (optim/adam.py layout,
    zero-size leaves for frozen params) as torch tensors; the int32 step
    counter keeps its dtype."""
    return _tree_from_numpy(tree, resolve_device(device), dtype)


def to_numpy(tree):
    """A tree of torch tensors as numpy arrays (bf16 leaves as float32),
    for the JAX package to load."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
