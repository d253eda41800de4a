"""Carry parameter and adapter trees from numpy into the port.

The JAX package keeps GPT-2 weights and LoRA adapters as nested dicts of
arrays; `jax.tree.map(np.asarray, tree)` turns one into numpy, and these
functions turn that into the port's nested dict of torch tensors with the
same keys and shapes, so both packages compute the same function on the
same weights. `device=None` is the CUDA card (core/device.py).
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


def lora_from_numpy(tree, device=None, dtype=torch.float32) -> dict:
    """A LoRA tree {"blocks": {target: {"A", "B", "scale"}}} (single or
    stack_adapters-stacked) as torch tensors; integer leaves such as
    routing "ids" keep their dtype."""
    return _tree_from_numpy(tree, resolve_device(device), dtype)
