"""Resident adapter bank with hot-swap: k LoRA tenants over one base model
(port of mobilefinetuner_tpu/serve/adapters.py).

The decode step routes each slot to its adapter through the per-row
gather (lora.stack_adapters layout: every A/B/scale leaf stacked along a
leading adapter axis). Loading copies a tenant's factors into one slot in
place; eviction zeroes it. Shapes never change, so nothing downstream is
rebuilt by a swap: the serve engine's captured decode step reads the
bank's leaves where they are. One hidden slot past capacity stays zero
forever: the BASE route that base-only requests carry.

`trace_count`, as the JAX bank's: the swap program's builds, one for each
signature (the incoming leaves' shapes and dtypes) seen first. The JAX
bank jits one swap for loads and evictions alike (an eviction swaps in
zeros of the template's dtypes), so the port counts an eviction under
the template's signature.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from mobilefinetuner_tpu_torch.lora.lora import stack_adapters, tree_leaves


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


class AdapterBank:
    """`capacity` resident adapter slots plus the zero base slot, stacked
    leaves [capacity + 1, ...]. `template` fixes the structure every load
    must match (rank, targets, layer count), and the bank's dtype and
    device; `family` ("gpt2" | "gemma") names the model an HF-PEFT
    directory is read for."""

    def __init__(self, template, capacity: int, family: str = "gpt2"):
        if capacity < 1:
            raise ValueError(f"bank capacity must be >= 1, got {capacity}")
        if family not in ("gpt2", "gemma"):
            raise ValueError(f"unknown family {family!r}")
        self.capacity = int(capacity)
        self.family = family
        zero = _zeros_like_tree(template)
        self.tree = stack_adapters([zero] * (capacity + 1))
        self._template = [(p, tuple(x.shape))
                          for p, x in tree_leaves(template)]
        self.names: List[Optional[str]] = [None] * capacity
        self.trace_count = 0
        self._signatures: set = set()
        self._template_sig = self._signature(template)

    @staticmethod
    def _signature(tree) -> tuple:
        return tuple((tuple(x.shape), x.dtype) for _, x in tree_leaves(tree))

    def _note(self, sig: tuple) -> None:
        """Count the swap program for `sig` the first time it is seen."""
        if sig not in self._signatures:
            self._signatures.add(sig)
            self.trace_count += 1

    @property
    def base_slot(self) -> int:
        """The hidden all-zero slot (= base model); never loadable."""
        return self.capacity

    @property
    def resident(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.names) if n is not None}

    def slot(self, name: str) -> int:
        for i, n in enumerate(self.names):
            if n == name:
                return i
        raise KeyError(
            f"adapter {name!r} not resident (loaded: "
            f"{sorted(self.resident)}) — engine.load_adapter first")

    def _validate(self, tree) -> None:
        leaves = tree_leaves(tree)
        if [p for p, _ in leaves] != [p for p, _ in self._template]:
            raise ValueError(
                "adapter structure does not match the bank template "
                "(residents must share rank and target set)")
        for (_, ws), (_, x) in zip(self._template, leaves):
            if tuple(x.shape) != ws:
                raise ValueError(
                    f"adapter leaf shape {tuple(x.shape)} does not match "
                    f"bank template {ws} (rank mismatch?)")

    def _write(self, tree, i: int) -> None:
        for (_, dst), (_, src) in zip(tree_leaves(self.tree),
                                      tree_leaves(tree)):
            dst[i].copy_(src)

    def load(self, name: str, tree) -> int:
        """Load/replace adapter `name` into a bank slot; returns the slot.
        Same-name load overwrites in place; otherwise the first free slot
        is taken. OverflowError when the bank is full."""
        self._validate(tree)
        if name in self.resident:
            i = self.resident[name]
        elif None in self.names:
            i = self.names.index(None)
        else:
            raise OverflowError(
                f"bank full ({self.capacity} residents: "
                f"{sorted(self.resident)}) — evict one first")
        self._note(self._signature(tree))
        self._write(tree, i)
        self.names[i] = name
        return i

    def load_file(self, name: str, path: str, verify: bool = True) -> int:
        """Load adapter `name` from disk: a native adapter file (lora/
        peft_io.save_adapter) or an HF-PEFT directory. A file is checked
        against its checksum manifest first when `verify`
        (CheckpointIntegrityError: a corrupt or unverifiable adapter never
        reaches a resident slot). The factors are cast to the bank's dtype
        and device, and the adapter's own alpha / rank becomes its scale."""
        from mobilefinetuner_tpu_torch.io.safetensors_io import verify_file
        from mobilefinetuner_tpu_torch.lora import peft_io
        ref = tree_leaves(self.tree)[0][1]
        if os.path.isdir(path):
            tree, _ = peft_io.import_peft(path, self.family,
                                          device=ref.device)
        else:
            if verify:
                verify_file(path)
            tree, _ = peft_io.load_adapter(path, device=ref.device)
        tree = {"blocks": {n: {k: v.to(ref.dtype) for k, v in e.items()}
                           for n, e in tree["blocks"].items()}}
        return self.load(name, tree)

    def evict(self, name: str) -> int:
        """Zero `name`'s slot and free it: a stale routing id can only
        ever reach the base model, never another tenant's weights."""
        i = self.slot(name)
        self._note(self._template_sig)
        for _, leaf in tree_leaves(self.tree):
            leaf[i].zero_()
        self.names[i] = None
        return i
