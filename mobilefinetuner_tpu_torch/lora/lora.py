"""LoRA: spec, GPT-2 and Gemma-3 targets, initialization, multi-adapter
stacking, the trainable mask and merging (port of mobilefinetuner_tpu/
lora/lora.py).

Entry layout per target: {"A": [L, in, r], "B": [L, r, out], "scale": ()}
with scale = alpha / rank; the unstacked "lm_head" target has A [in, r],
B [r, out]. A tree is {"blocks": {target: entry}} of torch tensors.

Init styles (`LoRASpec.init`), B = 0 in both:
  gpt2  A ~ N(0, 1/sqrt(r));
  peft  A ~ U(-1/sqrt(in), 1/sqrt(in)), torch's kaiming_uniform_(a=sqrt(5))
        on the [r, in] weight (the Gemma CLI's init).
Factors are drawn from a seeded CPU torch.Generator: a seed gives the same
adapter on every device (not the JAX package's numbers; tests hand both
packages the same numpy factors).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.device import resolve_device

# GPT-2 target name -> (in_dim_fn, out_dim_fn) over config
GPT2_TARGETS = {
    "attn_qkv": lambda c: (c.n_embd, 3 * c.n_embd),
    # split-QKV: separate adapters on the q/k/v column ranges of the fused
    # c_attn projection
    "attn_q": lambda c: (c.n_embd, c.n_embd),
    "attn_k": lambda c: (c.n_embd, c.n_embd),
    "attn_v": lambda c: (c.n_embd, c.n_embd),
    "attn_proj": lambda c: (c.n_embd, c.n_embd),
    "mlp_fc_in": lambda c: (c.n_embd, 4 * c.n_embd),
    "mlp_fc_out": lambda c: (4 * c.n_embd, c.n_embd),
    # a single unstacked site on the tied lm_head (logits = x @ wte^T)
    "lm_head": lambda c: (c.n_embd, c.vocab_size),
}
# column slot of each split target within the fused [E, 3E] c_attn weight
GPT2_SPLIT_QKV_SLOTS = {"attn_q": 0, "attn_k": 1, "attn_v": 2}
GPT2_DEFAULT_TARGETS = ["attn_qkv", "attn_proj"]

GEMMA_TARGETS = {
    "q_proj": lambda c: (c.hidden_size, c.num_attention_heads * c.head_dim),
    "k_proj": lambda c: (c.hidden_size, c.num_key_value_heads * c.head_dim),
    "v_proj": lambda c: (c.hidden_size, c.num_key_value_heads * c.head_dim),
    "o_proj": lambda c: (c.num_attention_heads * c.head_dim, c.hidden_size),
    "gate_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "up_proj": lambda c: (c.hidden_size, c.intermediate_size),
    "down_proj": lambda c: (c.intermediate_size, c.hidden_size),
    "lm_head": lambda c: (c.hidden_size, c.vocab_size),  # tied embed head
}
# targets with ONE site instead of a per-layer stack
UNSTACKED_TARGETS = frozenset({"lm_head"})
# Gemma target presets; lm_head is opt-in only
GEMMA_PRESETS = {
    "full": [t for t in GEMMA_TARGETS if t not in UNSTACKED_TARGETS],
    "attn": ["q_proj", "k_proj", "v_proj", "o_proj"],
    "light": ["q_proj", "v_proj"],
}
INIT_STYLES = ("gpt2", "peft")


@dataclasses.dataclass
class LoRASpec:
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    targets: Optional[List[str]] = None
    init: str = "gpt2"  # one of INIT_STYLES

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def to_metadata(self) -> Dict[str, str]:
        return {"lora_rank": str(self.rank), "lora_alpha": str(self.alpha),
                "lora_dropout": str(self.dropout),
                "lora_targets": ",".join(self.targets or []),
                "lora_init": self.init}

    @classmethod
    def from_metadata(cls, md: Dict[str, str]) -> "LoRASpec":
        return cls(rank=int(md["lora_rank"]),
                   alpha=float(md["lora_alpha"]),
                   dropout=float(md.get("lora_dropout", 0.0)),
                   targets=[t for t in md.get("lora_targets", "").split(",")
                            if t],
                   init=md.get("lora_init", "gpt2"))


def _init_A(gen: torch.Generator, shape, style: str) -> torch.Tensor:
    """A of shape [L, in, r] in `style` (module docstring), drawn on the
    CPU."""
    _, fan_in, r = shape
    if style == "peft":
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound
    return torch.randn(shape, generator=gen) / math.sqrt(r)


def init_lora(target_dims: Dict[str, Tuple[int, int]], n_layers: int,
              spec: LoRASpec, seed: int = 0, dtype=torch.float32,
              device=None) -> dict:
    """The stacked LoRA tree for the given targets (B = 0)."""
    if spec.init not in INIT_STYLES:
        raise ValueError(f"LoRA init {spec.init!r} is not one of "
                         f"{INIT_STYLES}")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    tree = {}
    for name in sorted(target_dims):
        fan_in, fan_out = target_dims[name]
        if name in UNSTACKED_TARGETS:
            A = _init_A(gen, (1, fan_in, spec.rank), spec.init)[0]
            B = torch.zeros(spec.rank, fan_out)
        else:
            A = _init_A(gen, (n_layers, fan_in, spec.rank), spec.init)
            B = torch.zeros(n_layers, spec.rank, fan_out)
        tree[name] = {"A": A.to(device, dtype), "B": B.to(device, dtype),
                      "scale": torch.tensor(spec.scale, dtype=dtype,
                                            device=device)}
    return {"blocks": tree}


def init_lora_gpt2(config, spec: LoRASpec, seed: int = 0,
                   dtype=torch.float32, device=None) -> dict:
    targets = spec.targets or GPT2_DEFAULT_TARGETS
    dims = {t: GPT2_TARGETS[t](config) for t in targets}
    return init_lora(dims, config.n_layer, spec, seed, dtype, device)


def init_lora_gemma3(config, spec: LoRASpec, seed: int = 0,
                     dtype=torch.float32, device=None) -> dict:
    """targets: a list, a GEMMA_PRESETS name, or None for "full"."""
    targets = spec.targets or GEMMA_PRESETS["full"]
    if isinstance(targets, str):
        targets = GEMMA_PRESETS[targets]
    dims = {t: GEMMA_TARGETS[t](config) for t in targets}
    return init_lora(dims, config.num_hidden_layers, spec, seed, dtype,
                     device)


def tree_leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict, in sorted key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}"
        if isinstance(val, dict):
            out.extend(tree_leaves(val, path))
        else:
            out.append((path, val))
    return out


def stack_adapters(loras) -> dict:
    """Stack N same-shaped adapter trees along a new leading ADAPTER axis;
    scale stacks to [N] so per-adapter alpha/r survives."""
    if not loras:
        raise ValueError("stack_adapters needs at least one adapter")
    ref = tree_leaves(loras[0])
    for i, t in enumerate(loras[1:], 1):
        leaves = tree_leaves(t)
        if [p for p, _ in leaves] != [p for p, _ in ref]:
            raise ValueError(
                f"adapter {i} has different targets/structure than "
                f"adapter 0: targets {sorted(t.get('blocks', {}))} vs "
                f"{sorted(loras[0].get('blocks', {}))} (multi-adapter "
                f"serving needs identical rank + target sets)")
        for (path, x0), (_, xi) in zip(ref, leaves):
            if x0.shape != xi.shape:
                raise ValueError(
                    f"adapter {i} leaf {path} has shape {tuple(xi.shape)} "
                    f"but adapter 0 has {tuple(x0.shape)} (rank/dim "
                    f"mismatch — stacked serving needs identical shapes)")

    def stack(*nodes):
        if isinstance(nodes[0], dict):
            return {k: stack(*(n[k] for n in nodes)) for k in nodes[0]}
        return torch.stack(list(nodes))

    return stack(*loras)


def unstack_adapter(stacked: dict, index: int) -> dict:
    """Adapter `index` of a stacked [k, ...] bank in the solo layout (A
    [L, in, r], B [L, r, out], a scalar scale): the inverse of one
    stack_adapters slot. Routing "ids" leaves are dropped (batch data, not
    adapter state). The leaves are views of the bank's; the multi-tenant
    engine's save path runs it on a host snapshot, so a bank-trained
    adapter saves byte-identical to a solo-trained one."""
    first = next(iter(stacked["blocks"].values()))
    n = int(first["A"].shape[0])
    if not (0 <= index < n):
        raise ValueError(
            f"adapter index {index} out of range for a stacked bank of "
            f"{n} adapter(s) (valid: 0..{n - 1})")
    out = dict(stacked)
    out["blocks"] = {
        name: {leaf: v[index] for leaf, v in entry.items() if leaf != "ids"}
        for name, entry in stacked["blocks"].items()}
    return out


def bank_size(stacked: dict) -> int:
    """The adapter count of a stack_adapters tree."""
    return int(next(iter(stacked["blocks"].values()))["A"].shape[0])


def check_adapter_ids(n: int, adapter_ids) -> np.ndarray:
    """Host adapter ids (a list, numpy array or tensor: a CUDA tensor costs
    one device-to-host copy) as int64 numpy, validated against a bank of
    `n` adapters: a gather on the card would index out of bounds, and a
    clamping one would quietly serve tenant A another tenant's weights."""
    if isinstance(adapter_ids, torch.Tensor):
        host = adapter_ids.detach().cpu().numpy()
    else:
        host = np.asarray(adapter_ids)
    host = host.astype(np.int64)
    bad = host[(host < 0) | (host >= n)]
    if bad.size:
        raise ValueError(
            f"adapter id(s) {sorted(set(int(b) for b in bad))} out of range "
            f"for a stacked bank of {n} adapter(s) (valid: 0..{n - 1})")
    return host


def route_rows(stacked: dict, ids: torch.Tensor) -> dict:
    """A stack_adapters tree routed by the device index tensor `ids`, by
    reference: the tree reads whatever `ids` and the bank's leaves hold
    when it is used, so one tree built over a static buffer serves every
    replay of a CUDA graph. The caller validates what it writes into
    `ids` (check_adapter_ids)."""
    out = dict(stacked)
    out["blocks"] = {name: dict(entry, ids=ids)
                     for name, entry in stacked["blocks"].items()}
    return out


def assign_adapters(stacked: dict, adapter_ids) -> dict:
    """Route batch rows to adapters: insert the per-row index array into
    every site entry of a stack_adapters tree (serving only).

    The ids are validated on the host first (check_adapter_ids). Pass host
    ids (a list, numpy array or CPU tensor): they go to the card through
    pinned memory without waiting for it."""
    host = check_adapter_ids(bank_size(stacked), adapter_ids)
    ids = torch.from_numpy(host)
    device = next(iter(stacked["blocks"].values()))["A"].device
    if device.type == "cuda":
        ids = ids.pin_memory().to(device, non_blocking=True)
    return route_rows(stacked, ids)


def trainable_mask(lora_tree) -> dict:
    """Tree of bools: True for the trainable leaves (A, B), False for the
    "scale" hyperparameter and for routing "ids"."""
    return {k: (trainable_mask(v) if isinstance(v, dict)
                else k not in ("scale", "ids"))
            for k, v in lora_tree.items()}


def num_trainable(lora_tree) -> int:
    mask = dict(tree_leaves(trainable_mask(lora_tree)))
    return sum(int(t.numel()) for path, t in tree_leaves(lora_tree)
               if mask[path])


def _delta_w(entry) -> torch.Tensor:
    """[L, in, out] = scale * A @ B per layer, in f32."""
    return entry["scale"].float() * torch.einsum(
        "lir,lro->lio", entry["A"].float(), entry["B"].float())


# base-weight leaf each GPT-2 target modifies; a third element is the
# column slot within the fused c_attn weight (split-QKV)
_GPT2_BASE = {"attn_qkv": ("attn", "qkv_w"), "attn_proj": ("attn", "proj_w"),
              "mlp_fc_in": ("mlp", "fc_w"), "mlp_fc_out": ("mlp", "proj_w"),
              **{name: ("attn", "qkv_w", slot)
                 for name, slot in GPT2_SPLIT_QKV_SLOTS.items()}}

_GEMMA_BASE = {"q_proj": ("attn", "q_w"), "k_proj": ("attn", "k_w"),
               "v_proj": ("attn", "v_w"), "o_proj": ("attn", "o_w"),
               "gate_proj": ("mlp", "gate_w"), "up_proj": ("mlp", "up_w"),
               "down_proj": ("mlp", "down_w")}


def _merge(params, lora_tree, base_map, sign: float) -> dict:
    """params + sign * dW on every adapted base weight, as a new tree
    (the input is not modified); split targets add into their column
    range of the fused weight."""
    blocks = {g: dict(v) if isinstance(v, dict) else v
              for g, v in params["blocks"].items()}
    for name, entry in lora_tree["blocks"].items():
        if name not in base_map:
            raise ValueError(
                f"target {name!r} cannot be merged into the base weights "
                f"(the lm_head is tied to the embedding table: folding its "
                f"dW in would change the input lookup too); serve it "
                f"through the lora= argument")
        spec = base_map[name]
        w = blocks[spec[0]][spec[1]]
        delta = sign * _delta_w(entry).to(w.dtype)
        if len(spec) == 3:
            out = delta.shape[-1]
            col0 = spec[2] * out
            w = w.clone()
            w[:, :, col0:col0 + out] += delta
        else:
            w = w + delta
        blocks[spec[0]][spec[1]] = w
    return dict(params, blocks=blocks)


def merge_gpt2(params, lora_tree) -> dict:
    """Fold each adapter's dW into the GPT-2 base weights."""
    return _merge(params, lora_tree, _GPT2_BASE, +1.0)


def unmerge_gpt2(params, lora_tree) -> dict:
    return _merge(params, lora_tree, _GPT2_BASE, -1.0)


def merge_gemma3(params, lora_tree) -> dict:
    """Fold each adapter's dW into the Gemma-3 base weights."""
    return _merge(params, lora_tree, _GEMMA_BASE, +1.0)


def unmerge_gemma3(params, lora_tree) -> dict:
    return _merge(params, lora_tree, _GEMMA_BASE, -1.0)
