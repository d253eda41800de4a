"""Adapter files: the native format and HF-PEFT export/import (port of
mobilefinetuner_tpu/lora/peft_io.py; byte-compatible with it).

  native  keys `blocks.{target}.{A|B}` holding the stacked [L, ...] f32
          arrays, the LoRASpec in the header metadata (`format`
          "mobilefinetuner_tpu.lora.v1"): exact, single-file resume;
  PEFT    `adapter_model.safetensors` with per-layer
          `base_model.model.<module>.lora_A.weight` [r, in] and
          `lora_B.weight` [out, r] (torch nn.Linear layout), plus
          `adapter_config.json`, loadable by HF PEFT on the base model;
          family "gpt2" (Conv1D, fan_in_fan_out) or "gemma" (nn.Linear).

Loaders put the tree on `device` (None = the CUDA card, core/device.py).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.io.safetensors_io import (SafeTensorsReader,
                                                         atomic_publish,
                                                         save_safetensors)
from mobilefinetuner_tpu_torch.lora.lora import LoRASpec

# target -> HF module path (PEFT keys prepend "base_model.model." and
# append ".lora_A.weight" / ".lora_B.weight")
GPT2_PEFT_MODULES = {
    "attn_qkv": "transformer.h.{}.attn.c_attn",
    "attn_proj": "transformer.h.{}.attn.c_proj",
    "mlp_fc_in": "transformer.h.{}.mlp.c_fc",
    "mlp_fc_out": "transformer.h.{}.mlp.c_proj",
}
GEMMA_PEFT_MODULES = {
    **{t: "model.layers.{}.self_attn." + t
       for t in ("q_proj", "k_proj", "v_proj", "o_proj")},
    **{t: "model.layers.{}.mlp." + t
       for t in ("gate_proj", "up_proj", "down_proj")},
}
# adapter_config.json target_modules of GPT-2, path-qualified so PEFT's
# suffix match cannot hit both attn.c_proj and mlp.c_proj (the Gemma
# target names are already unique)
PEFT_TARGET_MODULES = {
    "attn_qkv": "attn.c_attn", "attn_proj": "attn.c_proj",
    "mlp_fc_in": "mlp.c_fc", "mlp_fc_out": "mlp.c_proj",
}
FAMILY_MODULES = {"gpt2": GPT2_PEFT_MODULES, "gemma": GEMMA_PEFT_MODULES}
NATIVE_FORMAT = "mobilefinetuner_tpu.lora.v1"


def _f32(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _tree(blocks_np: Dict[str, Dict[str, np.ndarray]], spec: LoRASpec,
          device) -> dict:
    device = resolve_device(device)
    blocks = {name: {leaf: torch.from_numpy(np.array(a, np.float32))
                     .to(device) for leaf, a in leaves.items()}
              for name, leaves in blocks_np.items()}
    for entry in blocks.values():
        entry["scale"] = torch.tensor(spec.scale, dtype=torch.float32,
                                      device=device)
    spec.targets = sorted(blocks)
    return {"blocks": blocks}


def save_adapter(path: str, lora_tree, spec: LoRASpec,
                 extra_metadata: Optional[Dict[str, str]] = None):
    """Native adapter file, published atomically with its manifest."""
    tensors = {}
    for name, entry in lora_tree["blocks"].items():
        tensors[f"blocks.{name}.A"] = _f32(entry["A"])
        tensors[f"blocks.{name}.B"] = _f32(entry["B"])
    md = spec.to_metadata()
    md["format"] = NATIVE_FORMAT
    if extra_metadata:
        md.update(extra_metadata)
    save_safetensors(path, tensors, metadata=md)


def load_adapter(path: str, device=None) -> Tuple[dict, LoRASpec]:
    """A native adapter file -> (lora tree of f32 tensors, spec)."""
    reader = SafeTensorsReader(path)
    spec = LoRASpec.from_metadata(reader.metadata)
    blocks: dict = {}
    for key in reader.keys():
        prefix, name, leaf = key.split(".")
        if prefix != "blocks" or leaf not in ("A", "B"):
            raise ValueError(f"{path}: {key!r} is not a native adapter key "
                             f"(blocks.<target>.A|B)")
        blocks.setdefault(name, {})[leaf] = reader.load(key)
    return _tree(blocks, spec, device), spec


def _modules(family: str) -> Dict[str, str]:
    if family not in FAMILY_MODULES:
        raise ValueError(f"PEFT family {family!r} is not one of "
                         f"{sorted(FAMILY_MODULES)}")
    return FAMILY_MODULES[family]


def export_peft(out_dir: str, lora_tree, spec: LoRASpec, family: str,
                base_model_name: str = ""):
    """adapter_model.safetensors + adapter_config.json for HF PEFT
    (GPT-2 is Conv1D, so fan_in_fan_out; Gemma is nn.Linear)."""
    modules = _modules(family)
    unsupported = sorted(set(lora_tree["blocks"]) - set(modules))
    if unsupported:
        raise ValueError(
            f"targets {unsupported} have no PEFT representation (PEFT "
            f"cannot express column-sliced adapters on the fused c_attn, "
            f"nor the tied lm_head); use the native adapter format")
    os.makedirs(out_dir, exist_ok=True)
    tensors = {}
    for name, entry in lora_tree["blocks"].items():
        A, B = _f32(entry["A"]), _f32(entry["B"])
        for i in range(A.shape[0]):
            mod = "base_model.model." + modules[name].format(i)
            tensors[mod + ".lora_A.weight"] = A[i].T.copy()
            tensors[mod + ".lora_B.weight"] = B[i].T.copy()
    save_safetensors(os.path.join(out_dir, "adapter_model.safetensors"),
                     tensors, metadata={"format": "pt"})
    cfg = {
        "peft_type": "LORA", "task_type": "CAUSAL_LM",
        "base_model_name_or_path": base_model_name,
        "r": spec.rank, "lora_alpha": spec.alpha,
        "lora_dropout": spec.dropout, "bias": "none",
        "fan_in_fan_out": family == "gpt2",
        "target_modules": (sorted({PEFT_TARGET_MODULES[t]
                                   for t in lora_tree["blocks"]})
                           if family == "gpt2"
                           else sorted(lora_tree["blocks"])),
        "inference_mode": False,
    }
    with atomic_publish(os.path.join(out_dir, "adapter_config.json")) as tmp:
        with open(tmp, "w") as f:
            json.dump(cfg, f, indent=2)


def import_peft(adapter_dir: str, family: str,
                device=None) -> Tuple[dict, LoRASpec]:
    """An HF-PEFT adapter dir -> (stacked lora tree, spec)."""
    modules = _modules(family)
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        cfg = json.load(f)
    spec = LoRASpec(rank=cfg["r"], alpha=cfg["lora_alpha"],
                    dropout=cfg.get("lora_dropout", 0.0), init="peft")
    raw = SafeTensorsReader(os.path.join(
        adapter_dir, "adapter_model.safetensors")).load_all(
            promote_to_f32=True)
    blocks: dict = {}
    for name, fmt in modules.items():
        As, Bs = [], []
        while True:
            mod = "base_model.model." + fmt.format(len(As))
            if mod + ".lora_A.weight" not in raw:
                break
            As.append(raw[mod + ".lora_A.weight"].T)
            Bs.append(raw[mod + ".lora_B.weight"].T)
        if As:
            blocks[name] = {"A": np.stack(As), "B": np.stack(Bs)}
    return _tree(blocks, spec, device), spec
