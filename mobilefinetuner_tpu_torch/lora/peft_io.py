"""Adapter files: the native format and HF-PEFT export/import (port of
mobilefinetuner_tpu/lora/peft_io.py; byte-compatible with it).

  native  keys `blocks.{target}.{A|B}` holding the stacked [L, ...] f32
          arrays, the LoRASpec in the header metadata (`format`
          "mobilefinetuner_tpu.lora.v1"): exact, single-file resume;
  PEFT    `adapter_model.safetensors` with per-layer
          `base_model.model.<module>.lora_A.weight` [r, in] and
          `lora_B.weight` [out, r] (torch nn.Linear layout), plus
          `adapter_config.json`, loadable by HF PEFT on the base model.

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
# adapter_config.json target_modules, path-qualified so PEFT's suffix
# match cannot hit both attn.c_proj and mlp.c_proj
PEFT_TARGET_MODULES = {
    "attn_qkv": "attn.c_attn", "attn_proj": "attn.c_proj",
    "mlp_fc_in": "mlp.c_fc", "mlp_fc_out": "mlp.c_proj",
}
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


def export_peft(out_dir: str, lora_tree, spec: LoRASpec, family: str,
                base_model_name: str = ""):
    """adapter_model.safetensors + adapter_config.json for HF PEFT
    (GPT-2: Conv1D, so fan_in_fan_out)."""
    if family != "gpt2":
        raise NotImplementedError(
            f"PEFT export for {family!r} comes with the Gemma slice "
            f"(ROADMAP.md port item P3)")
    unsupported = sorted(set(lora_tree["blocks"]) - set(GPT2_PEFT_MODULES))
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
            mod = "base_model.model." + GPT2_PEFT_MODULES[name].format(i)
            tensors[mod + ".lora_A.weight"] = A[i].T.copy()
            tensors[mod + ".lora_B.weight"] = B[i].T.copy()
    save_safetensors(os.path.join(out_dir, "adapter_model.safetensors"),
                     tensors, metadata={"format": "pt"})
    cfg = {
        "peft_type": "LORA", "task_type": "CAUSAL_LM",
        "base_model_name_or_path": base_model_name,
        "r": spec.rank, "lora_alpha": spec.alpha,
        "lora_dropout": spec.dropout, "bias": "none",
        "fan_in_fan_out": True,
        "target_modules": sorted({PEFT_TARGET_MODULES[t]
                                  for t in lora_tree["blocks"]}),
        "inference_mode": False,
    }
    with atomic_publish(os.path.join(out_dir, "adapter_config.json")) as tmp:
        with open(tmp, "w") as f:
            json.dump(cfg, f, indent=2)


def import_peft(adapter_dir: str, family: str,
                device=None) -> Tuple[dict, LoRASpec]:
    """An HF-PEFT adapter dir -> (stacked lora tree, spec)."""
    if family != "gpt2":
        raise NotImplementedError(
            f"PEFT import for {family!r} comes with the Gemma slice "
            f"(ROADMAP.md port item P3)")
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        cfg = json.load(f)
    spec = LoRASpec(rank=cfg["r"], alpha=cfg["lora_alpha"],
                    dropout=cfg.get("lora_dropout", 0.0), init="peft")
    raw = SafeTensorsReader(os.path.join(
        adapter_dir, "adapter_model.safetensors")).load_all(
            promote_to_f32=True)
    blocks: dict = {}
    for name, fmt in GPT2_PEFT_MODULES.items():
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
