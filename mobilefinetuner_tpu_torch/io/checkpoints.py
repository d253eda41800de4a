"""HF GPT-2 checkpoints <-> the port's stacked parameter tree (port of
mobilefinetuner_tpu/io/checkpoints.py, the GPT-2 part: `load_gpt2` and
the two key maps; Gemma-3 and the checkpoint lineage come with later
slices, ROADMAP.md port items P3 and P5).

The stacked layout ([L, ...] leaves, models/gpt2.py) is a gather + stack
of the HF per-layer keys. HF GPT-2 linears are Conv1D [in, out], which is
what y = x @ W computes, so no transpose is applied. Trees here are numpy
(float32), as in the JAX package; convert.gpt2_params_from_numpy puts
them on a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.io.safetensors_io import SafeTensorsReader

# (HF per-layer key, stacked group, leaf)
_GPT2_LAYER_KEYS = (
    ("h.{}.ln_1.weight", "ln_1", "g"), ("h.{}.ln_1.bias", "ln_1", "b"),
    ("h.{}.attn.c_attn.weight", "attn", "qkv_w"),
    ("h.{}.attn.c_attn.bias", "attn", "qkv_b"),
    ("h.{}.attn.c_proj.weight", "attn", "proj_w"),
    ("h.{}.attn.c_proj.bias", "attn", "proj_b"),
    ("h.{}.ln_2.weight", "ln_2", "g"), ("h.{}.ln_2.bias", "ln_2", "b"),
    ("h.{}.mlp.c_fc.weight", "mlp", "fc_w"),
    ("h.{}.mlp.c_fc.bias", "mlp", "fc_b"),
    ("h.{}.mlp.c_proj.weight", "mlp", "proj_w"),
    ("h.{}.mlp.c_proj.bias", "mlp", "proj_b"),
)


def load_hf_state_dict(model_dir: str,
                       promote_to_f32: bool = True) -> Dict[str, np.ndarray]:
    """An HF checkpoint dir's state dict, single-file or sharded
    (model.safetensors.index.json)."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out = {}
        for shard in sorted(set(weight_map.values())):
            out.update(SafeTensorsReader(os.path.join(model_dir, shard))
                       .load_all(promote_to_f32))
        return out
    return SafeTensorsReader(
        _find_weights_file(model_dir)).load_all(promote_to_f32)


def _find_weights_file(model_dir: str) -> str:
    for name in ("model.safetensors", "pytorch_model.safetensors"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    cands = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return os.path.join(model_dir, cands[0])
    if cands:
        raise FileNotFoundError(
            f"multiple safetensors shards in {model_dir} but no "
            "model.safetensors.index.json")
    raise FileNotFoundError(f"no safetensors weights in {model_dir}")


def _strip_prefix(tensors, prefixes=("transformer.", "model.")):
    out = {}
    for k, v in tensors.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def gpt2_params_from_hf(tensors: Dict[str, np.ndarray],
                        config: GPT2Config) -> dict:
    """HF GPT2LMHeadModel state dict -> the stacked tree (numpy)."""
    t = _strip_prefix(tensors)
    blocks: dict = {}
    for fmt, group, leaf in _GPT2_LAYER_KEYS:
        blocks.setdefault(group, {})[leaf] = np.stack(
            [t[fmt.format(i)] for i in range(config.n_layer)])
    return {"wte": t["wte.weight"], "wpe": t["wpe.weight"],
            "blocks": blocks,
            "ln_f": {"g": t["ln_f.weight"], "b": t["ln_f.bias"]}}


def gpt2_params_to_hf(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """The stacked tree (numpy or torch) -> HF GPT2LMHeadModel keys, in the
    JAX package's key order."""
    def arr(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") \
            else np.asarray(x)
    p = {"wte.weight": arr(params["wte"]), "wpe.weight": arr(params["wpe"]),
         "ln_f.weight": arr(params["ln_f"]["g"]),
         "ln_f.bias": arr(params["ln_f"]["b"])}
    b = params["blocks"]
    for fmt, group, leaf in _GPT2_LAYER_KEYS:
        stacked = arr(b[group][leaf])
        for i in range(stacked.shape[0]):
            p[fmt.format(i)] = stacked[i]
    if prefix:
        p = {prefix + k: v for k, v in p.items()}
    return p


def load_gpt2(model_dir: str, config: Optional[GPT2Config] = None):
    """(config, numpy params) from an HF GPT-2 checkpoint directory."""
    if config is None:
        config = GPT2Config.from_pretrained(model_dir)
    return config, gpt2_params_from_hf(load_hf_state_dict(model_dir), config)
