"""HF GPT-2 and Gemma-3 checkpoints <-> the port's stacked parameter
trees (port of mobilefinetuner_tpu/io/checkpoints.py: `load_gpt2`,
`save_gpt2`, `load_gemma3`, `save_gemma3` and their key maps; the
checkpoint lineage comes with ROADMAP.md port item P5).

The stacked layout ([L, ...] leaves, models/gpt2.py, models/gemma3.py) is
a gather + stack of the HF per-layer keys. HF GPT-2 linears are Conv1D
[in, out], which is what y = x @ W computes, so no transpose is applied;
Gemma-3 linears are nn.Linear [out, in] and are transposed to [in, out]
at load (and back at save). Trees here are numpy (float32), as in the JAX
package; the `convert` functions put them on a device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.io.safetensors_io import (SafeTensorsReader,
                                                         save_safetensors)

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


def _arr(x) -> np.ndarray:
    """A numpy or torch leaf as numpy (bf16 tensors as float32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def gpt2_params_to_hf(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """The stacked tree (numpy or torch) -> HF GPT2LMHeadModel keys, in the
    JAX package's key order."""
    arr = _arr
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


def save_gpt2(path: str, params, metadata: Optional[dict] = None):
    """A full-model GPT-2 file in the HF key scheme (the GPT-2 full-FT
    CLI's checkpoint; loads back through load_gpt2's key map)."""
    save_safetensors(path, gpt2_params_to_hf(params),
                     metadata=metadata or {"format": "pt"})


# (HF per-layer key, stacked path, is an nn.Linear weight), in the JAX
# package's key order
_GEMMA_LAYER_KEYS = (
    ("model.layers.{}.input_layernorm.weight", ("input_ln",), False),
    ("model.layers.{}.self_attn.q_proj.weight", ("attn", "q_w"), True),
    ("model.layers.{}.self_attn.k_proj.weight", ("attn", "k_w"), True),
    ("model.layers.{}.self_attn.v_proj.weight", ("attn", "v_w"), True),
    ("model.layers.{}.self_attn.o_proj.weight", ("attn", "o_w"), True),
    ("model.layers.{}.self_attn.q_norm.weight", ("attn", "q_norm"), False),
    ("model.layers.{}.self_attn.k_norm.weight", ("attn", "k_norm"), False),
    ("model.layers.{}.post_attention_layernorm.weight", ("post_attn_ln",),
     False),
    ("model.layers.{}.pre_feedforward_layernorm.weight", ("pre_ffn_ln",),
     False),
    ("model.layers.{}.mlp.gate_proj.weight", ("mlp", "gate_w"), True),
    ("model.layers.{}.mlp.up_proj.weight", ("mlp", "up_w"), True),
    ("model.layers.{}.mlp.down_proj.weight", ("mlp", "down_w"), True),
    ("model.layers.{}.post_feedforward_layernorm.weight", ("post_ffn_ln",),
     False),
)


def gemma3_params_from_hf(tensors: Dict[str, np.ndarray],
                          config: Gemma3TextConfig) -> dict:
    """HF Gemma3ForCausalLM (text) state dict -> the stacked tree (numpy),
    linear weights transposed to [in, out]."""
    t = {("model." + k if not k.startswith("model.") else k): v
         for k, v in tensors.items()}
    blocks: dict = {}
    for fmt, path, linear in _GEMMA_LAYER_KEYS:
        stacked = np.stack([t[fmt.format(i)].T if linear
                            else t[fmt.format(i)]
                            for i in range(config.num_hidden_layers)])
        if len(path) == 1:
            blocks[path[0]] = stacked
        else:
            blocks.setdefault(path[0], {})[path[1]] = stacked
    return {"embed": t["model.embed_tokens.weight"], "blocks": blocks,
            "final_norm": t["model.norm.weight"]}


def gemma3_params_to_hf(params) -> Dict[str, np.ndarray]:
    """The stacked tree (numpy or torch) -> HF Gemma3 text keys, linear
    weights back to [out, in], in the JAX package's key order."""
    p = {"model.embed_tokens.weight": _arr(params["embed"])}
    b = params["blocks"]
    for fmt, path, linear in _GEMMA_LAYER_KEYS:
        stacked = _arr(b[path[0]] if len(path) == 1 else b[path[0]][path[1]])
        for i in range(stacked.shape[0]):
            p[fmt.format(i)] = stacked[i].T if linear else stacked[i]
    p["model.norm.weight"] = _arr(params["final_norm"])
    return p


def load_gemma3(model_dir: str, config: Optional[Gemma3TextConfig] = None):
    """(config, numpy params) from an HF Gemma-3 checkpoint directory."""
    if config is None:
        config = Gemma3TextConfig.from_pretrained(model_dir)
    return config, gemma3_params_from_hf(load_hf_state_dict(model_dir),
                                         config)


def save_gemma3(path: str, params, metadata: Optional[dict] = None):
    """A full-model Gemma-3 file in the HF key scheme (the Gemma full-FT
    CLI's checkpoint; loads back through load_gemma3's key map)."""
    save_safetensors(path, gemma3_params_to_hf(params),
                     metadata=metadata or {"format": "pt"})
