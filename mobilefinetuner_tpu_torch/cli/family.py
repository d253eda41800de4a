"""Model-family dispatch of the eval CLIs (port of
mobilefinetuner_tpu/cli/family.py).

From --pretrained_dir to (config, weights, tokenizer, model module, merge
function) for both families, so eval_ppl (and the eval CLIs to come)
share one copy of the load / sniff / merge block. The family is read off
the HF config.json (model_type, or a nested text_config for Gemma-3).
Unlike the JAX package, which hands back host numpy weights and leaves
the device placement to its caller, the bundle holds the weights as
tensors on `device` (None = the CUDA card), where the merge then runs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Optional

import torch

from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.lora import peft_io

log = get_logger()


def detect_family(model_dir: str) -> str:
    """gpt2 vs gemma from config.json (model_type or nested text_config)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        raw = json.load(f)
    mt = str(raw.get("model_type", "")).lower()
    if "gemma" in mt or "text_config" in raw:
        return "gemma"
    return "gpt2"


@dataclasses.dataclass
class FamilyBundle:
    family: str              # "gpt2" | "gemma"
    config: Any
    params: Any              # tensor tree on `device`
    tok: Any
    model: Any               # models.gpt2 or models.gemma3
    merge_fn: Callable       # merge_gpt2 / merge_gemma3
    head_key: str            # tied lm_head weight key: "wte" / "embed"
    max_len: int             # n_positions / max_position_embeddings
    device: torch.device


def load_family(pretrained_dir: str, family: str = "auto",
                device=None) -> FamilyBundle:
    """The bundle of --pretrained_dir; family "auto" reads config.json."""
    device = resolve_device(device)
    if family == "auto":
        try:
            family = detect_family(pretrained_dir)
        except OSError:
            raise SystemExit(
                f"no readable config.json under {pretrained_dir}")
    log.info(f"model family: {family}")
    if family == "gemma":
        from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
            GemmaTokenizer
        from mobilefinetuner_tpu_torch.io.checkpoints import load_gemma3
        from mobilefinetuner_tpu_torch.lora.lora import merge_gemma3
        from mobilefinetuner_tpu_torch.models import gemma3
        config, params = load_gemma3(pretrained_dir)
        return FamilyBundle(
            family, config,
            convert.gemma3_params_from_numpy(params, device=device),
            GemmaTokenizer.from_pretrained(pretrained_dir), gemma3,
            merge_gemma3, "embed", config.max_position_embeddings, device)
    from mobilefinetuner_tpu_torch.data.tokenizer_bpe import GPT2BPETokenizer
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.lora.lora import merge_gpt2
    from mobilefinetuner_tpu_torch.models import gpt2
    config, params = load_gpt2(pretrained_dir)
    return FamilyBundle(
        family, config, convert.gpt2_params_from_numpy(params, device=device),
        GPT2BPETokenizer.from_pretrained(pretrained_dir), gpt2, merge_gpt2,
        "wte", config.n_positions, device)


def apply_adapter(bundle: FamilyBundle, lora_path: str,
                  lora_merge: bool) -> Optional[dict]:
    """Load an adapter onto the bundle's device; merged: fold it into
    bundle.params and return None; dynamic: return the LoRA tree for the
    model's lora= argument (and the chunked loss's lora_head)."""
    if not lora_path:
        return None
    lora, spec = peft_io.load_adapter(lora_path, device=bundle.device)
    log.info(f"adapter: r={spec.rank} alpha={spec.alpha} "
             f"targets={spec.targets} "
             f"({'merged' if lora_merge else 'dynamic'})")
    if lora_merge:
        bundle.params = bundle.merge_fn(bundle.params, lora)
        return None
    return lora
