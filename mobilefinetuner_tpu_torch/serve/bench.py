"""Build a serving engine over seeded random weights (the counterpart of
tools/serve_bench.py `build_engine` and `rand_adapters` in the JAX tree).

    eng, names = build_engine("gemma270m", adapters=2, dtype="bfloat16",
                              prefix_cache=True, max_prompt_chunked=608,
                              sampling=True)
    reqs = [eng.submit(p, adapter=a) for p, a in ...]
    eng.drain()

Needs no download: weights come from `models.gpt2.init_params` /
`models.gemma3.init_params` and each tenant's adapter from
`lora.init_lora_gpt2` / `init_lora_gemma3` (every Gemma site: q/k/v/o and
gate/up/down) with every factor redrawn (B pushed off zero, so tenants'
outputs actually differ).
"""

from __future__ import annotations

import dataclasses

import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec, init_lora_gemma3,
                                                 init_lora_gpt2)
from mobilefinetuner_tpu_torch.models import gemma3, gpt2
from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.serve.engine import (DTYPES, ServeConfig,
                                                    ServeEngine)


def tiny_gemma() -> Gemma3TextConfig:
    """Gemma3TextConfig.tiny() with head_dim 64, the smallest head dim the
    flash and paged kernels take, so the tiny engine serves on the card
    as well as on the CPU."""
    return dataclasses.replace(Gemma3TextConfig.tiny(), head_dim=64,
                               query_pre_attn_scalar=64.0)


# model name -> (family, config)
MODELS = {"gpt2s": ("gpt2", GPT2Config.gpt2_small),
          "tiny-gpt2": ("gpt2", GPT2Config.tiny),
          "gemma270m": ("gemma", Gemma3TextConfig.gemma3_270m),
          "tiny-gemma": ("gemma", tiny_gemma)}


def rand_adapters(family: str, config, k: int, seed: int = 0, device=None,
                  dtype=torch.float32):
    """k seeded random rank-4 (alpha 8) adapters on the family's default
    targets, every A/B leaf redrawn as 0.02 * N(0, 1)."""
    device = resolve_device(device)
    init = init_lora_gpt2 if family == "gpt2" else init_lora_gemma3
    out = []
    for i in range(k):
        lora = init(config, LoRASpec(rank=4, alpha=8.0), seed=seed + i,
                    dtype=dtype, device=device)
        gen = torch.Generator().manual_seed(seed + 100 + i)
        for name in sorted(lora["blocks"]):
            entry = lora["blocks"][name]
            for leaf in ("A", "B"):
                entry[leaf] = (0.02 * torch.randn(
                    entry[leaf].shape, generator=gen)).to(device, dtype)
        out.append(lora)
    return out


def build_engine(model: str = "gpt2s", num_slots: int = 8,
                 block_T: int = 16, num_blocks: int = 512,
                 max_prompt: int = 128, max_new: int = 64,
                 adapters: int = 2, dtype: str = "bfloat16", seed: int = 0,
                 prefix_cache: bool = False, max_prompt_chunked: int = 0,
                 sampling: bool = False, device=None):
    """model: gpt2s | tiny-gpt2 | gemma270m | tiny-gemma. Returns (engine,
    tenant names), the tenants already loaded into the engine's bank."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (one of {sorted(MODELS)})")
    device = resolve_device(device)
    family, make_config = MODELS[model]
    config = make_config()
    cfg = ServeConfig(num_slots=num_slots, block_T=block_T,
                      num_blocks=num_blocks, max_prompt=max_prompt,
                      max_new_tokens=max_new, dtype=dtype,
                      prefix_cache=prefix_cache,
                      max_prompt_chunked=max_prompt_chunked,
                      sampling=sampling)
    cfg.validate()
    mod = gpt2 if family == "gpt2" else gemma3
    params = mod.init_params(config, seed=seed, dtype=DTYPES[dtype],
                             device=device)
    bank, names, trees = None, [], []
    if adapters:
        trees = rand_adapters(family, config, adapters, seed, device,
                              DTYPES[dtype])
        bank = AdapterBank(trees[0], capacity=adapters, family=family)
        names = [f"tenant{i}" for i in range(adapters)]
    eng = ServeEngine(family, config, params, cfg, bank=bank, device=device)
    for n, t in zip(names, trees):
        eng.load_adapter(n, t)
    return eng, names
