"""Build a serving engine over seeded random weights (the counterpart of
tools/serve_bench.py `build_engine` and `rand_adapters` in the JAX tree).

    eng, names = build_engine("gpt2s", adapters=2, dtype="bfloat16")
    reqs = [eng.submit(p, adapter=a) for p, a in ...]
    eng.drain()

Needs no download: GPT-2 weights come from `models.gpt2.init_params` and
each tenant's adapter from `lora.init_lora_gpt2` with every factor redrawn
(B pushed off zero, so tenants' outputs actually differ).
"""

from __future__ import annotations

import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.lora.lora import LoRASpec, init_lora_gpt2
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.serve.engine import (DTYPES, ServeConfig,
                                                    ServeEngine)

MODELS = {"gpt2s": GPT2Config.gpt2_small, "tiny-gpt2": GPT2Config.tiny}


def rand_adapters(config, k: int, seed: int = 0, device=None,
                  dtype=torch.float32):
    """k seeded random rank-4 (alpha 8) adapters on the default GPT-2
    targets, every A/B leaf redrawn as 0.02 * N(0, 1)."""
    device = resolve_device(device)
    out = []
    for i in range(k):
        lora = init_lora_gpt2(config, LoRASpec(rank=4, alpha=8.0),
                              seed=seed + i, dtype=dtype, device=device)
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
                 device=None):
    """model: gpt2s | tiny-gpt2. Returns (engine, tenant names), the
    tenants already loaded into the engine's bank."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r} (one of {sorted(MODELS)})")
    device = resolve_device(device)
    config = MODELS[model]()
    cfg = ServeConfig(num_slots=num_slots, block_T=block_T,
                      num_blocks=num_blocks, max_prompt=max_prompt,
                      max_new_tokens=max_new, dtype=dtype)
    cfg.validate()
    params = gpt2.init_params(config, seed=seed, dtype=DTYPES[dtype],
                              device=device)
    bank, names, trees = None, [], []
    if adapters:
        trees = rand_adapters(config, adapters, seed, device, DTYPES[dtype])
        bank = AdapterBank(trees[0], capacity=adapters)
        names = [f"tenant{i}" for i in range(adapters)]
    eng = ServeEngine("gpt2", config, params, cfg, bank=bank, device=device)
    for n, t in zip(names, trees):
        eng.load_adapter(n, t)
    return eng, names
