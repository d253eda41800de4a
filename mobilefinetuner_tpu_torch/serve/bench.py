"""Build a serving engine over seeded random weights (the counterpart of
tools/serve_bench.py `build_engine` and `rand_adapters` in the JAX tree).

    eng, names = build_engine("gemma270m", adapters=2, dtype="bfloat16",
                              prefix_cache=True, max_prompt_chunked=608,
                              sampling=True)
    reqs = [eng.submit(p, adapter=a) for p, a in ...]
    eng.drain()

With `telemetry_out` the engine writes its stream (request phases,
`serve_stats` every `stats_every` decode steps, spans under
`trace_spans`), and `metrics_port` > 0 serves the OpenMetrics endpoint
(core/metrics_http.py) over that stream with /healthz on
`engine.health` (the server is `engine.metrics_server`; close it when
done).

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
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.core.metrics_http import (MetricsRegistry,
                                                         MetricsServer)
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry
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
                 sampling: bool = False, device=None,
                 telemetry_out: str = "", stats_every: int = 0,
                 watchdog=None, trace_spans: bool = False,
                 metrics_port: int = 0, metrics_addr: str = "127.0.0.1",
                 host: int = 0, _eager: bool = False):
    """model: gpt2s | tiny-gpt2 | gemma270m | tiny-gemma. Returns (engine,
    tenant names), the tenants already loaded into the engine's bank.
    `host` stamps the telemetry envelope (a replica k of a fleet writes
    with host=k); `watchdog` is petted after each decode step (its
    start and stop are the caller's). `_eager` is the engine's
    private argument (comparisons only)."""
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
                      sampling=sampling, stats_every=stats_every,
                      trace_spans=trace_spans)
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
    tel = Telemetry(telemetry_out, host=host)
    registry = None
    if metrics_port > 0:
        # the observer is attached before the engine builds, so run_start
        # and the build-time mem_check reach the registry too
        registry = MetricsRegistry()
        tel.add_observer(registry.observe)
    eng = ServeEngine(family, config, params, cfg, bank=bank, telemetry=tel,
                      watchdog=watchdog, device=device,
                      _eager=_eager)
    eng.metrics_server = None
    if registry is not None:
        eng.metrics_server = MetricsServer(
            registry, port=metrics_port, addr=metrics_addr,
            health_fn=eng.health)
        get_logger().info(f"metrics endpoint: http://"
                          f"{eng.metrics_server.addr}:"
                          f"{eng.metrics_server.port}/metrics (+ /healthz)")
    for n, t in zip(names, trees):
        eng.load_adapter(n, t)
    return eng, names
