"""Text generation: KV-cached sampling for GPT-2 and Gemma-3, with
optional LoRA adapters, merged, dynamic or several routed per prompt (port
of mobilefinetuner_tpu/cli/generate.py: the same flags, SystemExit
messages and `--json` records, plus `--device`).

    python -m mobilefinetuner_tpu_torch.cli.generate \\
        --pretrained_dir /path/gpt2-or-gemma --prompt "The meaning of" \\
        [--prompt ...] [--lora_path adapter.safetensors [--lora_dynamic]] \\
        [--max_new_tokens 64] [--greedy | --temperature 0.8 --top_k 50 \\
         --top_p 0.95] [--seed 0] [--dtype bfloat16] [--json]

The family is read off config.json (`--model` forces it). Prompts are
left-padded into one batch and run through models/generate.py
(`gpt2_generate` / `gemma3_generate`): on the card, the flash forward
kernel in the prefill and the contiguous-decode kernel (row 13) in every
decode step, the LoRA epilogue kernel at every site of a dynamic adapter.
Sampling draws from a torch.Generator seeded with --seed, so sampled
tokens differ from the JAX CLI's (greedy ones do not). The log line
gives tokens/s; on the card also the prefill, the first token and the
decode-step p50 from CUDA events recorded between the phases. The decode
steps replay one CUDA graph on the card, captured at the second step
(models/generate.py), so the step p50 is a replayed step's.
`main(argv, stats=dict)` fills `stats` with the same figures and
`graph_captures`, the captures the run made; `_eager=True` (private:
comparisons only) keeps every step eager on the card.
"""

from __future__ import annotations

import argparse
import functools
import json as json_mod
import sys
import time
from typing import Optional

import torch

from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.cli.family import apply_adapter, load_family
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.models.generate import (SampleConfig,
                                                       gemma3_generate,
                                                       gpt2_generate,
                                                       graph_captures,
                                                       left_pad)

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "generate", description="KV-cached sampling (GPT-2 / Gemma-3), "
                                "PyTorch port")
    p.add_argument("--pretrained_dir", required=True)
    p.add_argument("--model", choices=["auto", "gpt2", "gemma"],
                   default="auto")
    p.add_argument("--prompt", action="append", default=[],
                   help="repeatable; one generation per prompt")
    p.add_argument("--prompt_file", default="",
                   help="one prompt per line (adds to --prompt)")
    p.add_argument("--lora_path", default="",
                   help="adapter safetensors; merged into the base weights "
                        "by default. A comma list serves SEVERAL adapters "
                        "in one batch (dynamically; route prompts with "
                        "--adapter_ids)")
    p.add_argument("--adapter_ids", default="",
                   help="comma list, one 0-based adapter index per "
                        "prompt (default: prompt i -> adapter "
                        "i %% n_adapters)")
    p.add_argument("--lora_dynamic", action="store_true",
                   help="apply the adapter at every site instead of "
                        "merging it")
    p.add_argument("--lora_impl", choices=["auto", "naive", "fused"],
                   default="auto",
                   help="dynamic-LoRA implementation (models/lora_apply."
                        "py): 'auto' is the epilogue kernel on the card, "
                        "'naive' the oracle")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="Gemma long-prompt mode: prefill in W-token "
                        "windows against the growing KV cache; 0 = "
                        "whole-prompt forward. Gemma-only")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--no_eos_stop", action="store_true",
                   help="keep sampling past the eos token")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--json", action="store_true", dest="json_out",
                   help="emit one JSON object per prompt on stdout")
    common.add_device_flag(p)
    return p


def _route_adapters(args, paths, n_prompts, device):
    """A stack of the comma-listed adapters with each prompt's index."""
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.lora.lora import (assign_adapters,
                                                     stack_adapters)
    adapters = [peft_io.load_adapter(p, device=device)[0] for p in paths]
    if args.adapter_ids:
        try:
            ids = [int(x) for x in args.adapter_ids.split(",") if x]
        except ValueError:
            raise SystemExit(
                f"--adapter_ids must be a comma list of integers, "
                f"got {args.adapter_ids!r}")
        if len(ids) != n_prompts:
            raise SystemExit(
                f"--adapter_ids has {len(ids)} entries for "
                f"{n_prompts} prompts")
        bad = [i for i in ids if not 0 <= i < len(adapters)]
        if bad:
            raise SystemExit(f"adapter ids out of range: {bad}")
    else:
        ids = [i % len(adapters) for i in range(n_prompts)]
    log.info(f"multi-adapter serving: {len(adapters)} adapters, "
             f"prompt routing {ids}")
    return assign_adapters(stack_adapters(adapters), ids)


def main(argv=None, stats: Optional[dict] = None,
         _eager: bool = False) -> int:
    args = build_parser().parse_args(argv)
    prompts = list(args.prompt)
    if args.prompt_file:
        with open(args.prompt_file, encoding="utf-8") as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
    if not prompts:
        raise SystemExit("no prompts (--prompt / --prompt_file)")
    device = common.setup_device(args)
    compute_dtype = common.compute_dtype_from_args(args)
    b = load_family(args.pretrained_dir, args.model, device=device)
    if args.prefill_chunk and b.family == "gpt2":
        raise SystemExit("--prefill_chunk is Gemma-only (GPT-2's learned "
                         "positions cap prompts at n_positions)")
    if b.family == "gpt2":
        gen = gpt2_generate
    else:
        gen = functools.partial(gemma3_generate,
                                prefill_chunk=args.prefill_chunk or None)
    tok = b.tok
    lora_paths = [p for p in args.lora_path.split(",") if p]
    if len(lora_paths) > 1:
        lora = _route_adapters(args, lora_paths, len(prompts), device)
    else:
        if args.adapter_ids:
            raise SystemExit(
                "--adapter_ids requires at least two --lora_path entries "
                "(comma list) to route between")
        lora = apply_adapter(b, args.lora_path,
                             lora_merge=not args.lora_dynamic)

    encoded = [tok.encode(p) for p in prompts]  # Gemma: BOS (HF parity)
    empty = [p for p, e in zip(prompts, encoded) if not e]
    if empty:
        raise SystemExit(f"prompt(s) encode to zero tokens: {empty!r}")
    ids, mask = left_pad(encoded, tok.pad_id)
    cfg = SampleConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        greedy=args.greedy,
        eos_id=None if args.no_eos_stop else tok.eos_id,
        pad_id=tok.pad_id)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    events = [] if device.type == "cuda" else None

    captures0 = graph_captures["decode_step"]
    t0 = time.perf_counter()
    out = gen(b.config, b.params, torch.as_tensor(ids, device=device),
              torch.as_tensor(mask, device=device), cfg,
              generator=generator, compute_dtype=compute_dtype, lora=lora,
              lora_impl=args.lora_impl, events=events, _eager=_eager).cpu()
    dt = time.perf_counter() - t0
    n_tok = int(out.numel())
    run = {"tokens": n_tok, "seconds": dt,
           "tokens_per_s": n_tok / max(dt, 1e-9),
           "graph_captures": graph_captures["decode_step"] - captures0}
    msg = f"{n_tok} tokens in {dt:.2f}s ({run['tokens_per_s']:.1f} tok/s)"
    if events:
        # events: before the prefill, after it, after the decode set-up
        # (the caches, the weights cast once) and the first sample, after
        # each decode step
        run["prefill_ms"] = events[0].elapsed_time(events[1])
        run["first_token_ms"] = events[0].elapsed_time(events[2])
        steps = [a.elapsed_time(e) for a, e in zip(events[2:], events[3:])]
        run["decode_step_ms"] = steps
        msg += (f"; prefill {run['prefill_ms']:.3f} ms, first token "
                f"{run['first_token_ms']:.3f} ms")
        if steps:
            run["decode_step_ms_p50"] = sorted(steps)[len(steps) // 2]
            msg += f"; decode step p50 {run['decode_step_ms_p50']:.3f} ms"
    log.info(msg)
    if stats is not None:
        stats.update(run)

    for i, prompt in enumerate(prompts):
        row = out[i].tolist()
        if cfg.eos_id is not None and cfg.eos_id in row:
            row = row[:row.index(cfg.eos_id) + 1]
        text = tok.decode(row)
        if args.json_out:
            print(json_mod.dumps({"prompt": prompt, "ids": row,
                                  "text": text}))
        else:
            print(f"=== {prompt!r}\n{text}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
