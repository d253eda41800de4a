"""WikiText-2 perplexity of GPT-2 or Gemma-3, with or without a LoRA
adapter (port of mobilefinetuner_tpu/cli/eval_ppl.py: the same flags,
log lines, JSONL records and final JSON line, plus `--device`).

    python -m mobilefinetuner_tpu_torch.cli.eval_ppl \\
        --pretrained_dir /path/gpt2-or-gemma --data_root /path/wikitext-2 \\
        --split valid [--lora_path adapter.safetensors [--lora_merge]]

The family is read off config.json (`--family` forces it). The adapter is
folded into the base weights (`--lora_merge`) or applied dynamically.
The split is scored in order (no shuffle, the short tail kept) as a
token-weighted mean NLL: nll = sum(nll) / tokens, ppl = exp(nll).

GPT-2 goes through models/gpt2.forward and ops/loss.lm_cross_entropy_sum;
Gemma-3 through models/gemma3.hidden_states and the chunked loss
(`--loss_chunks` sequence chunks, so the [B, S, 262,144] logits never
exist), where an "lm_head" adapter entry rides as `lora_head` (hidden
states apply only the per-layer sites; dropping the head adapter would
score another model than the one trained). It runs under
torch.no_grad(): on the card the flash forward, the LoRA epilogue at
every adapted site and, for Gemma, the fused CE forward kernel (row 6,
or row 9 with a head adapter) in every chunk. Batches come through
data/prefetch.Prefetcher (`--prefetch`, 0 = synchronous), placed on the
card from pinned memory.

Before the data loop the full [batch_size, seq_len] batch is admitted
against device memory (`common.preflight_eval`, on the analytic estimate
of core/memory_guard.py where the JAX CLI judges its ahead-of-time
compile): `--on_oom_risk fail` raises MemoryAdmissionError there,
`degrade` and `warn` proceed with a warning (eval has no ladder).
`--telemetry_out` writes run_start, mem_check, one `eval` per progress
line and at the end, and run_end (its goodput None, as in the JAX eval
CLIs); `--run_registry` adds one registry record, finalized "ok" before
run_end.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import torch

from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.cli.family import apply_adapter, load_family
from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.logging import JSONLWriter, get_logger
from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)
from mobilefinetuner_tpu_torch.ops.loss import (
    chunked_lm_cross_entropy_sum, lm_cross_entropy_sum, perplexity_from_loss)

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval_ppl",
        description="WikiText-2 perplexity (PyTorch port)")
    p.add_argument("--pretrained_dir", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="valid", choices=["valid", "test"])
    p.add_argument("--lora_path", default="")
    p.add_argument("--lora_merge", action="store_true",
                   help="fold the adapter into base weights instead of "
                        "applying it dynamically")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seq_len", type=int, default=1024)
    p.add_argument("--stride", type=int, default=0,
                   help="chunk stride; 0 = seq_len (no overlap)")
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--out", default="", help="JSONL output path")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--family", choices=["auto", "gpt2", "gemma"],
                   default="auto")
    p.add_argument("--loss_chunks", type=int, default=8,
                   help="sequence chunks for Gemma's 262k-vocab chunked "
                        "CE")
    p.add_argument("--prefetch", type=int, default=2,
                   help="input pipeline depth (background batch producer "
                        "+ placement lookahead, data/prefetch.py); 0 = "
                        "synchronous")
    p.add_argument("--telemetry_out", default="",
                   help="run-telemetry JSONL stream (core/telemetry.py)")
    p.add_argument("--run_registry", default="",
                   help="append-only run registry stream (core/"
                        "run_registry.py): one crash-safe record per "
                        "eval run; default $MFT_RUN_REGISTRY, empty = "
                        "off")
    common.add_mem_flags(p)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.check_not_ported(args)
    device = common.setup_device(args)
    compute_dtype = common.compute_dtype_from_args(args)
    b = load_family(args.pretrained_dir, args.family, device=device)
    family = b.family
    lora = apply_adapter(b, args.lora_path, args.lora_merge)
    config, params, tok = b.config, b.params, b.tok

    if family == "gemma":
        from mobilefinetuner_tpu_torch.models import gemma3
        encode = lambda s: tok.encode(s, add_bos=False)  # noqa: E731
        eos_id, pad_id = tok.eos_id, tok.pad_id
        head_entry = None if lora is None else lora["blocks"].get("lm_head")

        def step(batch):
            hidden = gemma3.hidden_states(
                config, params, batch["input_ids"],
                attention_mask=batch["attention_mask"], lora=lora,
                compute_dtype=compute_dtype)
            return chunked_lm_cross_entropy_sum(
                hidden, params["embed"], batch["labels"],
                num_chunks=args.loss_chunks, lora_head=head_entry)
    else:
        from mobilefinetuner_tpu_torch.models import gpt2
        encode, eos_id, pad_id = tok.encode, tok.eos_id, None

        def step(batch):
            logits = gpt2.forward(config, params, batch["input_ids"],
                                  attention_mask=batch["attention_mask"],
                                  lora=lora, compute_dtype=compute_dtype)
            return lm_cross_entropy_sum(logits, batch["labels"])

    args.seq_len = min(args.seq_len, b.max_len)
    wt2 = WT2Config(seq_len=args.seq_len, batch_size=args.batch_size,
                    stride=args.stride or None, shuffle=False,
                    drop_last=False)
    ds = WikiText2Dataset(args.data_root, args.split, wt2, encode, eos_id,
                          pad_id=pad_id)
    jsonl = JSONLWriter(args.out) if args.out else None
    tel = common.eval_telemetry(args, device)
    run_rec = common.eval_run_record(args, tel, device, "eval_ppl")
    if family == "gemma":
        fp = mg.gemma3_footprint(config, compute_dtype, args.seq_len,
                                 args.loss_chunks, head_trains=False)
    else:
        fp = mg.gpt2_footprint(config, compute_dtype, args.seq_len)
    weights = (params, lora)
    common.preflight_eval(
        mg.eval_estimate_mb(fp, params=weights, rows=args.batch_size,
                            seq_len=args.seq_len,
                            compute_dtype=compute_dtype),
        args, tel, device, resident_mb=mg.tree_bytes(weights) / 2 ** 20,
        what=f"eval_ppl batch [{args.batch_size}, {args.seq_len}]")

    # the sums stay on the device, read at log boundaries and once after
    total, count, n_done = None, None, 0
    t0 = time.time()
    source = ds.epoch(0)
    if args.max_batches:
        source = itertools.islice(source, args.max_batches)
    with torch.no_grad(), Prefetcher(
            source, depth=args.prefetch,
            place_fn=lambda bt: common.place_batch(bt, device),
            rss_limit_mb=args.prefetch_rss_mb) as batches:
        for n, batch in enumerate(batches):
            s, c = step(batch)
            total = s.float() if total is None else total + s.float()
            count = c if count is None else count + c
            n_done = n + 1
            if args.log_every and n_done % args.log_every == 0:
                t, k = torch.stack([total, count.float()]).cpu().tolist()
                mean = t / max(int(k), 1)
                log.info(f"batch {n_done}/{ds.num_batches()} "
                         f"nll={mean:.4f} "
                         f"ppl={perplexity_from_loss(mean):.2f}")
                if jsonl:
                    jsonl.write({"type": "progress", "batch": n_done,
                                 "nll": mean,
                                 "ppl": perplexity_from_loss(mean)})
                tel.emit("eval", step=n_done, loss=mean,
                         ppl=perplexity_from_loss(mean), tokens=int(k))
    if n_done:
        total, count = torch.stack([total, count.float()]).cpu().tolist()
    total, count = (float(total), int(count)) if n_done else (0.0, 0)
    mean = total / max(count, 1)
    ppl = perplexity_from_loss(mean)
    record = {"type": "final", "family": family, "split": args.split,
              "nll": mean, "ppl": ppl, "tokens": count,
              "seq_len": args.seq_len, "lora": bool(args.lora_path),
              "merged": args.lora_merge,
              "seconds": round(time.time() - t0, 1)}
    log.info(f"{args.split} ppl={ppl:.3f} nll={mean:.4f} ({count} tokens)")
    if jsonl:
        jsonl.write(record)
    tel.emit("eval", step=n_done, loss=mean, ppl=ppl, tokens=count)
    # the registry's `run` end event lands before run_end, which stays
    # the stream's last event
    if run_rec is not None:
        run_rec.finalize("ok")
    # goodput is None: the eval CLIs have no metered phase loop
    tel.emit("run_end", steps=n_done, wall_s=round(time.time() - t0, 3),
             exit="ok", goodput=None)
    tel.close()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
