"""MMLU 4-choice accuracy of GPT-2 or Gemma-3, with or without a LoRA
adapter (port of mobilefinetuner_tpu/cli/eval_mmlu.py: the same flags,
log lines, JSON report and final one-line summary, plus `--device` and
the train CLIs' `--attention_impl`).

    python -m mobilefinetuner_tpu_torch.cli.eval_mmlu \\
        --pretrained_dir /path/gpt2-or-gemma --mmlu_root /path/mmlu \\
        --split test [--fewshot 5] [--lora_path adapter.safetensors \\
        [--lora_merge]]

The family is read off config.json (cli/family.py); the adapter is
folded into the base weights (`--lora_merge`) or applied dynamically.
Prompts are right-padded to power-of-two length buckets
(eval/mmlu.evaluate_batched) and scored `--eval_batch` at a time, with no
padding mask: causal attention keeps the pads out of the real rows. The
last real token's hidden state is taken by index and only those rows go
through the tied head (a plain matmul; an "lm_head" adapter entry lands
there through models/lora_apply.maybe_lora, so the scored model is the
trained one): [B, S, V] logits never exist (at Gemma's 262,144 entries
they would take ~1 MB a token in f32). Only the four letter columns are
brought to the host, in f32, and the A-D argmax keeps the numpy rule
(ties go to the first letter). On the card a batch runs the flash
forward kernel in every layer and, with a dynamic adapter, the LoRA
epilogue kernel at every adapted site (the head adapter at [B, V]).
Gemma's letters are encoded without a BOS and its bucket cap is
min(max_position_embeddings, 4096). `main(argv, stats=dict)` also fills
`stats` with the result (each item's prediction in work order), the
scoring's seconds and items/s, the batches by bucket and the first
batch's (ids, last).

Before any item is scored the worst bucket the work list lands in is
admitted against device memory (`common.preflight_eval`, on the analytic
estimate of core/memory_guard.py where the JAX CLI judges the compiled
worst-bucket step): `--on_oom_risk fail` raises MemoryAdmissionError,
`degrade` and `warn` proceed with a warning. `--telemetry_out` writes
run_start, mem_check, one `eval` (accuracy fields, loss and ppl null) and
run_end (its goodput None, as in the JAX eval CLIs); `--run_registry`
adds one registry record, finalized "ok" before run_end.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.cli.family import (apply_adapter,
                                                  detect_family, load_family)
from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.core.logging import JSONLWriter, get_logger
from mobilefinetuner_tpu_torch.eval import mmlu
from mobilefinetuner_tpu_torch.eval.mmlu_categories import category_rollup
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval_mmlu", description="MMLU 4-choice accuracy (PyTorch port)")
    p.add_argument("--pretrained_dir", required=True)
    p.add_argument("--family", choices=["auto", "gpt2", "gemma"],
                   default="auto")
    p.add_argument("--mmlu_root", required=True,
                   help="dir containing <split>/ with per-subject CSVs")
    p.add_argument("--split", default="test")
    p.add_argument("--fewshot", type=int, default=0)
    p.add_argument("--lora_path", default="")
    p.add_argument("--lora_merge", action="store_true")
    p.add_argument("--max_items", type=int, default=0,
                   help="cap items per subject (debug)")
    p.add_argument("--out", default="", help="JSON report path")
    p.add_argument("--synthetic", action="store_true",
                   help="stamp the report synthetic=true: the model "
                        "weights and/or MMLU data are synthetic (harness "
                        "proof, not a real evaluation)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--telemetry_out", default="",
                   help="run-telemetry JSONL stream (core/telemetry.py)")
    p.add_argument("--run_registry", default="",
                   help="append-only run registry stream (core/"
                        "run_registry.py): one crash-safe record per "
                        "eval run; default $MFT_RUN_REGISTRY, empty = "
                        "off")
    p.add_argument("--eval_batch", type=int, default=16,
                   help="items per forward (bucketed batching)")
    p.add_argument("--attention_impl", choices=["auto", "xla", "flash"],
                   default="auto",
                   help="'auto': the flash kernel on the card, the plain "
                        "attention on the CPU; 'xla': the plain attention "
                        "everywhere (the kernel's reference)")
    common.add_mem_flags(p)
    common.add_device_flag(p)
    return p


def setup_family(args, device=None):
    """(hidden_fn, head_key, compute_dtype, tok, letter_encode, max_len,
    params, lora): family dispatch via cli/family.py, the weights on
    `device`. hidden_fn(params, lora, ids) -> [B, S, E] final-norm hidden
    states; params[head_key] is the tied lm_head weight [V, E];
    letter_encode is the BOS-free encoder of the A-D letter ids (None =
    tok.encode as it is)."""
    compute_dtype = common.compute_dtype_from_args(args)
    attn_impl = common.attn_impl_from_args(args)
    b = load_family(args.pretrained_dir, args.family, device=device)
    lora = apply_adapter(b, args.lora_path, args.lora_merge)
    config, model = b.config, b.model

    def hidden_fn(params, lora, ids):
        return model.hidden_states(config, params, ids, lora=lora,
                                   compute_dtype=compute_dtype,
                                   attn_impl=attn_impl)

    if b.family == "gemma":
        tok = b.tok
        letter_encode = lambda s: tok.encode(s, add_bos=False)  # noqa
        # prompts are bucketed; 4096 is far above MMLU prompt sizes and
        # far below the 32k maximum, whose zero-padded bucket is waste
        max_len = min(b.max_len, 4096)
    else:
        letter_encode = None   # GPT-2's encode adds no sequence-start token
        max_len = b.max_len
    return (hidden_fn, b.head_key, compute_dtype, b.tok, letter_encode,
            max_len, b.params, lora)


def make_batched_logits_fn(hidden_fn, head_key, compute_dtype, params,
                           lora, columns: Optional[Sequence[int]] = None):
    """Batched bucketed last-REAL-token logits: (ids [B,S], last [B]) numpy
    -> [B, V] numpy f32. Only the selected rows go through the head. With
    `columns` (the letter ids) only those columns are computed into the
    result and brought to the host; the rest of each row is 0, never read
    by mmlu.restricted_argmax, and the [B, V] array is one buffer that the
    next call of the same B overwrites."""
    head_entry = None if lora is None else lora["blocks"].get("lm_head")
    head = params[head_key].to(compute_dtype)     # cast once, not a batch
    device = head.device
    col_list = None if columns is None else list(columns)
    cols = (None if columns is None else
            torch.as_tensor(col_list, dtype=torch.long, device=device))
    buffers = {}

    @torch.no_grad()
    def logits_fn(ids: np.ndarray, last: np.ndarray) -> np.ndarray:
        ids_t = torch.from_numpy(np.asarray(ids)).long().to(device)
        last_t = torch.from_numpy(np.asarray(last)).long().to(device)
        h = hidden_fn(params, lora, ids_t)                     # [B, S, E]
        rows = h[torch.arange(h.shape[0], device=device), last_t]  # [B, E]
        logits = torch.matmul(rows, head.T)                    # [B, V]
        # hidden_fn applies only the per-layer sites; an lm_head adapter
        # entry must land at this head projection too
        logits = maybe_lora(logits, rows, head_entry)
        if cols is None:
            return logits.float().cpu().numpy()
        out = buffers.get(logits.shape)
        if out is None:
            out = buffers[logits.shape] = np.zeros(tuple(logits.shape),
                                                   np.float32)
        out[:, col_list] = logits.index_select(1, cols).float().cpu().numpy()
        return out

    return logits_fn


def main(argv=None, stats: Optional[dict] = None) -> int:
    args = build_parser().parse_args(argv)
    common.check_not_ported(args)
    t_run = time.perf_counter()
    device = common.setup_device(args)
    (hidden_fn, head_key, compute_dtype, tok, letter_encode, max_len,
     params, lora) = setup_family(args, device)

    by_subject = mmlu.load_split(args.mmlu_root, args.split)
    n_items = sum(len(v) for v in by_subject.values())
    log.info(f"MMLU {args.split}: {len(by_subject)} subjects, "
             f"{n_items} items, fewshot={args.fewshot}")
    work, _totals = mmlu.materialize_work(
        by_subject, tok.encode, fewshot_k=args.fewshot,
        max_items_per_subject=args.max_items, max_len=max_len)
    B = max(args.eval_batch, 1)
    tel = common.eval_telemetry(args, device)
    run_rec = common.eval_run_record(args, tel, device, "eval_mmlu")
    worst_S = max((mmlu.bucket_for(len(w[4]), max_len=max_len)
                   for w in work), default=max_len)
    family = (detect_family(args.pretrained_dir) if args.family == "auto"
              else args.family)
    if family == "gemma":
        config = Gemma3TextConfig.from_pretrained(args.pretrained_dir)
        fp = mg.gemma3_footprint(config, compute_dtype, worst_S, 1, False)
    else:
        config = GPT2Config.from_pretrained(args.pretrained_dir)
        fp = mg.gpt2_footprint(config, compute_dtype, worst_S)
    weights = (params, lora)
    common.preflight_eval(
        mg.eval_estimate_mb(fp, params=weights, rows=B, seq_len=worst_S,
                            compute_dtype=compute_dtype,
                            head_rows_bytes=B * config.vocab_size * 8),
        args, tel, device, resident_mb=mg.tree_bytes(weights) / 2 ** 20,
        what=f"eval_mmlu worst-case bucket [{B}, {worst_S}]")
    letter_ids = mmlu.letter_token_ids(letter_encode or tok.encode)
    logits_fn = make_batched_logits_fn(hidden_fn, head_key, compute_dtype,
                                       params, lora, columns=letter_ids)
    done = [0]
    batches, first = collections.Counter(), []

    def progress(subject, i, n):
        done[0] += 1
        if done[0] % 50 == 0:
            log.info(f"{done[0]} items... ({subject} {i}/{n})")

    def scored(ids, last):
        batches[ids.shape[1]] += 1
        if not first:
            first.append((ids.copy(), last.copy()))
        return logits_fn(ids, last)

    t0 = time.perf_counter()
    result = mmlu.evaluate_batched(
        by_subject, scored, tok.encode, fewshot_k=args.fewshot,
        progress_fn=progress, max_items_per_subject=args.max_items,
        letter_encode_fn=letter_encode,
        batch_size=B, max_len=max_len, work=work)
    scoring_s = time.perf_counter() - t0   # each batch ends on the host
    if stats is not None:
        stats.update(result=result, predictions=result.predictions,
                     scoring_s=scoring_s,
                     items_per_s=result.total / scoring_s,
                     batches_by_bucket=dict(sorted(batches.items())),
                     first_batch=first[0] if first else None)

    categories = category_rollup(result)
    report = {
        "split": args.split, "fewshot": args.fewshot,
        "synthetic": bool(args.synthetic),
        "model_dir": args.pretrained_dir,
        "mmlu_root": args.mmlu_root,
        "macro_accuracy": round(result.macro, 4),
        "micro_accuracy": round(result.micro, 4),
        "total_items": result.total,
        "categories": categories,
        "per_subject": {r.subject: {"accuracy": round(r.accuracy, 4),
                                    "correct": r.correct, "total": r.total}
                        for r in result.per_subject},
    }
    for r in result.per_subject:
        log.info(f"  {r.subject}: {r.accuracy:.3f} "
                 f"({r.correct}/{r.total})")
    for cat, c in categories.items():
        log.info(f"  [{cat}] macro={c['macro_accuracy']:.3f} "
                 f"micro={c['micro_accuracy']:.3f} "
                 f"({c['correct']}/{c['total']}, {c['subjects']} subjects)")
    log.info(f"macro={result.macro:.4f} micro={result.micro:.4f}")
    if args.out:
        JSONLWriter(args.out).write(report)
    # an accuracy eval is not NLL-shaped: loss and ppl are null, the
    # result rides as accuracy fields
    tel.emit("eval", step=result.total, loss=None, ppl=None,
             tokens=result.total, macro_accuracy=report["macro_accuracy"],
             micro_accuracy=report["micro_accuracy"])
    # the registry's `run` end event lands before run_end, which stays
    # the stream's last event
    if run_rec is not None:
        run_rec.finalize("ok")
    tel.emit("run_end", steps=result.total,
             wall_s=round(time.perf_counter() - t_run, 3), exit="ok",
             goodput=None)
    tel.close()
    print(json.dumps({"macro_accuracy": report["macro_accuracy"],
                      "micro_accuracy": report["micro_accuracy"],
                      "total_items": result.total,
                      "categories": {c: v["macro_accuracy"]
                                     for c, v in categories.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
