#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, evaluation and generation
paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases, none of whose failures is caught (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every kernel from mobilefinetuner_tpu_torch/csrc with nvcc for
     sm_90a, one nvcc per source, all at once; the 3xTF32 sources of rows
     1-2 and 6-11 and row 5's f32 vector source must spill no register;
  3. hold each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at a few others, with the tolerance
     printed: the flash forward (bf16 / f16 on the tensor-core kernel,
     f32 on the 3xTF32 one; with and without dropout, bf16 dropout with
     the merged backward on its output, bf16 D 256 with GQA, a window
     inside a key tile and a ragged S), the merged
     and the split flash backward (the merged one in bf16 / f16 on the
     tensor-core kernel, f32 on the 3xTF32 one; bf16 D 256 with GQA, a
     ragged S, a padded tail, a window inside a key block and dropout
     0.1), the LoRA epilogue (bf16 / f16 on the vector kernel, which folds
     the scale read from the device into xa: its xs bit for bit the
     composition's, two calls bit-identical; f32 on its own vector kernel,
     which folds the scale too; at the training sites, generate's decode
     shapes and the head adapter's lm_head, in bf16 and f32), the paged
     decode (row 12: the serving shape, D 128, a GQA
     window, Gemma's D 256 GQA and Gemma-3-270M serving with its window;
     bf16 / f16 on the kernel that loads each lane's K/V rows straight
     into registers, f32 on the same design on 16-byte f32 pieces, D 256
     too; the pool rows
     no slot attends holding
     Inf in K and NaN in V must change nothing, two calls bit-identical),
     the fused CE forward, dh and dW (rows 6-8; forward, dh and dW in
     bf16 on the tensor-core kernels: R 37 and a ragged V too, two calls
     bit-identical; the forward, dh and dW in f32 on the 3xTF32 kernels at
     R 120, V 50,257, H 1,152, dW over a cluster of four H parts), a head
     dim and a bf16 H the kernels do not take refused, an f32 one by the
     3xTF32 kernels, and their
     head-adapter variants (rows 9-11, dW in both its modes; the forward,
     dh + dxa and dbt-only mode in bf16 on the tensor-core kernels, at r
     4, 8 and 128, two calls bit-identical; dh + dxa and dbt-only in f32
     on the 3xTF32 kernels at R 120, V 50,257, H 1,000, r 4),
     the contiguous decode
     (row 13: the microbenchmark shapes B 8 x T 192, a ragged T, the Gemma
     generate path's last step with the 512 window in bf16 and f32, f16 at
     D 32, masked columns poisoned; bf16 / f16 on the tensor-core
     flash-decoding kernel, f32 on the FMA flash-decoding split, whose
     masked columns holding Inf and NaN must change nothing and whose two
     calls must be bit-identical); then GPT-2 small through
     the kernels against the plain path in f32: prefill and one paged
     decode step, and a LoRA train step (loss and LoRA grads); then
     Gemma-3-270M the same way in f32: hidden states and the chunked loss
     at S = 1024 (the 512-token window bites), a LoRA train step and a
     LoRA + lm_head one (the head's A and B among the grads);
  4. serve GPT-2 small (12 layers, n_embd 768, bf16 weights and KV pool,
     8 slots, block_T 16, max_prompt 128, 64 new tokens) over 12 ragged
     requests routed to 2 rank-4 tenants and the base model, through
     serve.bench.build_engine, with its telemetry stream (every request's
     enqueue, admit, first_token and finish; serve_stats every 8 decode
     steps; trace spans) and the metrics endpoint, /metrics and /healthz
     scraped at the 16th decode step; with every launch count set to 0
     just before: every request finishes, every page comes back, and the
     flash kernel ran 12 times a prefill, the paged kernel 12 times a
     decode step; every engine program (decode step, one-shot prefill,
     prompt-page write, each chunk bucket, page copy) ran twice in a
     warm-up and replayed its CUDA graph in the traffic, each (program,
     signature) that ran twice captured exactly once, and the same
     traffic through an engine whose programs are eager (its launches
     counted, then taken back out: they count for no path) gives the
     same tokens, pools and launches; each engine's decode step,
     prefill, chunk, TTFT and TPOT p50, the captures by trace_counts key
     and the memory the captures reserve are printed (the same holds for
     `gemma_serve` and `gemma_serve_f32`'s cache engine, whose warm-up's
     launches are taken back out; each `generate` run's eager twin is the
     CLI with its steps eager);
     then serve Gemma-3-270M (18 layers, hidden 640, 4 query heads over
     1 kv head of 256, window 512, vocab 262,144, bf16; 8 slots, block_T
     16, max_prompt 128, chunked admission up to 608 tokens, 64 new
     tokens) through build_engine("gemma270m") with 2 rank-4 tenants, the
     prefix cache and sampling (`gemma_serve`): 16 requests, 8 over one
     256-token prefix (4 base, one a full hit; 4 on a tenant, never on a
     base page), 8 of 8-608 tokens (3 crossing the window), half of them
     sampled; with every launch count set to 0 just before, every request
     finishes with 64 tokens, every page is returned or parked as the
     cache maps it, the flash kernel ran 18 times a one-shot prefill, the
     paged kernel 18 times a decode step, no other kernel; then, counts
     set to 0 again (`gemma_serve_f32`), in f32 the paged step with the
     kernel against the plain one (logits 1e-4), and the same tokens from
     the kernel engine with the cache (cold, then prefix hits, a sampled
     request too), a plain engine without it and an engine that chunks
     every prompt; after the counts are read, that f32 decode step's
     device ms from CUDA events around CUDA-graph replays, and row 12's
     share of it (the step's own 18 paged calls replayed in a graph, and
     again on the first version);
  5. train: write a random-weight GPT-2 small directory and a synthetic
     WikiText-shaped corpus into a temporary directory, take the base
     model's eval perplexity, set every launch count to 0 and run the
     port's CLI, cli.gpt2_lora_finetune.main, for 30 steps (micro-batch
     8, accumulation 2, seq 128, bf16, LoRA r 8, alpha 16 on attn_qkv and
     attn_proj); the loss must fall, the eval perplexity must end below
     the base model's, the adapter and its .opt sidecar must reload, and
     the forward, backward and epilogue kernels must have launched
     exactly as often as the path runs them;
  6. serve one request with the trained adapter, loaded from its file
     through AdapterBank.load_file; then, counts set to 0, fine-tune the
     same GPT-2 small in full through cli.gpt2_full_finetune.main
     (`gpt2_full_ft`: all 124,439,808 parameters, dropout 0.1 at every
     model site so the attention probs take the flash kernels' hash mask,
     batch 8, seq 128, bf16, 20 steps, a step file at step 10), and again
     resumed from that file: the loss must fall, the eval perplexity end
     below the base model's, the resumed run repeat the later losses
     (1e-3; whether bit for bit is printed), the model file reload
     through load_gpt2, and the flash forward launch 12 times a forward,
     the merged backward 12 times a backward, nothing else; then
     `recovery`, GPT-2 small LoRA at the `train` config in child
     processes of the CLI (each writes its wrappers' launch counts on
     exit): --inject grad_nan:5:3 under the skip guard with saves every 2
     steps must skip 3 steps and roll back once (skip_streak) and end on
     the adapter of a clean run resumed from the rollback's checkpoint
     (1e-3; whether bit for bit is printed); that resume, SIGTERMed once
     step 8's step_stats is in its stream, must drain (exit 75, preempt,
     run_end{exit=preempted}) and, resumed, end on the same adapter;
     --inject ckpt_corrupt's step-2 file must make a resume fall back
     down the lineage (ckpt_verify false, then true); the rollback's
     steps lost and wall time and the SIGTERM-to-exit time are printed;
     then `observe`, the observability plane (counts set to 0 before):
     the `train` config for 12 steps through the CLI in process with
     every observability flag off (--watchdog 0), then with every one on
     (--trace_spans, --run_registry, --metrics_port, a --profile_dir
     window over steps 0-1, --auto_profile with a slow step injected
     before step 8 at 3x the off run's step p50, --pm_schedule 0-:1, the
     watchdog): the losses must be identical, exactly one profile_capture
     (slow_step) whose *.trace.json.gz names the flash forward and the
     LoRA epilogue kernels, the phase spans must reconcile with the
     goodput buckets through tools/trace_export.py, the registry must
     hold one ok record; then a child engine (GPT-2 small, 4 slots, 12
     requests) SIGTERMed after its first step must finish its 4 in-flight
     requests, reject the other 8 with reason shutdown and end with
     run_end{exit=preempted}, and a child trainer with --watchdog 2 and
     a 20 s sleep before step 3 must exit 113 with a complete hang record
     whose device probe is "ok"; step ms p50 with the instruments on and
     off is printed (the overhead);
  7. Gemma: write a random-weight Gemma-3-270M directory (full width and
     depth, a 262,144-entry tokenizer.json) and the corpus, take the base
     model's eval perplexity, then with the counts set to 0 run
     cli.train_lora_gemma.main (bf16, r 8, alpha 32, targets full, batch
     4, seq 256, 8 loss chunks, 20 steps, eval) and, counts set to 0
     again, cli.gemma_full_finetune.main (6 steps): the LoRA loss and
     eval perplexity must fall, and every kernel of each path must have
     launched exactly as often as the path runs it (the fused CE dW only
     on the full fine-tuning path); then, counts set to 0 again,
     `degrade`: cli.gemma_full_finetune (3 steps) at --hbm_cap_mb 1 must
     run the ladder dry (remat, accum_x2, strictly falling estimates)
     before any data loads; at a cap between the first two estimates it
     must walk remat, admit, and take the losses of a run launched at
     --remat; --on_oom_risk fail at that cap must refuse before data
     loads; --inject hbm_pressure (a ballast of all the card leaves free
     but 256 MB) must raise a real out-of-memory error at the first
     dispatch that the loop survives on the remat rung; and sync and
     async saves of the 268M-parameter model and its Adam state must be
     byte-identical (snapshot, write and MB/s printed); then, counts set
     to 0 again,
     cli.train_lora_gemma.main with --lora_targets full,lm_head (the same
     run plus a LoRA on the tied head, riding the chunked loss through
     the head-adapter kernels: `gemma_lora_head`): the loss and eval
     perplexity must fall, the head adapter's B must have left zero, and
     the head-adapter kernels must have launched in place of the base
     ones exactly as the formulas say; then, counts set to 0 before each,
     both LoRA runs again at the default dtype, f32 (no --dtype: 4 steps
     and a final eval of 2 batches; `gemma_train_f32` and
     `gemma_lora_head_f32`): rows 6-7 (9-11 with the head) launch exactly
     steps x chunks plus the eval's forwards, rows 6 and 7 (10 and 11's
     dbt-only mode) on their 3xTF32 kernels, the losses finite; each
     prints its step ms p50 and one step's device ms from CUDA events
     around CUDA-graph replays; then, counts set to 0 again,
     cli.gemma_full_finetune.main at the default dtype too
     (`gemma_full_ft_f32`: 3 steps, a final eval of 2 batches and its
     save): rows 6-8 launch exactly as the formulas say, row 8 8 times a
     step on its 3xTF32 cluster kernel, admission ok, finite losses, the
     model file and its .opt complete; one step's device ms from CUDA
     events around CUDA-graph replays and, from a torch.profiler trace
     of two steps, row 8's share of the device time; then
     cli.eval_ppl.main (`eval_ppl`,
     counts set to 0 before each run): Gemma with the head adapter just
     trained must reproduce the trainer's final eval perplexity (1e-3
     relative) through the head-adapter forward kernel alone, and GPT-2
     with the `train` adapter, dynamic and merged (f32), must agree;
     then cli.generate.main (`generate`, counts set to 0 before each
     run): GPT-2 small (bf16, 8 ragged left-padded prompts of 8-128
     tokens, 64 new tokens, greedy, the `train` adapter dynamic) and
     Gemma-3-270M (bf16, 4 prompts of ~600 tokens so the 512 window
     bites, the head adapter dynamic, once whole-prompt and once with
     --prefill_chunk 256, whose ids must be identical); per family an f32
     run of 16 new tokens whose every greedy token must be within 1e-3 of
     the argmax of one plain f32 full forward over prompt + output
     (teacher forcing); row 13 must launch L x (N - 1) times a run, the
     flash forward L times a whole-prompt prefill, the epilogue at every
     adapter site, the paged kernel never; then each family's bf16
     decode step again, timed from CUDA events around CUDA-graph replays
     (device) and around eager calls (host); then cli.eval_mmlu (`mmlu`,
     counts set to 0 before each run) on both families over a synthetic
     MMLU (data/synthetic.write_synthetic_mmlu: 57 subjects, 2 items
     each, buckets of 16 prompts): in f32 the report through the kernels
     must equal the plain attention's and the first batch's last-token
     logits agree within 1e-4; in bf16 GPT-2 with the `train` adapter dynamic
     and merged must predict alike on >= 95% of the items, and Gemma
     with the head adapter dynamic runs the epilogue at [16, 262,144];
     the flash forward launches batches x layers, the epilogue batches x
     adapted sites; items/s of each run's scoring; then `multitenant`,
     counts set to 0 before each run: cli.train_multi_lora.main on GPT-2
     small (bf16, 8 slots x 2 rows x seq 128, r 8) over ten jobs with
     their own lr, alpha and budgets of 6-12 steps (two refills, one job
     saving every 4 steps keeping 1, one exporting PEFT): every job
     finishes and its file reloads trained, the mean tenant loss falls,
     rows 1 and 2 launch exactly layers x steps; the same config with
     one job in one slot (step time against k = 1); three tenants 5 steps
     in the engine in f32 against the port's solo make_train_step on the
     same batches and init (two held: losses within 1e-4, weights within
     1e-3 of the trained change in L2; the third, at lr 4e-3 / scale 4,
     and every tenant's two solo runs of another rounding order, printed
     as the drift witness); two
     Gemma-3-270M tenants (bf16, 2 slots x 1 row x seq 256, targets
     full, 3 steps); two of the GPT-2 files through
     AdapterBank.load_file into a serve engine with lora_impl fused, one
     request each; join, leave, refill and cancel moving no bank or
     optimizer tensor; the port's routed gather timed against the JAX
     package's dense order (within one bf16 ulp) at the serving decode
     and the training shape; the routed dropout's mask on the card; rows
     1-2 on fully masked rows (idle slots) finite in bf16 and f32; rows
     1 and 2 in f32 at the f32 run's shape timed in turns with their FMA
     first versions and beside SDPA;
  8. trace a decode step (and time it from CUDA events around CUDA-graph
     replays of one gpt2_decode_step_paged call with the engine's state
     held fixed), a 128-token prefill, the Gemma serve decode step and a
     128-token Gemma prefill chunk (graphs of one
     gemma3_decode_step_paged and one gemma3_prefill_chunk), a GPT-2
     train step, a GPT-2 full fine-tuning step, a
     Gemma LoRA train step without and with the lm_head target and a
     Gemma full fine-tuning step with torch.profiler: device busy time
     against
     host wall time, and the kernels that take the device time; for the
     phases that never wait on the card (prefill, train steps), the
     device time again from CUDA events around replays of a CUDA graph
     of the phase, and the busy share against its wall time without the
     profiler (`events`);
  9. time each kernel, its plain version and, where one exists, the
     PyTorch library call (row 12: a two-call chain, the pages gathered
     then SDPA) at the main paths' shapes, with its bound on
     this card: "ms" is the device time of a call between CUDA events
     with the host queued ahead of the card, "call_ms" the time a call
     takes between CUDA events, host overhead included; then the merged
     backward against the split pair at a few longer and wider shapes
     (`bwd_sweep`, the measurements behind resolve_bwd_impl). The
     epilogue's entries at each timed shape give the launches the main
     paths' runs made at that shape (the wrapper's `by_shape`, which must
     add up to the paths' launches of the kernel); row 1 also at the
     Gemma serving prefill's shape (q 1 x 4 x 128 x 256) and row 12 at
     Gemma-3-270M serving, each with the `gemma_serve` path's launches;
     row 1 at every shape the MMLU runs launched it (each bucket of GPT-2
     16 x 12 heads and Gemma 16 x 4 heads over 1, bf16 on the tensor-core
     kernel and f32 on the 3xTF32 one, timed in turns with its FMA first
     version, each held against its plain version) and row 5 at the MMLU
     head adapter's [16, 262,144], with the launches at that shape (the
     wrappers' `by_shape`); rows 1 and 2 in f32 get entries of their own
     (the 3xTF32 sources), with the f32 launches of every path (the
     wrappers' `by_shape` and `by_dtype`), the 16-bit entries the rest;
     rows 6-11 (11 dbt only) in f32 too (fused_ce_fwd_tf32.cu,
     fused_ce_dh_tf32.cu, fused_ce_dw_tf32.cu, fused_ce_fwd_lora_tf32.cu,
     fused_ce_dh_lora_tf32.cu and fused_ce_dbt_tf32.cu, with the f32
     paths' launches, timed in turns with their fused_ce.cu first
     versions, the softmax part of dh, dW, dxa and dbt held on its own),
     and row 5 in f32 on lora_epilogue_vec_f32.cu at GPT-2's attn_qkv,
     timed in turns with its first version lora_epilogue.cu after the
     wrapper's fold that version needed; rows 1-2 in f32 at the
     `gemma_train_f32` shape (q 4 x 4 x 256 x 256, kv 4 x 1, window
     512), row 12 in f32 at `gemma_serve_f32`'s (8 x 1 x 4 x 256, 42
     pages, window 512) and row 13 in f32 at `generate`'s f32 last steps
     (GPT-2 and Gemma), with those paths' f32 launches: each held against
     its plain version and timed beside its library call in f32, rows 12
     and 13 on the flash-decoding splits (paged_decode_attention_vec_f32.cu,
     decode_attention_split_f32.cu) in turns with their first versions
     (paged_decode_attention.cu, decode_attention.cu). f32 work is bounded
     at the 3xTF32 rate (495 / 3 TFLOP/s).

Every training and eval run writes its telemetry stream: each event is
checked against the schema, every earlier path's memory admission must
be "ok" with no degrade, and each trained run's estimate must not fall
below the allocated-bytes peak of its first flush (the `admission`
line). Each trained path's line carries `mfu` (the p50 of
step_stats.mfu) and its run's `goodput` buckets, whose sum must equal
their total.

Prints `serve`, `gemma_serve`, `train`, `gpt2_full_ft`, `recovery`,
`observe`, `gemma_train`, `gemma_full_ft`, `degrade`, `gemma_lora_head`,
`gemma_train_f32`, `gemma_lora_head_f32`, `gemma_full_ft_f32`, `eval_ppl`,
`generate`, `mmlu`, `multitenant`, `profile`, `bwd_sweep`,
`admission` and `kernels` JSON lines, the card's name and power limit, and, last, the device line
`{"ok": true, "device": {...}}`. Without a CUDA card, or without the repo
beside it, it exits non-zero and prints no result. `--only multitenant` builds the
kernels, writes its own synthetic models and runs that path alone;
`--only f32_ce` builds them and runs the f32 kernel entries alone
(`f32_ce_entries` at the Gemma chunk, `f32_path_entries` on stand-in
prompt lengths: checks and times, no path run, so no launches).
"""

from __future__ import annotations

import collections
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its flops over the rate of
# its type: bf16 / f16 on the tensor cores; f32 as 3xTF32 on them (three
# TF32 products for each f32 one, f32_bound), which the f32 flash kernels
# run and which is less time than the 67 TFLOP/s of the FMA units
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
LAYERS = 12
CSRC = "mobilefinetuner_tpu_torch/csrc/"
JAX_OPS = "mobilefinetuner_tpu/ops/"
# the training main path (phase 5)
TRAIN = dict(steps=30, batch=8, accum=2, seq=128, rank=8, alpha=16.0,
             eval_batch=8, eval_batches=8, lr=1e-3)
# the Gemma-3-270M training paths (phase 7): LoRA, then full fine-tuning
GEMMA = dict(steps=20, batch=4, seq=256, rank=8, alpha=32.0, chunks=8,
             eval_batch=4, eval_batches=4, lr=1e-3, full_steps=6,
             full_lr=1e-4)
# the default-dtype (f32) Gemma runs: a few steps and a final eval of the
# `gemma_train` (LoRA) and `gemma_full_ft` configs, on their directory and
# corpus
GEMMA_F32 = dict(steps=4, eval_batches=2, full_steps=3)
# the paths whose fused CE runs in f32 (rows 6-11's f32 launches)
CE_F32_PATHS = ("gemma_train_f32", "gemma_lora_head_f32",
                "gemma_full_ft_f32")
GEMMA_LAYERS = 18
GEMMA_SITES = 7          # LoRA sites a Gemma layer (targets "full")
# the generate paths (phase 8): prompts (tokens) and new tokens a run
EPI_SCALE = 0.37         # the LoRA scale of the epilogue checks (not 2^k)
GEN = dict(gpt2_batch=8, gpt2_min=8, gpt2_max=128, new=64, tf_new=16,
           gemma_words=(600, 590, 575, 560), chunk=256, window=512)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def refuses(fn) -> bool:
    """Whether fn() raises the ValueError a wrapper gives for what its
    kernel does not take (checked before any launch); any other error
    propagates."""
    try:
        fn()
    except ValueError:
        return True
    return False


def ptxas_summary(log: str) -> list:
    """[kernel, registers, spill stores, spill loads] of each kernel in an
    nvcc -Xptxas -v build log, the kernel as `name<type, D or flags>`
    (fused_ce.cu's bool flag is LORA, fused_ce_fwd_mma.cu's whether h is
    held in registers, fused_ce_fwd_lora_mma.cu's and fused_ce_dbt_mma.cu's
    whether h and xa are, fused_ce_dw_tf32.cu's whether h comes in row
    chunks); a kernel in a nested namespace (decode_split_f32.cuh's
    split_f32) by its own name."""
    import re
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
    h_regs = ("h in registers", "h in smem")
    xa_regs = ("xa in registers", "xa in smem")
    flags = {"fwd_mma_kernel": [h_regs],
             "fwd_lora_mma_kernel": [h_regs, xa_regs],
             "dbt_mma_kernel": [h_regs, xa_regs],
             "dw_tf32_kernel": [("h in chunks", "h whole")]}
    rows, kernel, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}(\d+)"
                      r"(\w+)'", line)
        if m:   # <length><name>I<template args>E... after the namespace
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            while rest[:1].isdigit():   # a nested namespace: its member
                n = int(re.match(r"\d+", rest).group())
                skip = len(str(n))
                base, rest = rest[skip:skip + n], rest[skip + n:]
            args = re.findall(r"13__nv_bfloat16|6__half|Lb[01]E|Li\d+E",
                              rest) if rest.startswith("I") else []
            if rest.startswith("If"):
                args.insert(0, "f")
            pairs = iter(flags.get(base, [("lora", "base")] * 2))
            args = [a[2:-1] if a.startswith("Li")
                    else next(pairs)[a == "Lb0E"] if a.startswith("Lb")
                    else names.get(a, a) for a in args]
            kernel = f"{base}<{', '.join(args)}>" if args else base
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            rows.append([kernel, int(m.group(1)), *spills])
            kernel, spills = None, (0, 0)
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def call_ms(fn, iters: int) -> float:
    """Mean time of one fn() call between CUDA events over `iters` calls,
    after a warm-up: the device time, or the host's when each call's
    Python and launch overhead outlasts its kernels."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int):
    """[(kernel name, us)] of every device activity of `iters` fn() calls,
    traced by torch.profiler (CUPTI), and the wall time in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    return ([(e.name, e.time_range.elapsed_us()) for e in prof.events()
             if e.device_type == cuda], wall_ms)


def bound(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def f32_bound(nbytes: float, flops: float):
    """The bound of f32 work: its products in 3xTF32 on the tensor cores,
    three TF32 products for each f32 one."""
    return bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """max |a - b| over max(1, max |b|): outputs of a few units rounded to
    bf16/f16 carry errors in proportion to their size."""
    return max_err(a, b) / max(1.0, float(b.float().abs().max()))


def scaled_err(a, b) -> float:
    """max |a - b| over max |b|: for outputs far below 1 in size."""
    return max_err(a, b) / float(b.float().abs().max())


def queued_ms(fn, iters: int) -> float:
    """Device time of one fn() call between CUDA events with the host
    queued ahead of the card: a spin kernel (torch.cuda._sleep, sized
    from a first, timed enqueue of the calls) holds the stream while the
    host enqueues all `iters` calls, so the events see the card's work
    back to back and not the host's gaps between calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1 << 20)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = (1 << 20) / start.elapsed_time(end)
    torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms + 5.0)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of one fn() call from a CUDA graph of it: the replays
    run its kernels back to back, with no host in between (a step's
    thousands of launches overflow the stream's launch queue, so
    queued_ms would read the host's rate there)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    gc.disable()        # a collection freeing a graph fails a capture
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timed(fns: dict, iters: int = 200):
    """{key: (ms, call_ms)} for each fn of `fns`: the device time of a
    call with the host queued ahead (queued_ms) and the time a call takes
    between CUDA events, host included (call_ms). Not the profiler's
    trace: traces of queued back-to-back kernels lost launches on an
    H100 (PERF.md)."""
    return {key: (queued_ms(fn, iters), call_ms(fn, iters))
            for key, fn in fns.items()}


# the LoRA epilogue's launches by (dtype, N, d_out), the flash forward's
# by (dtype, B, Hq, S, D) and the merged backward's by dtype, summed over
# the main paths' runs: each run counts from zero_counts to read_counts
EPI_BY_SHAPE = collections.Counter()
FLASH_BY_SHAPE = collections.Counter()
BWD_BY_DTYPE = collections.Counter()
# {path: (flash forward, merged backward, epilogue) launches in f32},
# from mark_f32 after each path in main
F32_BY_PATH = {}


def zero_counts(kernels: dict) -> None:
    """Every kernel's launch count set to 0, just before a path's run."""
    for fn in kernels.values():
        fn.launches = 0
    kernels["lora_epilogue"].by_shape.clear()
    kernels["flash_fwd"].by_shape.clear()
    kernels["bwd_merged"].by_dtype.clear()


def read_counts(kernels: dict) -> dict:
    """{kernel: launches} since zero_counts, just after a path's run; the
    epilogue's and the flash forward's launches by shape go into
    EPI_BY_SHAPE and FLASH_BY_SHAPE, the merged backward's by dtype into
    BWD_BY_DTYPE."""
    EPI_BY_SHAPE.update(kernels["lora_epilogue"].by_shape)
    FLASH_BY_SHAPE.update(kernels["flash_fwd"].by_shape)
    BWD_BY_DTYPE.update(kernels["bwd_merged"].by_dtype)
    return {k: fn.launches for k, fn in kernels.items()}


def launches_since(before, kernels: dict) -> dict:
    """{kernel: launches} counted since `before` (a kernels.graphs
    launch_snapshot), by the kernels line's names."""
    from mobilefinetuner_tpu_torch.kernels import graphs
    moved = {fn: n for fn, n, _ in graphs.launch_delta(before)}
    return {k: moved.get(fn, 0) for k, fn in kernels.items()}


def take_back(before) -> None:
    """Every count since `before` taken back out: the launches of a run
    made only to compare with, which count for no path."""
    from mobilefinetuner_tpu_torch.kernels import graphs
    graphs.add_launches(graphs.launch_delta(before), -1)


def p50(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def eager_twin(warm, run, kernels: dict, graphed_launches: dict):
    """A comparison run with its decode steps eager: `run(warm())`, the
    launches of run() counted and checked equal to `graphed_launches`
    (the graphed run's, by the kernels line's names, zeros left out),
    then every launch of warm() and run() taken back out. Returns run()'s
    result."""
    from mobilefinetuner_tpu_torch.kernels import graphs
    before = graphs.launch_snapshot()
    state = warm()
    counted = graphs.launch_snapshot()
    out = run(state)
    eager = {k: n for k, n in launches_since(counted, kernels).items() if n}
    take_back(before)
    want = {k: n for k, n in graphed_launches.items() if n}
    check(eager == want, f"eager launches {eager} != graphed {want}")
    return out


SERVE_KEYS = ("prefill", "decode_step", "write_prefill", "prefill_chunk",
              "cow_copy")


def warm_programs(eng, adapter, **kw) -> None:
    """Every program of the engine called twice before its measured
    traffic, so that traffic replays graphs only (on the card a program
    captures at its second call): two one-shot prompts; with the prefix
    cache a one-page prompt, then the same twice (two full hits, two page
    copies); with chunked admission, for each chunk bucket W, two prompts
    of max_prompt + W tokens (the widest bucket, then W). 4 new tokens a
    request, on `adapter`, with the sampling kwargs `kw`."""
    import numpy as np
    cfg = eng.cfg
    rng = np.random.default_rng(99)
    ints = lambda n: [int(x) for x in  # noqa: E731
                      rng.integers(0, eng.config.vocab_size, n)]
    waves = [[ints(3), ints(5)]]
    if eng.prefix is not None:
        page = ints(cfg.block_T)
        waves += [[page], [list(page), list(page)]]
    if cfg.max_prompt_chunked:
        waves.append([ints(cfg.max_prompt + W) for W in eng.chunk_buckets
                      for _ in range(2)])
    reqs = []
    for wave in waves:
        reqs += [eng.submit(p, max_new_tokens=4, adapter=adapter, **kw)
                 for p in wave]
        eng.drain()
    check(all(r.state == "finished" for r in reqs),
          "warm-up requests did not finish")


def time_programs(eng) -> dict:
    """{"prefill": [ms], "chunk": [ms]}, filled while the engine serves:
    the wall time of each one-shot prefill admission (its first token's
    host sync included) and of each prefill chunk, the card synchronized
    after it (its device work included)."""
    import torch
    ms = {"prefill": [], "chunk": []}
    for key, attr in (("prefill", "_admit_prefill"),
                      ("chunk", "_prefill_chunk")):
        def timed(req, fn=getattr(eng, attr), out=ms[key]):
            t0 = time.perf_counter()
            fn(req)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        setattr(eng, attr, timed)
    return ms


def graph_report(eng, label: str, replayed=()) -> dict:
    """The engine's graphs checked and printed: each (program, signature)
    that ran twice or more captured exactly once, none more, and each
    program in `replayed` captured; its captures by trace_counts key, the
    (calls, captures) of each signature, and the memory the captures
    reserved (their private pools)."""
    sigs = {}
    for (program, sig), g in eng.graphs().items():
        name = program + "".join(f"[{w}]" for w in sig)
        check(g.captures == (g.calls >= 2),
              f"{label}: {name} {g.calls} calls, {g.captures} captures")
        check(program not in replayed or g.captures == 1,
              f"{label}: {name} never captured ({g.calls} calls)")
        sigs[name] = [g.calls, g.captures]
    out = {"captures": {k: eng.trace_counts[k] for k in SERVE_KEYS},
           "calls_captures": sigs,
           "graphs_reserved_mib": sum(
               g.reserved for g in eng.graphs().values()) / 2 ** 20}
    print(f"{label} graphs: captures {out['captures']}; (calls, captures) "
          f"{sigs}; the captures reserved "
          f"{out['graphs_reserved_mib']:.1f} MiB")
    return out


def pools_equal(a, b) -> bool:
    """Two engines' pools bit for bit, the trash page aside (which of
    several idle or padded rows' writes lands there is unspecified)."""
    import torch
    return (torch.equal(a.pool_k[1:], b.pool_k[1:])
            and torch.equal(a.pool_v[1:], b.pool_v[1:]))


def latency(reqs, ms: dict) -> dict:
    """TTFT / TPOT p50 of `reqs` and the prefill / chunk wall p50 of
    time_programs' lists (None where a program did not run)."""
    return {"ttft_ms_p50": p50([r.ttft_ms for r in reqs]),
            "tpot_ms_p50": p50([r.tpot_ms for r in reqs]),
            **{f"{k}_ms_p50": p50(v) if v else None for k, v in ms.items()},
            **{f"{k}_calls": len(v) for k, v in ms.items()}}


def print_latency(label: str, graphed: dict, eager: dict) -> None:
    def fmt(x):
        return "-" if x is None else f"{x:.3f}"
    print(f"{label} p50 ms graphed / eager twin: " + ", ".join(
        f"{k[:-7]} {fmt(graphed[k])} / {fmt(eager[k])}"
        for k in ("prefill_ms_p50", "chunk_ms_p50", "ttft_ms_p50",
                  "tpot_ms_p50")))


def f32_launches() -> tuple:
    """(flash forward, merged backward, LoRA epilogue) launches in f32
    counted so far."""
    import torch
    return (sum(n for key, n in FLASH_BY_SHAPE.items()
                if key[0] == torch.float32), BWD_BY_DTYPE[torch.float32],
            sum(n for key, n in EPI_BY_SHAPE.items()
                if key[0] == torch.float32))


def mark_f32(path: str, since: tuple) -> tuple:
    """F32_BY_PATH[path]: the f32 launches of rows 1, 2 and 5 since
    `since`, the counts after the path's run; returns those counts."""
    now = f32_launches()
    F32_BY_PATH[path] = tuple(a - b for a, b in zip(now, since))
    return now


def in_turns(new, old, iters: int) -> dict:
    """{"ms", "earlier_ms"}: (device ms, call ms) of a kernel and of its
    earlier version on the same inputs, each the mean of two timed() runs
    taken in turns (new, old, old, new)."""
    runs = [timed({"x": fn}, iters)["x"] for fn in (new, old, old, new)]
    return {"ms": tuple((a + b) / 2 for a, b in zip(runs[0], runs[3])),
            "earlier_ms": tuple((a + b) / 2 for a, b in zip(runs[1],
                                                            runs[2]))}


def kernel_entry(name, source, replaces, launches, err, times, bnd,
                 extra=None):
    """One entry of the kernels line from timed() results (and in_turns'
    earlier version's times, where there are)."""
    b_ms, b_by = bnd
    entry = {"name": name, "route": "cuda", "source": CSRC + source,
             "replaces": JAX_OPS + replaces, "launches": launches,
             "max_abs_err": err, "ms": times["ms"][0],
             "plain_ms": times["plain_ms"][0], "bound_ms": b_ms,
             "bound_by": b_by,
             "library_ms": (times["library_ms"][0] if "library_ms" in times
                            else None),
             "call_ms": times["ms"][1],
             "plain_call_ms": times["plain_ms"][1],
             "library_call_ms": (times["library_ms"][1]
                                 if "library_ms" in times else None)}
    if "earlier_ms" in times:
        entry.update(earlier_ms=times["earlier_ms"][0],
                     earlier_call_ms=times["earlier_ms"][1])
    entry.update(extra or {})
    return entry


def fma_flash(torch, fa, q, k, v, pad, *, scale, is_causal=True,
              sliding_window=None, p_drop=0.0, seed=None):
    """(fwd, bwd): calls of rows 1-2's f32 FMA first versions
    (flash_attention_fwd.cu, flash_attention_bwd_merged.cu), which no path
    runs since f32 moved to the 3xTF32 kernels, on the wrappers'
    arguments: fwd() -> (out, lse), bwd(lse, delta, dout) -> (dq, dk,
    dv), with the workspaces and the GQA sum the wrapper gave them. Their
    times, in turns beside the new kernels', are the f32 rows' earlier
    times; their launches are outside the wrappers' counts."""
    from mobilefinetuner_tpu_torch.kernels import build
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    pad = torch.ones(B, S, device=q.device) if pad is None else pad
    tail = (B, Hq, Hkv, S, D, 0, float(scale), int(bool(is_causal)),
            int(sliding_window is not None), int(sliding_window or 0),
            *fa._dropout_args(p_drop, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    f_fn = fa._fn("flash_attention_fwd", "mft_flash_attention_fwd", 6)
    b_fn = fa._fn("flash_attention_bwd_merged",
                  "mft_flash_attention_bwd_merged", 10)

    def fwd():
        out = torch.empty_like(q)
        lse = torch.empty(B, Hq, S, 1, device=q.device)
        build.check_launch("flash_attention_fwd.cu", f_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *tail))
        return out, lse

    def bwd(lse, delta, dout):
        dq = torch.zeros_like(q)
        dk_p, dv_p = torch.empty_like(q), torch.empty_like(q)
        build.check_launch("flash_attention_bwd_merged.cu", b_fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk_p.data_ptr(), dv_p.data_ptr(), *tail))
        if G > 1:
            dk_p = dk_p.reshape(B, Hkv, G, S, D).sum(2)
            dv_p = dv_p.reshape(B, Hkv, G, S, D).sum(2)
        return dq, dk_p, dv_p
    return fwd, bwd


# ------------------------------------------------------------- inputs ------

def flash_inputs(torch, dev, dtype, B, Hq, Hkv, S, D, n_real, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g).to(dev, dtype)  # noqa: E731
    q, k, v = mk(B, Hq, S, D), mk(B, Hkv, S, D), mk(B, Hkv, S, D)
    pad = torch.zeros(B, S, device=dev)
    for b, n in enumerate(n_real):
        pad[b, :n] = 1.0
    return q, k, v, pad


def paged_inputs(torch, dev, dtype, S, KV, G, D, bT, M, L, seed,
                 window=None):
    """Pools with a zero trash page, distinct pages per slot, ragged
    positions and one idle slot (pos 0 on the trash page)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    NB = S * M + 1
    pool_k = torch.randn(NB, L, KV, bT, D, generator=g)
    pool_v = torch.randn(NB, L, KV, bT, D, generator=g)
    pool_k[0] = pool_v[0] = 0.0
    q = torch.randn(S, KV, G, D, generator=g)
    perm = torch.randperm(NB - 1, generator=g) + 1
    tbl = torch.zeros(S, M, dtype=torch.int32)
    pos = torch.randint(0, M * bT, (S,), generator=g)
    pos[-1] = 0
    for s in range(S - 1):
        n = int(pos[s]) // bT + 1
        tbl[s, :n] = perm[s * M:s * M + n].int()
    cols = torch.arange(M * bT)
    ok = cols[None] <= pos[:, None]
    if window is not None:
        ok &= cols[None] > pos[:, None] - window
    return (q.to(dev, dtype), pool_k.to(dev, dtype), pool_v.to(dev, dtype),
            tbl.to(dev), ok.to(dev))


# ------------------------------------------------------- kernel checks ------

def check_flash(torch, fa, dev):
    """The forward kernels vs flash_attention_reference (bf16 and f16: the
    tensor-core kernel, f32: the 3xTF32 one): the path shapes, a bf16
    dropout case whose output the merged backward then takes (against its
    plain version), bf16 at D = 256 with GQA 4:1, a window that cuts
    inside a key tile and a ragged S; and the refusal of a head dim the
    kernels do not take. Returns the training case's max error (out) and
    its inputs."""
    cases = [  # (name, dtype, B, Hq, Hkv, S, D, n_real, causal, window,
        #         p_drop, tol)
        ("serving", torch.bfloat16, 1, 12, 12, 128, 64, (100,), True, None,
         0.0, 1e-2),
        ("training", torch.bfloat16, 8, 12, 12, 128, 64, (128,) * 8, True,
         None, 0.0, 1e-2),
        ("gqa_window_ragged", torch.float32, 2, 4, 2, 200, 64, (200, 150),
         True, 24, 0.0, 1e-4),
        ("d128_noncausal", torch.bfloat16, 2, 8, 8, 96, 128, (96, 40),
         False, None, 0.0, 1e-2),
        ("d256_gqa", torch.float16, 1, 8, 2, 130, 256, (130,), True, None,
         0.0, 1e-2),
        ("dropout_0.1", torch.float32, 2, 4, 4, 128, 64, (128, 100), True,
         None, 0.1, 1e-4),
        ("bf16_dropout_0.1", torch.bfloat16, 2, 4, 4, 128, 64, (128, 100),
         True, None, 0.1, 1e-2),
        ("bf16_d256_gqa_window_ragged", torch.bfloat16, 2, 8, 2, 200, 256,
         (200, 150), True, 40, 0.0, 1e-2),
    ]
    training = None
    for (name, dt, B, Hq, Hkv, S, D, n_real, causal, window, p_drop,
         tol) in cases:
        q, k, v, pad = flash_inputs(torch, dev, dt, B, Hq, Hkv, S, D, n_real,
                                    seed=S + D)
        kw = dict(is_causal=causal, sliding_window=window, p_drop=p_drop,
                  seed=20261016 if p_drop else None)
        out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
        torch.cuda.synchronize()
        e_out, e_lse = max_err(out, ref_out), max_err(lse, ref_lse)
        print(f"flash fwd {name}: {dt} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
              f"p_drop={p_drop}: max |out err| {e_out:.3e}, max |lse err| "
              f"{e_lse:.3e} (tolerance {tol:g}, lse 1e-4)")
        check(bool(torch.isfinite(out).all()), f"flash {name} non-finite")
        check(e_out <= tol and e_lse <= 1e-4,
              f"flash {name} disagrees with its plain version")
        if name == "training":
            training = (e_out, (q, k, v, pad))
        if name == "bf16_dropout_0.1":
            do = flash_inputs(torch, dev, dt, B, Hq, Hq, S, D, n_real,
                              seed=S + 9)[0]
            delta = (do.float() * out.float()).sum(-1, keepdim=True)
            bkw = dict(scale=D ** -0.5, **kw)
            args = (q, k, v, pad, lse, delta, do)
            got = fa.flash_attention_bwd_merged(*args, **bkw)
            ref = fa.flash_bwd_merged_reference(*args, **bkw)
            torch.cuda.synchronize()
            e_bwd = max(rel_err(a, b) for a, b in zip(got, ref))
            print(f"flash bwd merged on the {name} forward: max err / max(1,"
                  f" |ref|) {e_bwd:.3e} (tolerance 2e-2)")
            check(e_bwd <= 2e-2, "merged bwd on the bf16 dropout forward "
                  "disagrees with its plain version")
    q = torch.zeros(1, 2, 8, 96, device=dev, dtype=torch.bfloat16)
    check(refuses(lambda: fa.flash_attention_fwd(q, q, q)),
          "flash_attention_fwd took D = 96")
    return training


def check_flash_bwd(torch, fa, dev):
    """The merged and the split backward kernels against their plain
    versions (the merged one in bf16 / f16 on the tensor-core kernel, in
    f32 on the 3xTF32 one);
    returns {kernel: max error} at the training shape."""
    cases = [  # (name, dtype, B, Hq, Hkv, S, D, n_real, window, p_drop,
        #         tol of rel_err)
        ("training", torch.bfloat16, 8, 12, 12, 128, 64, (128,) * 8, None,
         0.0, 2e-2),
        ("gqa_window_ragged", torch.float32, 2, 4, 2, 200, 64, (200, 150),
         24, 0.0, 1e-5),
        ("d128", torch.bfloat16, 2, 8, 8, 96, 128, (96, 70), None, 0.0,
         2e-2),
        ("d256_gqa", torch.float16, 1, 8, 2, 130, 256, (130,), None, 0.0,
         5e-3),
        ("dropout_0.1", torch.float32, 2, 4, 4, 128, 64, (128, 100), None,
         0.1, 1e-5),
        ("bf16_d256_gqa_ragged_dropout", torch.bfloat16, 2, 8, 2, 200, 256,
         (200, 150), 40, 0.1, 2e-2),
    ]
    errs = None
    for (name, dt, B, Hq, Hkv, S, D, n_real, window, p_drop,
         tol) in cases:
        q, k, v, pad = flash_inputs(torch, dev, dt, B, Hq, Hkv, S, D, n_real,
                                    seed=3 * S + D)
        do = flash_inputs(torch, dev, dt, B, Hq, Hq, S, D, n_real,
                          seed=S + 7)[0]
        kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window,
                  p_drop=p_drop, seed=77 if p_drop else None)
        out, lse = fa.flash_attention_fwd(q, k, v, pad, **{
            n: kw[n] for n in ("scale", "sliding_window", "p_drop",
                               "seed")})
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        args = (q, k, v, pad, lse, delta, do)
        merged = fa.flash_attention_bwd_merged(*args, **kw)
        dq = fa.flash_attention_bwd_dq(*args, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(*args, **kw)
        ref_m = fa.flash_bwd_merged_reference(*args, **kw)
        ref_s = fa.flash_bwd_split_reference(*args, **kw)
        torch.cuda.synchronize()
        e = {"merged": max(rel_err(a, b) for a, b in zip(merged, ref_m)),
             "dq": rel_err(dq, ref_s[0]),
             "dkv": max(rel_err(dk, ref_s[1]), rel_err(dv, ref_s[2]))}
        print(f"flash bwd {name}: {dt} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
              f"window={window} p_drop={p_drop}: max err / max(1, |ref|): "
              f"merged {e['merged']:.3e}, split dq {e['dq']:.3e}, split "
              f"dk/dv {e['dkv']:.3e} (tolerance {tol:g})")
        for t in (*merged, dq, dk, dv):
            check(bool(torch.isfinite(t).all()), f"flash bwd {name} "
                  f"non-finite")
        check(max(e.values()) <= tol,
              f"flash bwd {name} disagrees with its plain versions")
        if name == "training":
            errs = {k_: max_err(a, b) for k_, a, b in (
                ("merged", torch.cat([t.flatten() for t in merged]),
                 torch.cat([t.flatten() for t in ref_m])),
                ("dq", dq, ref_s[0]),
                ("dkv", torch.cat([dk.flatten(), dv.flatten()]),
                 torch.cat([ref_s[1].flatten(), ref_s[2].flatten()])))}
            errs["args"] = (args, kw)
    return errs


def check_epilogue(torch, lf, dev):
    """The LoRA epilogue kernels against their plain version, the scale
    on the device: the training sites (N = 8 x 128 rows, r = 8), a ragged
    f32 shape, rank 128 with 8-byte vectors, and generate's decode shapes
    (GPT-2's attn_qkv at 8 rows, Gemma's gate_proj at 4 and the head
    adapter's lm_head, 4 x 262,144, in bf16 and f32). bf16 / f16 run
    lora_epilogue_vec.cu, f32 lora_epilogue_vec_f32.cu (8-byte vectors at
    d_out 770, four rows a thread at the lm_head): xs must be
    round(f32(xa) * scale) bit for bit and two calls bit-identical.
    Returns {site: (max error, inputs)} of the timed sites."""
    cases = [  # (name, dtype, N, d_out, r, tol)
        ("attn_qkv", torch.bfloat16, 1024, 2304, 8, 1e-2),
        ("attn_proj", torch.bfloat16, 1024, 768, 8, 1e-2),
        ("ragged_f32", torch.float32, 1000, 770, 8, 1e-5),
        ("rank128_f16", torch.float16, 37, 300, 128, 1e-2),
        ("decode_attn_qkv", torch.bfloat16, 8, 2304, 8, 1e-2),
        ("decode_gate_proj", torch.bfloat16, 4, 2048, 8, 1e-2),
        ("decode_lm_head", torch.bfloat16, 4, 262144, 8, 1e-2),
        ("decode_lm_head_f32", torch.float32, 4, 262144, 8, 1e-5),
    ]
    sites = {}
    for name, dt, N, d_out, r, tol in cases:
        g = torch.Generator().manual_seed(N + d_out)
        y, xa, b = (torch.randn(s, generator=g).to(dev, dt)
                    for s in ((N, d_out), (N, r), (r, d_out)))
        scale = torch.tensor(EPI_SCALE, device=dev)
        out, xs = lf.lora_epilogue(y, xa, b, scale)
        again, _ = lf.lora_epilogue(y, xa, b, scale)
        ref = lf.lora_epilogue_reference(y, xa, b, scale)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        print(f"lora epilogue {name}: {dt} N={N} d_out={d_out} r={r} "
              f"({lf.epilogue_library(dt)[0]}.cu): max |err| {e:.3e} "
              f"(tolerance {tol:g})")
        check(bool(torch.isfinite(out).all()) and e <= tol,
              f"lora epilogue {name} disagrees with its plain version")
        check(torch.equal(xs, (xa.float() * scale).to(dt)),
              f"lora epilogue {name}: xs is not round(f32(xa) * scale)")
        check(torch.equal(out, again),
              f"lora epilogue {name}: two calls differ")
        if dt == torch.bfloat16:
            sites[name] = (e, (y, xa, b, scale))
    return sites


def paged_poison(torch, pk, pv, tbl, ok):
    """Copies of the pools whose rows no slot attends (masked columns of
    live pages, unused table rows, the trash page but an idle slot's
    column) hold Inf in K and NaN in V."""
    S, M = tbl.shape
    bT = pk.shape[3]
    cols = torch.arange(M * bT, device=ok.device)
    blk = tbl.long()[:, cols // bT]
    attended = torch.zeros(pk.shape[0], bT, dtype=torch.bool,
                           device=ok.device)
    attended[blk[ok], (cols % bT).expand(S, -1)[ok]] = True
    dead = ~attended[:, None, None, :, None]
    return (pk.masked_fill(dead, float("inf")),
            pv.masked_fill(dead, float("nan")))


PAGED_CASES = [  # (name, dtype, S, KV, G, D, bT, M, L, window, tol)
    ("serving", "bfloat16", 8, 12, 1, 64, 16, 12, 12, None, 2e-2),
    ("gqa_window", "float32", 5, 2, 2, 64, 16, 6, 3, 20, 1e-4),
    ("d128", "bfloat16", 4, 4, 1, 128, 8, 5, 2, None, 2e-2),
    ("d256_gqa", "bfloat16", 3, 1, 4, 256, 16, 4, 2, None, 2e-2),
    # Gemma-3-270M serving: 8 slots, T up to 672, its 512-token window
    ("gemma_serve", "bfloat16", 8, 1, 4, 256, 16, 42, 18, 512, 2e-2),
    ("gemma_serve_f16", "float16", 8, 1, 4, 256, 16, 42, 18, 512, 2e-2),
    ("gemma_serve_f32", "float32", 8, 1, 4, 256, 16, 42, 18, 512, 1e-4),
]


def check_paged(torch, da, dev):
    """Row 12 against paged_attention at the serving shape, D 128, a GQA
    window, Gemma's D 256 GQA and Gemma-3-270M serving (bf16 / f16 on
    paged_decode_attention_vec.cu, f32 on paged_decode_attention_vec_f32.cu): the
    pool rows no slot attends poisoned with Inf in K and NaN in V must
    leave ctx bit for bit as it was, two calls must be bit-identical, and
    the launch counter must count each call. Returns {name: (max error,
    inputs)} of the serving and Gemma serving cases (bf16 and f32)."""
    out = {}
    n0 = da.paged_decode_attention.launches
    calls = 0
    for name, dt, S, KV, G, D, bT, M, L, window, tol in PAGED_CASES:
        dt = getattr(torch, dt)
        q, pk, pv, tbl, ok = paged_inputs(torch, dev, dt, S, KV, G, D, bT, M,
                                          L, seed=S * D, window=window)
        layer, scale = L - 1, D ** -0.5
        ctx = da.paged_decode_attention(q, pk, pv, tbl, layer, ok, scale)
        ref = da.paged_attention(q, pk, pv, tbl, layer, ok, scale)
        kp, vp = paged_poison(torch, pk, pv, tbl, ok)
        poisoned = da.paged_decode_attention(q, kp, vp, tbl, layer, ok,
                                             scale)
        again = da.paged_decode_attention(q, kp, vp, tbl, layer, ok, scale)
        calls += 3
        torch.cuda.synchronize()
        del kp, vp
        e = max_err(ctx, ref)
        lib = da.paged_library(dt)[0]
        print(f"paged {name}: {dt} S={S} KV={KV} G={G} D={D} bT={bT} M={M} "
              f"window={window} ({lib}.cu): max |ctx err| {e:.3e} "
              f"(tolerance {tol:g})")
        check(bool(torch.isfinite(ctx).all()), f"paged {name} non-finite")
        check(e <= tol, f"paged {name} disagrees with its plain version")
        check(torch.equal(poisoned, ctx), f"paged {name}: unattended rows "
              f"holding Inf / NaN moved ctx")
        check(torch.equal(again, ctx), f"paged {name}: two calls differ")
        if name in ("serving", "gemma_serve", "gemma_serve_f32"):
            out[name] = (e, (q, pk, pv, tbl, layer, ok, scale))
    check(da.paged_decode_attention.launches == n0 + calls,
          f"paged launches {da.paged_decode_attention.launches - n0}, "
          f"expected {calls}")
    return out


def decode_inputs(torch, dev, dtype, B, KV, G, T, D, seed, n_pad=(),
                  window=None):
    """q and caches whose masked columns hold +-1e6 (+-6e4 in f16, whose
    largest finite magnitude is 65504): left padding of n_pad[b] columns
    and the generate path's window over the last query position; the last
    column attendable."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, KV, G, D, generator=g)
    kc = torch.randn(B, KV, T, D, generator=g)
    vc = torch.randn(B, KV, T, D, generator=g)
    cols = torch.arange(T)
    ok = torch.ones(B, T, dtype=torch.bool)
    for b, n in enumerate(n_pad):
        ok[b, :n] = False
    if window is not None:
        ok &= cols[None] > T - 1 - window
    big = 6e4 if dtype == torch.float16 else 1e6
    kc.masked_fill_(~ok[:, None, :, None], big)
    vc.masked_fill_(~ok[:, None, :, None], -big)
    return (q.to(dev, dtype), kc.to(dev, dtype), vc.to(dev, dtype),
            ok.to(dev))


def check_decode(torch, da, dev):
    """Row 13 against xla_reference at the microbenchmark shapes (B 8,
    T 192), a ragged T, the Gemma generate path's last step (T = P + N,
    the 512 window in ok) in bf16 and f32, and f16 at D 32, every masked
    column poisoned (+-1e6); on every source (bf16 / f16 the tensor-core
    kernel, f32 the FMA split) the masked columns again holding Inf in K
    and NaN in V must leave ctx bit for bit as it was, and two calls must
    be bit-identical; the launch counter must count each call. Returns
    {name: (max error, inputs)} of the GPT-2 bench and the Gemma path
    cases."""
    T_gemma = max(GEN["gemma_words"]) + 1 + GEN["new"]   # BOS + words + N
    pads = [max(GEN["gemma_words"]) - n for n in GEN["gemma_words"]]
    cases = [  # (name, dtype, B, KV, G, T, D, n_pad, window, tol)
        ("gpt2_bench", torch.bfloat16, 8, 12, 1, 192, 64,
         (0, 17, 40, 64, 90, 100, 120, 3), None, 2e-2),
        ("gemma_bench", torch.bfloat16, 8, 1, 4, 192, 256, (0, 33) * 4,
         None, 2e-2),
        ("ragged_f32", torch.float32, 3, 2, 2, 77, 64, (0, 9, 40), None,
         1e-5),
        ("gemma_path", torch.bfloat16, 4, 1, 4, T_gemma, 256, pads,
         GEN["window"], 2e-2),
        ("gemma_path_f32", torch.float32, 4, 1, 4, T_gemma, 256, pads,
         GEN["window"], 1e-5),
        ("f16_d32", torch.float16, 3, 2, 2, 40, 32, (5, 0, 39), None, 2e-2),
    ]
    out = {}
    n0 = da.decode_attention.launches
    calls = 0
    for name, dt, B, KV, G, T, D, n_pad, window, tol in cases:
        q, kc, vc, ok = decode_inputs(torch, dev, dt, B, KV, G, T, D,
                                      seed=T + D, n_pad=n_pad,
                                      window=window)
        scale = D ** -0.5
        ctx = da.decode_attention(q, kc, vc, ok, scale)
        ref = da.xla_reference(q, kc, vc, ok, scale)
        calls += 1
        torch.cuda.synchronize()
        e = max_err(ctx, ref)
        lib = da.decode_library(dt)[0]
        print(f"decode {name}: {dt} B={B} KV={KV} G={G} T={T} D={D} "
              f"window={window} ({lib}.cu): max |ctx err| {e:.3e} "
              f"(tolerance {tol:g})")
        check(bool(torch.isfinite(ctx).all()), f"decode {name} non-finite")
        check(e <= tol, f"decode {name} disagrees with its plain version")
        masked = ~ok[:, None, :, None]
        kp = kc.masked_fill(masked, float("inf"))
        vp = vc.masked_fill(masked, float("nan"))
        poisoned = da.decode_attention(q, kp, vp, ok, scale)
        again = da.decode_attention(q, kc, vc, ok, scale)
        calls += 2
        torch.cuda.synchronize()
        del kp, vp
        check(torch.equal(poisoned, ctx), f"decode {name}: masked "
              f"columns holding Inf / NaN moved ctx")
        check(torch.equal(again, ctx), f"decode {name}: two calls differ")
        out[name] = (e, (q, kc, vc, ok, scale))
    check(da.decode_attention.launches == n0 + calls,
          f"decode launches {da.decode_attention.launches - n0}, expected "
          f"{calls}")
    return out


def check_model(torch, dev):
    """GPT-2 small in f32: prefill and one paged decode step through the
    kernels against the same through the plain versions."""
    from mobilefinetuner_tpu_torch.core.config import GPT2Config
    from mobilefinetuner_tpu_torch.models import generate, gpt2
    from mobilefinetuner_tpu_torch.serve.paged_kv import (init_pools,
                                                          write_prompt_blocks)
    base = GPT2Config.gpt2_small()
    params = gpt2.init_params(base, seed=1, device=dev)
    P, n_real, bT, M = 128, 77, 16, 12
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, base.vocab_size, (1, P), generator=g).to(dev)
    mask = (torch.arange(P) < n_real).long()[None].to(dev)
    out = {}
    for impl in ("auto", "plain"):
        logits, (k, v) = generate.gpt2_prefill(base, params, ids, mask,
                                               attn_impl=impl)
        pk, pv = init_pools(M + 1, base.n_layer, base.n_head, bT,
                            base.head_dim, torch.float32, dev)
        blocks = torch.arange(1, P // bT + 1, dtype=torch.int32, device=dev)
        write_prompt_blocks(pk, pv, k[:, 0], v[:, 0], blocks)
        tbl = torch.zeros(1, M, dtype=torch.int32, device=dev)
        tbl[0, :P // bT] = blocks
        tok = logits.argmax(-1)
        pos = torch.tensor([n_real], device=dev)
        step, _, _ = generate.gpt2_decode_step_paged(
            base, params, pk, pv, tok, pos, tbl, attn_impl=impl)
        out[impl] = (logits, step)
    torch.cuda.synchronize()
    e_pre = max_err(out["auto"][0], out["plain"][0])
    e_dec = max_err(out["auto"][1], out["plain"][1])
    print(f"gpt2s f32 kernel path vs plain path: prefill logits max err "
          f"{e_pre:.3e}, decode-step logits max err {e_dec:.3e} "
          f"(tolerance 1e-4)")
    check(e_pre <= 1e-4 and e_dec <= 1e-4,
          "GPT-2 small kernel path disagrees with the plain path")
    return params


def check_train_step(torch, dev, params):
    """GPT-2 small in f32 with a rank-8 LoRA on attn_qkv/attn_proj: loss
    and LoRA grads through the flash forward/backward and epilogue
    kernels against the plain attention and the naive LoRA order."""
    from mobilefinetuner_tpu_torch.core.config import GPT2Config
    from mobilefinetuner_tpu_torch.lora.lora import LoRASpec, init_lora_gpt2
    from mobilefinetuner_tpu_torch.models import gpt2
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    base = GPT2Config.gpt2_small()
    lora = init_lora_gpt2(base, LoRASpec(rank=8, alpha=16.0), seed=3,
                          device=dev)
    g = torch.Generator().manual_seed(4)
    for entry in lora["blocks"].values():   # B off zero: grads reach A
        entry["B"] = (0.02 * torch.randn(entry["B"].shape,
                                         generator=g)).to(dev)
    ids = torch.randint(0, base.vocab_size, (2, 128), generator=g).to(dev)
    mask = torch.ones(2, 128, device=dev)
    out = {}
    for attn_impl, lora_impl in (("auto", "auto"), ("plain", "naive")):
        leaves = {n: {k: t.clone().requires_grad_(k != "scale")
                      for k, t in e.items()}
                  for n, e in lora["blocks"].items()}
        logits = gpt2.forward(base, params, ids, mask, {"blocks": leaves},
                              attn_impl=attn_impl, lora_impl=lora_impl)
        s, w = lm_cross_entropy_sum(logits, ids)
        grads = torch.autograd.grad(
            s / w, [leaves[n][k] for n in sorted(leaves) for k in "AB"])
        out[attn_impl] = (float((s / w).detach()), grads)
    e_loss = abs(out["auto"][0] - out["plain"][0])
    e_grad = max(max_err(a, b) for a, b in zip(out["auto"][1],
                                                 out["plain"][1]))
    print(f"gpt2s f32 LoRA train step, kernel path vs plain path: loss "
          f"{out['auto'][0]:.6f} vs {out['plain'][0]:.6f} (err "
          f"{e_loss:.3e}), LoRA grads max err {e_grad:.3e} (tolerance 1e-4)")
    check(e_loss <= 1e-4 and e_grad <= 1e-4,
          "GPT-2 small train step: kernel path disagrees with plain path")


def fused_ce_inputs(torch, dev, dtype, R, V, H, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(R, H, generator=g, device=dev).to(dtype)
    w = (0.05 * torch.randn(V, H, generator=g, device=dev)).to(dtype)
    lab = torch.randint(0, V, (R,), generator=g, device=dev)
    dlse = torch.randn(R, generator=g, device=dev)
    dgold = torch.randn(R, generator=g, device=dev)
    return h, w, lab, dlse, dgold


def check_fused_ce(torch, fc, dev):
    """The fused CE kernels (rows 6-8) against their plain versions at the
    Gemma training shape (R = 4 x 32 rows of a loss chunk), at batch 8, at
    a ragged shape (R 120, V 50,257, H 1,152) and in f32. lse and gold:
    max abs error; dh and dW: max abs error over max(1, max |ref|). The
    label rows (dgold * onehot) dominate dh and dW there, so the softmax
    part (dlse * p, p ~ 1 / V) is held on its own too: dh and dW again
    with dgold = 0, max abs error over max |ref| (tolerance sm_tol; bf16
    measured at most 3.5e-4 on an H100: a few coefs round the other way).
    The forward, dh and dW of bf16 / f16 run on the tensor-core kernels,
    of f32 on the 3xTF32 kernels (dW over a cluster of 4 H parts at H
    1,152): R 37 (a ragged row tile) with a ragged V and H 1,152 in bf16
    too; the path case's forward, dh and dW twice each must give
    identical bits (no atomics), and an H that is not a multiple of 8
    must be refused by all three in bf16 and in f32.
    Returns the path case's max abs errors and inputs."""
    cases = [  # (name, dtype, R, V, H, tol, sm_tol)
        ("path", torch.bfloat16, 128, 262144, 640, 2e-3, 2e-3),
        ("batch8", torch.bfloat16, 256, 262144, 640, 2e-3, 2e-3),
        ("ragged", torch.bfloat16, 120, 50257, 1152, 2e-3, 2e-3),
        ("r37_ragged", torch.bfloat16, 37, 50257, 1152, 2e-3, 2e-3),
        ("ragged_f32", torch.float32, 120, 50257, 1152, 1e-4, 1e-4),
    ]
    path = None
    for name, dt, R, V, H, tol, sm_tol in cases:
        h, w, lab, dl, dg = fused_ce_inputs(torch, dev, dt, R, V, H,
                                            seed=R + H)
        lse, gold = fc.fused_ce_fwd(h, w, lab)
        rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
        dh = fc.fused_ce_bwd_dh(h, w, lab, rl, dl, dg)
        rdh = fc.fused_ce_dh_reference(h, w, lab, rl, dl, dg)
        dw = fc.fused_ce_bwd_dw(h, w, lab, rl, dl, dg)
        rdw = fc.fused_ce_dw_reference(h, w, lab, rl, dl, dg)
        torch.cuda.synchronize()
        e = {"lse": max_err(lse, rl), "gold": max_err(gold, rg),
             "dh": max_err(dh, rdh), "dw": max_err(dw, rdw)}
        rel = {"dh": rel_err(dh, rdh), "dw": rel_err(dw, rdw)}
        for t in (lse, gold, dh, dw):
            check(bool(torch.isfinite(t).all()), f"fused CE {name} "
                  f"non-finite")
        del dw, rdw
        z = torch.zeros_like(dg)
        sm = {"dh": scaled_err(fc.fused_ce_bwd_dh(h, w, lab, rl, dl, z),
                               fc.fused_ce_dh_reference(h, w, lab, rl, dl,
                                                        z)),
              "dw": scaled_err(fc.fused_ce_bwd_dw(h, w, lab, rl, dl, z),
                               fc.fused_ce_dw_reference(h, w, lab, rl, dl,
                                                        z))}
        print(f"fused CE {name}: {dt} R={R} V={V} H={H}: max abs err lse "
              f"{e['lse']:.3e}, gold {e['gold']:.3e}, dh {e['dh']:.3e}, dW "
              f"{e['dw']:.3e}; dh / dW over max(1, |ref|) {rel['dh']:.3e} / "
              f"{rel['dw']:.3e} (tolerance {tol:g}); softmax part "
              f"(dgold = 0) dh / dW over max |ref| {sm['dh']:.3e} / "
              f"{sm['dw']:.3e} (tolerance {sm_tol:g})")
        check(max(e["lse"], e["gold"], rel["dh"], rel["dw"]) <= tol,
              f"fused CE {name} disagrees with its plain versions")
        check(max(sm.values()) <= sm_tol, f"fused CE {name}: the softmax "
              f"part of dh / dW disagrees with its plain versions")
        if name == "path":
            path = (e, (h, w, lab, rl, dl, dg))
            lse2, gold2 = fc.fused_ce_fwd(h, w, lab)
            check(bool(torch.equal(lse, lse2) and torch.equal(gold, gold2)),
                  "fused CE forward: two calls gave different bits")
            again = fc.fused_ce_bwd_dh(h, w, lab, rl, dl, dg)
            check(bool(torch.equal(dh, again)),
                  "fused CE dh: two calls gave different bits")
            dw = fc.fused_ce_bwd_dw(h, w, lab, rl, dl, dg)
            again = fc.fused_ce_bwd_dw(h, w, lab, rl, dl, dg)
            check(bool(torch.equal(dw, again)),
                  "fused CE dW: two calls gave different bits")
            del dw, again
            print("fused CE path: forward, dh and dW twice each, identical "
                  "bits")
    h, w, lab, dl, dg = fused_ce_inputs(torch, dev, torch.bfloat16, 8, 100,
                                        1004, seed=1)
    check(refuses(lambda: fc.fused_ce_fwd(h, w, lab)),
          "fused_ce_fwd took a bf16 H = 1004 (not a multiple of 8)")
    for kernel in (fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dw):
        check(refuses(lambda: kernel(h, w, lab, dl, dl, dg)),
              f"{kernel.__name__} took a bf16 H = 1004 (not a multiple "
              f"of 8)")
    h, w = h.float(), w.float()
    for kernel in (fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dw):
        check(refuses(lambda: kernel(h, w, lab, dl, dl, dg)),
              f"{kernel.__name__} took an f32 H = 1004 (not a multiple "
              f"of 8)")
    check(refuses(lambda: fc.fused_ce_fwd(h, w, lab)),
          "fused_ce_fwd took an f32 H = 1004 (not a multiple of 8)")
    return path


def check_fused_ce_lora(torch, fc, dev):
    """The head-adapter fused CE kernels (rows 9-11) against their plain
    versions at the Gemma chunk shape (R 128, V 262,144, H 640, r 8),
    at a ragged shape (R 120, V 50,257, H 1,000, r 4: none a multiple of
    a tile) in bf16 and in f32, and at rank 128 in bf16 (row 10's plan
    then takes 32-row tiles and two W buffers). lse and gold: max abs
    error; dh, dxa, dW and dbt (row 11 in its dW mode and its dbt-only
    mode): max abs error over max(1, max |ref|) with random dgold, and
    over max |ref| with dgold = 0 (the softmax part alone). The forward,
    dh + dxa and dbt-only mode of bf16 / f16 run on the tensor-core
    kernels, of f32 on the 3xTF32 kernels (row 11's dW + dbt mode of
    every dtype on fused_ce.cu): the path case's (lse, gold), (dh, dxa)
    and dbt-only twice must give identical bits, and an H that is not a
    multiple of 8 must be refused by all three, in bf16 and in f32.
    Returns the path case's max abs errors and inputs."""
    cases = [  # (name, dtype, R, V, H, r, tol)
        ("path", torch.bfloat16, 128, 262144, 640, 8, 2e-3),
        ("ragged", torch.bfloat16, 120, 50257, 1000, 4, 2e-3),
        ("ragged_f32", torch.float32, 120, 50257, 1000, 4, 1e-4),
        ("rank128", torch.bfloat16, 128, 50257, 640, 128, 2e-3),
    ]
    path = None
    for name, dt, R, V, H, r, tol in cases:
        h, w, lab, dl, dg = fused_ce_inputs(torch, dev, dt, R, V, H,
                                            seed=R + H + r)
        g = torch.Generator(device=dev).manual_seed(r)
        xa = torch.randn(R, r, generator=g, device=dev).to(dt)
        bt = (0.05 * torch.randn(V, r, generator=g, device=dev)).to(dt)
        lse, gold = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
        rl, rg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
        e = {"lse": max_err(lse, rl), "gold": max_err(gold, rg)}
        errs = {}
        for key, dgold, err_fn in (("rel", dg, rel_err),
                                   ("sm", torch.zeros_like(dg), scaled_err)):
            args = (h, w, xa, bt, lab, rl, dl, dgold)
            got = dict(zip(("dh", "dxa"), fc.fused_ce_bwd_dh_lora(*args)))
            ref = dict(zip(("dh", "dxa"),
                           fc.fused_ce_dh_lora_reference(*args)))
            got.update(zip(("dw", "dbt"), fc.fused_ce_bwd_dw_lora(*args)))
            ref.update(zip(("dw", "dbt"),
                           fc.fused_ce_dw_lora_reference(*args)))
            no_dw, got["dbt_only"] = fc.fused_ce_bwd_dw_lora(*args,
                                                             want_dw=False)
            check(no_dw is None, "row 11 wrote dW in its dbt-only mode")
            ref["dbt_only"] = ref["dbt"]
            torch.cuda.synchronize()
            for t in (lse, gold, *got.values()):
                check(bool(torch.isfinite(t).all()), f"fused CE lora {name} "
                      f"non-finite")
            errs[key] = {k: err_fn(got[k], ref[k]) for k in got}
            if key == "rel":
                e.update({k: max_err(got[k], ref[k]) for k in got})
            del got, ref
        print(f"fused CE lora {name}: {dt} R={R} V={V} H={H} r={r}: max abs "
              f"err lse {e['lse']:.3e}, gold {e['gold']:.3e}; over "
              f"max(1, |ref|) " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs["rel"].items())
              + "; softmax part (dgold = 0) over max |ref| " + ", ".join(
                  f"{k} {v:.3e}" for k, v in errs["sm"].items())
              + f" (tolerance {tol:g})")
        check(max(e["lse"], e["gold"], *errs["rel"].values()) <= tol,
              f"fused CE lora {name} disagrees with its plain versions")
        check(max(errs["sm"].values()) <= tol, f"fused CE lora {name}: the "
              f"softmax part disagrees with its plain versions")
        if name == "path":
            path = (e, (h, w, xa, bt, lab, rl, dl, dg))
            args = path[1]
            twice = {
                "(lse, gold)": lambda: fc.fused_ce_fwd_lora(*args[:5]),
                "(dh, dxa)": lambda: fc.fused_ce_bwd_dh_lora(*args),
                "dbt-only": lambda: fc.fused_ce_bwd_dw_lora(
                    *args, want_dw=False)[1:]}
            for what, fn in twice.items():
                first, again = fn(), fn()
                check(all(bool(torch.equal(a, b))
                          for a, b in zip(first, again)),
                      f"fused CE lora {what}: two calls gave different "
                      f"bits")
            print("fused CE lora path: (lse, gold), (dh, dxa) and dbt-only "
                  "twice each, identical bits")
            del first, again
    h, w, lab, dl, dg = fused_ce_inputs(torch, dev, torch.bfloat16, 8, 100,
                                        1004, seed=1)
    xa = torch.zeros(8, 8, device=dev, dtype=torch.bfloat16)
    bt = torch.zeros(100, 8, device=dev, dtype=torch.bfloat16)
    for name, fn in (
            ("fused_ce_fwd_lora",
             lambda: fc.fused_ce_fwd_lora(h, w, xa, bt, lab)),
            ("fused_ce_bwd_dh_lora",
             lambda: fc.fused_ce_bwd_dh_lora(h, w, xa, bt, lab, dl, dl, dg)),
            ("fused_ce_bwd_dw_lora (dbt only)",
             lambda: fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, dl, dl, dg,
                                             want_dw=False))):
        check(refuses(fn), f"{name} took a bf16 H = 1004 (not a multiple "
                           f"of 8)")
    h, w, xa, bt = h.float(), w.float(), xa.float(), bt.float()
    check(refuses(lambda: fc.fused_ce_fwd_lora(h, w, xa, bt, lab)),
          "fused_ce_fwd_lora took an f32 H = 1004 (not a multiple of 8)")
    check(refuses(lambda: fc.fused_ce_bwd_dh_lora(h, w, xa, bt, lab, dl, dl,
                                                  dg)),
          "fused_ce_bwd_dh_lora took an f32 H = 1004 (not a multiple of 8)")
    check(refuses(lambda: fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, dl, dl,
                                                  dg, want_dw=False)),
          "fused_ce_bwd_dw_lora (dbt only) took an f32 H = 1004 (not a "
          "multiple of 8)")
    return path


def check_wide_h(torch, fc, dev):
    """The fused CE width rule on the card: the chunked loss at
    Gemma-3-4B's width (B 4 x S 257, 8 chunks of 4 x 32 rows, H 2,560, V
    262,144), which no fused CE layout takes, in bf16 and f32, with and
    without a rank-8 head adapter: impl "auto" must launch no fused CE
    kernel (ops/fused_ce.fused_ce_eligible is false there, so every
    chunk takes the plain body) and give impl "plain"'s sum, count and
    gradients (hidden states, and A, B) to 1e-6 of their size. Returns
    {case: {"max_rel_err", "fused_launches"}}."""
    from mobilefinetuner_tpu_torch.ops import loss
    kernels = (fc.fused_ce_fwd, fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dw,
               fc.fused_ce_fwd_lora, fc.fused_ce_bwd_dh_lora,
               fc.fused_ce_bwd_dw_lora)
    B, S, H, V, r = 4, 257, 2560, 262144, 8
    g = torch.Generator(device=dev).manual_seed(45)
    hid32 = torch.randn(B, S, H, generator=g, device=dev)
    w32 = 0.02 * torch.randn(V, H, generator=g, device=dev)
    labels = torch.randint(0, V, (B, S), generator=g, device=dev)
    a32 = 0.02 * torch.randn(H, r, generator=g, device=dev)
    b32 = 0.1 * torch.randn(r, V, generator=g, device=dev)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        w = w32.to(dt)
        for head_on in (False, True):
            got = {}
            for impl in ("plain", "auto"):
                leaves = [t.to(dt).requires_grad_(True)
                          for t in (hid32, a32, b32)]
                head = ({"A": leaves[1], "B": leaves[2],
                         "scale": torch.tensor(4.0, device=dev)}
                        if head_on else None)
                n = [f.launches for f in kernels]
                s, c = loss.chunked_lm_cross_entropy_sum(
                    leaves[0], w, labels, num_chunks=GEMMA["chunks"],
                    impl=impl, lora_head=head)
                grads = torch.autograd.grad(
                    s, leaves if head_on else leaves[:1])
                torch.cuda.synchronize()
                fused = sum(f.launches for f in kernels) - sum(n)
                got[impl] = (s.detach(), int(c), grads, fused)
            name = f"{str(dt)[6:]}{'_head' if head_on else ''}"
            err = max(rel_err(a, b) for a, b in zip(
                (got["auto"][0], *got["auto"][2]),
                (got["plain"][0], *got["plain"][2])))
            out[name] = {"max_rel_err": err,
                         "fused_launches": got["auto"][3]}
            check(got["auto"][3] == 0, f"wide H {name}: the chunked loss "
                  f"launched {got['auto'][3]} fused CE kernels at H {H}")
            check(got["auto"][1] == got["plain"][1] == B * (S - 1),
                  f"wide H {name}: counts {got['auto'][1]} / "
                  f"{got['plain'][1]}")
            check(all(bool(torch.isfinite(t).all()) for t in
                      (got["auto"][0], *got["auto"][2])),
                  f"wide H {name}: non-finite loss or gradient")
            check(err <= 1e-6, f"wide H {name}: auto vs plain {err:.3e}")
            del got, leaves, grads
        del w
    print(f"wide H (H {H}, V {V}, {GEMMA['chunks']} chunks of {B} x 32 "
          f"rows): impl auto = impl plain, no fused CE launch: "
          + json.dumps(out))
    return out


def check_gemma(torch, dev):
    """Gemma-3-270M in f32, kernel path (flash, epilogue, fused CE)
    against the plain path (plain attention, naive LoRA, plain chunked
    loss): hidden states and the loss at S = 1024 with a padded row (the
    512-token window bites), then a LoRA train step (targets full, r 8)
    at S = 256, and one with the lm_head target too (the head-adapter
    rows 9-11 in f32, row 10 on its 3xTF32 kernel): loss and LoRA grads,
    the head's A and B among them."""
    from mobilefinetuner_tpu_torch.core.config import Gemma3TextConfig
    from mobilefinetuner_tpu_torch.lora.lora import (GEMMA_PRESETS,
                                                     LoRASpec,
                                                     init_lora_gemma3)
    from mobilefinetuner_tpu_torch.models import gemma3
    from mobilefinetuner_tpu_torch.ops.loss import \
        chunked_lm_cross_entropy_sum
    cfg = Gemma3TextConfig.gemma3_270m()
    params = gemma3.init_params(cfg, seed=1, device=dev)
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g).to(dev)
    mask = torch.ones(2, 1024, device=dev)
    mask[1, 900:] = 0.0
    labels = torch.where(mask > 0, ids, -100)
    paths = {"kernel": ("auto", "auto", "auto"),
             "plain": ("plain", "naive", "plain")}
    out = {}
    for key, (attn, lora_impl, loss_impl) in paths.items():
        with torch.no_grad():
            h = gemma3.hidden_states(cfg, params, ids, mask,
                                     attn_impl=attn, lora_impl=lora_impl)
            s, n = chunked_lm_cross_entropy_sum(h, params["embed"], labels,
                                                impl=loss_impl)
        out[key] = (h, float(s / n))
    torch.cuda.synchronize()
    e_h = max_err(out["kernel"][0], out["plain"][0])
    e_loss = abs(out["kernel"][1] - out["plain"][1])
    print(f"gemma3-270m f32 S=1024 kernel path vs plain path: hidden states "
          f"max err {e_h:.3e} (tolerance 1e-3), loss {out['kernel'][1]:.6f} "
          f"vs {out['plain'][1]:.6f} (err {e_loss:.3e}, tolerance 1e-4)")
    check(e_h <= 1e-3 and e_loss <= 1e-4,
          "Gemma-3 kernel path disagrees with the plain path")
    del out
    ids, mask, labels = ids[:, :256], mask[:, :256], labels[:, :256]
    for targets in (GEMMA_PRESETS["full"], GEMMA_PRESETS["full"]
                    + ["lm_head"]):
        lora = init_lora_gemma3(cfg, LoRASpec(rank=8, alpha=32.0,
                                              init="peft", targets=targets),
                                seed=3, device=dev)
        for entry in lora["blocks"].values():   # B off zero: grads reach A
            entry["B"] = (0.02 * torch.randn(entry["B"].shape,
                                             generator=g)).to(dev)
        out = {}
        for key, (attn, lora_impl, loss_impl) in paths.items():
            leaves = {n: {k: t.clone().requires_grad_(k != "scale")
                          for k, t in e.items()}
                      for n, e in lora["blocks"].items()}
            h = gemma3.hidden_states(cfg, params, ids, mask,
                                     {"blocks": leaves}, attn_impl=attn,
                                     lora_impl=lora_impl)
            s, n = chunked_lm_cross_entropy_sum(
                h, params["embed"], labels, impl=loss_impl,
                lora_head=leaves.get("lm_head"))
            grads = torch.autograd.grad(
                s / n, [leaves[k][x] for k in sorted(leaves) for x in "AB"])
            out[key] = (float((s / n).detach()), grads)
        e_loss = abs(out["kernel"][0] - out["plain"][0])
        e_grad = max(max_err(a, b) for a, b in zip(out["kernel"][1],
                                                     out["plain"][1]))
        what = "LoRA + lm_head" if "lm_head" in targets else "LoRA"
        print(f"gemma3-270m f32 {what} train step, kernel path vs plain "
              f"path: loss {out['kernel'][0]:.6f} vs {out['plain'][0]:.6f} "
              f"(err {e_loss:.3e}), LoRA grads max err {e_grad:.3e} over "
              f"{len(out['kernel'][1])} (tolerance 1e-4)")
        check(e_loss <= 1e-4 and e_grad <= 1e-4,
              f"Gemma-3 {what} train step: kernel path disagrees with "
              f"plain path")


# ----------------------------------------------------------- main paths ----

def serve(torch, fa, da):
    """The serving path: GPT-2 small served through build_engine, with
    its telemetry stream (request phases, serve_stats every 8 decode
    steps, trace spans) and the metrics endpoint, scraped mid-run."""
    import numpy as np

    from mobilefinetuner_tpu_torch.serve.bench import build_engine
    stream = os.path.join(STREAMS["dir"], "serve.jsonl")
    eng, names = build_engine("gpt2s", num_slots=8, block_T=16,
                              num_blocks=128, max_prompt=128, max_new=64,
                              adapters=2, dtype="bfloat16", seed=0,
                              telemetry_out=stream, stats_every=8,
                              trace_spans=True, metrics_port=free_port())
    V = eng.config.vocab_size
    warm_programs(eng, names[0])
    rng = np.random.default_rng(0)
    routes = [names[0], names[1], None] * 4
    prompts = [list(rng.integers(0, V, int(n)))
               for n in rng.integers(8, 129, len(routes))]
    prefills0, steps0, decode_s0 = (eng.prefills, eng.decode_steps,
                                    eng.decode_s)
    fa.flash_attention_fwd.launches = 0
    da.paged_decode_attention.launches = 0
    da.decode_attention.launches = 0
    ms = time_programs(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, adapter=a) for p, a in zip(prompts, routes)]
    done, scraped = [], None
    while not eng.idle:
        done.extend(eng.step())
        if scraped is None and eng.decode_steps - steps0 == 16:
            url = f"http://127.0.0.1:{eng.metrics_server.port}"
            scraped = (scrape(url + "/metrics"), scrape(url + "/healthz"))
    wall = time.perf_counter() - t0
    launches = {"flash": fa.flash_attention_fwd.launches,
                "paged": da.paged_decode_attention.launches,
                "decode": da.decode_attention.launches}
    prefills = eng.prefills - prefills0
    steps = eng.decode_steps - steps0
    check(len(done) == len(reqs), f"{len(done)} of {len(reqs)} terminal")
    for r in reqs:
        check(r.state == "finished", f"request {r.id} {r.state} {r.reason}")
        check(len(r.tokens) == 64 and all(0 <= t < V for t in r.tokens),
              f"request {r.id} tokens {r.tokens[:8]}...")
    check(eng.alloc.in_use == 0 and eng.alloc.free_blocks == 127,
          f"pages not returned: in_use {eng.alloc.in_use}")
    check(prefills == len(reqs), f"{prefills} prefills")
    check(launches["flash"] == prefills * LAYERS,
          f"flash launches {launches['flash']} != {prefills} x {LAYERS}")
    check(launches["paged"] == steps * LAYERS,
          f"paged launches {launches['paged']} != {steps} x {LAYERS}")
    check(launches["decode"] == 0, f"serving launched the contiguous "
          f"decode kernel {launches['decode']} times")
    # the telemetry: the endpoint answered mid-run, and every request's
    # phases and spans are in the stream
    (m_code, metrics), (h_code, health) = scraped
    check(m_code == 200 and metrics.endswith("# EOF\n")
          and 'mft_requests_total{phase="first_token"}' in metrics
          and h_code == 200
          and json.loads(health)["status"] == "ok",
          f"metrics scrape {m_code} {metrics[-200:]!r}, healthz {h_code}")
    eng.metrics_server.close()
    evs = read_stream(stream)
    phases = collections.defaultdict(list)
    for e in evs:
        if e["event"] == "request":
            phases[e["id"]].append(e["phase"])
    check(all(phases[r.id] == ["enqueue", "admit", "first_token", "finish"]
              for r in reqs), f"request phases {dict(phases)}")
    n_stats = sum(1 for e in evs if e["event"] == "serve_stats")
    n_spans = sum(1 for e in evs if e["event"] == "span")
    check(n_stats >= steps // 8 and n_spans >= 3 * len(reqs),
          f"{n_stats} serve_stats, {n_spans} spans")
    # every program replayed its graph, captured in the warm-up; the same
    # traffic through an engine that runs them eagerly gives the same
    # tokens, pools and launches
    graphs = graph_report(eng, "serve", replayed=("decode_step", "prefill",
                                                  "write_prefill"))
    graphed_ms = list(eng._step_ms)[-steps:]

    def eager_warm():
        twin, _ = build_engine("gpt2s", num_slots=8, block_T=16,
                               num_blocks=128, max_prompt=128, max_new=64,
                               adapters=2, dtype="bfloat16", seed=0,
                               _eager=True)
        warm_programs(twin, names[0])
        return twin

    def eager_run(twin):
        twin_ms = time_programs(twin)
        rs = [twin.submit(p, adapter=a) for p, a in zip(prompts, routes)]
        twin.drain()
        pools = pools_equal(twin, eng)
        out = ([r.tokens for r in rs], list(twin._step_ms)[-steps:],
               dict(twin.trace_counts), latency(rs, twin_ms), pools)
        twin.close()
        return out
    names_of = {"flash": "flash_fwd", "paged": "paged", "decode": "decode"}
    eager_toks, eager_ms, eager_traces, eager_lat, pools = eager_twin(
        eager_warm, eager_run, kernel_wrappers(),
        {names_of[k]: n for k, n in launches.items()})
    check(eager_toks == [r.tokens for r in reqs],
          "serve: graphed tokens differ from the eager engine's")
    check(pools, "serve: graphed pools differ from the eager engine's")
    lat = latency(reqs, ms)
    graph = {**graphs, "eager_traces": eager_traces,
             "step_ms_p50": p50(graphed_ms),
             "eager_step_ms_p50": p50(eager_ms), "ids_equal_eager": True,
             "pools_equal_eager": True, "launches_equal_eager": True,
             "graphed": lat, "eager": eager_lat}
    print(f"serve decode graph: engine step p50 {graph['step_ms_p50']:.3f} "
          f"ms graphed, {graph['eager_step_ms_p50']:.3f} eager; ids, pools "
          f"and launches equal")
    print_latency("serve", lat, eager_lat)
    ttft = sorted(r.ttft_ms for r in reqs)
    tpot = sorted(r.tpot_ms for r in reqs)
    n_tok = sum(len(r.tokens) for r in reqs)
    stats = {
        "model": "gpt2s", "dtype": "bfloat16", "requests": len(reqs),
        "prefills": prefills, "decode_steps": steps, "graphs": graph,
        "ttft_ms_p50": ttft[len(ttft) // 2],
        "tpot_ms_p50": tpot[len(tpot) // 2],
        "tokens_per_s": n_tok / wall,
        "decode_tokens_per_s": (n_tok - len(reqs))
        / (eng.decode_s - decode_s0),
        "wall_s": wall,
        "telemetry": {"serve_stats": n_stats, "spans": n_spans,
                      "scraped_at_step": 16},
    }
    return launches, stats, eng, names


def profile_phases(phases: dict) -> dict:
    """{name: wall/device ms, device busy share, top kernels} of each
    (fn, iters, events) phase, traced with torch.profiler. Where `events`
    (the phase never waits on the card), the same figures again from CUDA
    events without the profiler: device ms of a CUDA graph's replay
    (graph_ms), wall ms a call (call_ms) and their ratio."""
    out = {}
    for name, (fn, iters, events) in phases.items():
        evs, wall_ms = device_events(fn, iters)
        by_name = {}
        for k, us in evs:
            by_name[k] = by_name.get(k, 0.0) + us
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        out[name] = {
            "wall_ms": wall_ms / iters, "device_ms": busy_ms / iters,
            "device_busy_share": busy_ms / wall_ms if wall_ms else None,
            "device_activities": len(evs) // iters,
            "top": [[k[:60], us / 1e3 / iters] for k, us in top]}
        if events:
            dev_ms, call = graph_ms(fn, iters), call_ms(fn, iters)
            out[name]["events"] = {"device_ms": dev_ms, "wall_ms": call,
                                   "device_busy_share": dev_ms / call}
    return out


def engine_graph_events(eng, step_ms) -> dict:
    """The device ms of the engine's own decode-step graph (its sampling
    and argmax included) from CUDA events around replays with the last
    step's inputs, which rewrite the same K/V and tokens (no count
    moves), and its share of the serve run's graphed step p50."""
    dev_ms = call_ms(eng._decode_graph.graph.replay, 20)
    return {"engine_graph_device_ms": dev_ms,
            "engine_graph_busy_share": dev_ms / p50(step_ms)}


def engine_program_events(eng, graph, staged, tok, inputs: dict) -> dict:
    """One of the engine's own program graphs on `inputs` (greedy): the
    device ms of its replay, and the wall ms of a whole call (staging,
    replay, the token's host sync), from CUDA events. Its replays write
    only its static outputs and the trash page (the caller's table), so
    no request's pages move, and no count moves."""
    staged.stage(**{"temp": 0.0, "topk": 0, "topp": 1.0, "seed": 0,
                    **inputs})

    def call():
        staged.stage(**inputs)
        graph.graph.replay()
        return tok.item()
    return {"engine_graph_device_ms": call_ms(graph.graph.replay, 20),
            "engine_call_wall_ms": call_ms(call, 20)}


def profile_serve(torch, eng, names):
    """Where a decode step and a prefill spend their time. The engine's
    step reads its tokens back, so no graph of it: the decode step's
    device time comes from CUDA events around CUDA-graph replays of one
    gpt2_decode_step_paged call with the engine's tokens, positions,
    tables and adapter routing held fixed (`events`: graph device ms,
    eager call ms, their ratio, and the serve run's step p50 from the
    engine's own clock); the prefill's also from the engine's own prefill
    graph (engine_program_events)."""
    import numpy as np

    from mobilefinetuner_tpu_torch.lora.lora import assign_adapters
    from mobilefinetuner_tpu_torch.models.generate import (
        gpt2_decode_step_paged, gpt2_prefill)
    step_ms = sorted(eng._step_ms)
    rng = np.random.default_rng(1)
    V = eng.config.vocab_size
    for i in range(eng.cfg.num_slots):
        eng.submit(list(rng.integers(0, V, 100)),
                   adapter=(names + [None])[i % 3])
    eng.step()                          # admit every slot, first decode
    check(len(eng.active) == eng.cfg.num_slots, "slots not all admitted")
    ids = torch.as_tensor(rng.integers(0, V, (1, 128)), device=eng.device)
    mask = torch.ones(1, 128, dtype=torch.long, device=eng.device)
    lora = assign_adapters(eng.bank.tree, [0])
    out = profile_phases({
        "decode_step": (eng.step, 10, False),       # reads its tokens
        "prefill_128": (lambda: gpt2_prefill(
            eng.config, eng.params, ids, mask, compute_dtype=eng.dtype,
            lora=lora), 5, True)})
    out["prefill_128"]["events"].update(engine_program_events(
        eng, eng._prefill_graph, eng._prefill_in, eng._tok0, dict(
            ids=ids.cpu().numpy(), mask=np.ones((1, 128), np.int64),
            aid=0, block_ids=np.zeros(128 // eng.cfg.block_T, np.int32))))
    # the fed tokens' K/V land where the engine's next step writes its own
    tok, pos, tbl = (eng._dev(a.copy()) for a in (eng._tok, eng._pos,
                                                  eng._tbl))
    routed = assign_adapters(eng.bank.tree, eng._aid)

    def decode_step():
        gpt2_decode_step_paged(eng.config, eng.params, eng.pool_k,
                               eng.pool_v, tok, pos, tbl, lora=routed,
                               compute_dtype=eng.dtype,
                               attn_impl=eng.cfg.attn_impl)
    dev_ms, wall_ms = graph_ms(decode_step, 20), call_ms(decode_step, 20)
    out["decode_step"]["events"] = {
        "device_ms": dev_ms, "wall_ms": wall_ms,
        "device_busy_share": dev_ms / wall_ms,
        "serve_step_ms_p50": step_ms[len(step_ms) // 2],
        **engine_graph_events(eng, step_ms)}
    while not eng.idle:
        eng.step()
    return out


# Gemma-3-270M serving: 8 slots, pages of 16, one-shot prompts up to 128
# tokens and chunked ones up to 608 (42 pages with the 64 new tokens), a
# 256-token shared prefix; the f32 cross-checks serve 4 requests of 16
GEMMA_SERVE = dict(slots=8, block_T=16, blocks=512, max_prompt=128,
                   chunked=608, new=64, prefix=256, f32_new=16)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def gemma_serve_traffic(rng, V, tenant):
    """16 requests: 8 over one 256-token prefix (4 on the base, 2 of them
    identical and the copy last, so it is a full hit; 4 on `tenant`), and
    8 prompts of 8-608 tokens (3 over 448, so prompt + 64 new tokens
    crosses the 512 window; 2 of at most 128, one-shot). Every other
    request is sampled (SAMPLED, a seed each). Returns [(prompt, adapter,
    sampling kwargs)] and the shared-prefix requests' indices by route."""
    G = GEMMA_SERVE
    ints = lambda n: [int(x) for x in rng.integers(0, V, n)]  # noqa: E731
    prefix = ints(G["prefix"])
    full = prefix + ints(32)                     # 18 whole pages
    shared = [(full, None), (prefix + ints(17), None),
              (prefix + ints(100), None), (prefix + ints(20), tenant),
              (prefix + ints(45), tenant), (prefix + ints(64), tenant),
              (prefix + ints(33), tenant)]
    lens = ([int(n) for n in rng.integers(449, G["chunked"] + 1, 3)]
            + [int(n) for n in rng.integers(8, G["max_prompt"] + 1, 2)]
            + [int(n) for n in rng.integers(8, G["chunked"] + 1, 3)])
    other = [(ints(n), None) for n in lens]
    order = [shared[0], other[0], shared[1], other[1], shared[3], other[2],
             shared[4], other[3], shared[2], other[4], shared[5], other[5],
             shared[6], other[6], other[7], (list(full), None)]
    out = []
    for i, (prompt, adapter) in enumerate(order):
        kw = dict(SAMPLED, seed=1000 + i) if i % 2 else {}
        out.append((prompt, adapter, kw))
    base = [i for i, (p, a, _) in enumerate(out)
            if a is None and p[:G["prefix"]] == prefix]
    ten = [i for i, (p, a, _) in enumerate(out) if a == tenant]
    return out, base, ten


def gemma_serve(torch, kernels, card):
    """The Gemma-3-270M serving path: build_engine("gemma270m") in bf16
    with 2 rank-4 tenants, the prefix cache, chunked admission and
    sampling, serving gemma_serve_traffic with every launch count set to 0
    just before. Every request finishes with 64 in-vocab tokens; every
    page is returned or parked, and the parked pages are the cache's; the
    flash forward ran 18 times a one-shot prefill, the paged kernel 18
    times a decode step, no other kernel; the shared prefix hit, and no
    tenant request held a base page."""
    import numpy as np

    from mobilefinetuner_tpu_torch.serve.bench import build_engine
    G = GEMMA_SERVE
    eng, names = build_engine(
        "gemma270m", num_slots=G["slots"], block_T=G["block_T"],
        num_blocks=G["blocks"], max_prompt=G["max_prompt"],
        max_new=G["new"], adapters=2, dtype="bfloat16", seed=0,
        prefix_cache=True, max_prompt_chunked=G["chunked"], sampling=True)
    V = eng.config.vocab_size
    warm_programs(eng, names[1], seed=1, **SAMPLED)
    spec, base, ten = gemma_serve_traffic(np.random.default_rng(0), V,
                                          names[0])
    evicted = []
    on_evict = eng.alloc.on_evict
    eng.alloc.on_evict = lambda b, k: (evicted.append(b), on_evict(b, k))
    n0 = dict(prefills=eng.prefills, chunks=eng.chunks,
              full_hits=eng.full_hits, decode_steps=eng.decode_steps,
              decode_s=eng.decode_s, hit=eng.prefix.hit_tokens,
              looked=eng.prefix.lookup_tokens)
    pages = {}                    # request -> its prefix pages, once live
    ms = time_programs(eng)
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, adapter=a, **kw) for p, a, kw in spec]
    while not eng.idle:
        eng.step()
        for r in eng.active:
            if not r.prefilling and r.id not in pages:
                pages[r.id] = set(r.blocks[:G["prefix"] // G["block_T"]])
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    d = {k: getattr(eng, k) - n0[k] for k in ("prefills", "chunks",
                                              "full_hits", "decode_steps")}
    hit_rate = ((eng.prefix.hit_tokens - n0["hit"])
                / (eng.prefix.lookup_tokens - n0["looked"]))
    for r in reqs:
        check(r.state == "finished", f"request {r.id} {r.state} {r.reason}")
        check(len(r.tokens) == G["new"]
              and all(0 <= t < V for t in r.tokens),
              f"request {r.id} tokens {r.tokens[:8]}...")
    check(eng.alloc.in_use == 0 and eng.alloc.refcounts == {},
          f"pages not returned: in_use {eng.alloc.in_use}")
    eng.prefix.check_consistent()
    check(sorted(eng.alloc.parked) == eng.prefix.blocks,
          "parked pages are not the prefix cache's entries")
    L = GEMMA_LAYERS
    check(d["prefills"] > 0 and d["chunks"] > 0 and d["full_hits"] >= 1,
          f"admission paths not all taken: {d}")
    check(launches["flash_fwd"] == d["prefills"] * L,
          f"flash launches {launches['flash_fwd']} != {d['prefills']} x {L}")
    check(launches["paged"] == d["decode_steps"] * L,
          f"paged launches {launches['paged']} != {d['decode_steps']} x {L}")
    others = {k: n for k, n in launches.items()
              if k not in ("flash_fwd", "paged") and n}
    check(not others, f"gemma serving launched other kernels: {others}")
    check(hit_rate > 0, "the shared prefix never hit")
    base_pages = set().union(*(pages[reqs[i].id] for i in base))
    ten_pages = set().union(*(pages[reqs[i].id] for i in ten))
    check(len(base_pages) < len(base) * 16 and len(ten_pages) < len(ten) * 16,
          "requests over one prefix did not share its pages")
    check(not base_pages & ten_pages, "a tenant request held a base page")
    # every program replayed its graphs (each chunk bucket one), captured
    # in the warm-up; the same traffic through an engine that runs them
    # eagerly gives the same tokens, sampled ones too, pools and launches
    graphs = graph_report(eng, "gemma_serve", replayed=SERVE_KEYS)
    graphed_ms = list(eng._step_ms)[-d["decode_steps"]:]

    def eager_warm():
        twin, _ = build_engine(
            "gemma270m", num_slots=G["slots"], block_T=G["block_T"],
            num_blocks=G["blocks"], max_prompt=G["max_prompt"],
            max_new=G["new"], adapters=2, dtype="bfloat16", seed=0,
            prefix_cache=True, max_prompt_chunked=G["chunked"],
            sampling=True, _eager=True)
        warm_programs(twin, names[1], seed=1, **SAMPLED)
        return twin

    def eager_run(twin):
        twin_ms = time_programs(twin)
        rs = [twin.submit(p, adapter=a, **kw) for p, a, kw in spec]
        twin.drain()
        out = ([r.tokens for r in rs],
               list(twin._step_ms)[-d["decode_steps"]:],
               latency(rs, twin_ms), pools_equal(twin, eng))
        twin.close()
        return out
    eager_toks, eager_ms, eager_lat, pools = eager_twin(
        eager_warm, eager_run, kernels, launches)
    check(eager_toks == [r.tokens for r in reqs],
          "gemma_serve: graphed tokens differ from the eager engine's")
    check(pools, "gemma_serve: graphed pools differ from the eager engine's")
    lat = latency(reqs, ms)
    graph = {**graphs, "step_ms_p50": p50(graphed_ms),
             "eager_step_ms_p50": p50(eager_ms), "ids_equal_eager": True,
             "pools_equal_eager": True, "launches_equal_eager": True,
             "graphed": lat, "eager": eager_lat}
    print(f"gemma_serve decode graph: engine step p50 "
          f"{graph['step_ms_p50']:.3f} ms graphed, "
          f"{graph['eager_step_ms_p50']:.3f} eager; ids (half sampled), "
          f"pools and launches equal")
    print_latency("gemma_serve", lat, eager_lat)
    ttft = sorted(r.ttft_ms for r in reqs)
    tpot = sorted(r.tpot_ms for r in reqs)
    n_tok = sum(len(r.tokens) for r in reqs)
    stats = {
        "model": "gemma270m", "dtype": "bfloat16", "requests": len(reqs),
        **{k: d[k] for k in ("prefills", "chunks", "full_hits",
                             "decode_steps")},
        "prefix_hit_rate": hit_rate, "evictions": len(evicted),
        "ttft_ms_p50": ttft[len(ttft) // 2],
        "tpot_ms_p50": tpot[len(tpot) // 2],
        "tokens_per_s": n_tok / wall,
        # tokens the decode steps emitted (a full hit's first one too)
        "decode_tokens_per_s": (n_tok - len(reqs) + d["full_hits"])
        / (eng.decode_s - n0["decode_s"]),
        "wall_s": wall, "card": card, "graphs": graph,
    }
    return stats, launches, eng, names


def profile_gemma_serve(torch, eng, names):
    """Where a Gemma serve decode step and a 128-token prefill chunk spend
    their time (as profile_serve): the engine's step traced with its 8
    slots busy (it reads its tokens back, so no graph of it), and CUDA
    events around CUDA-graph replays of one gemma3_decode_step_paged and
    one gemma3_prefill_chunk with the engine's state held fixed; the
    chunk's also from the engine's own widest-bucket chunk graph
    (engine_program_events)."""
    import numpy as np

    from mobilefinetuner_tpu_torch.lora.lora import assign_adapters
    from mobilefinetuner_tpu_torch.models.generate import (
        gemma3_decode_step_paged, gemma3_prefill_chunk)
    step_ms = sorted(eng._step_ms)
    rng = np.random.default_rng(2)
    V = eng.config.vocab_size
    for i in range(eng.cfg.num_slots):
        eng.submit([int(x) for x in rng.integers(0, V, 100)],
                   adapter=(names + [None])[i % 3],
                   **(dict(SAMPLED, seed=i) if i % 2 else {}))
    eng.step()                          # admit every slot, first decode
    check(len(eng.active) == eng.cfg.num_slots, "slots not all admitted")
    out = profile_phases({"gemma_decode_step": (eng.step, 10, False)})
    tok, pos, tbl = (eng._dev(a.copy()) for a in (eng._tok, eng._pos,
                                                  eng._tbl))
    routed = assign_adapters(eng.bank.tree, eng._aid)
    W = eng.chunk_buckets[-1]
    ids = eng._dev(rng.integers(0, V, (1, W)))
    # a table of trash pages: the chunk writes page 0 only, and attends
    # all M pages masked, as a first chunk does
    ctbl = torch.zeros(1, eng.M, dtype=torch.int32, device=eng.device)
    chunk_lora = assign_adapters(eng.bank.tree, np.full(W, eng._aid[0]))

    def decode_step():
        gemma3_decode_step_paged(eng.config, eng.params, eng.pool_k,
                                 eng.pool_v, tok, pos, tbl, lora=routed,
                                 compute_dtype=eng.dtype,
                                 attn_impl=eng.cfg.attn_impl)

    def chunk():
        gemma3_prefill_chunk(eng.config, eng.params, eng.pool_k,
                             eng.pool_v, ids, 0, W, ctbl, lora=chunk_lora,
                             compute_dtype=eng.dtype)

    out.update(profile_phases({"gemma_prefill_chunk_128": (chunk, 5,
                                                           True)}))
    out["gemma_prefill_chunk_128"]["events"].update(engine_program_events(
        eng, eng._chunk_graphs[W], eng._chunk_in, eng._chunk_tok, dict(
            ids=ids[0].cpu().numpy(), aid=eng._aid[0], start_n=(0, W),
            tbl=ctbl.cpu().numpy())))
    dev_ms, wall_ms = graph_ms(decode_step, 20), call_ms(decode_step, 20)
    out["gemma_decode_step"]["events"] = {
        "device_ms": dev_ms, "wall_ms": wall_ms,
        "device_busy_share": dev_ms / wall_ms,
        "serve_step_ms_p50": step_ms[len(step_ms) // 2],
        **engine_graph_events(eng, step_ms)}
    while not eng.idle:
        eng.step()
    return out


def gemma_serve_f32(torch, dev):
    """f32 cross-checks of Gemma-3-270M serving on the card, 4 requests of
    16 new tokens (one on a tenant, one sampled, one of 560 tokens whose
    decode crosses the 512 window): one gemma3_decode_step_paged with the
    kernel against attn_impl="plain" on the same pools (logits 1e-4 max
    abs), and the same tokens from the kernel engine with the prefix cache
    (a cold wave, then a wave of prefix hits), a plain engine without the
    cache, and an engine that chunks every prompt (max_prompt 32).
    Returns (stats, step): `step` the kernel engine's decode-step inputs
    at the cross-check (its pools copied), for gemma_f32_step_events to
    time once the path's launches are read."""
    import numpy as np

    from mobilefinetuner_tpu_torch.core.config import Gemma3TextConfig
    from mobilefinetuner_tpu_torch.lora.lora import assign_adapters
    from mobilefinetuner_tpu_torch.models import gemma3
    from mobilefinetuner_tpu_torch.models.generate import \
        gemma3_decode_step_paged
    from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine
    from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
    from mobilefinetuner_tpu_torch.serve.bench import rand_adapters
    G = GEMMA_SERVE
    config = Gemma3TextConfig.gemma3_270m()
    params = gemma3.init_params(config, seed=0, dtype=torch.float32,
                                device=dev)
    tenant = rand_adapters("gemma", config, 1, seed=0, device=dev)[0]

    def engine(eager=False, **kw):
        cfg = dict(num_slots=4, block_T=G["block_T"], num_blocks=G["blocks"],
                   max_prompt=G["max_prompt"], max_prompt_chunked=G["chunked"],
                   max_new_tokens=G["f32_new"], dtype="float32",
                   sampling=True)
        cfg.update(kw)
        eng = ServeEngine("gemma", config, params, ServeConfig(**cfg),
                          bank=AdapterBank(tenant, 1, family="gemma"),
                          device=dev, _eager=eager)
        eng.load_adapter("tenant0", tenant)
        return eng

    rng = np.random.default_rng(1)
    ints = lambda n: [int(x) for x in rng.integers(  # noqa: E731
        0, config.vocab_size, n)]
    shared = ints(64)
    prompts = [shared + ints(40), shared + ints(24), ints(560),
               shared + ints(64)]
    routes = [None, "tenant0", None, None]
    samp = [{}, {}, {}, dict(SAMPLED, seed=11)]

    def submit(eng):
        return [eng.submit(p, adapter=a, **kw)
                for p, a, kw in zip(prompts, routes, samp)]

    from mobilefinetuner_tpu_torch.kernels import graphs
    kernels = kernel_wrappers()
    # every program called twice first, so the waves replay graphs only;
    # the warm-up counts for no path, as the other serve paths' warm-ups
    # run before their counts are set to 0
    kern = engine(prefix_cache=True)
    before = graphs.launch_snapshot()
    warm_programs(kern, None)
    take_back(before)
    ms = time_programs(kern)
    before = graphs.launch_snapshot()
    reqs = submit(kern)
    while not all(len(r.tokens) >= 2 for r in reqs):
        kern.step()
    kern_launches = launches_since(before, kernels)
    check(int(kern._pos.max()) > GEN["window"], "no slot past the window")
    tok, pos, tbl = (kern._dev(a.copy()) for a in (kern._tok, kern._pos,
                                                   kern._tbl))
    lora = assign_adapters(kern.bank.tree, kern._aid)
    step = dict(config=config, params=kern.params, pool_k=kern.pool_k.clone(),
                pool_v=kern.pool_v.clone(), tok=tok, pos=pos, tbl=tbl,
                lora=lora)
    logits = {}
    for impl in ("auto", "plain"):
        pk, pv = kern.pool_k.clone(), kern.pool_v.clone()
        logits[impl] = gemma3_decode_step_paged(
            config, kern.params, pk, pv, tok, pos, tbl, lora=lora,
            compute_dtype=torch.float32, attn_impl=impl)[0]
        del pk, pv
    err = max_err(logits["auto"], logits["plain"])
    before = graphs.launch_snapshot()
    kern.drain()
    tokens = {"kernel_cold": [r.tokens for r in reqs]}
    hit0 = kern.prefix.hit_tokens
    again = submit(kern)
    kern.drain()
    tokens["kernel_prefix_hits"] = [r.tokens for r in again]
    check(kern.prefix.hit_tokens > hit0, "the second wave did not hit")
    kern_launches = {k: n + kern_launches[k] for k, n
                     in launches_since(before, kernels).items()}
    # the kernel engine replayed every program's graphs, captured in the
    # warm-up; the same two waves through an engine that runs them eagerly
    # give the same tokens, pools and launches
    graphs_out = graph_report(kern, "gemma_serve f32", replayed=SERVE_KEYS)

    def eager_run(twin):
        twin_ms = time_programs(twin)
        waves, rs = [], []
        for _ in range(2):
            rs += submit(twin)
            twin.drain()
            waves.append([r.tokens for r in rs[-len(prompts):]])
        return (waves, list(twin._step_ms),
                latency(rs[-len(prompts):], twin_ms),
                pools_equal(twin, kern))
    def eager_warm():
        twin = engine(eager=True, prefix_cache=True)
        warm_programs(twin, None)
        return twin
    eager_waves, eager_ms, eager_lat, pools = eager_twin(
        eager_warm, eager_run, kernels, kern_launches)
    check(eager_waves == [tokens["kernel_cold"],
                          tokens["kernel_prefix_hits"]],
          "gemma_serve f32: graphed tokens differ from the eager engine's")
    check(pools, "gemma_serve f32: graphed pools differ from the eager "
          "engine's")
    # TTFT / TPOT of the second wave: the first pauses for the cross-check
    lat = latency(again, ms)
    graph = {**graphs_out, "step_ms_p50": p50(kern._step_ms),
             "eager_step_ms_p50": p50(eager_ms), "ids_equal_eager": True,
             "pools_equal_eager": True, "launches_equal_eager": True,
             "graphed": lat, "eager": eager_lat}
    print(f"gemma_serve f32 decode graph: engine step p50 "
          f"{graph['step_ms_p50']:.3f} ms graphed, "
          f"{graph['eager_step_ms_p50']:.3f} eager; ids, pools and launches "
          f"equal")
    print_latency("gemma_serve f32", lat, eager_lat)
    runs = {"plain": engine(attn_impl="plain"),
            "chunked": engine(max_prompt=32)}
    for name, eng in runs.items():
        rs = submit(eng)
        eng.drain()
        tokens[name] = [r.tokens for r in rs]
    check(runs["plain"].prefills == 3 and runs["chunked"].prefills == 0,
          "the admission paths were not the ones compared")
    print(f"gemma_serve f32: paged step kernel vs plain max |logits err| "
          f"{err:.3e} (tolerance 1e-4)")
    check(err <= 1e-4, "the Gemma paged step disagrees with its plain "
          "version")
    for name, toks in tokens.items():
        check(toks == tokens["kernel_cold"],
              f"gemma_serve f32: {name} tokens differ from the kernel "
              f"engine's cold wave")
    return ({"step_logits_max_abs_err": err, "graphs": graph,
             "compared": sorted(tokens), "requests": len(prompts)}, step)


def gemma_f32_step_events(torch, da, step):
    """The device ms of one f32 gemma3_decode_step_paged at
    `gemma_serve_f32`'s cross-check (4 slots, one past the 512 window;
    `step` from gemma_serve_f32) from CUDA events around CUDA-graph
    replays, and row 12's share of it: the step's own paged calls,
    recorded from one eager step, replayed in a graph on
    paged_decode_attention_vec_f32.cu and again on the first version
    (fma_paged), whose step time is estimated as the step's less the
    split's calls plus its own. Called after the path's launches are
    read: none of these counts."""
    from mobilefinetuner_tpu_torch.models import generate
    cfg = step["config"]

    def decode_step():
        generate.gemma3_decode_step_paged(
            cfg, step["params"], step["pool_k"], step["pool_v"],
            step["tok"], step["pos"], step["tbl"], lora=step["lora"],
            compute_dtype=torch.float32, attn_impl="auto")

    calls = []
    real = generate.paged_decode_attention

    def record(*args):
        calls.append(args)
        return real(*args)
    generate.paged_decode_attention = record
    try:
        decode_step()
    finally:
        generate.paged_decode_attention = real
    check(len(calls) == cfg.num_hidden_layers,
          f"the f32 decode step made {len(calls)} paged calls")
    step_ms = graph_ms(decode_step, 20)
    paged_ms = graph_ms(lambda: [da.paged_decode_attention(*a)
                                 for a in calls], 20)
    first_ms = graph_ms(lambda: [fma_paged(*a) for a in calls], 20)
    out = {"device_ms": step_ms, "paged_calls": len(calls),
           "paged_device_ms": paged_ms, "paged_share": paged_ms / step_ms,
           "first_version_paged_device_ms": first_ms,
           "first_version_step_ms_estimate": step_ms - paged_ms + first_ms}
    print(f"gemma_serve f32 decode step: {step_ms:.3f} device ms, row 12 "
          f"{paged_ms:.3f} ({100 * paged_ms / step_ms:.1f}%; the first "
          f"version's calls {first_ms:.3f})")
    return out


def gemma_serve_flash_entry(torch, fa, dev):
    """Row 1 at the serving prefill's shape (q 1 x 4 x 128 x 256, kv 1 x 1
    x 128 x 256, bf16, a prompt of 100 tokens right-padded to 128, causal;
    the 512 window is wider than the prompt): held against its plain
    version (check_flash's bf16 tolerances), then timed and bounded."""
    B, Hq, Hkv, S, D, n = 1, 4, 1, GEMMA_SERVE["max_prompt"], 256, 100
    q, k, v, pad = flash_inputs(torch, dev, torch.bfloat16, B, Hq, Hkv, S, D,
                                (n,), seed=21)
    kw = dict(scale=D ** -0.5, is_causal=True,
              sliding_window=GEN["window"])
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
    torch.cuda.synchronize()
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    print(f"gemma serve prefill shape, bf16: flash fwd max |out err| "
          f"{err:.3e} (tolerance 1e-2), max |lse err| {lse_err:.3e} (1e-4)")
    check(bool(torch.isfinite(out).all()), "serve-shape flash non-finite")
    check(err <= 1e-2 and lse_err <= 1e-4, "flash fwd at the serving "
          "prefill shape disagrees with its plain version")
    allowed = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    allowed = allowed[None, None] & (pad > 0)[:, None, None, :]
    pairs = int(allowed.sum()) * Hq
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = timed({
        "ms": lambda: fa.flash_attention_fwd(q, k, v, pad, **kw),
        "plain_ms": lambda: fa.flash_attention_reference(q, k, v, pad, **kw),
        "library_ms": lambda: sdpa(q, k, v, attn_mask=allowed,
                                   scale=kw["scale"], enable_gqa=True)})
    isz = q.element_size()
    return kernel_entry(
        "flash_attention_fwd", "flash_attention_fwd_mma.cu",
        "flash_attention.py:162", None, err, times,
        bound((2 * q.numel() + 2 * k.numel()) * isz + pad.numel() * 4
              + B * Hq * S * 4, 4 * D * pairs),
        {"shape": f"q {B}x{Hq}x{S}x{D}, kv {B}x{Hkv}x{S}x{D}, bf16, causal, "
                  f"{n} of {S} rows real (gemma serving prefill)"})


def read_csv(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def train(torch, dev, work, kernels):
    """The training path: the port's CLI on a synthetic full-size GPT-2
    small and corpus, launch counts set to 0 just before it."""
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.cli import common
    from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli
    from mobilefinetuner_tpu_torch.data.synthetic import (
        write_synthetic_corpus, write_synthetic_gpt2)
    from mobilefinetuner_tpu_torch.data.tokenizer_bpe import GPT2BPETokenizer
    from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                          WT2Config)
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec,
                                                     init_lora_gpt2,
                                                     trainable_mask)
    from mobilefinetuner_tpu_torch.models import gpt2
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.optim import adam
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_eval_step)
    T = TRAIN
    gdir, ddir = os.path.join(work, "gpt2"), os.path.join(work, "wiki")
    out = os.path.join(work, "out")
    t0 = time.perf_counter()
    write_synthetic_gpt2(gdir, seed=0)
    write_synthetic_corpus(ddir, n_train_words=60_000, seed=0)
    config, params_np = load_gpt2(gdir)
    params = convert.gpt2_params_from_numpy(params_np, device=dev)
    tok = GPT2BPETokenizer.from_pretrained(gdir)
    valid = WikiText2Dataset(ddir, "valid", WT2Config(
        seq_len=T["seq"], batch_size=T["eval_batch"], shuffle=False),
        tok.encode, tok.eos_id)
    eval_nb = min(T["eval_batches"], valid.num_batches())
    spec = LoRASpec(rank=T["rank"], alpha=T["alpha"],
                    targets=["attn_qkv", "attn_proj"])

    def nll_fn(lora_t, frozen, mb):
        logits = gpt2.forward(config, frozen, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              lora=lora_t, compute_dtype=torch.bfloat16)
        return lm_cross_entropy_sum(logits, mb["labels"])

    lora0 = init_lora_gpt2(config, spec, seed=42, device=dev)
    base = common.evaluate(make_eval_step(nll_fn), lora0, params, valid,
                           T["eval_batches"], dev)
    setup_s = time.perf_counter() - t0
    print(f"train setup: synthetic GPT-2 small + corpus written and base "
          f"eval done in {setup_s:.1f} s; base eval ppl {base['ppl']:.3f} "
          f"over {base['tokens']} tokens")

    adapter = os.path.join(out, "adapter.safetensors")
    argv = ["--pretrained_dir", gdir, "--data_dir", ddir,
            "--steps", str(T["steps"]), "--batch_size", str(T["batch"]),
            "--grad_accum_steps", str(T["accum"]),
            "--seq_len", str(T["seq"]), "--dtype", "bfloat16",
            "--rank", str(T["rank"]), "--alpha", str(T["alpha"]),
            "--lr", str(T["lr"]), "--eval_interval", str(T["steps"]),
            "--eval_batch_size", str(T["eval_batch"]),
            "--eval_batches", str(T["eval_batches"]),
            "--lora_out", adapter,
            "--metrics_csv", os.path.join(out, "metrics.csv"),
            "--eval_out", os.path.join(out, "eval.jsonl"),
            *telemetry_argv("train")]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"gpt2_lora_finetune.main returned {rc}")
    admitted("train")

    rows = read_csv(os.path.join(out, "metrics.csv"))
    losses = [float(r["loss"]) for r in rows]
    step_ms = sorted(float(r["step_time_ms"]) for r in rows)
    with open(os.path.join(out, "eval.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    final = evals[-1]
    check(len(losses) == T["steps"] and all(map(_finite, losses)),
          f"losses {losses}")
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last5 < first5, f"loss did not fall: first-5 mean {first5:.4f}, "
          f"last-5 mean {last5:.4f}")
    check(final["type"] == "final_eval" and final["ppl"] < base["ppl"],
          f"eval ppl {final['ppl']:.3f} not below the base model's "
          f"{base['ppl']:.3f}")

    micro = T["steps"] * T["accum"]
    fwd_passes = micro + len(evals) * eval_nb
    impl = resolve_bwd_impl(T["seq"], config.head_dim, torch.bfloat16)
    want = {"flash_fwd": LAYERS * fwd_passes,
            "bwd_merged": LAYERS * micro if impl == "merged" else 0,
            "bwd_dq": LAYERS * micro if impl == "split" else 0,
            "bwd_dkv": LAYERS * micro if impl == "split" else 0,
            "lora_epilogue": 2 * LAYERS * fwd_passes, "paged": 0,
            "decode": 0,
            "fused_ce_fwd": 0, "fused_ce_dh": 0, "fused_ce_dw": 0,
            "fused_ce_fwd_lora": 0, "fused_ce_dh_lora": 0,
            "fused_ce_dw_lora": 0}
    check(launches == want, f"train launches {launches}, expected {want} "
          f"(auto backward: {impl})")

    # the adapter and its sidecar reload
    lora, spec2 = peft_io.load_adapter(adapter, device=dev)
    tc = TrainConfig(total_steps=T["steps"], lr=T["lr"])
    state, _ = adam.load_state(adapter + ".opt", init_optimizer(
        lora, tc, trainable_mask(lora)), verify=True)
    check(spec2.rank == T["rank"] and int(state["step"]) == T["steps"]
          and all(bool(torch.isfinite(e["B"]).all())
                  and float(e["B"].abs().max()) > 0
                  for e in lora["blocks"].values()),
          "trained adapter / .opt sidecar did not reload")

    tokens = T["batch"] * T["accum"] * T["seq"]
    stats = {"model": "gpt2s", "dtype": "bfloat16", "steps": T["steps"],
             "micro_batch": T["batch"], "grad_accum": T["accum"],
             "seq_len": T["seq"], "lora_rank": T["rank"],
             "tokens_per_step": tokens,
             "step_ms_p50": step_ms[len(step_ms) // 2],
             "tokens_per_s": tokens / (step_ms[len(step_ms) // 2] / 1e3),
             "first_loss": losses[0], "last_loss": losses[-1],
             "first5_mean_loss": first5, "last5_mean_loss": last5,
             "eval_ppl_before": base["ppl"], "eval_ppl_after": final["ppl"],
             "eval_tokens": final["tokens"], "eval_batches": eval_nb,
             "bwd_impl": impl, "wall_s": wall, "setup_s": setup_s}
    return stats, launches, adapter, (config, params, tok, spec)


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def serve_trained(torch, dev, adapter, model):
    """The serving path with the trained adapter, loaded from its file."""
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.optim.adam import tree_map
    from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine
    from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
    config, params, tok, _ = model
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    template, _ = peft_io.load_adapter(adapter, device=dev)
    template = {"blocks": {n: {k: v.to(torch.bfloat16) for k, v in e.items()}
                           for n, e in template["blocks"].items()}}
    eng = ServeEngine("gpt2", config, params, ServeConfig(
        num_slots=2, block_T=16, num_blocks=32, max_prompt=64,
        max_new_tokens=16, dtype="bfloat16"),
        bank=AdapterBank(template, capacity=1), device=dev)
    slot = eng.load_adapter("trained", adapter)
    prompt = tok.encode(" w001 w002 w003 w004")
    r = eng.submit(prompt, adapter="trained")
    eng.drain()
    check(r.state == "finished" and len(r.tokens) == 16
          and all(0 <= t < config.vocab_size for t in r.tokens),
          f"trained-adapter request {r.state} {r.tokens}")
    print(f"served with the trained adapter (bank slot {slot}): "
          f"{tok.decode(r.tokens)!r}")
    return r.tokens


def profile_train(torch, dev, model):
    """Where one train step (micro-batch 8 x 2, bf16) spends its time."""
    import numpy as np

    from mobilefinetuner_tpu_torch.cli.common import place_batch
    from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec,
                                                     init_lora_gpt2,
                                                     trainable_mask)
    from mobilefinetuner_tpu_torch.models import gpt2
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    config, params, _, spec = model
    T = TRAIN
    lora = init_lora_gpt2(config, spec, seed=42, device=dev)
    mask = trainable_mask(lora)
    tc = TrainConfig(total_steps=T["steps"], lr=T["lr"],
                     grad_accum_steps=T["accum"])

    def loss_fn(lora_t, frozen, mb):
        logits = gpt2.forward(config, frozen, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              lora=lora_t, compute_dtype=torch.bfloat16)
        return lm_cross_entropy_sum(logits, mb["labels"])

    step_fn = make_train_step(loss_fn, tc, mask)
    opt = init_optimizer(lora, tc, mask)
    rng = np.random.default_rng(3)
    rows = T["batch"] * T["accum"]
    ids = rng.integers(0, config.vocab_size, (rows, T["seq"]),
                       dtype=np.int32)
    batch = place_batch({"input_ids": ids, "labels": ids,
                         "attention_mask": np.ones((rows, T["seq"]),
                                                   np.float32)}, dev)
    return profile_phases({"train_step": (
        lambda: step_fn(lora, params, opt, batch, 0), 5, True)})


def gemma_train(torch, dev, work, kernels):
    """The Gemma LoRA path: the port's CLI on a synthetic full-size
    Gemma-3-270M and corpus, launch counts set to 0 just before it."""
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.cli import common
    from mobilefinetuner_tpu_torch.cli import train_lora_gemma as cli
    from mobilefinetuner_tpu_torch.data.synthetic import (
        write_synthetic_corpus, write_synthetic_gemma270m)
    from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
        GemmaTokenizer
    from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                          WT2Config)
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gemma3
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.lora.lora import (GEMMA_PRESETS,
                                                     LoRASpec,
                                                     init_lora_gemma3,
                                                     trainable_mask)
    from mobilefinetuner_tpu_torch.models import gemma3
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    from mobilefinetuner_tpu_torch.ops.loss import \
        chunked_lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.optim import adam
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_eval_step)
    G = GEMMA
    gdir, ddir = os.path.join(work, "gemma"), os.path.join(work, "gwiki")
    out = os.path.join(work, "gemma_out")
    t0 = time.perf_counter()
    write_synthetic_gemma270m(gdir, seed=0)
    write_synthetic_corpus(ddir, n_train_words=60_000, seed=0)
    config, params_np = load_gemma3(gdir)
    params = convert.gemma3_params_from_numpy(params_np, device=dev)
    del params_np
    tok = GemmaTokenizer.from_pretrained(gdir)
    valid = WikiText2Dataset(ddir, "valid", WT2Config(
        seq_len=G["seq"], batch_size=G["eval_batch"], shuffle=False),
        lambda t: tok.encode(t, add_bos=False), tok.eos_id,
        pad_id=tok.pad_id)
    eval_nb = min(G["eval_batches"], valid.num_batches())
    spec = LoRASpec(rank=G["rank"], alpha=G["alpha"], init="peft",
                    targets=GEMMA_PRESETS["full"])

    def nll_fn(lora_t, frozen, mb):
        hidden = gemma3.hidden_states(config, frozen, mb["input_ids"],
                                      attention_mask=mb["attention_mask"],
                                      lora=lora_t,
                                      compute_dtype=torch.bfloat16)
        return chunked_lm_cross_entropy_sum(hidden, frozen["embed"],
                                            mb["labels"],
                                            num_chunks=G["chunks"])

    lora0 = init_lora_gemma3(config, spec, seed=42, device=dev)
    base = common.evaluate(make_eval_step(nll_fn), lora0, params, valid,
                           G["eval_batches"], dev)
    setup_s = time.perf_counter() - t0
    print(f"gemma setup: synthetic Gemma-3-270M + corpus written and base "
          f"eval done in {setup_s:.1f} s; base eval ppl {base['ppl']:.3f} "
          f"over {base['tokens']} tokens")

    argv = ["--model_dir", gdir, "--data_dir", ddir,
            "--max_steps", str(G["steps"]), "--batch", str(G["batch"]),
            "--seq_len", str(G["seq"]), "--dtype", "bfloat16",
            "--rank", str(G["rank"]), "--alpha", str(G["alpha"]),
            "--targets", "full", "--loss_chunks", str(G["chunks"]),
            "--lr", str(G["lr"]), "--eval_interval", str(G["steps"]),
            "--eval_batch_size", str(G["eval_batch"]),
            "--eval_batches", str(G["eval_batches"]),
            "--output_dir", out,
            "--metrics_csv", os.path.join(out, "metrics.csv"),
            "--eval_out", os.path.join(out, "eval.jsonl"),
            *telemetry_argv("gemma_train")]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"train_lora_gemma.main returned {rc}")
    admitted("gemma_train")
    stats, evals = run_stats(out, G["steps"], base, check_learns=True)
    M, E = G["steps"], len(evals) * eval_nb
    impl = resolve_bwd_impl(G["seq"], config.head_dim, torch.bfloat16)
    want = gemma_launches(M, E, impl, "lora")
    check(launches == want, f"gemma_train launches {launches}, expected "
          f"{want} (M={M} micro-batches, E={E} eval batches)")
    adapter = os.path.join(out, "gemma_lora.safetensors")
    lora, spec2 = peft_io.load_adapter(adapter, device=dev)
    state, _ = adam.load_state(adapter + ".opt", init_optimizer(
        lora, TrainConfig(), trainable_mask(lora)), verify=True)
    check(spec2.rank == G["rank"] and int(state["step"]) == G["steps"]
          and sorted(spec2.targets) == sorted(GEMMA_PRESETS["full"])
          and all(bool(torch.isfinite(e["B"]).all())
                  and float(e["B"].abs().max()) > 0
                  for e in lora["blocks"].values()),
          "trained Gemma adapter / .opt sidecar did not reload")
    stats.update({"model": "gemma3-270m", "mode": "lora", "dtype": "bfloat16",
                  "lora_rank": G["rank"], "lora_alpha": G["alpha"],
                  "targets": "full", "micro_batches": M, "eval_batches": E,
                  "bwd_impl": impl, "wall_s": wall, "setup_s": setup_s})
    return stats, launches, (config, params, spec, base, gdir, ddir,
                             eval_nb)


def gemma_launches(M: int, E: int, impl: str, mode: str) -> dict:
    """Kernel launches of M train micro-batches and E eval batches of the
    Gemma paths: per forward 18 flash forwards, 8 fused CE forwards and
    (LoRA) 126 epilogues; per backward 18 flash backwards and 8 dh; dW
    only when the head trains (mode "full", full fine-tuning). Mode
    "head" (targets full + lm_head) runs the head-adapter kernels in place
    of the base ones: 8 forwards, 8 dh and 8 dbt-only dW launches."""
    fwd, C = M + E, GEMMA["chunks"]
    head = mode == "head"
    return {"flash_fwd": GEMMA_LAYERS * fwd,
            "bwd_merged": GEMMA_LAYERS * M if impl == "merged" else 0,
            "bwd_dq": GEMMA_LAYERS * M if impl == "split" else 0,
            "bwd_dkv": GEMMA_LAYERS * M if impl == "split" else 0,
            "lora_epilogue": (0 if mode == "full"
                              else GEMMA_LAYERS * GEMMA_SITES * fwd),
            "paged": 0, "decode": 0,
            "fused_ce_fwd": 0 if head else C * fwd,
            "fused_ce_dh": 0 if head else C * M,
            "fused_ce_dw": C * M if mode == "full" else 0,
            "fused_ce_fwd_lora": C * fwd if head else 0,
            "fused_ce_dh_lora": C * M if head else 0,
            "fused_ce_dw_lora": C * M if head else 0}


def run_stats(out, steps, base, check_learns):
    """Metrics of a CLI run from its CSV and eval JSONL."""
    rows = read_csv(os.path.join(out, "metrics.csv"))
    losses = [float(r["loss"]) for r in rows]
    step_ms = sorted(float(r["step_time_ms"]) for r in rows)
    with open(os.path.join(out, "eval.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    final = evals[-1]
    check(len(losses) == steps and all(map(_finite, losses)),
          f"losses {losses}")
    check(final["type"] == "final_eval" and _finite(final["ppl"]),
          f"final eval {final}")
    k = min(5, steps)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    if check_learns:
        check(last < first, f"loss did not fall: first-{k} mean "
              f"{first:.4f}, last-{k} mean {last:.4f}")
        check(final["ppl"] < base["ppl"],
              f"eval ppl {final['ppl']:.3f} not below the base model's "
              f"{base['ppl']:.3f}")
    tokens = GEMMA["batch"] * GEMMA["seq"]
    p50 = step_ms[len(step_ms) // 2]
    return {"steps": steps, "batch": GEMMA["batch"], "seq_len": GEMMA["seq"],
            "loss_chunks": GEMMA["chunks"], "tokens_per_step": tokens,
            "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
            "first_loss": losses[0], "last_loss": losses[-1],
            f"first{k}_mean_loss": first, f"last{k}_mean_loss": last,
            "eval_ppl_before": base["ppl"], "eval_ppl_after": final["ppl"],
            "eval_tokens": final["tokens"]}, evals


def gemma_full_ft(torch, dev, work, kernels, gemma, f32: bool = False):
    """The Gemma full fine-tuning path: the port's CLI on the same
    directory and corpus, launch counts set to 0 just before it. With
    `f32`, at every CLI's default dtype (no --dtype; `gemma_full_ft_f32`),
    GEMMA_F32's steps and final eval: rows 6-8 in f32 on their 3xTF32
    kernels (row 8 8 times a micro-batch on fused_ce_dw_tf32.cu); also one
    such step's device ms from CUDA events around replays of a CUDA graph
    of it (graph_ms) and its trace, with row 8's share of the device
    time."""
    from mobilefinetuner_tpu_torch.cli import gemma_full_finetune as cli
    from mobilefinetuner_tpu_torch.io.safetensors_io import \
        SafeTensorsReader
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    config, _, _, base, gdir, ddir, eval_nb = gemma
    G = GEMMA
    name = "gemma_full_ft_f32" if f32 else "gemma_full_ft"
    steps = GEMMA_F32["full_steps"] if f32 else G["full_steps"]
    eval_batches = GEMMA_F32["eval_batches"] if f32 else G["eval_batches"]
    dtype = torch.float32 if f32 else torch.bfloat16
    out = os.path.join(work, f"{name}_out")
    model = os.path.join(out, "full.safetensors")
    argv = ["--model_dir", gdir, "--data_dir", ddir,
            "--steps", str(steps), "--batch_size", str(G["batch"]),
            "--seq_len", str(G["seq"]),
            *([] if f32 else ["--dtype", "bfloat16"]),
            "--loss_chunks", str(G["chunks"]), "--lr", str(G["full_lr"]),
            "--eval_interval", str(steps),
            "--eval_batch_size", str(G["eval_batch"]),
            "--eval_batches", str(eval_batches),
            "--output_path", model,
            "--metrics_csv", os.path.join(out, "metrics.csv"),
            "--eval_out", os.path.join(out, "eval.jsonl"),
            *telemetry_argv(name)]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"gemma_full_finetune.main ({name}) returned {rc}")
    admitted(name)
    stats, evals = run_stats(out, steps, base, check_learns=False)
    M, E = steps, len(evals) * min(eval_batches, eval_nb)
    impl = resolve_bwd_impl(G["seq"], config.head_dim, dtype)
    want = gemma_launches(M, E, impl, "full")
    check(launches == want, f"{name} launches {launches}, expected "
          f"{want} (M={M} micro-batches, E={E} eval batches)")
    reader = SafeTensorsReader(model)
    check(len(reader.keys()) == 2 + 13 * config.num_hidden_layers
          and SafeTensorsReader(model + ".opt").metadata["loop_step"]
          == str(steps), f"{name}: full-model file / .opt incomplete")
    stats.update({"model": "gemma3-270m", "mode": "full",
                  "dtype": str(dtype).split(".")[-1], "micro_batches": M,
                  "eval_batches": E, "bwd_impl": impl, "wall_s": wall})
    if f32:
        step = gemma_full_step(torch, gemma, dtype)
        step_ms = graph_ms(step, 3)
        evs, wall_ms = device_events(step, 2)   # torch.profiler, 2 steps
        del step
        busy = sum(us for _, us in evs) / 2e3
        dw_ms = sum(us for k, us in evs if "dw_tf32_kernel" in k) / 2e3
        stats.update(step_device_ms=step_ms, traced_device_ms=busy,
                     traced_wall_ms=wall_ms / 2, row8_traced_ms=dw_ms,
                     row8_share=dw_ms / busy)
        print(f"{name}: f32 (no --dtype), {M} steps: step ms p50 "
              f"{stats['step_ms_p50']:.1f}, one step's device ms "
              f"{step_ms:.2f} (CUDA events around CUDA-graph replays); "
              f"traced {busy:.2f} device ms, row 8 (dw_tf32_kernel) "
              f"{dw_ms:.2f} ms = {100 * stats['row8_share']:.1f}%; losses "
              f"{stats['first_loss']:.4f} -> {stats['last_loss']:.4f}")
    return stats, launches


def gemma_lora_head(torch, dev, work, kernels, gemma):
    """The head-adapter path: cli.train_lora_gemma with
    --lora_targets full,lm_head on the same directory and corpus, launch
    counts set to 0 just before it: the LoRA on the tied head rides the
    chunked loss through rows 9-11."""
    from mobilefinetuner_tpu_torch.cli import train_lora_gemma as cli
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.lora.lora import GEMMA_PRESETS
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    config, _, _, base, gdir, ddir, eval_nb = gemma
    G = GEMMA
    out = os.path.join(work, "gemma_head_out")
    argv = ["--model_dir", gdir, "--data_dir", ddir,
            "--max_steps", str(G["steps"]), "--batch", str(G["batch"]),
            "--seq_len", str(G["seq"]), "--dtype", "bfloat16",
            "--rank", str(G["rank"]), "--alpha", str(G["alpha"]),
            "--lora_targets", "full,lm_head",
            "--loss_chunks", str(G["chunks"]),
            "--lr", str(G["lr"]), "--eval_interval", str(G["steps"]),
            "--eval_batch_size", str(G["eval_batch"]),
            "--eval_batches", str(G["eval_batches"]),
            "--output_dir", out,
            "--metrics_csv", os.path.join(out, "metrics.csv"),
            "--eval_out", os.path.join(out, "eval.jsonl"),
            *telemetry_argv("gemma_lora_head")]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"train_lora_gemma.main (lm_head) returned {rc}")
    admitted("gemma_lora_head")
    stats, evals = run_stats(out, G["steps"], base, check_learns=True)
    M, E = G["steps"], len(evals) * eval_nb
    impl = resolve_bwd_impl(G["seq"], config.head_dim, torch.bfloat16)
    want = gemma_launches(M, E, impl, "head")
    check(launches == want, f"gemma_lora_head launches {launches}, "
          f"expected {want} (M={M} micro-batches, E={E} eval batches)")
    adapter = os.path.join(out, "gemma_lora.safetensors")
    lora, spec = peft_io.load_adapter(adapter, device=dev)
    head = lora["blocks"]["lm_head"]
    check(sorted(spec.targets) == sorted(GEMMA_PRESETS["full"]
                                         + ["lm_head"])
          and tuple(head["B"].shape) == (G["rank"], config.vocab_size)
          and bool(torch.isfinite(head["B"]).all())
          and float(head["B"].abs().max()) > 0,
          "the head adapter's B is still zero or did not reload")
    stats.update({"model": "gemma3-270m", "mode": "lora", "dtype":
                  "bfloat16", "lora_rank": G["rank"],
                  "lora_alpha": G["alpha"], "targets": "full,lm_head",
                  "head_B_max_abs": float(head["B"].abs().max()),
                  "micro_batches": M, "eval_batches": E, "bwd_impl": impl,
                  "wall_s": wall})
    return stats, launches, adapter, evals[-1]


def gemma_train_f32(torch, dev, work, kernels, gemma, head: bool):
    """The default-dtype Gemma path: cli.train_lora_gemma with no --dtype
    (f32, every CLI's default) on the directory and corpus `gemma_train`
    wrote, the `gemma_train` config (targets full, r 8, batch 4, seq 256,
    8 loss chunks; with `head`, --lora_targets full,lm_head) for
    GEMMA_F32's steps and final eval, launch counts set to 0 just before
    it. Its chunked loss runs the fused CE in f32: rows 6 and 7 (rows 9-11
    with the head), row 7 (10) on its 3xTF32 kernel; every launch count
    must be exact and the losses finite. Also one such step's device ms,
    from CUDA events around replays of a CUDA graph of it (graph_ms)."""
    from mobilefinetuner_tpu_torch.cli import train_lora_gemma as cli
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    config, _, _, base, gdir, ddir, eval_nb = gemma
    G, F = GEMMA, GEMMA_F32
    name = CE_F32_PATHS[int(head)]
    out = os.path.join(work, name)
    argv = ["--model_dir", gdir, "--data_dir", ddir,
            "--max_steps", str(F["steps"]), "--batch", str(G["batch"]),
            "--seq_len", str(G["seq"]),
            "--rank", str(G["rank"]), "--alpha", str(G["alpha"]),
            *(["--lora_targets", "full,lm_head"] if head
              else ["--targets", "full"]),
            "--loss_chunks", str(G["chunks"]),
            "--lr", str(G["lr"]), "--eval_interval", str(F["steps"]),
            "--eval_batch_size", str(G["eval_batch"]),
            "--eval_batches", str(F["eval_batches"]),
            "--output_dir", out,
            "--metrics_csv", os.path.join(out, "metrics.csv"),
            "--eval_out", os.path.join(out, "eval.jsonl"),
            *telemetry_argv(name)]
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"train_lora_gemma.main ({name}) returned {rc}")
    admitted(name)
    stats, evals = run_stats(out, F["steps"], base, check_learns=False)
    M, E = F["steps"], len(evals) * min(F["eval_batches"], eval_nb)
    impl = resolve_bwd_impl(G["seq"], config.head_dim, torch.float32)
    want = gemma_launches(M, E, impl, "head" if head else "lora")
    check(launches == want, f"{name} launches {launches}, expected "
          f"{want} (M={M} micro-batches, E={E} eval batches)")
    step_ms = graph_ms(gemma_step(torch, dev, gemma, head, torch.float32),
                       3)
    stats.update({"model": "gemma3-270m", "mode": "lora",
                  "dtype": "float32", "lora_rank": G["rank"],
                  "targets": "full,lm_head" if head else "full",
                  "micro_batches": M, "eval_batches": E, "bwd_impl": impl,
                  "step_device_ms": step_ms, "wall_s": wall})
    print(f"{name}: f32 (no --dtype), {M} steps: step ms p50 "
          f"{stats['step_ms_p50']:.1f}, one step's device ms "
          f"{step_ms:.1f} (CUDA events around CUDA-graph replays); losses "
          f"{stats['first_loss']:.4f} -> {stats['last_loss']:.4f}")
    return stats, launches


def run_eval_ppl(argv):
    """cli.eval_ppl.main(argv) -> its final record (its last stdout
    line)."""
    import contextlib
    import io

    from mobilefinetuner_tpu_torch.cli import eval_ppl
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_ppl.main(argv)
    check(rc == 0, f"eval_ppl.main returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def eval_ppl_phase(torch, kernels, gemma, head, gpt2):
    """cli.eval_ppl on both families, launch counts set to 0 just before
    each run: Gemma with the head adapter just trained (dynamic), on the
    batches of the trainer's final eval, whose perplexity it must
    reproduce; GPT-2 with the `train` phase's adapter, dynamic and merged
    (f32), which must agree."""
    _, _, _, _, gdir, ddir, eval_nb = gemma
    head_adapter, head_final = head
    gpt2_dir, wiki_dir, gpt2_adapter, gpt2_nb = gpt2
    G, T = GEMMA, TRAIN
    runs, launches = {}, {}
    argvs = {
        "gemma_head": ["--pretrained_dir", gdir, "--data_root", ddir,
                       "--lora_path", head_adapter, "--batch_size",
                       str(G["eval_batch"]), "--seq_len", str(G["seq"]),
                       "--max_batches", str(eval_nb), "--dtype", "bfloat16",
                       "--loss_chunks", str(G["chunks"])],
        "gpt2_dynamic": ["--pretrained_dir", gpt2_dir, "--data_root",
                         wiki_dir, "--lora_path", gpt2_adapter,
                         "--batch_size", str(T["eval_batch"]), "--seq_len",
                         str(T["seq"]), "--max_batches", str(gpt2_nb),
                         "--dtype", "float32"]}
    argvs["gpt2_merged"] = argvs["gpt2_dynamic"] + ["--lora_merge"]
    wall = {}
    for name, argv in argvs.items():
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = run_eval_ppl(argv + ["--log_every", "0",
                                          *telemetry_argv(f"eval_{name}")])
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        launches[name] = read_counts(kernels)
        admitted(f"eval_{name}", trained=False)
    g = runs["gemma_head"]
    n_b = eval_nb
    want = {k: 0 for k in kernels}
    want.update({"flash_fwd": GEMMA_LAYERS * n_b,
                 "lora_epilogue": GEMMA_LAYERS * GEMMA_SITES * n_b,
                 "fused_ce_fwd_lora": G["chunks"] * n_b})
    check(launches["gemma_head"] == want, f"eval_ppl gemma launches "
          f"{launches['gemma_head']}, expected {want}")
    rel = abs(g["ppl"] - head_final["ppl"]) / head_final["ppl"]
    check(g["tokens"] == head_final["tokens"] and rel <= 1e-3,
          f"eval_ppl gemma ppl {g['ppl']} over {g['tokens']} tokens vs the "
          f"trainer's final eval {head_final['ppl']} over "
          f"{head_final['tokens']} (relative {rel:.2e}, tolerance 1e-3)")
    d, m = runs["gpt2_dynamic"], runs["gpt2_merged"]
    rel_g = abs(d["ppl"] - m["ppl"]) / m["ppl"]
    check(d["tokens"] == m["tokens"] and rel_g <= 1e-3,
          f"eval_ppl gpt2 dynamic ppl {d['ppl']} vs merged {m['ppl']} "
          f"(relative {rel_g:.2e}, tolerance 1e-3)")
    for name, n_epi in (("gpt2_dynamic", 2 * LAYERS), ("gpt2_merged", 0)):
        want = {k: 0 for k in kernels}
        want.update({"flash_fwd": LAYERS * gpt2_nb,
                     "lora_epilogue": n_epi * gpt2_nb})
        check(launches[name] == want, f"eval_ppl {name} launches "
              f"{launches[name]}, expected {want}")
    stats = {name: dict(runs[name], wall_s=wall[name]) for name in runs}
    stats["gemma_head"]["trainer_final_eval_ppl"] = head_final["ppl"]
    stats["gemma_head"]["relative_diff"] = rel
    stats["gpt2_dynamic_vs_merged_relative_diff"] = rel_g
    total = {k: sum(v[k] for v in launches.values()) for k in kernels}
    return stats, total, launches


# --------------------------------------------- GPT-2 full fine-tuning ------

GPT2_FULL = dict(steps=20, batch=8, seq=128, lr=2e-4, save_every=10,
                 eval_batch=8, eval_batches=8, pdrop=0.1)


def dropout_dir(src: str, d: str, pdrop: float) -> str:
    """`src`'s checkpoint with GPT-2's published dropout rates (embd /
    resid / attn pdrop) in its config.json; the other files linked."""
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(src):
        if name != "config.json":
            os.symlink(os.path.join(src, name), os.path.join(d, name))
    with open(os.path.join(src, "config.json")) as f:
        raw = json.load(f)
    raw.update(embd_pdrop=pdrop, resid_pdrop=pdrop, attn_pdrop=pdrop)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(raw, f)
    return d


def gpt2_full_ft(torch, work, kernels, base_ppl, eval_nb):
    """The GPT-2 full fine-tuning path: cli.gpt2_full_finetune on the
    `train` phase's synthetic GPT-2 small (dropout 0.1 at every model
    site, the attention probs through the flash kernels' hash mask) and
    corpus, then again resumed from its step-10 file; launch counts set
    to 0 just before the first run and read just after the second."""
    import numpy as np
    from mobilefinetuner_tpu_torch.cli import gpt2_full_finetune as cli
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.io.safetensors_io import \
        SafeTensorsReader
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    F = GPT2_FULL
    gdir = dropout_dir(os.path.join(work, "gpt2"),
                       os.path.join(work, "gpt2_drop"), F["pdrop"])
    ddir = os.path.join(work, "wiki")
    out, out_r = (os.path.join(work, n) for n in ("full_out", "full_resume"))
    model = os.path.join(out, "full.safetensors")
    step_file = os.path.join(out, f"full_step{F['save_every']}.safetensors")

    def argv(o, *extra):
        return ["--pretrained_dir", gdir, "--data_dir", ddir,
                "--steps", str(F["steps"]), "--batch_size", str(F["batch"]),
                "--seq_len", str(F["seq"]), "--dtype", "bfloat16",
                "--lr", str(F["lr"]), "--eval_interval", str(F["steps"]),
                "--eval_batch_size", str(F["eval_batch"]),
                "--eval_batches", str(F["eval_batches"]),
                "--output_path", os.path.join(o, "full.safetensors"),
                "--metrics_csv", os.path.join(o, "metrics.csv"),
                "--eval_out", os.path.join(o, "eval.jsonl"), *extra]

    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv(out, "--save_every", str(F["save_every"]),
                       *telemetry_argv("gpt2_full_ft")))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"gpt2_full_finetune.main returned {rc}")
    t0 = time.perf_counter()
    rc = cli.main(argv(out_r, "--resume_from", step_file,
                       *telemetry_argv("gpt2_full_ft_resumed")))
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"gpt2_full_finetune.main (resumed) returned {rc}")
    admitted("gpt2_full_ft")
    admitted("gpt2_full_ft_resumed")

    rows = read_csv(os.path.join(out, "metrics.csv"))
    losses = [float(r["loss"]) for r in rows]
    step_ms = sorted(float(r["step_time_ms"]) for r in rows)
    resumed = [float(r["loss"]) for r in read_csv(
        os.path.join(out_r, "metrics.csv"))]
    evals = [json.loads(ln) for ln in open(os.path.join(out,
                                                        "eval.jsonl"))]
    evals_r = [json.loads(ln) for ln in open(os.path.join(out_r,
                                                          "eval.jsonl"))]
    final, final_r = evals[-1], evals_r[-1]
    check(len(losses) == F["steps"] and all(map(_finite, losses)),
          f"losses {losses}")
    first5, last5 = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last5 < first5, f"loss did not fall: first-5 mean {first5:.4f}, "
          f"last-5 mean {last5:.4f}")
    check(final["type"] == "final_eval" and final["ppl"] < base_ppl,
          f"eval ppl {final['ppl']:.3f} not below the base model's "
          f"{base_ppl:.3f}")
    # the resumed run repeats the uninterrupted one from step 11 on; the
    # merged backward's dQ sums are atomic (csrc/flash_attention_bwd_
    # merged_mma.cu), so "exact" is reported and 1e-3 is the check
    tail = losses[F["save_every"]:]
    resume_diff = max(abs(a - b) for a, b in zip(resumed, tail))
    check(len(resumed) == len(tail) and resume_diff <= 1e-3
          and abs(final_r["ppl"] - final["ppl"]) <= 1e-3 * final["ppl"],
          f"resumed losses {resumed} vs {tail}, eval ppl "
          f"{final_r['ppl']} vs {final['ppl']}")
    fwd = F["steps"] + (F["steps"] - F["save_every"]) \
        + (len(evals) + len(evals_r)) * eval_nb
    bwd = F["steps"] + (F["steps"] - F["save_every"])
    impl = resolve_bwd_impl(F["seq"], 64, torch.bfloat16)
    want = {k: 0 for k in kernels}
    want.update({"flash_fwd": LAYERS * fwd,
                 "bwd_merged": LAYERS * bwd if impl == "merged" else 0,
                 "bwd_dq": LAYERS * bwd if impl == "split" else 0,
                 "bwd_dkv": LAYERS * bwd if impl == "split" else 0})
    check(launches == want, f"gpt2_full_ft launches {launches}, expected "
          f"{want} ({fwd} forwards, {bwd} backwards)")
    # the saved file reloads through load_gpt2 (an HF dir around it)
    rdir = os.path.join(work, "gpt2_full_reload")
    os.makedirs(rdir)
    for name in ("config.json", "vocab.json", "merges.txt"):
        os.symlink(os.path.join(gdir, name), os.path.join(rdir, name))
    os.symlink(model, os.path.join(rdir, "model.safetensors"))
    cfg, p = load_gpt2(rdir)
    _, p0 = load_gpt2(gdir)
    leaves = [p["wte"], p["wpe"], p["ln_f"]["g"], p["ln_f"]["b"]] + [
        x for g in p["blocks"].values() for x in g.values()]
    n_params = sum(x.size for x in leaves)
    check(n_params == 124_439_808 and cfg.attn_pdrop == F["pdrop"]
          and all(bool(np.isfinite(x).all()) for x in leaves)
          and float(np.abs(p["wte"] - p0["wte"]).max()) > 0
          and SafeTensorsReader(model + ".opt").metadata["loop_step"]
          == str(F["steps"]), "full-model file / .opt did not reload")
    tokens = F["batch"] * F["seq"]
    p50 = step_ms[len(step_ms) // 2]
    return {"model": "gpt2s", "mode": "full", "dtype": "bfloat16",
            "trainable_params": n_params, "model_pdrop": F["pdrop"],
            "steps": F["steps"], "micro_batch": F["batch"],
            "seq_len": F["seq"], "lr": F["lr"], "tokens_per_step": tokens,
            "step_ms_p50": p50, "tokens_per_s": tokens / (p50 / 1e3),
            "first_loss": losses[0], "last_loss": losses[-1],
            "first5_mean_loss": first5, "last5_mean_loss": last5,
            "eval_ppl_before": base_ppl, "eval_ppl_after": final["ppl"],
            "resumed_from_step": F["save_every"],
            "resumed_losses_exact": resumed == tail,
            "resumed_max_abs_diff": resume_diff,
            "resumed_eval_ppl": final_r["ppl"], "forwards": fwd,
            "backwards": bwd, "bwd_impl": impl, "wall_s": wall,
            "resumed_wall_s": wall_r}, launches


def profile_gpt2_full_ft(torch, dev, model):
    """Where one GPT-2 small full fine-tuning step (batch 8 x 128, bf16,
    every parameter trainable, the tied wte's two gradients summed by
    autograd, Adam over 124M parameters) spends its time."""
    import numpy as np
    from mobilefinetuner_tpu_torch.cli.common import place_batch
    from mobilefinetuner_tpu_torch.models import gpt2
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.optim.adam import tree_map
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    config, params = model[:2]
    F = GPT2_FULL
    params = tree_map(lambda t: t.clone(), params)
    tc = TrainConfig(total_steps=F["steps"], lr=F["lr"])

    def loss_fn(trainable, _frozen, mb):
        logits = gpt2.forward(config, trainable, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              compute_dtype=torch.bfloat16)
        return lm_cross_entropy_sum(logits, mb["labels"])

    step_fn = make_train_step(loss_fn, tc, None)
    opt = init_optimizer(params, tc, None)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, config.vocab_size, (F["batch"], F["seq"]),
                       dtype=np.int32)
    batch = place_batch({"input_ids": ids, "labels": ids,
                         "attention_mask": np.ones((F["batch"], F["seq"]),
                                                   np.float32)}, dev)
    return profile_phases({"gpt2_full_ft_train_step": (
        lambda: step_fn(params, None, opt, batch, 0), 5, True)})


# -------------------------------------------------------------- MMLU -------

MMLU = dict(items=2, batch=16)   # synthetic items a subject (57 subjects)


def mmlu_args(model_dir, root, dtype, attn="auto", lora="", merge=False):
    argv = ["--pretrained_dir", model_dir, "--mmlu_root", root,
            "--dtype", dtype, "--attention_impl", attn, "--synthetic",
            "--eval_batch", str(MMLU["batch"])]
    if lora:
        argv += ["--lora_path", lora] + (["--lora_merge"] if merge else [])
    return argv


def run_eval_mmlu(argv, stats=None):
    """cli.eval_mmlu.main(argv + --out, stats) -> its JSON report; its
    admission check read from its stream."""
    import contextlib
    import io

    from mobilefinetuner_tpu_torch.cli import eval_mmlu
    name = f"mmlu_{sum(k.startswith('mmlu_') for k in ADMISSION)}"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "report.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = eval_mmlu.main(argv + ["--out", out, *telemetry_argv(name)],
                                stats=stats)
        check(rc == 0, f"eval_mmlu.main returned {rc}")
        admitted(name, trained=False)
        with open(out) as f:
            return json.load(f)


def mmlu_last_token_logits(model_dir, root, dev, batch):
    """max |difference| of the full last-token logits [16, V] of the
    first batch that the CLI scored, the kernel path's against the plain
    attention's (f32)."""
    import numpy as np

    from mobilefinetuner_tpu_torch.cli import eval_mmlu
    out = {}
    for attn in ("xla", "auto"):
        args = eval_mmlu.build_parser().parse_args(
            mmlu_args(model_dir, root, "float32", attn))
        f = eval_mmlu.setup_family(args, dev)
        out[attn] = eval_mmlu.make_batched_logits_fn(*f[:3], f[6], f[7])(
            *batch)
        del f
    return float(np.abs(out["auto"] - out["xla"]).max())


def mmlu_phase(torch, dev, kernels, gpt2, gemma):
    """cli.eval_mmlu on both families over a synthetic MMLU (57 subjects,
    MMLU["items"] test items each), launch counts set to 0 just before
    each run and read just after: at f32 the kernel path's report must
    equal the plain attention's and the first batch's last-token logits
    agree within 1e-4; at bf16 GPT-2 with the `train` adapter dynamic and
    merged must give the same prediction on >= 95% of the items, and
    Gemma with the head adapter dynamic runs the epilogue at [16,
    262,144]; the flash forward launches batches x layers, the epilogue
    batches x adapted sites. Returns the stats, the launches summed and
    by run, and the flash forward's launches by shape over the phase."""
    import numpy as np

    from mobilefinetuner_tpu_torch.data.synthetic import write_synthetic_mmlu
    gpt2_dir, gpt2_adapter = gpt2
    gemma_dir, head_adapter = gemma
    root = write_synthetic_mmlu(
        os.path.join(os.path.dirname(gpt2_dir), "mmlu"), MMLU["items"])
    L = {"gpt2": LAYERS, "gemma": GEMMA_LAYERS}
    dirs = {"gpt2": gpt2_dir, "gemma": gemma_dir}
    stats, launches, reports, scored = {}, {}, {}, {}
    flash_before = FLASH_BY_SHAPE.copy()

    def counted(name, argv):
        zero_counts(kernels)
        scored[name] = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports[name] = run_eval_mmlu(argv, scored[name])
        torch.cuda.synchronize()
        launches[name] = read_counts(kernels)
        stats[name] = {
            "wall_s": time.perf_counter() - t0,
            "items_per_s": scored[name]["items_per_s"],
            "scoring_s": scored[name]["scoring_s"],
            "macro_accuracy": reports[name]["macro_accuracy"],
            "micro_accuracy": reports[name]["micro_accuracy"],
            "total_items": reports[name]["total_items"],
            "batches_by_bucket": scored[name]["batches_by_bucket"]}
        return sum(scored[name]["batches_by_bucket"].values())

    def want(fam, batches, sites):
        w = {k: 0 for k in kernels}
        w.update({"flash_fwd": L[fam] * batches,
                  "lora_epilogue": sites * batches})
        return w

    # f32: the CLI's report through the kernels and through the plain
    # attention; the first batch's last-token logits
    for fam in ("gpt2", "gemma"):
        for attn in ("auto", "xla"):
            name = f"{fam}_f32_{'kernel' if attn == 'auto' else 'plain'}"
            n_b = counted(name, mmlu_args(dirs[fam], root, "float32", attn))
            check(launches[name] == want(fam, n_b if attn == "auto" else 0,
                                         0),
                  f"mmlu {name} launches {launches[name]}, expected {n_b} "
                  f"batches x {L[fam]} layers")
        same = reports[f"{fam}_f32_kernel"] == reports[f"{fam}_f32_plain"]
        check(same, f"mmlu {fam} f32: the kernel path's report differs "
              f"from the plain attention's")
        batch = scored[f"{fam}_f32_kernel"]["first_batch"]
        err = mmlu_last_token_logits(dirs[fam], root, dev, batch)
        print(f"mmlu {fam} f32: last-token logits of a "
              f"{list(batch[0].shape)} batch, kernel vs plain max |err| "
              f"{err:.3e} (tolerance 1e-4); reports equal")
        check(err <= 1e-4, f"mmlu {fam} f32 logits differ by {err}")
        stats[f"{fam}_f32_kernel"].update({"logits_max_abs_err": err,
                                           "report_equals_plain": same})

    # bf16: GPT-2's adapter dynamic and merged; Gemma's head adapter
    runs = {"gpt2_bf16_dynamic": ("gpt2", gpt2_adapter, False, 2 * LAYERS),
            "gpt2_bf16_merged": ("gpt2", gpt2_adapter, True, 0),
            "gemma_bf16_head_dynamic": (
                "gemma", head_adapter, False,
                GEMMA_LAYERS * GEMMA_SITES + 1)}
    for name, (fam, adapter, merge, sites) in runs.items():
        n_b = counted(name, mmlu_args(dirs[fam], root, "bfloat16",
                                      lora=adapter, merge=merge))
        check(launches[name] == want(fam, n_b, sites),
              f"mmlu {name} launches {launches[name]}, expected "
              f"{want(fam, n_b, sites)}")
    preds = {k: scored[k]["predictions"]
             for k in ("gpt2_bf16_dynamic", "gpt2_bf16_merged")}
    agree = np.mean([a == b for a, b in zip(preds["gpt2_bf16_dynamic"],
                                            preds["gpt2_bf16_merged"])])
    print(f"mmlu gpt2 bf16: dynamic and merged adapter predictions agree "
          f"on {agree:.4f} of {len(preds['gpt2_bf16_merged'])} items "
          f"(tolerance >= 0.95)")
    check(agree >= 0.95, f"mmlu gpt2 bf16 dynamic vs merged agree on "
          f"{agree:.4f} of the items")
    stats["gpt2_bf16_dynamic_vs_merged_agreement"] = float(agree)
    total = {k: sum(v[k] for v in launches.values()) for k in kernels}
    return stats, total, launches, FLASH_BY_SHAPE - flash_before


def mmlu_kernel_entries(torch, fa, lf, dev, flash_shapes):
    """Row 1 at every shape the MMLU runs launched it (`flash_shapes`,
    (dtype, B, Hq, S, D) -> launches; GPT-2 [16, 12, S, 64] causal,
    Gemma [16, 4, S, 256] over 1 kv head, causal, with the sliding
    layers' window 512 and the global layers' none; no padding: the pads
    sit after every real row) and row 5 at the head adapter's [16,
    262,144], r 8: each held against its plain version (the tolerances
    of check_flash and check_epilogue), timed and bounded, with the
    launches the paths made at that shape. f32 shapes run the 3xTF32
    kernel (flash_attention_fwd_tf32.cu), timed in turns with its FMA
    first version (flash_attention_fwd.cu) and bounded at the 3xTF32
    rate."""
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fams = {(12, 64): ("gpt2", 12, (None,)),
            (4, 256): ("gemma", 1, (512, None))}
    out = {"flash": [], "flash_f32": []}
    for key in sorted(flash_shapes, key=lambda k: (str(k[0]), k[2], k[3])):
        dt, B, Hq, S, D = key
        check((Hq, D) in fams, f"MMLU flash launch at a shape {key} of "
              f"neither family")
        fam, Hkv, windows = fams[(Hq, D)]
        tol, src = ((1e-2, "flash_attention_fwd_mma.cu") if dt == bf else
                    (1e-4, "flash_attention_fwd_tf32.cu"))
        q, k, v, _ = flash_inputs(torch, dev, dt, B, Hq, Hkv, S, D,
                                  (S,) * B, seed=21)
        errs = []
        for window in windows:
            kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window)
            o, lse = fa.flash_attention_fwd(q, k, v, None, **kw)
            ref, ref_lse = fa.flash_attention_reference(q, k, v, None, **kw)
            err, lse_err = max_err(o, ref), max_err(lse, ref_lse)
            print(f"mmlu {fam} bucket {S}, {dt}, window {window}: flash fwd "
                  f"max |out err| {err:.3e} (tolerance {tol:g}), max |lse "
                  f"err| {lse_err:.3e} (1e-4)")
            check(bool(torch.isfinite(o).all()) and err <= tol
                  and lse_err <= 1e-4, f"flash fwd at the {fam} MMLU bucket "
                  f"{S} ({dt}, window {window}): max |err| {err:.3e}, lse "
                  f"{lse_err:.3e}")
            errs.append(err)
        kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=windows[0])
        fns = {
            "ms": lambda: fa.flash_attention_fwd(q, k, v, None, **kw),
            "plain_ms": lambda: fa.flash_attention_reference(q, k, v, None,
                                                             **kw),
            "library_ms": lambda: sdpa(q, k, v, is_causal=True,
                                       scale=kw["scale"],
                                       enable_gqa=Hq != Hkv)}
        extra = {}
        if dt == bf:
            times = timed(fns, 50)
        else:   # the new kernel and its earlier version in turns
            times = in_turns(fns.pop("ms"), fma_flash(
                torch, fa, q, k, v, None, **kw)[0], 50)
            times.update(timed(fns, 50))
            extra["earlier_source"] = CSRC + "flash_attention_fwd.cu"
        pairs = B * Hq * sum(min(i + 1, windows[0] or S)   # causal
                             for i in range(S))
        isz = q.element_size()
        nbytes = ((2 * q.numel() + 2 * k.numel()) * isz + B * S * 4
                  + B * Hq * S * 4)
        out["flash" if dt == bf else "flash_f32"].append(kernel_entry(
            "flash_attention_fwd", src, "flash_attention.py:162",
            flash_shapes[key], max(errs), times,
            bound(nbytes, 4 * D * pairs) if dt == bf
            else f32_bound(nbytes, 4 * D * pairs),
            dict(extra, family=fam, bucket=S, shape=(
                f"q {B}x{Hq}x{S}x{D}, kv {B}x{Hkv}x{S}x{D}, "
                f"{str(dt).split('.')[-1]}, causal"
                + (f", window {windows[0]}" if windows[0] else "")
                + f" (eval_mmlu {fam} bucket {S})"))))
    g = torch.Generator(device=dev).manual_seed(22)
    y, xa, bm = (torch.randn(sh, generator=g, device=dev).to(bf)
                 for sh in ((MMLU["batch"], 262144), (MMLU["batch"], 8),
                            (8, 262144)))
    es = torch.tensor(EPI_SCALE, device=dev)
    epi, _ = lf.lora_epilogue(y, xa, bm, es)
    epi_err = max_err(epi, lf.lora_epilogue_reference(y, xa, bm, es))
    check(epi_err <= 1e-2, f"LoRA epilogue at the MMLU head shape: max "
          f"|err| {epi_err:.3e}")
    out["lm_head"] = kernel_entry(
        "lora_epilogue", "lora_epilogue_vec.cu", "lora_fused.py:78",
        EPI_BY_SHAPE[(bf, *y.shape)], epi_err,
        timed(epi_fns(torch, lf, y, xa, bm, es)), epi_bound(y, xa, bm),
        {"shape": "eval_mmlu head adapter: y 16x262144, r 8, bf16"})
    return out


def run_generate(argv, stats=None, eager=False):
    """cli.generate.main(argv + --json) -> its records (one a prompt);
    `eager` keeps its decode steps eager (comparisons only)."""
    import contextlib
    import io

    from mobilefinetuner_tpu_torch.cli import generate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = generate.main(argv + ["--json"], stats=stats, _eager=eager)
    check(rc == 0, f"generate.main returned {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def generate_prompts(tok, family):
    """The generate phase's prompts as text, with their token counts:
    GPT-2 (a byte-level vocabulary with no merges: a character a token),
    8 prompts of 8-128 tokens; Gemma (a corpus word a token, after the
    BOS), 4 prompts of about 600 tokens."""
    import numpy as np

    from mobilefinetuner_tpu_torch.data.synthetic import CORPUS_WORDS
    rng = np.random.default_rng(7)
    words = [CORPUS_WORDS[i] for i in rng.integers(0, len(CORPUS_WORDS),
                                                   1000)]
    if family == "gpt2":
        lens = [GEN["gpt2_min"], GEN["gpt2_max"]] + [
            int(n) for n in rng.integers(GEN["gpt2_min"], GEN["gpt2_max"],
                                         GEN["gpt2_batch"] - 2)]
        text = " ".join(words)
        prompts = [text[i:i + n] for i, n in enumerate(lens)]
        want = lens
    else:
        prompts = ["".join(" " + w for w in words[i:i + n])
                   for i, n in enumerate(GEN["gemma_words"])]
        want = [n + 1 for n in GEN["gemma_words"]]
    got = [len(tok.encode(p)) for p in prompts]
    check(got == want, f"{family} prompt token counts {got} != {want}")
    return prompts, got


def teacher_forced_check(torch, dev, family, model_dir, adapter, prompts,
                         records):
    """The JAX naive_rollout oracle made robust to argmax ties: prompt +
    generated ids through one plain f32 full forward (no cache,
    attn_impl="plain", the adapter applied naively); at each generated
    position the chosen token's logit must lie within 1e-3 of the
    maximum. Returns the largest gap."""
    from mobilefinetuner_tpu_torch.cli.family import (apply_adapter,
                                                      load_family)
    from mobilefinetuner_tpu_torch.models.generate import (_head_lora,
                                                           left_pad)
    b = load_family(model_dir, family, device=dev)
    lora = apply_adapter(b, adapter, lora_merge=False)
    enc = [b.tok.encode(p) for p in prompts]
    ids, mask = left_pad(enc, b.tok.pad_id)
    P = ids.shape[1]
    gen_ids = torch.tensor([r["ids"] for r in records], device=dev)
    n_new = gen_ids.shape[1]
    full = torch.cat([torch.as_tensor(ids, device=dev).long(), gen_ids],
                     dim=1)
    fmask = torch.cat([torch.as_tensor(mask, device=dev),
                       torch.ones_like(gen_ids, dtype=torch.int32)], dim=1)
    with torch.no_grad():
        h = b.model.hidden_states(b.config, b.params, full, fmask,
                                  lora=lora, attn_impl="plain",
                                  lora_impl="naive")
        h = h[:, P - 1:P - 1 + n_new]
        logits = h @ b.params[b.head_key].T
        logits = _head_lora(logits, h, None if lora is None
                            else lora["blocks"], "naive")
    chosen = logits.gather(-1, gen_ids[..., None])[..., 0]
    gap = float((logits.max(-1).values - chosen).max())
    del b, logits
    return gap


def generate_phase(torch, dev, kernels, gpt2, gemma):
    """cli.generate.main on both families at full width and depth, launch
    counts set to 0 just before each run: GPT-2 small, bf16, 8 ragged
    left-padded prompts of 8-128 tokens, 64 new tokens, greedy, the
    `train` adapter dynamic; Gemma-3-270M, bf16, 4 prompts of ~600 tokens
    (T > the 512 window), the head adapter dynamic, whole-prompt and with
    --prefill_chunk 256 (identical ids); then per family one f32 run of
    16 new tokens held by teacher forcing against a plain full forward.
    Row 13 must launch L x (N - 1) times a run, the flash forward L times
    a whole-prompt prefill, the LoRA epilogue at every adapter site of
    the prefill and of each decode step, nothing else."""
    from mobilefinetuner_tpu_torch.data.tokenizer_bpe import GPT2BPETokenizer
    from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
        GemmaTokenizer
    gpt2_dir, gpt2_adapter = gpt2
    gemma_dir, head_adapter = gemma
    N = GEN["new"]
    runs, launches = {}, {}
    fams = {"gpt2": (gpt2_dir, gpt2_adapter, GPT2BPETokenizer, LAYERS,
                     2 * LAYERS),
            "gemma": (gemma_dir, head_adapter, GemmaTokenizer, GEMMA_LAYERS,
                      GEMMA_SITES * GEMMA_LAYERS + 1)}
    plan = [("gpt2", "bfloat16", N, []),
            ("gpt2_tf32", "float32", GEN["tf_new"], ["--no_eos_stop"]),
            ("gemma", "bfloat16", N, []),
            ("gemma_chunked", "bfloat16", N,
             ["--prefill_chunk", str(GEN["chunk"])]),
            ("gemma_tf32", "float32", GEN["tf_new"], ["--no_eos_stop"])]
    prompts = {}
    for name, dtype, n_new, extra in plan:
        fam = name.split("_")[0]
        mdir, adapter, tok_cls, L, sites = fams[fam]
        if fam not in prompts:
            prompts[fam] = generate_prompts(tok_cls.from_pretrained(mdir),
                                            fam)
        argv = ["--pretrained_dir", mdir, "--lora_path", adapter,
                "--lora_dynamic", "--greedy", "--max_new_tokens",
                str(n_new), "--dtype", dtype, *extra]
        for p in prompts[fam][0]:
            argv += ["--prompt", p]
        stats = {}
        zero_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records = run_generate(argv, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts(kernels)
        P = max(prompts[fam][1])
        chunked = "--prefill_chunk" in extra
        windows = -(-P // GEN["chunk"]) if chunked else 0
        want = {k: 0 for k in kernels}
        want.update({
            "decode": L * (n_new - 1),
            "flash_fwd": 0 if chunked else L,
            "lora_epilogue": (sites * n_new if not chunked else
                              (sites - (fam == "gemma")) * windows + 1
                              + sites * (n_new - 1))})
        check(got == want, f"generate {name} launches {got}, expected "
              f"{want}")
        # the decode steps replayed one graph; the same run with eager
        # steps gives the same ids and launches
        check(stats["graph_captures"] == 1,
              f"generate {name}: {stats['graph_captures']} captures")
        eager_stats = {}
        eager_records = eager_twin(
            lambda: None, lambda _: run_generate(argv, eager_stats, True),
            kernels, got)
        check([r["ids"] for r in eager_records]
              == [r["ids"] for r in records],
              f"generate {name}: graphed ids differ from the eager run's")
        check(eager_stats["graph_captures"] == 0,
              f"generate {name}: the eager run captured a graph")
        print(f"generate {name} decode graph: 1 capture, CLI step p50 "
              f"{stats['decode_step_ms_p50']:.3f} ms graphed, "
              f"{eager_stats['decode_step_ms_p50']:.3f} eager; ids and "
              f"launches equal")
        check(len(records) == len(prompts[fam][0])
              and all(len(r["ids"]) <= n_new for r in records),
              f"generate {name}: records {[len(r['ids']) for r in records]}")
        if extra == ["--no_eos_stop"]:
            check(all(len(r["ids"]) == n_new for r in records),
                  f"generate {name}: rows shorter than {n_new}")
            gap = teacher_forced_check(torch, dev, fam, mdir, adapter,
                                       prompts[fam][0], records)
            print(f"generate {name}: teacher-forced max (max logit - chosen "
                  f"logit) {gap:.3e} (tolerance 1e-3)")
            check(gap <= 1e-3, f"generate {name}: a greedy token is not the "
                  f"plain forward's argmax (gap {gap:.3e})")
        runs[name] = {"dtype": dtype, "batch": len(records),
                      "prompt_tokens": prompts[fam][1], "new_tokens": n_new,
                      "tokens_per_s": stats["tokens_per_s"],
                      "prefill_ms": stats["prefill_ms"],
                      "first_token_ms": stats["first_token_ms"],
                      "decode_step_ms_p50": stats.get("decode_step_ms_p50"),
                      "decode_graph": {
                          "captures": stats["graph_captures"],
                          "eager_decode_step_ms_p50":
                              eager_stats["decode_step_ms_p50"],
                          "ids_equal_eager": True,
                          "launches_equal_eager": True},
                      "wall_s": wall, "ids": [r["ids"] for r in records]}
        launches[name] = got
    check(runs["gemma_chunked"]["ids"] == runs["gemma"]["ids"],
          "generate gemma: --prefill_chunk ids differ from the whole-prompt "
          "ids")
    for r in runs.values():
        r["ids_head"] = [ids[:8] for ids in r.pop("ids")]
    total = {k: sum(v[k] for v in launches.values()) for k in kernels}
    return runs, total, launches, prompts


def decode_step_events(torch, dev, model_dir, adapter, family, prompts):
    """Device time of one bf16 decode step (the CLI run's shape, the
    adapter dynamic) from CUDA events around CUDA-graph replays, and the
    time a step takes from the host (call_ms, events around eager
    calls)."""
    from mobilefinetuner_tpu_torch.cli.family import (apply_adapter,
                                                      load_family)
    from mobilefinetuner_tpu_torch.models import generate
    b = load_family(model_dir, family, device=dev)
    lora = apply_adapter(b, adapter, lora_merge=False)
    ids, mask = generate.left_pad([b.tok.encode(p) for p in prompts],
                                  b.tok.pad_id)
    ids = torch.as_tensor(ids, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    bf = torch.bfloat16
    with torch.no_grad():
        _, (pk, pv) = b.model.hidden_states(
            b.config, b.params, ids, mask, lora=lora, compute_dtype=bf,
            collect_kv=True)
        kc, vc = generate._caches(pk, pv, GEN["new"])
        decoder = (generate.gpt2_decoder if family == "gpt2"
                   else generate.gemma3_decoder)
        step = decoder(b.config, b.params, kc, vc, mask, lora, bf)
        tok = ids[:, -1].clone()
        t = torch.tensor(GEN["new"] // 2, device=dev)

        def fn():
            step(tok, t)
        dev_ms, wall_ms = graph_ms(fn, 20), call_ms(fn, 20)
    del b, kc, vc
    return dev_ms, wall_ms


def gemma_step(torch, dev, gemma, head: bool = False, dtype=None):
    """One Gemma-3-270M LoRA train step (batch 4 x 256, targets full, 8
    loss chunks; with `head`, the lm_head target too) in `dtype` (bf16
    by default), on a fixed random batch: a closure that runs it."""
    import dataclasses

    import numpy as np

    from mobilefinetuner_tpu_torch.cli.common import place_batch
    from mobilefinetuner_tpu_torch.lora.lora import (init_lora_gemma3,
                                                     trainable_mask)
    from mobilefinetuner_tpu_torch.models import gemma3
    from mobilefinetuner_tpu_torch.ops.loss import \
        chunked_lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    config, params, spec = gemma[:3]
    G = GEMMA
    if head:
        spec = dataclasses.replace(spec, targets=spec.targets + ["lm_head"])
    lora = init_lora_gemma3(config, spec, seed=42, device=dev)
    mask = trainable_mask(lora)
    tc = TrainConfig(total_steps=G["steps"], lr=G["lr"])

    def loss_fn(lora_t, frozen, mb):
        hidden = gemma3.hidden_states(config, frozen, mb["input_ids"],
                                      attention_mask=mb["attention_mask"],
                                      lora=lora_t,
                                      compute_dtype=dtype or torch.bfloat16)
        return chunked_lm_cross_entropy_sum(
            hidden, frozen["embed"], mb["labels"], num_chunks=G["chunks"],
            lora_head=lora_t["blocks"].get("lm_head"))

    step_fn = make_train_step(loss_fn, tc, mask)
    opt = init_optimizer(lora, tc, mask)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, config.vocab_size, (G["batch"], G["seq"]),
                       dtype=np.int32)
    batch = place_batch({"input_ids": ids, "labels": ids,
                         "attention_mask": np.ones((G["batch"], G["seq"]),
                                                   np.float32)}, dev)
    return lambda: step_fn(lora, params, opt, batch, 0)


def profile_gemma_train(torch, dev, gemma, head: bool = False):
    """Where one Gemma-3-270M LoRA train step (batch 4 x 256, bf16,
    targets full, 8 loss chunks; with `head`, the lm_head target too)
    spends its time."""
    name = "gemma_lora_head_train_step" if head else "gemma_lora_train_step"
    return profile_phases({name: (gemma_step(torch, dev, gemma, head), 3,
                                  True)})


def profile_gemma_full_ft(torch, dev, gemma):
    """Where one Gemma-3-270M full fine-tuning step (batch 4 x 256, bf16,
    8 loss chunks, every parameter trainable: rows 6-8, Adam over 268M
    parameters) spends its time."""
    return profile_phases({"gemma_full_ft_train_step": (
        gemma_full_step(torch, gemma, torch.bfloat16), 3, True)})


def gemma_full_step(torch, gemma, dtype):
    """One Gemma-3-270M full fine-tuning step (batch 4 x 256, 8 loss
    chunks, every parameter trainable: rows 6-8, Adam over 268M
    parameters) computing in `dtype`, on a fixed random batch: a closure
    that runs it (the step is functional: the parameters it is given stay
    as they are)."""
    import numpy as np

    from mobilefinetuner_tpu_torch.cli.common import place_batch
    from mobilefinetuner_tpu_torch.models import gemma3
    from mobilefinetuner_tpu_torch.ops.loss import \
        chunked_lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    config, params = gemma[:2]
    G = GEMMA
    tc = TrainConfig(total_steps=G["full_steps"], lr=G["full_lr"])

    def loss_fn(trainable, _frozen, mb):
        hidden = gemma3.hidden_states(config, trainable, mb["input_ids"],
                                      attention_mask=mb["attention_mask"],
                                      compute_dtype=dtype)
        return chunked_lm_cross_entropy_sum(
            hidden, trainable["embed"], mb["labels"], num_chunks=G["chunks"])

    step_fn = make_train_step(loss_fn, tc, None)
    opt = init_optimizer(params, tc, None)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, config.vocab_size, (G["batch"], G["seq"]),
                       dtype=np.int32)
    batch = place_batch({"input_ids": ids, "labels": ids,
                         "attention_mask": np.ones((G["batch"], G["seq"]),
                                                   np.float32)},
                        params["embed"].device)
    return lambda: step_fn(params, None, opt, batch, 0)


def bwd_sweep(torch, fa, dev):
    """The merged backward against the split pair at training shapes the
    port's models reach (bf16, causal): the time of one backward call
    between CUDA events, kernels and the wrappers' torch passes (zeroing,
    casts, the GQA sum) included. The data behind resolve_bwd_impl."""
    rows = []
    for B, Hq, Hkv, S, D in ((8, 12, 12, 128, 64), (8, 12, 12, 512, 64),
                             (2, 12, 12, 2048, 64), (4, 16, 16, 1024, 128),
                             (2, 8, 2, 1024, 256), (1, 4, 1, 4096, 256)):
        q, k, v, pad = flash_inputs(torch, dev, torch.bfloat16, B, Hq, Hkv,
                                    S, D, (S,) * B, seed=S + D)
        do = flash_inputs(torch, dev, torch.bfloat16, B, Hq, Hq, S, D,
                          (S,) * B, seed=S)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, pad)
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        args = (q, k, v, pad, lse, delta, do)
        kw = dict(scale=D ** -0.5)
        m = call_ms(lambda: fa.flash_attention_bwd_merged(*args, **kw), 10)
        sp = call_ms(lambda: fa.flash_attention_bwd_split(*args, **kw), 10)
        rows.append({"B": B, "Hq": Hq, "Hkv": Hkv, "S": S, "D": D,
                     "merged_ms": m, "split_ms": sp,
                     "auto": fa.resolve_bwd_impl(S, D, torch.bfloat16)})
    return rows


def epi_fns(torch, lf, y, xa, b, scale):
    """The epilogue kernel, its plain version and torch.addmm (alpha the
    scale: the same function up to where it rounds) on one site's
    inputs, for timed()."""
    return {"ms": lambda: lf.lora_epilogue(y, xa, b, scale),
            "plain_ms": lambda: lf.lora_epilogue_reference(y, xa, b, scale),
            "library_ms": lambda: torch.addmm(y, xa, b, alpha=EPI_SCALE)}


def epi_bound(y, xa, b, bnd=bound):
    """Read y, xa, B and the scale once, write out once; 2 N r d_out
    flops."""
    N, d_out = y.shape
    r = xa.shape[1]
    return bnd((2 * y.numel() + xa.numel() + b.numel()) * y.element_size()
               + 4, 2 * N * r * d_out)


def gemma_kernel_entries(torch, fa, lf, dev):
    """The flash forward, the merged backward and the LoRA epilogue at the
    Gemma LoRA step's shapes (batch 4 x 256, 4 q-heads over 1 kv-head,
    D 256, the 512 window, bf16; the gate_proj site, y 1024 x 2048, r 8):
    each held against its plain version with the bf16 tolerances of
    check_flash, check_flash_bwd and check_epilogue, then timed and
    bounded, as sub-entries of the kernels line."""
    B, Hq, Hkv, S, D, window = 4, 4, 1, 256, 256, 512
    bf = torch.bfloat16
    q, k, v, pad = flash_inputs(torch, dev, bf, B, Hq, Hkv, S, D, (S,) * B,
                                seed=11)
    do = flash_inputs(torch, dev, bf, B, Hq, Hq, S, D, (S,) * B, seed=12)[0]
    kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, pad, lse, delta, do)
    merged = fa.flash_attention_bwd_merged(*args, **kw)
    ref_m = fa.flash_bwd_merged_reference(*args, **kw)
    torch.cuda.synchronize()
    fwd_err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    bwd_err = max(max_err(a, b) for a, b in zip(merged, ref_m))
    bwd_rel = max(rel_err(a, b) for a, b in zip(merged, ref_m))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, scale=kw["scale"],
                   enable_gqa=True)
    pairs = B * Hq * S * (S + 1) // 2          # causal, window >= S
    isz = q.element_size()
    n_q, n_kv = q.numel(), k.numel()
    fwd_times = timed({
        "ms": lambda: fa.flash_attention_fwd(q, k, v, pad, **kw),
        "plain_ms": lambda: fa.flash_attention_reference(q, k, v, pad,
                                                         **kw),
        "library_ms": lambda: sdpa(q, k, v, is_causal=True,
                                   scale=kw["scale"], enable_gqa=True)},
        50)
    bwd_times = timed({
        "ms": lambda: fa.flash_attention_bwd_merged(*args, **kw),
        "plain_ms": lambda: fa.flash_bwd_merged_reference(*args, **kw),
        "library_ms": lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True)}, 50)
    g = torch.Generator(device=dev).manual_seed(13)
    y, xa, bm = (torch.randn(sh, generator=g, device=dev).to(bf)
                 for sh in ((B * S, 2048), (B * S, 8), (8, 2048)))
    es = torch.tensor(EPI_SCALE, device=dev)
    epi, _ = lf.lora_epilogue(y, xa, bm, es)
    epi_err = max_err(epi, lf.lora_epilogue_reference(y, xa, bm, es))
    print(f"gemma shapes, bf16: flash fwd max |out err| {fwd_err:.3e} "
          f"(tolerance 1e-2), max |lse err| {lse_err:.3e} (1e-4); merged "
          f"bwd max err / max(1, |ref|) {bwd_rel:.3e} (2e-2); epilogue "
          f"gate_proj max |err| {epi_err:.3e} (1e-2)")
    for t in (out, *merged, epi):
        check(bool(torch.isfinite(t).all()), "gemma-shape kernel non-finite")
    check(fwd_err <= 1e-2 and lse_err <= 1e-4, "flash fwd at the Gemma "
          "shape disagrees with its plain version")
    check(bwd_rel <= 2e-2, "merged bwd at the Gemma shape disagrees with "
          "its plain version")
    check(epi_err <= 1e-2, "LoRA epilogue at the Gemma shape disagrees "
          "with its plain version")
    epi_times = timed(epi_fns(torch, lf, y, xa, bm, es))
    shape = (f"q {B}x{Hq}x{S}x{D}, kv {B}x{Hkv}x{S}x{D}, bf16, causal, "
             f"window {window} (gemma)")
    return {
        "flash_fwd": kernel_entry(
            "flash_attention_fwd", "flash_attention_fwd_mma.cu",
            "flash_attention.py:162", None, fwd_err, fwd_times,
            bound((2 * n_q + 2 * n_kv) * isz + pad.numel() * 4
                  + B * Hq * S * 4, 4 * D * pairs), {"shape": shape}),
        "bwd_merged": kernel_entry(
            "flash_attention_bwd_merged", "flash_attention_bwd_merged_mma.cu",
            "flash_attention.py:415", None, bwd_err, bwd_times,
            bound((3 * n_q + 4 * n_kv) * isz + pad.numel() * 4
                  + 2 * B * Hq * S * 4, 10 * D * pairs), {"shape": shape}),
        "lora_epilogue": kernel_entry(
            "lora_epilogue", "lora_epilogue_vec.cu", "lora_fused.py:78",
            EPI_BY_SHAPE[(bf, *y.shape)], epi_err, epi_times,
            epi_bound(y, xa, bm),
            {"shape": "gate_proj: y 1024x2048, r 8, bf16 (gemma)"})}


def paged_library_chain(torch, q, pk, pv, tbl, layer, ok, scale):
    """Row 12's library yardstick, a two-call chain: gather each slot's
    pages of `layer` for every kv head (one index kernel each for K and
    V), then SDPA with the bool mask, the scale and enable_gqa."""
    S, KV, G, D = q.shape
    cols = ok.shape[1]
    kv = torch.arange(KV, device=q.device, dtype=torch.int32)[:, None]
    idx = tbl[:, None, :]
    qh = q.reshape(S, KV * G, 1, D)
    mask = ok[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def chain():
        kc = pk[idx, layer, kv].view(S, KV, cols, D)
        vc = pv[idx, layer, kv].view(S, KV, cols, D)
        return sdpa(qh, kc, vc, attn_mask=mask, scale=scale,
                    enable_gqa=True)
    return chain


def paged_entry(torch, da, case, bnd=bound, earlier=None):
    """Row 12's entry of the kernels line at one check_paged case: its
    times (in turns with `earlier`, a call of a first version on the same
    inputs, where given), the plain version's and the library chain's,
    its plan and its bound (`bnd`: bf16's, or f32_bound) from the
    attendable columns' K and V rows, q, tbl, ok and ctx; the source is
    the dtype's."""
    err, (q, pk, pv, tbl, layer, ok, scale) = case
    S, KV, G, D = q.shape
    M, bT = tbl.shape[1], pk.shape[3]
    chain = paged_library_chain(torch, q, pk, pv, tbl, layer, ok, scale)
    args = (q, pk, pv, tbl, layer, ok, scale)
    times = timed({"plain_ms": lambda: da.paged_attention(*args),
                   "library_ms": chain})
    times.update(timed({"ms": lambda: da.paged_decode_attention(*args)})
                 if earlier is None else
                 in_turns(lambda: da.paged_decode_attention(*args),
                          lambda: earlier(*args), 200))
    live = int(ok.sum()) * KV                  # attendable (slot, kv) rows
    isz = pk.element_size()
    bounds = bnd(2 * live * D * isz + q.numel() * isz + tbl.numel() * 4
                 + ok.numel() + q.numel() * 4, 4 * D * G * live)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = (da.paged_f32_plan if q.dtype == torch.float32 else
            da.paged_plan)(S, KV, G, M, bT, D, q.dtype, n_sm)
    extra = ({"earlier_max_abs_err": max_err(earlier(*args),
                                             da.paged_attention(*args))}
             if earlier is not None else {})
    return kernel_entry(
        "paged_decode_attention", da.paged_library(q.dtype)[0] + ".cu",
        "decode_attention.py:223", None, err, times, bounds,
        {"shape": f"q {S}x{KV}x{G}x{D}, {M} pages of {bT}, {q.dtype}, "
                  f"{int(ok.sum())} of {S * M * bT} columns attendable, "
                  f"{int(ok.reshape(S, M, bT).any(-1).sum())} live pages",
         "plan": {k: plan[k] for k in ("n_chunks", "cpc", "grid")},
         **extra,
         "library": "a two-call chain: the pages gathered (pool[tbl, "
                    "layer, kv], K and V), then SDPA (bool mask, scale, "
                    "enable_gqa)",
         "library_max_abs_err": max_err(
             chain().reshape(S, KV, G, D),
             da.paged_attention(q, pk, pv, tbl, layer, ok, scale))})


def decode_entry(torch, da, case, bnd=bound, earlier=None):
    """Row 13's entry of the kernels line at one check_decode case: its
    times (in turns with `earlier`, a call of a first version on the same
    inputs, where given), the plain version's and SDPA's (a bool mask,
    the scale and enable_gqa: the same function up to its output
    rounding), its plan and its bound (`bnd`: bf16's, or f32_bound) from
    the attendable columns' K and V, q, ok and ctx; the source is the
    dtype's."""
    err, (q, kc, vc, ok, scale) = case
    B, KV, G, D = q.shape
    T = kc.shape[2]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q.reshape(B, KV * G, 1, D)
    mask = ok[:, None, None, :]
    args = (q, kc, vc, ok, scale)
    times = timed({
        "plain_ms": lambda: da.xla_reference(*args),
        "library_ms": lambda: sdpa(qh, kc, vc, attn_mask=mask, scale=scale,
                                   enable_gqa=True)})
    times.update(timed({"ms": lambda: da.decode_attention(*args)})
                 if earlier is None else
                 in_turns(lambda: da.decode_attention(*args),
                          lambda: earlier(*args), 200))
    lib = sdpa(qh, kc, vc, attn_mask=mask, scale=scale, enable_gqa=True)
    # and with the masked columns zeroed instead of poisoned
    kz, vz = (t.masked_fill(~ok[:, None, :, None], 0) for t in (kc, vc))
    lib_clean = sdpa(qh, kz, vz, attn_mask=mask, scale=scale,
                     enable_gqa=True)
    live = int(ok.sum()) * KV                   # attendable (b, kv) rows
    isz = kc.element_size()
    bounds = bnd(2 * live * D * isz + q.numel() * isz + ok.numel()
                 + q.numel() * 4, 4 * D * G * live)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = (da.decode_f32_plan if q.dtype == torch.float32 else
            da.decode_mma_plan)(B, KV, G, T, D, q.dtype, n_sm)
    extra = ({"earlier_max_abs_err": max_err(earlier(*args),
                                             da.xla_reference(*args))}
             if earlier is not None else {})
    return kernel_entry(
        "decode_attention", da.decode_library(q.dtype)[0] + ".cu",
        "decode_attention.py:137", None, err, times, bounds,
        {"shape": f"q {B}x{KV}x{G}x{D}, cache T {T}, {q.dtype}, "
                  f"{int(ok.sum())} of {B * T} columns attendable",
         "plan": {k: plan[k] for k in ("n_chunks", "tiles_per_chunk",
                                       "cpc", "grid") if k in plan},
         **extra,
         "library_max_abs_err": max_err(
             lib.reshape(B, KV, G, D),
             da.xla_reference(q, kc, vc, ok, scale)),
         "library_max_abs_err_unpoisoned": max_err(
             lib_clean.reshape(B, KV, G, D),
             da.xla_reference(q, kz, vz, ok, scale))})


CE_KEYS = ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")
CE_LORA_KEYS = ("fused_ce_fwd_lora", "fused_ce_dh_lora", "fused_ce_dw_lora",
                "fused_ce_dw_lora_dw_mode")


def fused_ce_times(torch, fc, args, keys=CE_KEYS, bnd=bound):
    """Times (of `keys`) and bounds (`bnd`: bf16's, or f32_bound) of the
    fused CE kernels at the Gemma chunk shape; the library yardstick is
    the unfused PyTorch pair: h @ W^T, then logsumexp and a gather (row 6)
    and autograd of that for h (row 7) or W (row 8), the `autograd.grad`
    call only."""
    h, w, lab, lse, dl, dg = args
    R, H = h.shape
    V = w.shape[0]
    hl = h.detach().clone().requires_grad_(True)
    wl = w.detach().clone().requires_grad_(True)

    def lib_fwd(hh, ww):
        logits = (hh @ ww.T).float()
        return torch.logsumexp(logits, -1), logits.gather(1, lab[:, None])

    lse_l, gold_l = lib_fwd(hl, wl)
    obj = (lse_l * dl).sum() + (gold_l[:, 0] * dg).sum()
    bwd = (h, w, lab, lse, dl, dg)
    fns = {
        "fused_ce_fwd": {
            "ms": lambda: fc.fused_ce_fwd(h, w, lab),
            "plain_ms": lambda: fc.fused_ce_fwd_reference(h, w, lab),
            "library_ms": lambda: lib_fwd(h, w)},
        "fused_ce_dh": {
            "ms": lambda: fc.fused_ce_bwd_dh(*bwd),
            "plain_ms": lambda: fc.fused_ce_dh_reference(*bwd),
            "library_ms": lambda: torch.autograd.grad(
                obj, [hl], retain_graph=True)},
        "fused_ce_dw": {
            "ms": lambda: fc.fused_ce_bwd_dw(*bwd),
            "plain_ms": lambda: fc.fused_ce_dw_reference(*bwd),
            "library_ms": lambda: torch.autograd.grad(
                obj, [wl], retain_graph=True)}}
    times = {key: timed(fns[key], 20) for key in keys}
    ins = (R * H + V * H) * h.element_size() + R * lab.element_size()
    rows = 3 * R * 4                       # lse, dlse, dgold
    bounds = {"fused_ce_fwd": bnd(ins + 2 * R * 4, 2 * R * V * H),
              "fused_ce_dh": bnd(ins + rows + R * H * 4, 4 * R * V * H),
              "fused_ce_dw": bnd(ins + rows + V * H * 4, 4 * R * V * H)}
    return times, bounds


def fused_ce_lora_times(torch, fc, args, keys=CE_LORA_KEYS, bnd=bound):
    """Times (of `keys`) and bounds (`bnd`) of the head-adapter kernels
    (rows 9-11) at the Gemma chunk shape, row 11 in its dbt-only mode
    (the main path's: the tied embedding is frozen) and in its dW mode.
    The library yardstick is
    the unfused PyTorch chain: h @ W^T + xa @ bt^T, logsumexp and a
    gather (row 9), and autograd of that for (h, xa) (row 10), for bt
    with W frozen (row 11) or for (W, bt) (row 11, dW mode), the
    `autograd.grad` call only."""
    h, w, xa, bt, lab, lse, dl, dg = args
    R, H = h.shape
    V, r = bt.shape
    leaves = [t.detach().clone().requires_grad_(True) for t in (h, w, xa,
                                                                 bt)]

    def lib_fwd(hh, ww, aa, bb):
        logits = (hh @ ww.T).float() + (aa @ bb.T).float()
        return torch.logsumexp(logits, -1), logits.gather(1, lab[:, None])

    lse_l, gold_l = lib_fwd(*leaves)
    obj = (lse_l * dl).sum() + (gold_l[:, 0] * dg).sum()
    bwd = (h, w, xa, bt, lab, lse, dl, dg)
    lh, lw, lxa, lbt = leaves
    fns = {
        "fused_ce_fwd_lora": {
            "ms": lambda: fc.fused_ce_fwd_lora(h, w, xa, bt, lab),
            "plain_ms": lambda: fc.fused_ce_fwd_lora_reference(h, w, xa, bt,
                                                               lab),
            "library_ms": lambda: lib_fwd(h, w, xa, bt)},
        "fused_ce_dh_lora": {
            "ms": lambda: fc.fused_ce_bwd_dh_lora(*bwd),
            "plain_ms": lambda: fc.fused_ce_dh_lora_reference(*bwd),
            "library_ms": lambda: torch.autograd.grad(
                obj, [lh, lxa], retain_graph=True)},
        "fused_ce_dw_lora": {
            "ms": lambda: fc.fused_ce_bwd_dw_lora(*bwd, want_dw=False),
            "plain_ms": lambda: fc.fused_ce_dw_lora_reference(
                *bwd, want_dw=False),
            "library_ms": lambda: torch.autograd.grad(
                obj, [lbt], retain_graph=True)},
        "fused_ce_dw_lora_dw_mode": {
            "ms": lambda: fc.fused_ce_bwd_dw_lora(*bwd),
            "plain_ms": lambda: fc.fused_ce_dw_lora_reference(*bwd),
            "library_ms": lambda: torch.autograd.grad(
                obj, [lw, lbt], retain_graph=True)}}
    times = {key: timed(fns[key], 20) for key in keys}
    isz = h.element_size()
    ins = (R * H + V * H + R * r + V * r) * isz + R * lab.element_size()
    rows = 3 * R * 4                       # lse, dlse, dgold
    logit_ops = 2 * R * V * (H + r)
    bounds = {
        "fused_ce_fwd_lora": bnd(ins + 2 * R * 4, logit_ops),
        "fused_ce_dh_lora": bnd(ins + rows + R * (H + r) * 4,
                                2 * logit_ops),
        "fused_ce_dw_lora": bnd(ins + rows + V * r * 4,
                                logit_ops + 2 * R * V * r),
        "fused_ce_dw_lora_dw_mode": bnd(ins + rows + V * (H + r) * 4,
                                        2 * logit_ops)}
    return times, bounds


def fma_dh(torch, fc, h, w, labels, rows, lora=None):
    """dh (and dxa with lora = (xa, bt)) through rows 7 and 10's f32 FMA
    first versions (fused_ce.cu's mft_fused_ce_dh and
    mft_fused_ce_dh_lora, on their own slab plan), which no path runs
    since f32 moved to the 3xTF32 kernels. Their times, in turns beside
    the new kernels', are the rows' earlier times; their launches are
    outside the wrappers' counts."""
    from mobilefinetuner_tpu_torch.kernels import build
    R, H = h.shape
    V = w.shape[0]
    n_slabs, per_slab = fc._slabs(R, V, h.device, 2)
    lab = fc._labels(labels, h)
    part = torch.empty(n_slabs, R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    ins = (lab.data_ptr(), *(t.data_ptr() for t in rows))
    tail = (n_slabs, per_slab, 0, fc._stream(h))
    if lora is None:
        build.check_launch("fused_ce.cu dh", fc._fn("mft_fused_ce_dh", 8, 6)(
            h.data_ptr(), w.data_ptr(), *ins, part.data_ptr(),
            dh.data_ptr(), R, V, H, *tail))
        return dh
    xa, bt = lora
    r = xa.shape[1]
    xpart = torch.empty(n_slabs, R, r, device=h.device)
    dxa = torch.empty(R, r, device=h.device)
    build.check_launch("fused_ce.cu dh_lora", fc._fn(
        "mft_fused_ce_dh_lora", 12, 7)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(), *ins,
        part.data_ptr(), dh.data_ptr(), xpart.data_ptr(), dxa.data_ptr(), R,
        V, H, r, *tail))
    return dh, dxa


def f32_path_entries(torch, fa, da, dev, paged_f32, gen_prompts,
                     launches):
    """Rows 1-2, 12 and 13 in f32 at the shapes the default-dtype paths
    run them: the flash forward and merged backward (3xTF32) at
    `gemma_train_f32`'s q 4 x 4 x 256 x 256, kv 4 x 1, window 512 (held
    against the plain versions: out and lse 1e-4, the backward 1e-4 of
    max(1, |ref|); beside SDPA and its autograd in f32); the paged decode
    (paged_decode_attention_vec_f32.cu) at `gemma_serve_f32`'s 8 slots x
    42 pages (check_paged's case; beside the bf16 entry's chain, in f32);
    the contiguous decode (decode_attention_split_f32.cu) at `generate`'s
    f32 last steps, GPT-2 (8 x 12 x 1 x 64) and Gemma (4 x 1 x 4 x 256,
    window 512), the caches P + 16 long, masked columns poisoned (held at
    1e-5; beside SDPA in f32); rows 12 and 13 timed in turns with their
    first versions (fma_paged, fma_decode). Each bounded at the 3xTF32
    rate, with those
    paths' f32 launches (`launches`: {"flash_fwd", "bwd_merged", "paged",
    "decode_gpt2", "decode_gemma"}). Returns {name: entry}."""
    f32 = torch.float32
    B, Hq, Hkv, S, D, window = 4, 4, 1, 256, 256, 512
    q, k, v, pad = flash_inputs(torch, dev, f32, B, Hq, Hkv, S, D, (S,) * B,
                                seed=11)
    do = flash_inputs(torch, dev, f32, B, Hq, Hq, S, D, (S,) * B,
                      seed=12)[0]
    kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window)
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
    delta = (do * out).sum(-1, keepdim=True)
    args = (q, k, v, pad, lse, delta, do)
    merged = fa.flash_attention_bwd_merged(*args, **kw)
    ref_m = fa.flash_bwd_merged_reference(*args, **kw)
    torch.cuda.synchronize()
    fwd_err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    bwd_err = max(max_err(a, b) for a, b in zip(merged, ref_m))
    bwd_rel = max(rel_err(a, b) for a, b in zip(merged, ref_m))
    check(fwd_err <= 1e-4 and lse_err <= 1e-4, f"f32 flash fwd at the "
          f"gemma_train_f32 shape: {fwd_err:.3e}, lse {lse_err:.3e}")
    check(bwd_rel <= 1e-4, f"f32 merged bwd at the gemma_train_f32 shape: "
          f"{bwd_rel:.3e}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True, scale=kw["scale"],
                   enable_gqa=True)
    pairs = B * Hq * S * (S + 1) // 2          # causal, window >= S
    n_q, n_kv = q.numel(), k.numel()
    fwd_times = timed({
        "ms": lambda: fa.flash_attention_fwd(q, k, v, pad, **kw),
        "plain_ms": lambda: fa.flash_attention_reference(q, k, v, pad,
                                                         **kw),
        "library_ms": lambda: sdpa(q, k, v, is_causal=True,
                                   scale=kw["scale"], enable_gqa=True)},
        30)
    bwd_times = timed({
        "ms": lambda: fa.flash_attention_bwd_merged(*args, **kw),
        "plain_ms": lambda: fa.flash_bwd_merged_reference(*args, **kw),
        "library_ms": lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True)}, 30)
    shape = (f"q {B}x{Hq}x{S}x{D}, kv {B}x{Hkv}x{S}x{D}, f32, causal, "
             f"window {window} (gemma_train_f32)")
    out_entries = {
        "flash_fwd": kernel_entry(
            "flash_attention_fwd", "flash_attention_fwd_tf32.cu",
            "flash_attention.py:162", launches["flash_fwd"],
            max(fwd_err, lse_err), fwd_times,
            f32_bound((2 * n_q + 2 * n_kv) * 4 + pad.numel() * 4
                      + B * Hq * S * 4, 4 * D * pairs), {"shape": shape}),
        "bwd_merged": kernel_entry(
            "flash_attention_bwd_merged", "flash_attention_bwd_merged_tf32.cu",
            "flash_attention.py:415", launches["bwd_merged"], bwd_err,
            bwd_times,
            f32_bound((3 * n_q + 4 * n_kv) * 4 + pad.numel() * 4
                      + 2 * B * Hq * S * 4, 10 * D * pairs),
            {"shape": shape, "max_err_over_max1_ref": bwd_rel})}
    del merged, ref_m, lib_out, leaves
    out_entries["paged"] = dict(
        paged_entry(torch, da, paged_f32, f32_bound, earlier=fma_paged),
        launches=launches["paged"], earlier="paged_decode_attention.cu")
    for fam, (KV, G, D, window) in (("gpt2", (12, 1, 64, None)),
                                    ("gemma", (1, 4, 256, GEN["window"]))):
        lens = gen_prompts[fam][1]
        P = max(lens)
        T = P + GEN["tf_new"]
        q, kc, vc, ok = decode_inputs(torch, dev, f32, len(lens), KV, G, T,
                                      D, seed=T + D,
                                      n_pad=[P - n for n in lens],
                                      window=window)
        scale = D ** -0.5
        err = max_err(da.decode_attention(q, kc, vc, ok, scale),
                      da.xla_reference(q, kc, vc, ok, scale))
        check(err <= 1e-5, f"f32 decode at generate's {fam} last step: "
              f"max |ctx err| {err:.3e}")
        out_entries[f"decode_{fam}"] = dict(
            decode_entry(torch, da, (err, (q, kc, vc, ok, scale)),
                         f32_bound, earlier=fma_decode),
            launches=launches[f"decode_{fam}"],
            path=f"generate {fam}_tf32 (f32), last step",
            earlier="decode_attention.cu")
    print("f32 at the default-dtype paths' shapes: " + ", ".join(
        f"{k} {e['ms'] * 1e3:.2f} us (library {e['library_ms'] * 1e3:.2f}, "
        f"bound {e['bound_ms'] * 1e3:.2f}"
        + (f", first version {e['earlier_ms'] * 1e3:.2f}"
           if "earlier_ms" in e else "") + ")"
        for k, e in out_entries.items()))
    return out_entries


def fma_paged(q, pk, pv, tbl, layer, ok, scale):
    """ctx through row 12's f32 first version (paged_decode_attention.cu's
    mft_paged_decode_attention: one CTA a query head and slot), which no
    path runs since f32 moved to paged_decode_attention_vec_f32.cu; its
    launches are outside the wrapper's count."""
    import ctypes

    import torch

    from mobilefinetuner_tpu_torch.kernels import build
    fn = build.load("paged_decode_attention").mft_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    S, KV, G, D = q.shape
    NB, L, _, bT, _ = pk.shape
    ctx = torch.empty(S, KV, G, D, device=q.device)
    build.check_launch("paged_decode_attention.cu", fn(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), tbl.data_ptr(),
        ok.data_ptr(), ctx.data_ptr(), S, KV, G, D, NB, L, int(layer), bT,
        tbl.shape[1], 0, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream))
    return ctx


def fma_decode(q, kc, vc, ok, scale):
    """ctx through row 13's f32 first version (decode_attention.cu's
    mft_decode_attention: one CTA a query head and batch row), which no
    path runs since f32 moved to decode_attention_split_f32.cu; its
    launches are outside the wrapper's count."""
    import ctypes

    import torch

    from mobilefinetuner_tpu_torch.kernels import build
    fn = build.load("decode_attention").mft_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, KV, G, D = q.shape
    ctx = torch.empty(B, KV, G, D, device=q.device)
    build.check_launch("decode_attention.cu", fn(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ok.data_ptr(),
        ctx.data_ptr(), B, KV, G, D, kc.shape[2], 0, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream))
    return ctx


def fma_dw(torch, fc, h, w, labels, rows):
    """dW through row 8's f32 FMA first version (fused_ce.cu's
    mft_fused_ce_dw), which no path runs since f32 moved to
    fused_ce_dw_tf32.cu; its launches are outside the wrapper's count."""
    from mobilefinetuner_tpu_torch.kernels import build
    R, H = h.shape
    V = w.shape[0]
    dw = torch.empty(V, H, device=h.device)
    build.check_launch("fused_ce.cu dw", fc._fn("mft_fused_ce_dw", 7, 4)(
        h.data_ptr(), w.data_ptr(), fc._labels(labels, h).data_ptr(),
        *(t.data_ptr() for t in rows), dw.data_ptr(), R, V, H, 0,
        fc._stream(h)))
    return dw


def fma_epilogue(torch, lf, y, xa, b, scale):
    """out through row 5's f32 first version as the wrapper ran it before
    f32 moved to lora_epilogue_vec_f32.cu: xs = scaled_bottleneck(xa,
    scale) in launches of its own, then lora_epilogue.cu's
    mft_lora_epilogue; its launches are outside the wrapper's count."""
    import ctypes

    from mobilefinetuner_tpu_torch.kernels import build
    fn = build.load("lora_epilogue").mft_lora_epilogue
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    N, d_out = y.shape
    xs = lf.scaled_bottleneck(xa, scale, y.dtype)
    out = torch.empty_like(y)
    build.check_launch("lora_epilogue.cu", fn(
        y.data_ptr(), xs.data_ptr(), b.data_ptr(), out.data_ptr(), N, d_out,
        xa.shape[1], 0, torch.cuda.current_stream(y.device).cuda_stream))
    return out


def fma_fwd(torch, fc, h, w, labels):
    """(lse, gold) through row 6's f32 FMA first version (fused_ce.cu's
    mft_fused_ce_fwd and its merge pass, on its own slab plan), which no
    path runs since f32 moved to fused_ce_fwd_tf32.cu; its launches are
    outside the wrapper's count."""
    from mobilefinetuner_tpu_torch.kernels import build
    code, lse, gold = fc._launch_fwd(h, w, labels, None)
    build.check_launch("fused_ce.cu fwd", code)
    return lse, gold


def fma_fwd_lora(torch, fc, h, w, xa, bt, labels):
    """(lse, gold) through row 9's f32 FMA first version (fused_ce.cu's
    mft_fused_ce_fwd_lora and its merge pass, on its own slab plan), which
    no path runs since f32 moved to fused_ce_fwd_lora_tf32.cu; its
    launches are outside the wrapper's count."""
    from mobilefinetuner_tpu_torch.kernels import build
    code, lse, gold = fc._launch_fwd(h, w, labels, (xa, bt))
    build.check_launch("fused_ce.cu fwd_lora", code)
    return lse, gold


def fma_dbt(torch, fc, h, w, xa, bt, labels, rows):
    """dbt through row 11's f32 FMA first version (fused_ce.cu's
    mft_fused_ce_dw_lora with no dW), which no path runs since f32's
    dbt-only mode moved to fused_ce_dbt_tf32.cu; its launches are outside
    the wrapper's count."""
    from mobilefinetuner_tpu_torch.kernels import build
    R, H = h.shape
    V, r = bt.shape
    dbt = torch.empty(V, r, device=h.device)
    build.check_launch("fused_ce.cu dbt", fc._fn("mft_fused_ce_dw_lora", 10,
                                                 5)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        fc._labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
        None, dbt.data_ptr(), R, V, H, r, 0, fc._stream(h)))
    return dbt


def f32_ce_entries(torch, fc, lf, dev, ce_f32, ptxas):
    """Row 5 and the fused CE rows in f32, every CLI's default dtype:
    row 5 on lora_epilogue_vec_f32.cu at GPT-2's attn_qkv, y 1024 x 2304,
    r 8, timed in turns with its first version (lora_epilogue.cu) after
    the wrapper's fold it needed (fma_epilogue); at the Gemma chunk (R
    128, V 262,144, H 640; rows 9-11 at r 8, row 11 in its dbt-only mode)
    rows 6, 7, 8, 9, 10 and 11 on their 3xTF32 kernels
    (fused_ce_fwd_tf32.cu, fused_ce_dh_tf32.cu, fused_ce_dw_tf32.cu,
    fused_ce_fwd_lora_tf32.cu, fused_ce_dh_lora_tf32.cu,
    fused_ce_dbt_tf32.cu), each timed in turns with its fused_ce.cu first
    version (fma_fwd, fma_dh, fma_dw, fma_fwd_lora, fma_dbt; held against
    the plain version too), rows 6, 8, 9 and 11 with two calls
    bit-identical, and rows 7, 8, 10 and 11 also held against the plain
    version with dgold = 0 (the softmax part, over max |ref|). Each
    is held against its plain version (check_epilogue's and
    check_fused_ce's f32 tolerances), timed beside the bf16 entries'
    library call run in f32 (TF32 off) and bounded at the 3xTF32 rate,
    with the f32 launches the paths made at that shape: row 5's from
    EPI_BY_SHAPE, the fused CE's from `ce_f32` ({wrapper key: {path:
    launches}} of CE_F32_PATHS, the runs whose loss is f32). Returns
    {kernels line name: entry}."""
    f32 = torch.float32
    g = torch.Generator().manual_seed(41)
    y, xa, bm = (torch.randn(sh, generator=g).to(dev)
                 for sh in ((1024, 2304), (1024, 8), (8, 2304)))
    es = torch.tensor(EPI_SCALE, device=dev)
    ref5 = lf.lora_epilogue_reference(y, xa, bm, es)
    e5 = max_err(lf.lora_epilogue(y, xa, bm, es)[0], ref5)
    e5_old = max_err(fma_epilogue(torch, lf, y, xa, bm, es), ref5)
    check(max(e5, e5_old) <= 1e-5, f"f32 LoRA epilogue at attn_qkv: max "
          f"|err| {e5:.3e}, first version {e5_old:.3e}")
    times5 = timed(epi_fns(torch, lf, y, xa, bm, es))
    times5.update(in_turns(lambda: lf.lora_epilogue(y, xa, bm, es),
                           lambda: fma_epilogue(torch, lf, y, xa, bm, es),
                           200))
    print(f"f32 LoRA epilogue at attn_qkv: {times5['ms'][0] * 1e3:.2f} us "
          f"(lora_epilogue_vec_f32.cu) against "
          f"{times5['earlier_ms'][0] * 1e3:.2f} (lora_epilogue.cu with the "
          f"fold) in turns, addmm {times5['library_ms'][0] * 1e3:.2f}; max "
          f"|err| {e5:.3e} / {e5_old:.3e}")
    out = {"lora_epilogue": kernel_entry(
        "lora_epilogue", "lora_epilogue_vec_f32.cu", "lora_fused.py:78",
        EPI_BY_SHAPE[(f32, 1024, 2304)], e5, times5,
        epi_bound(y, xa, bm, f32_bound),
        {"shape": "attn_qkv: y 1024x2304, r 8, f32",
         "earlier": "lora_epilogue.cu after the wrapper's fold "
                    "(scaled_bottleneck)",
         "earlier_max_abs_err": e5_old,
         "ptxas": ptxas["lora_epilogue_vec_f32"]})}
    h, w, lab, dl, dg = fused_ce_inputs(torch, dev, f32, 128, 262144, 640,
                                        seed=43)
    g = torch.Generator(device=dev).manual_seed(44)
    xa = torch.randn(128, 8, generator=g, device=dev)
    bt = 0.05 * torch.randn(262144, 8, generator=g, device=dev)
    rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
    rll, rlg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    ce = (h, w, lab, rl, dl, dg)
    lora = (h, w, xa, bt, lab, rll, dl, dg)
    lse, gold = fc.fused_ce_fwd(h, w, lab)
    lse_l, gold_l = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    dbt = fc.fused_ce_bwd_dw_lora(*lora, want_dw=False)[1]
    dw = fc.fused_ce_bwd_dw(*ce)
    ref_dw = fc.fused_ce_dw_reference(*ce)
    e8 = rel_err(dw, ref_dw)
    dw_twice = bool(torch.equal(dw, fc.fused_ce_bwd_dw(*ce)))
    del dw
    ref_dh = fc.fused_ce_dh_reference(*ce)
    ref_dhl = fc.fused_ce_dh_lora_reference(*lora)
    ref_dbt = fc.fused_ce_dw_lora_reference(*lora, want_dw=False)[1]
    errs = {
        "fused_ce_fwd": max(max_err(lse, rl), max_err(gold, rg)),
        "fused_ce_dh": rel_err(fc.fused_ce_bwd_dh(*ce), ref_dh),
        "fused_ce_dw": e8,
        "fused_ce_fwd_lora": max(max_err(lse_l, rll), max_err(gold_l, rlg)),
        "fused_ce_dh_lora": max(rel_err(a, b) for a, b in zip(
            fc.fused_ce_bwd_dh_lora(*lora), ref_dhl)),
        "fused_ce_dw_lora": rel_err(dbt, ref_dbt)}
    lse2, gold2 = fc.fused_ce_fwd(h, w, lab)
    lse_l2, gold_l2 = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    twice = {"fused_ce_fwd": bool(torch.equal(lse, lse2)
                                  and torch.equal(gold, gold2)),
             "fused_ce_fwd_lora": bool(torch.equal(lse_l, lse_l2)
                                       and torch.equal(gold_l, gold_l2)),
             "fused_ce_dw_lora": bool(torch.equal(
                 dbt, fc.fused_ce_bwd_dw_lora(*lora, want_dw=False)[1])),
             "fused_ce_dw": dw_twice}
    z = torch.zeros_like(dg)
    ce0, lora0 = ce[:5] + (z,), lora[:7] + (z,)
    sm = {"fused_ce_dh": scaled_err(fc.fused_ce_bwd_dh(*ce0),
                                    fc.fused_ce_dh_reference(*ce0)),
          "fused_ce_dw": scaled_err(fc.fused_ce_bwd_dw(*ce0),
                                    fc.fused_ce_dw_reference(*ce0)),
          "fused_ce_dh_lora": max(scaled_err(a, b) for a, b in zip(
              fc.fused_ce_bwd_dh_lora(*lora0),
              fc.fused_ce_dh_lora_reference(*lora0))),
          "fused_ce_dw_lora": scaled_err(
              fc.fused_ce_bwd_dw_lora(*lora0, want_dw=False)[1],
              fc.fused_ce_dw_lora_reference(*lora0, want_dw=False)[1])}
    lse_f, gold_f = fma_fwd(torch, fc, h, w, lab)
    lse_lf, gold_lf = fma_fwd_lora(torch, fc, h, w, xa, bt, lab)
    earlier = {"fused_ce_fwd": max(max_err(lse_f, rl), max_err(gold_f, rg)),
               "fused_ce_fwd_lora": max(max_err(lse_lf, rll),
                                        max_err(gold_lf, rlg)),
               "fused_ce_dh": rel_err(fma_dh(torch, fc, h, w, lab, ce[3:]),
                                      ref_dh),
               "fused_ce_dw": rel_err(fma_dw(torch, fc, h, w, lab, ce[3:]),
                                      ref_dw),
               "fused_ce_dh_lora": max(rel_err(a, b) for a, b in zip(
                   fma_dh(torch, fc, h, w, lab, lora[5:], (xa, bt)),
                   ref_dhl)),
               "fused_ce_dw_lora": rel_err(
                   fma_dbt(torch, fc, h, w, xa, bt, lab, lora[5:]),
                   ref_dbt)}
    del ref_dh, ref_dw, ref_dhl, ref_dbt, lse_f, gold_f, lse_lf, gold_lf
    print("f32 fused CE at the Gemma chunk (R 128, V 262144, H 640, r 8): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; softmax part (dgold = 0) over max |ref| " + ", ".join(
              f"{k} {v:.3e}" for k, v in sm.items())
          + "; first versions of rows 6 / 9 / 7 / 8 / 10 / 11 " + ", ".join(
              f"{k} {v:.3e}" for k, v in earlier.items())
          + f" (tolerance 1e-4); two calls identical: {twice}")
    check(max(*errs.values(), *sm.values(), *earlier.values()) <= 1e-4,
          f"f32 fused CE at the Gemma chunk disagrees with its plain "
          f"versions: {errs}, {sm}, first versions {earlier}")
    check(all(twice.values()), f"f32 fused CE: two calls gave different "
          f"bits: {twice}")
    times, bounds = fused_ce_times(torch, fc, ce, CE_KEYS, f32_bound)
    lora_times, lora_bounds = fused_ce_lora_times(
        torch, fc, lora, CE_LORA_KEYS[:3], f32_bound)
    times.update(lora_times)
    bounds.update(lora_bounds)
    times["fused_ce_fwd"].update(in_turns(
        lambda: fc.fused_ce_fwd(h, w, lab),
        lambda: fma_fwd(torch, fc, h, w, lab), 10))
    times["fused_ce_dh"].update(in_turns(
        lambda: fc.fused_ce_bwd_dh(*ce),
        lambda: fma_dh(torch, fc, h, w, lab, ce[3:]), 10))
    times["fused_ce_dw"].update(in_turns(
        lambda: fc.fused_ce_bwd_dw(*ce),
        lambda: fma_dw(torch, fc, h, w, lab, ce[3:]), 10))
    times["fused_ce_fwd_lora"].update(in_turns(
        lambda: fc.fused_ce_fwd_lora(h, w, xa, bt, lab),
        lambda: fma_fwd_lora(torch, fc, h, w, xa, bt, lab), 10))
    times["fused_ce_dh_lora"].update(in_turns(
        lambda: fc.fused_ce_bwd_dh_lora(*lora),
        lambda: fma_dh(torch, fc, h, w, lab, lora[5:], (xa, bt)), 10))
    times["fused_ce_dw_lora"].update(in_turns(
        lambda: fc.fused_ce_bwd_dw_lora(*lora, want_dw=False),
        lambda: fma_dbt(torch, fc, h, w, xa, bt, lab, lora[5:]), 10))
    lines = {"fused_ce_fwd": ("fused_ce_fwd", "fused_ce.py:121", "",
                              "fused_ce_fwd_tf32.cu"),
             "fused_ce_dh": ("fused_ce_bwd_dh", "fused_ce.py:196", "",
                             "fused_ce_dh_tf32.cu"),
             "fused_ce_dw": ("fused_ce_bwd_dw", "fused_ce.py:224", "",
                             "fused_ce_dw_tf32.cu"),
             "fused_ce_fwd_lora": ("fused_ce_fwd_lora", "fused_ce.py:350",
                                   ", r 8", "fused_ce_fwd_lora_tf32.cu"),
             "fused_ce_dh_lora": ("fused_ce_bwd_dh_lora", "fused_ce.py:384",
                                  ", r 8", "fused_ce_dh_lora_tf32.cu"),
             "fused_ce_dw_lora": ("fused_ce_bwd_dw_lora", "fused_ce.py:421",
                                  ", r 8, dbt only (frozen head)",
                                  "fused_ce_dbt_tf32.cu")}
    for key, (name, line, tail, source) in lines.items():
        extra = {"shape": f"R 128, V 262144, H 640{tail}, f32 (gemma "
                          f"chunk)",
                 "launches_by_path": ce_f32[key]}
        if key in earlier:
            extra.update(earlier="fused_ce.cu (FMA first version)",
                         earlier_max_abs_err=earlier[key],
                         ptxas=ptxas[source[:-3]])
        if key in sm:
            extra["softmax_part_err"] = sm[key]
        if key == "fused_ce_dw":
            extra["earlier_ptxas"] = [row for row in ptxas["fused_ce"]
                                      if row[0].startswith("dw_kernel<f32")]
        out[name] = kernel_entry(name, source, line,
                                 sum(ce_f32[key].values()), errs[key],
                                 times[key], bounds[key], extra)
    return out


# --------------------------------------------------------------- main ------

# ------------------------------------------ admission and fault tolerance ---

# every CLI run of the paths writes its telemetry stream here (main() sets
# the directory); `admitted` reads each run's mem_check verdicts, and the
# first flush's measured peak of the trained runs, into ADMISSION
STREAMS = {"dir": None}
ADMISSION = {}


def telemetry_argv(name: str) -> list:
    """--telemetry_out for run `name` (a fresh stream)."""
    path = os.path.join(STREAMS["dir"], f"{name}.jsonl")
    if os.path.exists(path):
        os.unlink(path)
    return ["--telemetry_out", path]


def read_stream(path: str) -> list:
    """A run's telemetry events, each checked against the schema (the
    port's validate_event: the JAX package's rules, held equal by
    tests/test_torch_telemetry.py) and in increasing seq."""
    from mobilefinetuner_tpu_torch.core.telemetry import validate_event
    with open(path) as f:
        evs = [json.loads(line) for line in f if line.strip()]
    for e in evs:
        check(validate_event(e) is None,
              f"{path}: invalid event {e}: {validate_event(e)}")
    seqs = [e["seq"] for e in evs]
    check(all(a < b for a, b in zip(seqs, seqs[1:])), f"{path}: seq {seqs}")
    return evs


def admitted(name: str, trained: bool = True) -> dict:
    """A path's run admitted as it was before the memory guard existed:
    every mem_check "ok" and no degrade; for a trained run the estimate
    (its last mem_check) not below the peak the first flush measured
    (`step_stats.peak_mb`, torch.cuda's allocated-bytes peak)."""
    evs = read_stream(os.path.join(STREAMS["dir"], f"{name}.jsonl"))
    mcs = [e for e in evs if e["event"] == "mem_check"]
    check(mcs and all(m["verdict"] == "ok" for m in mcs)
          and not [e for e in evs if e["event"] == "degrade"],
          f"{name}: admission {[m['verdict'] for m in mcs]}, degrade "
          f"{[e for e in evs if e['event'] == 'degrade']}")
    rec = {"est_mb": mcs[-1]["est_mb"], "cap_mb": mcs[-1]["cap_mb"],
           "cap_source": mcs[-1]["cap_source"]}
    if trained:
        peaks = [e["peak_mb"] for e in evs
                 if e["event"] == "step_stats" and "peak_mb" in e]
        check(peaks and rec["est_mb"] >= peaks[0],
              f"{name}: estimate {rec['est_mb']} MB below the measured "
              f"peak {peaks[:1]} MB")
        rec["peak_mb"] = peaks[0] if peaks else None
        rec["est_over_peak"] = rec["est_mb"] / peaks[0] if peaks else None
    ADMISSION[name] = rec
    return rec


def kernel_wrappers() -> dict:
    """The thirteen kernel wrappers by the kernels line's names."""
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    from mobilefinetuner_tpu_torch.ops import flash_attention as fa
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc
    from mobilefinetuner_tpu_torch.ops import lora_fused as lf
    return {"flash_fwd": fa.flash_attention_fwd,
            "bwd_merged": fa.flash_attention_bwd_merged,
            "bwd_dq": fa.flash_attention_bwd_dq,
            "bwd_dkv": fa.flash_attention_bwd_dkv,
            "lora_epilogue": lf.lora_epilogue,
            "paged": da.paged_decode_attention,
            "decode": da.decode_attention,
            "fused_ce_fwd": fc.fused_ce_fwd,
            "fused_ce_dh": fc.fused_ce_bwd_dh,
            "fused_ce_dw": fc.fused_ce_bwd_dw,
            "fused_ce_fwd_lora": fc.fused_ce_fwd_lora,
            "fused_ce_dh_lora": fc.fused_ce_bwd_dh_lora,
            "fused_ce_dw_lora": fc.fused_ce_bwd_dw_lora}


# the `recovery` path's child: the GPT-2 LoRA CLI, its kernels' launch
# counts written to argv[1] on every exit (the drain's SystemExit too)
RECOVERY_CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli
kernels = chip_smoke.kernel_wrappers()
code = 1
try:
    code = cli.main(sys.argv[2:])
except SystemExit as e:
    code = e.code
finally:
    shapes = {k: [[str(key[0]), *key[1:], n]
                  for key, n in kernels[k].by_shape.items()]
              for k in ("lora_epilogue", "flash_fwd")}
    shapes["bwd_merged"] = [[str(key), n] for key, n in
                            kernels["bwd_merged"].by_dtype.items()]
    with open(sys.argv[1], "w") as f:
        json.dump({"launches": {k: fn.launches
                                for k, fn in kernels.items()},
                   "by_shape": shapes}, f)
sys.exit(code)
"""
RECOVERY = dict(steps=12, save_every=2, keep=4, nan_at=5, nan_n=3,
                drain_after=8, slow_ms=500, corrupt_steps=4)


def recovery(torch, work, kernels):
    """The `recovery` path: GPT-2 small LoRA (the `train` path's config)
    through `python -m`-style child processes of the CLI on the card:
    a grad_nan rollback, a clean run resumed from its checkpoint, a
    SIGTERM drain of that run and its resume, and a corrupt checkpoint's
    fallback. Launch counts come from the children's own wrappers."""
    import numpy as np
    from mobilefinetuner_tpu_torch.io.safetensors_io import \
        SafeTensorsReader
    T, R = TRAIN, RECOVERY
    gdir, ddir = os.path.join(work, "gpt2"), os.path.join(work, "wiki")
    rdir = os.path.join(work, "recovery")
    os.makedirs(rdir)
    repo = os.path.dirname(os.path.abspath(__file__))

    def argv(out, steps, *extra):
        return ["--pretrained_dir", gdir, "--data_dir", ddir,
                "--steps", str(steps), "--batch_size", str(T["batch"]),
                "--grad_accum_steps", str(T["accum"]),
                "--seq_len", str(T["seq"]), "--dtype", "bfloat16",
                "--rank", str(T["rank"]), "--alpha", str(T["alpha"]),
                "--lr", str(T["lr"]), "--log_interval", "1",
                "--lora_out", os.path.join(rdir, out), *extra]

    launches, walls = [], {}

    def run(name, args, sigterm_after=None):
        """(rc, events, seconds from SIGTERM to exit or None)."""
        counts = os.path.join(rdir, f"{name}.counts.json")
        stream = os.path.join(rdir, f"{name}.jsonl")
        log = open(os.path.join(rdir, f"{name}.log"), "w")
        t0 = time.perf_counter()
        child = subprocess.Popen(
            [sys.executable, "-c", RECOVERY_CHILD, counts, *args,
             "--telemetry_out", stream], cwd=repo,
            stdout=log, stderr=subprocess.STDOUT)
        drain_s = None
        try:
            if sigterm_after is not None:
                deadline = time.time() + 300
                while child.poll() is None and time.time() < deadline:
                    if os.path.exists(stream) and any(
                            e.get("event") == "step_stats"
                            and e.get("step", 0) >= sigterm_after
                            for e in map(json.loads, open(stream))):
                        break
                    time.sleep(0.02)
                sent = time.perf_counter()
                child.send_signal(signal.SIGTERM)
                rc = child.wait(timeout=300)
                drain_s = time.perf_counter() - sent
            else:
                rc = child.wait(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
            log.close()
        walls[name] = time.perf_counter() - t0
        with open(counts) as f:
            child_counts = json.load(f)
        got = child_counts["launches"]
        # the children's launches by shape join the paths' (EPI_BY_SHAPE
        # and FLASH_BY_SHAPE add up to the kernels' totals), the merged
        # backward's by dtype too
        for k, into in (("lora_epilogue", EPI_BY_SHAPE),
                        ("flash_fwd", FLASH_BY_SHAPE)):
            for dtype, *dims, n in child_counts["by_shape"][k]:
                into[(getattr(torch, dtype.split(".")[-1]), *dims)] += n
        for dtype, n in child_counts["by_shape"]["bwd_merged"]:
            BWD_BY_DTYPE[getattr(torch, dtype.split(".")[-1])] += n
        check(got["flash_fwd"] > 0 and got["bwd_merged"] > 0
              and got["lora_epilogue"] > 0,
              f"recovery {name}: the kernels did not run ({got})")
        launches.append(got)
        return rc, read_stream(stream), drain_s

    def adapter_diff(a, b):
        x = SafeTensorsReader(os.path.join(rdir, a)).load_all()
        y = SafeTensorsReader(os.path.join(rdir, b)).load_all()
        check(set(x) == set(y), f"adapter keys {a} {b}")
        return max(float(np.abs(x[k] - y[k]).max()) for k in x)

    # 1. rollback: three NaN-grad steps skipped, then one rollback
    rc, evs, _ = run("rollback", argv(
        "rb.safetensors", R["steps"], "--save_every", str(R["save_every"]),
        "--keep_ckpts", str(R["keep"]), "--skip_nonfinite", "1",
        "--rollback_budget", "2", "--rollback_skip_streak", "3",
        "--rollback_data_offset", "0",
        "--inject", f"grad_nan:{R['nan_at']}:{R['nan_n']}"))
    check(rc == 0, f"rollback run exited {rc}")
    rbs = [e for e in evs if e["event"] == "rollback"]
    skipped = sum(e.get("skipped") or 0 for e in evs
                  if e["event"] == "step_stats")
    check(len(rbs) == 1 and rbs[0]["ok"] and rbs[0]["reason"] ==
          "skip_streak" and skipped == R["nan_n"]
          and [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"],
          f"rollback run: rollbacks {rbs}, skipped {skipped}")
    rb = rbs[0]
    trigger = [e for e in evs if e["event"] == "step_stats"
               and e["step"] == rb["step"] and e["seq"] < rb["seq"]][-1]
    rb_wall = rb["t"] - trigger["t"]
    ckpt = rb["ckpt"]
    # 2. a clean run resumed from the rollback's checkpoint ends on the
    # same adapter
    rc, _, _ = run("clean", argv("clean.safetensors", R["steps"],
                                 "--skip_nonfinite", "1",
                                 "--resume_from", ckpt))
    check(rc == 0, f"clean resume exited {rc}")
    rb_diff = adapter_diff("rb.safetensors", "clean.safetensors")
    check(rb_diff <= 1e-3, f"rollback vs clean resume: max |diff| "
          f"{rb_diff} > 1e-3")
    # 3. the same resume, SIGTERMed once step drain_after's step_stats is
    # in its stream (steps from there sleep slow_ms so the signal lands
    # mid-run), then resumed from its drained file
    rc, evs, drain_s = run("drain", argv(
        "drain.safetensors", R["steps"], "--skip_nonfinite", "1",
        "--resume_from", ckpt,
        "--inject", f"slow_step:{R['drain_after'] - 1}:{R['slow_ms']}:"
                    f"{R['steps']}"), sigterm_after=R["drain_after"])
    pre = [e for e in evs if e["event"] == "preempt"]
    check(rc == 75 and len(pre) == 1 and evs[-1]["event"] == "run_end"
          and evs[-1]["exit"] == "preempted"
          and evs[-1]["reason"] == "preempted"
          and pre[0]["step"] < R["steps"],
          f"drain: exit {rc}, preempt {pre}, last {evs[-1]}")
    rc, _, _ = run("drain_resume", argv(
        "drain_resumed.safetensors", R["steps"], "--skip_nonfinite", "1",
        "--resume_from", os.path.join(rdir, "drain.safetensors")))
    check(rc == 0, f"drain resume exited {rc}")
    drain_diff = adapter_diff("drain_resumed.safetensors",
                              "clean.safetensors")
    check(drain_diff <= 1e-3, f"drained + resumed vs uninterrupted: max "
          f"|diff| {drain_diff} > 1e-3")
    # 4. a corrupt checkpoint: the resume falls back down the lineage
    rc, _, _ = run("corrupt", argv(
        "c.safetensors", R["corrupt_steps"], "--save_every",
        str(R["save_every"]), "--inject", "ckpt_corrupt"))
    check(rc == 0, f"ckpt_corrupt run exited {rc}")
    rc, evs, _ = run("corrupt_resume", argv(
        "c_resumed.safetensors", R["corrupt_steps"] + 1, "--resume_from",
        os.path.join(rdir, f"c_step{R['save_every']}.safetensors")))
    vfy = [(e["ok"], e["step"]) for e in evs if e["event"] == "ckpt_verify"]
    check(rc == 0 and vfy == [(False, R["save_every"]),
                              (True, R["corrupt_steps"])],
          f"corrupt resume: exit {rc}, verdicts {vfy}")
    total = {k: sum(n[k] for n in launches) for k in kernels}
    stats = {"model": "gpt2s", "dtype": "bfloat16",
             "rollback": {"at_step": rb["step"], "to_step": rb["to_step"],
                          "steps_lost": rb["steps_lost"],
                          "skipped": skipped, "wall_s": rb_wall,
                          "vs_clean_resume_max_abs_diff": rb_diff,
                          "bit_for_bit": rb_diff == 0.0},
             "drain": {"step": pre[0]["step"], "sigterm_to_exit_s": drain_s,
                       "resumed_vs_uninterrupted_max_abs_diff": drain_diff,
                       "bit_for_bit": drain_diff == 0.0},
             "corrupt": {"verdicts": vfy},
             "runs": len(launches), "walls_s": walls}
    return stats, total


# ------------------------------------------------------------ observe ------

def observed(name: str) -> dict:
    """A trained run's MFU and goodput from its stream: the p50 of
    step_stats.mfu (the CLI's transformer_flops estimate over the flush
    interval's per-step time and the card's peak) and run_end.goodput."""
    evs = read_stream(os.path.join(STREAMS["dir"], f"{name}.jsonl"))
    mfu = sorted(e["mfu"] for e in evs
                 if e["event"] == "step_stats" and e["mfu"] is not None)
    ends = [e for e in evs if e["event"] == "run_end"]
    check(len(ends) == 1 and isinstance(ends[0]["goodput"], dict),
          f"{name}: run_end {ends}")
    g = ends[0]["goodput"]
    buckets = sum(v for k, v in g.items()
                  if k.endswith("_s") and k != "total_s")
    check(abs(buckets - g["total_s"]) < 1e-3,
          f"{name}: goodput buckets {buckets} != total {g['total_s']}")
    return {"mfu": mfu[len(mfu) // 2] if mfu else None,
            "goodput": dict(g)}


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scrape(url: str) -> tuple:
    """(HTTP status, body) of one GET of the metrics endpoint."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# the `observe` path's serving child: GPT-2 small on the card, drained by
# the SIGTERM the parent sends once it has served a step; its wrappers'
# launch counts written to argv[1]
DRAIN_CHILD = """
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke
from mobilefinetuner_tpu_torch.serve.bench import build_engine
kernels = chip_smoke.kernel_wrappers()
eng, _ = build_engine("gpt2s", num_slots=4, block_T=16, num_blocks=128,
                      max_prompt=128, max_new=32, adapters=0,
                      dtype="bfloat16", telemetry_out=sys.argv[2],
                      stats_every=8, trace_spans=True)
eng.install_preemption()
reqs = [eng.submit([1 + i] * (16 + 8 * i), max_new_tokens=32)
        for i in range(12)]
eng.step()
print("ready", flush=True)
t0 = time.time()
while not eng.guard.triggered and time.time() - t0 < 120:
    time.sleep(0.01)
eng.drain()
eng.close()
with open(sys.argv[1], "w") as f:
    json.dump({"launches": {k: fn.launches for k, fn in kernels.items()},
               "by_shape": {"flash_fwd": [
                   [str(key[0]), *key[1:], n]
                   for key, n in kernels["flash_fwd"].by_shape.items()]},
               "states": [r.state for r in reqs],
               "reasons": [r.reason for r in reqs],
               "tokens": [len(r.tokens) for r in reqs]}, f)
"""
OBSERVE = dict(steps=12, slow_at=8, serve_stats_every=8)


def observe(torch, work, kernels):
    """The `observe` path (the observability plane on the card):
    GPT-2 small LoRA at the `train` config, 12 steps through the CLI in
    process with every observability flag off, then with every one on
    (trace spans, the run registry, the metrics endpoint, the profiler
    window over steps 0-1, the flight recorder armed by a slow step
    injected at step 8, the governor, the watchdog): identical losses,
    one capture whose trace names the flash forward and the LoRA
    epilogue, the spans reconciled with the goodput buckets; then a child
    engine (GPT-2 small) drained by SIGTERM and a child trainer aborted by
    `--watchdog 2` (exit 113, device probe "ok"). Launch counts: the two
    runs in process, the children's from their own wrappers."""
    T, O = TRAIN, OBSERVE
    gdir, ddir = os.path.join(work, "gpt2"), os.path.join(work, "wiki")
    odir = os.path.join(work, "observe")
    os.makedirs(odir)
    repo = os.path.dirname(os.path.abspath(__file__))
    from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli
    from mobilefinetuner_tpu_torch.core.run_registry import RunRegistry

    def argv(out, *extra):
        return ["--pretrained_dir", gdir, "--data_dir", ddir,
                "--steps", str(O["steps"]), "--batch_size", str(T["batch"]),
                "--grad_accum_steps", str(T["accum"]),
                "--seq_len", str(T["seq"]), "--dtype", "bfloat16",
                "--rank", str(T["rank"]), "--alpha", str(T["alpha"]),
                "--lr", str(T["lr"]), "--log_interval", "1",
                "--lora_out", os.path.join(odir, out), *extra]

    def steps_of(name):
        evs = read_stream(os.path.join(STREAMS["dir"], f"{name}.jsonl"))
        return evs, [e for e in evs if e["event"] == "step_stats"]

    def run_off(name):
        t0 = time.perf_counter()
        rc = cli.main(argv(f"{name}.safetensors", "--watchdog", "0",
                           *telemetry_argv(name)))
        check(rc == 0, f"{name} returned {rc}")
        return time.perf_counter() - t0, steps_of(name)[1]

    def run_on(name, registry, prof_dir, slow_ms):
        # the injected sleep makes step slow_at's interval about 4x the
        # median, past the 3x slow-step trigger
        t0 = time.perf_counter()
        rc = cli.main(argv(
            f"{name}.safetensors", "--watchdog", "1", "--trace_spans", "1",
            "--run_registry", registry, "--metrics_port", str(free_port()),
            "--profile_dir", prof_dir, "--profile_start", "0",
            "--profile_steps", "2", "--auto_profile", "1",
            "--auto_profile_steps", "2", "--pm_schedule", "0-:1",
            "--inject", f"slow_step:{O['slow_at']}:{slow_ms:.1f}",
            *telemetry_argv(name)))
        check(rc == 0, f"{name} returned {rc}")
        return time.perf_counter() - t0, steps_of(name)

    zero_counts(kernels)
    torch.cuda.synchronize()
    # every instrument off, then every one on
    wall_off, off = run_off("observe_off")
    off_ms = sorted(s["step_time_ms"] for s in off)
    p50_off = off_ms[len(off_ms) // 2]
    registry = os.path.join(odir, "registry.jsonl")
    prof_dir = os.path.join(odir, "window")
    slow_ms = 3 * p50_off
    wall_on, (evs, on) = run_on("observe_on", registry, prof_dir, slow_ms)
    # the instruments add no device work, so the instrumented losses are
    # an uninstrumented run's, bit for bit. The merged backward's dQ
    # atomics (csrc/flash_attention_bwd_merged_mma.cu) now and then give
    # an uninstrumented run other last bits too: on a mismatch one more
    # run of each side is made, and an instrumented run must equal an
    # uninstrumented one
    losses = {"off": [s["loss"] for s in off], "on": [s["loss"] for s in on]}
    if losses["on"] != losses["off"]:
        losses["off_2"] = [s["loss"] for s in run_off("observe_off_2")[1]]
        if losses["on"] not in (losses["off"], losses["off_2"]):
            _, (_, on2) = run_on("observe_on_2", registry + ".2",
                                 prof_dir + "_2", slow_ms)
            losses["on_2"] = [s["loss"] for s in on2]
    matched = [(a, b) for a in losses if a.startswith("on")
               for b in losses if b.startswith("off")
               if losses[a] == losses[b]]
    check(matched and len(on) == O["steps"],
          f"the instrumented losses equal no uninstrumented run's: "
          f"{losses}")
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    # the overhead over the steady steps: not the profiler window (steps
    # 1-2), its export (step 3), the injected slow step or the steps the
    # capture profiled and exported (its own and the next two)
    steady = {s["step"] for s in off} - {1, 2, 3} - {
        O["slow_at"] + k for k in (1, 2, 3)}

    def p50(stats):
        ms = sorted(s["step_time_ms"] for s in stats if s["step"] in steady)
        return ms[len(ms) // 2]
    p50_on, p50_steady_off = p50(on), p50(off)
    caps = [e for e in evs if e["event"] == "profile_capture"]
    # armed by step slow_at + 1's flush, stopped after two more steps
    check(len(caps) == 1 and caps[0]["trigger"] == "slow_step"
          and caps[0]["path"].endswith(f"_step{O['slow_at'] + 1}")
          and caps[0]["steps"] == 2,
          f"captures {caps} (one slow_step capture from step "
          f"{O['slow_at'] + 1} expected; none means the profiler failed)")
    import glob
    import gzip
    found = glob.glob(os.path.join(caps[0]["path"], "*.trace.json.gz"))
    check(len(found) == 1, f"capture files {found}")
    with gzip.open(found[0], "rt") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    for k in ("flash_fwd_mma_kernel", "lora_epilogue_vec_kernel"):
        check(any(k in n for n in names),
              f"the capture does not name {k}")
    window = glob.glob(os.path.join(prof_dir, "*.trace.json.gz"))
    check(len(window) == 1, f"profiler window files {window}")
    end = evs[-1]
    g = end["goodput"]
    check(end["event"] == "run_end" and end["exit"] == "ok"
          and end["governor_slept_ms"] == float(O["steps"])
          and g["governor_sleep_s"] > 0, f"run_end {end}")
    sys.path.insert(0, os.path.join(repo, "tools"))
    import trace_export
    trace_out = os.path.join(odir, "trace.json")
    check(trace_export.main([os.path.join(STREAMS["dir"],
                                          "observe_on.jsonl"),
                             "-o", trace_out]) == 0, "trace_export failed")
    with open(trace_out) as f:
        rec = trace_export.phase_reconcile(json.load(f), g)
    worst = max(d for _, _, d in rec.values())
    check(worst <= 1e-3 * g["total_s"] + 1e-3,
          f"span sums vs goodput buckets: {rec}")
    runs = RunRegistry(registry).records()
    check(len(runs) == 1 and runs[0]["status"] == "ok"
          and runs[0]["platform"] == "gpu", f"registry {runs}")
    hangs = [e for e in evs if e["event"] == "hang"]
    check(not hangs, f"false hang in a clean run: {hangs}")

    # a serving child drained by SIGTERM
    def child(name, script_args, sigterm_on=None, timeout=300):
        """(exit code, the child's counts file or {}): a child aborted by
        os._exit writes none, and its launches are not counted."""
        counts = os.path.join(odir, f"{name}.counts.json")
        log = open(os.path.join(odir, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", *script_args(counts)], cwd=repo,
            stdout=subprocess.PIPE if sigterm_on else log, stderr=log,
            text=True)
        try:
            if sigterm_on is not None:
                line = proc.stdout.readline().strip()
                check(line == sigterm_on, f"{name}: child said {line!r}")
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            if proc.stdout is not None:
                proc.stdout.close()
            log.close()
        if not os.path.exists(counts):
            return rc, {}
        with open(counts) as f:
            got = json.load(f)
        for k, into in (("lora_epilogue", EPI_BY_SHAPE),
                        ("flash_fwd", FLASH_BY_SHAPE)):
            for dtype, *dims, n in got.get("by_shape", {}).get(k, []):
                into[(getattr(torch, dtype.split(".")[-1]), *dims)] += n
        for dtype, n in got.get("by_shape", {}).get("bwd_merged", []):
            BWD_BY_DTYPE[getattr(torch, dtype.split(".")[-1])] += n
        for k in kernels:
            launches[k] += got["launches"][k]
        return rc, got

    stream = os.path.join(odir, "drain.jsonl")
    t0 = time.perf_counter()
    rc, got = child("drain", lambda c: [DRAIN_CHILD, c, stream],
                    sigterm_on="ready")
    drain_s = time.perf_counter() - t0
    devs = read_stream(stream)
    rejects = [e["reason"] for e in devs if e["event"] == "request"
               and e["phase"] == "reject"]
    check(rc == 0 and got["states"] == ["finished"] * 4 + ["rejected"] * 8
          and got["tokens"][:4] == [32] * 4
          and rejects == ["shutdown"] * 8
          and [e["event"] for e in devs].count("preempt") == 1
          and devs[-1]["event"] == "run_end"
          and devs[-1]["exit"] == "preempted",
          f"serving drain: exit {rc}, {got['states']}, rejects {rejects}, "
          f"last {devs[-1]}")
    check(got["launches"]["flash_fwd"] == 4 * LAYERS
          and got["launches"]["paged"] > 0,
          f"drain child launches {got['launches']}")

    # a training child aborted by the watchdog: step 3 sleeps 20 s
    wd_stream = os.path.join(odir, "watchdog.jsonl")
    t0 = time.perf_counter()
    rc, _ = child("watchdog", lambda c: [RECOVERY_CHILD, c, *argv(
        "wd.safetensors", "--watchdog", "2", "--watchdog_min_s", "5",
        "--inject", "slow_step:3:20000", "--telemetry_out", wd_stream)])
    wd_s = time.perf_counter() - t0
    with open(wd_stream, "rb") as f:
        raw = f.read()
    check(raw.endswith(b"\n"), "the aborted stream is not newline-ended")
    wevs = read_stream(wd_stream)
    hang = wevs[-1]
    check(rc == 113 and hang["event"] == "hang"
          and hang["action"] == "abort" and hang["step"] == 2
          and hang["device_probe"] == "ok",
          f"watchdog abort: exit {rc}, last event {hang}")

    stats = {"model": "gpt2s", "dtype": "bfloat16", "steps": O["steps"],
             "losses_identical": True, "runs_compared": sorted(losses),
             "matched": matched[0],
             "step_ms_p50_off": p50_steady_off, "step_ms_p50_on": p50_on,
             "overhead_frac": p50_on / p50_steady_off - 1.0,
             "wall_s_off": wall_off, "wall_s_on": wall_on,
             "capture": {"step": caps[0]["step"],
                         "trace_events": len(names)},
             "reconcile_max_abs_s": worst,
             "mfu_off": observed("observe_off")["mfu"],
             "mfu_on": observed("observe_on")["mfu"],
             "goodput_on": g,
             "drain": {"wall_s": drain_s, "finished": 4, "rejected": 8},
             "watchdog": {"exit": rc, "stall_s": hang["stall_s"],
                          "deadline_s": hang["deadline_s"],
                          "wall_s": wd_s}}
    return stats, launches


DEGRADE = dict(steps=3)


def degrade(torch, dev, work, kernels, gemma):
    """The `degrade` path: Gemma-3-270M full fine-tuning (the
    `gemma_full_ft` config) through cli.gemma_full_finetune in process,
    counts set to 0 just before: the exhausted ladder, the ladder walking
    remat at a capacity between the two estimates, the same run launched
    at --remat, fail mode at that capacity, a real out-of-memory error at
    the first dispatch, and sync and async saves of the 268M-parameter
    model."""
    import filecmp
    import math

    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.cli import common
    from mobilefinetuner_tpu_torch.cli import gemma_full_finetune as cli
    from mobilefinetuner_tpu_torch.core import memory_guard as mg
    from mobilefinetuner_tpu_torch.io.async_ckpt import (AsyncCheckpointer,
                                                         timed_snapshot)
    from mobilefinetuner_tpu_torch.io.checkpoints import (
        gemma3_params_from_hf, save_gemma3)
    from mobilefinetuner_tpu_torch.optim import adam
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer)
    config, _, _, _, gdir, ddir, _ = gemma
    G, D = GEMMA, DEGRADE
    out = os.path.join(work, "degrade")
    os.makedirs(out)

    def argv(name, *extra):
        return ["--model_dir", gdir, "--data_dir", ddir,
                "--steps", str(D["steps"]), "--batch_size", str(G["batch"]),
                "--seq_len", str(G["seq"]), "--dtype", "bfloat16",
                "--loss_chunks", str(G["chunks"]), "--lr", str(G["full_lr"]),
                "--output_path", os.path.join(out, f"{name}.safetensors"),
                "--metrics_csv", os.path.join(out, f"{name}.csv"),
                *telemetry_argv(f"degrade_{name}"), *extra]

    def events(name):
        return read_stream(os.path.join(STREAMS["dir"],
                                        f"degrade_{name}.jsonl"))

    def refused(name, *extra):
        """The refusal's ladder. The error itself is dropped: its
        traceback holds the refused run's trees, which the next run's
        preflight would count as live bytes."""
        try:
            cli.main(argv(name, *extra))
        except mg.MemoryAdmissionError as e:
            ladder = e.ladder
        else:
            ladder = None
        check(ladder is not None, f"degrade {name}: no MemoryAdmissionError")
        gc.collect()
        torch.cuda.empty_cache()
        return ladder

    def losses(name):
        return [float(r["loss"]) for r in read_csv(
            os.path.join(out, f"{name}.csv"))]

    walls = {}
    zero_counts(kernels)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # 1. every rung over: the ladder runs dry before any data loads
    ladder = refused("exhausted", "--hbm_cap_mb", "1")
    evs = events("exhausted")
    ests = [e["est_mb"] for e in evs if e["event"] == "mem_check"]
    check(ladder == ("remat", "accum_x2") and len(ests) == 3
          and ests[0] > ests[1] > ests[2]
          and not [e for e in evs if e["event"] == "step_stats"],
          f"exhausted ladder {ladder}, estimates {ests}")
    walls["exhausted"] = time.perf_counter() - t0
    # 2. a capacity whose admitted share lies between the estimates with
    # remat off and on: the run walks remat
    cap = math.ceil((ests[0] + ests[1]) / 2 / 0.9)
    t0 = time.perf_counter()
    check(cli.main(argv("ladder", "--hbm_cap_mb", str(cap))) == 0,
          "degrade ladder run failed")
    walls["ladder"] = time.perf_counter() - t0
    evs = events("ladder")
    verdicts = [m["verdict"] for m in evs if m["event"] == "mem_check"]
    rungs = [e["rung"] for e in evs if e["event"] == "degrade"]
    peak = [e["peak_mb"] for e in evs
            if e["event"] == "step_stats" and "peak_mb" in e]
    ladder_est = [m["est_mb"] for m in evs if m["event"] == "mem_check"]
    check(verdicts == ["over", "ok"] and rungs == ["remat"] and peak
          and ladder_est[-1] >= peak[0]
          and [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"],
          f"ladder: verdicts {verdicts}, rungs {rungs}, estimates "
          f"{ladder_est}, peak {peak}")
    # 3. the oracle: the same run launched at --remat
    t0 = time.perf_counter()
    check(cli.main(argv("direct", "--remat")) == 0, "direct --remat failed")
    walls["direct"] = time.perf_counter() - t0
    rec_direct = admitted("degrade_direct")
    lad, ref = losses("ladder"), losses("direct")
    loss_diff = max(abs(a - b) for a, b in zip(lad, ref))
    check(len(lad) == len(ref) == D["steps"] and loss_diff <= 1e-3,
          f"ladder losses {lad} vs --remat {ref}")
    # 4. fail mode at the same capacity: refused before data loads
    ladder = refused("fail", "--hbm_cap_mb", str(cap),
                     "--on_oom_risk", "fail")
    check([e["event"] for e in events("fail")] ==
          ["run_start", "mem_check", "run_end"] and not ladder,
          f"fail mode stream {[e['event'] for e in events('fail')]}")
    # 5. a real out-of-memory error at the first dispatch: the ballast
    # leaves BALLAST_SPARE_MB free, the step runs out, the loop walks
    # remat and runs the same batch again
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check(cli.main(argv("oom", "--inject", "hbm_pressure:1000000")) == 0,
          "hbm_pressure run failed")
    walls["oom"] = time.perf_counter() - t0
    evs = events("oom")
    dispatch = [m for m in evs if m["event"] == "mem_check"
                and m["phase"] == "dispatch"]
    rungs = [(e["rung"], e["step"]) for e in evs if e["event"] == "degrade"]
    steps = [e["step"] for e in evs if e["event"] == "step_stats"]
    check(len(dispatch) == 1 and rungs == [("remat", 0)]
          and steps == list(range(1, D["steps"] + 1)),
          f"oom run: dispatch {dispatch}, rungs {rungs}, steps {steps}")
    oom_peak = [e["peak_mb"] for e in evs
                if e["event"] == "step_stats" and "peak_mb" in e]
    # 6. sync and async saves of the trained 268M-parameter model and its
    # .opt, through the CLI's writers: byte-identical files
    model = os.path.join(out, "ladder.safetensors")
    params = convert.gemma3_params_from_numpy(gemma3_params_from_hf(
        common.load_full_resume(model), config), device=dev)
    opt_state, _ = adam.load_state(model + ".opt", init_optimizer(
        params, TrainConfig(), None))
    saves, ck_events = {}, []
    for mode in (0, 1):
        ck = AsyncCheckpointer(
            enabled=bool(mode),
            event_sink=lambda ev, **f: ck_events.append(dict(f, event=ev)))
        t_call = time.perf_counter()
        (p_h, o_h), snap_ms = timed_snapshot((params, opt_state))
        path = os.path.join(out, f"save{mode}.safetensors")

        def write(path=path, p_h=p_h, o_h=o_h):
            save_gemma3(path, p_h)
            adam.save_state(path + ".opt", o_h, adam.AdamConfig(),
                            extra_metadata={"loop_step": str(D["steps"])})
            return [path, path + ".opt"]

        ck.save(D["steps"], write, snapshot_ms=snap_ms)
        blocking_ms = (time.perf_counter() - t_call) * 1000
        ck.close()
        saves[mode] = {"loop_blocked_ms": blocking_ms, **{
            k: ck_events[-1][k] for k in ("snapshot_ms", "write_ms",
                                           "bytes", "mb_s", "async")}}
        # the next snapshot finds these pinned buffers free, as the next
        # periodic save of a run does once the write has landed
        del p_h, o_h, write
    for sfx in ("", ".opt"):
        check(filecmp.cmp(os.path.join(out, "save0.safetensors" + sfx),
                          os.path.join(out, "save1.safetensors" + sfx),
                          shallow=False), f"sync / async save{sfx} differ")
    del params, opt_state
    torch.cuda.empty_cache()
    launches = read_counts(kernels)
    for k in ("flash_fwd", "bwd_merged", "fused_ce_fwd", "fused_ce_dh",
              "fused_ce_dw"):
        check(launches[k] > 0, f"degrade: {k} never launched")
    cli_saves = {name: [{k: e[k] for k in ("snapshot_ms", "write_ms",
                                           "bytes", "mb_s", "async")}
                        for e in events(name) if e["event"] == "checkpoint"]
                 for name in ("ladder", "direct", "oom")}
    stats = {"model": "gemma3-270m", "mode": "full", "dtype": "bfloat16",
             "steps": D["steps"], "exhausted_estimates_mb": ests,
             "cap_mb": cap, "ladder_estimates_mb": ladder_est,
             "ladder_peak_mb": peak[0] if peak else None,
             "direct_remat": rec_direct,
             "ladder_vs_remat_max_abs_loss_diff": loss_diff,
             "ladder_losses_exact": lad == ref,
             "oom": {"dispatch_live_mb": dispatch[0]["live_mb"],
                     "retried_peak_mb": oom_peak[0] if oom_peak else None},
             "saves": saves, "cli_saves": cli_saves, "walls_s": walls}
    return stats, launches


# ------------------------------------------------------- multitenant ------

MT = dict(slots=8, batch=2, seq=128, rank=8, alpha=16.0,
          steps=(6, 7, 8, 9, 10, 11, 12, 12, 8, 6), k1_steps=12,
          parity_steps=5, parity_tol=1e-4, parity_w_tol=1e-3,
          gemma_slots=2, gemma_batch=1, gemma_seq=256, gemma_steps=3,
          serve_new=16)


# the routed sites where the JAX package's dense order is timed against
# the port's gather: (name, rows, tokens a row, d_in, d_out, r, k): the
# serving decode step (8 slots, a bank of 3, GPT-2 attn_qkv at the
# `serve` path's rank 4), the multi-tenant training step (2,048 tokens,
# k 8, rank 8) and the Gemma-3-270M serving decode's down_proj
MT_ORDER_SHAPES = (("serve_decode", 8, 1, 768, 2304, 4, 3),
                   ("train_k8", 16, 128, 768, 2304, 8, 8),
                   ("gemma_serve_down_proj", 8, 1, 2048, 640, 4, 3))


def mt_schedule(budgets, slots: int):
    """(engine steps, refills) when jobs with these step budgets are
    admitted in order into `slots` slots, a finished job's slot refilled
    from the queue at the step boundary (the engine's rule)."""
    pending = list(budgets)
    left = [pending.pop(0) for _ in range(min(slots, len(pending)))]
    steps = refills = 0
    while any(n > 0 for n in left):
        steps += 1
        for j, n in enumerate(left):
            if n > 0:
                left[j] = n - 1
                if left[j] == 0 and pending:
                    left[j] = pending.pop(0)
                    refills += 1
    return steps, refills


def write_jobs(path: str, family: str, jobs: list, defaults: dict) -> str:
    with open(path, "w") as f:
        json.dump({"family": family, "defaults": defaults, "jobs": jobs}, f)
    return path


def run_multi_lora(kernels, name: str, argv: list):
    """One cli.train_multi_lora run with its stream, counts set to 0 just
    before it: (launches, wall s, events)."""
    from mobilefinetuner_tpu_torch.cli import train_multi_lora as cli
    import torch
    zero_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv + telemetry_argv(name))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    check(rc == 0, f"{name}: train_multi_lora.main returned {rc}")
    return launches, wall, read_stream(
        os.path.join(STREAMS["dir"], f"{name}.jsonl"))


def attn_launches(layers: int, micro: int, seq: int, head_dim: int,
                  dtype) -> dict:
    """Rows 1 and 2 exactly `layers` x `micro` times, nothing else."""
    import torch
    from mobilefinetuner_tpu_torch.ops.flash_attention import \
        resolve_bwd_impl
    impl = resolve_bwd_impl(seq, head_dim, dtype)
    want = {k: 0 for k in kernel_wrappers()}
    want["flash_fwd"] = layers * micro
    if impl == "merged":
        want["bwd_merged"] = layers * micro
    else:
        want["bwd_dq"] = want["bwd_dkv"] = layers * micro
    del torch
    return want


def step_p50(evs, skip: int = 2) -> float:
    """The median per-step wall ms of a --log_interval 1 stream, its first
    `skip` steps (warm-up) left out."""
    ms = sorted(e["step_time_ms"] for e in evs
                if e["event"] == "step_stats")[skip:] or [float("nan")]
    return ms[len(ms) // 2]


def tenant_losses(evs) -> dict:
    """{tenant: (first loss, last loss)} from the step_stats sections."""
    out = {}
    for e in evs:
        for name, t in (e.get("tenants") or {}).items():
            if e["event"] == "step_stats" and t["loss"] is not None:
                first = out.get(name, (t["loss"], None))[0]
                out[name] = (first, t["loss"])
    return out


def mt_fused(torch, kernels, work, gdir, ddir):
    """Run 1: ten GPT-2 small jobs over 8 slots, bf16, two refills."""
    from mobilefinetuner_tpu_torch.lora import peft_io
    out = os.path.join(work, "mt_out")
    jobs = [{"name": f"t{i}", "lr": (1e-3, 2e-3, 3e-3, 4e-3)[i % 4],
             "alpha": (16.0, 8.0, 32.0)[i % 3], "steps": n, "seed": 1 + i,
             "data_seed": 100 + i}
            for i, n in enumerate(MT["steps"])]
    jobs[6].update(save_every=4, keep_ckpts=1)
    peft_dir = os.path.join(out, "t3_peft")
    jobs[3]["peft_export_dir"] = peft_dir
    jobs_file = write_jobs(os.path.join(work, "mt_jobs.json"), "gpt2", jobs,
                           {"rank": MT["rank"], "warmup_ratio": 0.1})
    argv = ["--jobs", jobs_file, "--pretrained_dir", gdir, "--data_dir",
            ddir, "--out_dir", out, "--slots", str(MT["slots"]),
            "--batch_size", str(MT["batch"]), "--seq_len", str(MT["seq"]),
            "--dtype", "bfloat16", "--log_interval", "1"]
    launches, wall, evs = run_multi_lora(kernels, "multitenant", argv)
    steps, refills = mt_schedule(MT["steps"], MT["slots"])
    tev = [e for e in evs if e["event"] == "tenant"]
    phases = collections.Counter(e["phase"] for e in tev)
    run_end = [e for e in evs if e["event"] == "run_end"][-1]
    check(run_end["steps"] == steps and run_end["exit"] == "ok",
          f"multitenant: run_end {run_end}, expected {steps} steps")
    check(phases["admit"] == len(jobs) and phases["finish"] == len(jobs)
          and phases["admit"] - MT["slots"] == refills == 2,
          f"multitenant: tenant phases {dict(phases)}, refills expected "
          f"{refills}")
    want = attn_launches(LAYERS, steps, MT["seq"], 64, torch.bfloat16)
    check(launches == want, f"multitenant launches {launches}, expected "
          f"{want}")
    saved = []
    for j in jobs:
        path = os.path.join(out, f"{j['name']}.safetensors")
        tree, spec = peft_io.load_adapter(path, device="cpu")
        check(spec.rank == MT["rank"] and spec.alpha == j["alpha"]
              and all(bool(torch.isfinite(e["B"]).all())
                      and float(e["B"].abs().max()) > 0
                      for e in tree["blocks"].values())
              and os.path.exists(path + ".manifest.json"),
              f"multitenant: {path} did not reload trained")
        saved.append(path)
    t6 = os.path.join(out, "t6_step{}.safetensors")
    check(os.path.exists(t6.format(8)) and not os.path.exists(t6.format(4))
          and os.path.exists(os.path.join(peft_dir,
                                          "adapter_model.safetensors")),
          "multitenant: save_every / keep_ckpts / peft_export_dir files")
    losses = tenant_losses(evs)
    first = sum(v[0] for v in losses.values()) / len(losses)
    last = sum(v[1] for v in losses.values()) / len(losses)
    check(len(losses) == len(jobs) and all(
        map(_finite, [x for v in losses.values() for x in v]))
        and last < first, f"multitenant: tenant losses {losses}")
    p50 = step_p50(evs)
    tokens = MT["slots"] * MT["batch"] * MT["seq"]
    stats = {"model": "gpt2s", "dtype": "bfloat16", "slots": MT["slots"],
             "jobs": len(jobs), "steps": steps, "refills": refills,
             "finished": phases["finish"], "saves": phases["save"],
             "files": len(saved) + 1, "tokens_per_step": tokens,
             "step_ms_p50_k8": p50, "tokens_per_s_k8": tokens / p50 * 1e3,
             "first_mean_loss": first, "last_mean_loss": last,
             "tenant_losses": losses, "wall_s": wall}
    return stats, launches, saved


def mt_k1(torch, kernels, work, gdir, ddir):
    """Run 2: the same config with one job in one slot."""
    out = os.path.join(work, "mt_k1_out")
    jobs_file = write_jobs(
        os.path.join(work, "mt_k1.json"), "gpt2",
        [{"name": "solo", "lr": 2e-3, "steps": MT["k1_steps"], "seed": 1,
          "data_seed": 100}], {"rank": MT["rank"]})
    argv = ["--jobs", jobs_file, "--pretrained_dir", gdir, "--data_dir",
            ddir, "--out_dir", out, "--slots", "1", "--batch_size",
            str(MT["batch"]), "--seq_len", str(MT["seq"]), "--dtype",
            "bfloat16", "--log_interval", "1"]
    launches, wall, evs = run_multi_lora(kernels, "multitenant_k1", argv)
    want = attn_launches(LAYERS, MT["k1_steps"], MT["seq"], 64,
                         torch.bfloat16)
    check(launches == want, f"multitenant k=1 launches {launches}, "
          f"expected {want}")
    return step_p50(evs), launches


def mt_parity(torch, dev, kernels, gdir):
    """Run 3: three tenants trained 5 steps in the engine, f32 at full
    width, each against the port's solo make_train_step on the same
    batches and init (`ref`), and against the same solo step run on the
    engine's whole batch, every tenant's rows in their slot's place and
    only this tenant's labels counted (`solo_engine_rows`: the base
    model's products at the engine's shapes, so what is left is the
    engine's own routing, clip and update). pa and pb are held: losses
    against ref within MT's parity_tol, weights against solo_engine_rows
    within parity_w_tol of the trained change. pc trains at lr 4e-3 /
    scale 4. The drift witness, printed for every tenant: how far from
    ref the engine, solo_engine_rows and a solo run with the plain
    attention in place of the kernels (another rounding order) land.
    Returns (stats, launches, the flash forward's launches by shape)."""
    import numpy as np
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.lora import peft_io
    from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec,
                                                     init_lora_gpt2,
                                                     trainable_mask)
    from mobilefinetuner_tpu_torch.models import gpt2
    from mobilefinetuner_tpu_torch.multitenant import (EngineConfig,
                                                       JobSpec,
                                                       MultiTenantEngine)
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    config, params_np = load_gpt2(gdir)
    params = convert.gpt2_params_from_numpy(params_np, device=dev)
    n, b, S = MT["parity_steps"], MT["batch"], MT["seq"]

    def batches(seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            ids = rng.integers(1, config.vocab_size, (b, S)).astype(np.int32)
            out.append({"input_ids": ids,
                        "attention_mask": np.ones((b, S), np.float32),
                        "labels": ids.copy()})
        return out

    jobs = [JobSpec(name="pa", lr=2e-3, alpha=16.0, steps=n, seed=11,
                    data_seed=201, warmup_ratio=0.2),
            JobSpec(name="pb", lr=1e-3, alpha=8.0, steps=n, seed=12,
                    data_seed=202),
            JobSpec(name="pc", lr=4e-3, alpha=32.0, steps=n, seed=13,
                    data_seed=203)]
    held = ("pa", "pb")
    out = tempfile.mkdtemp(prefix="mt_parity_")
    eng = MultiTenantEngine(
        "gpt2", config, params, jobs, lambda j: iter(batches(j.data_seed)),
        EngineConfig(slots=len(jobs), rows_per_tenant=b, seq_len=S,
                     dtype="float32", flush_every=1, prefetch=0,
                     out_dir=out), device=dev)
    zero_counts(kernels)
    eng.admit_pending()
    hist = {j.name: [] for j in jobs}
    for _ in range(n):
        eng.step()
        for j in jobs:
            hist[j.name].append(eng.tenants[j.name].last_loss)
    eng.close()
    torch.cuda.synchronize()
    shapes = dict(kernels["flash_fwd"].by_shape)
    launches = read_counts(kernels)
    want = attn_launches(LAYERS, n, S, 64, torch.float32)
    check(launches == want, f"multitenant parity launches {launches}, "
          f"expected {want}")

    def solo(job, attn_impl="auto", engine_rows=False):
        """(per-step losses, final adapter, initial adapter) of the solo
        step on the job's batches, or with `engine_rows` on the engine's
        whole batch with only this job's labels counted."""
        spec = LoRASpec(rank=job.rank, alpha=job.alpha, init="gpt2")
        lora = init_lora_gpt2(config, spec, job.seed, device=dev)
        lora0 = {t: {k: v.clone() for k, v in e.items()}
                 for t, e in lora["blocks"].items()}
        mask = trainable_mask(lora)
        tc = TrainConfig(total_steps=n, lr=job.lr,
                         warmup_ratio=job.warmup_ratio)

        def loss_fn(lt, p, mb):
            logits = gpt2.forward(config, p, mb["input_ids"],
                                  attention_mask=mb["attention_mask"],
                                  lora=lt, lora_impl="naive",
                                  attn_impl=attn_impl)
            return lm_cross_entropy_sum(logits, mb["labels"])

        step = make_train_step(loss_fn, tc, mask)
        opt = init_optimizer(lora, tc, mask)
        losses = []
        own = batches(job.data_seed)
        for s, bt in enumerate(own):
            if engine_rows:
                rows = [own[s] if o is job else batches(o.data_seed)[s]
                        for o in jobs]
                bt = {k: np.concatenate([r[k] if k != "labels" or r is bt
                                         else np.full_like(r[k], -100)
                                         for r in rows])
                      for k in bt}
            mb = {k: torch.from_numpy(v).to(dev) for k, v in bt.items()}
            mb["input_ids"], mb["labels"] = (mb["input_ids"].long(),
                                             mb["labels"].long())
            lora, opt, m = step(lora, params, opt, mb, s)
            losses.append(float(m["loss"]))
        return losses, lora["blocks"], lora0

    def apart(losses, tree, ref):
        """(max |loss err|, weights' |diff| / |trained change|, max |weight
        err|) of a run against the reference solo run `ref`."""
        ref_losses, ref_tree, init = ref
        diff_sq = change_sq = w_max = 0.0
        for tgt, e in ref_tree.items():
            for leaf in ("A", "B"):
                d = (tree[tgt][leaf].double() - e[leaf].double())
                diff_sq += float(d.square().sum())
                change_sq += float((e[leaf].double()
                                    - init[tgt][leaf].double())
                                   .square().sum())
                w_max = max(w_max, float(d.abs().max()))
        return {"loss_err": max(abs(a - c) for a, c in zip(losses,
                                                           ref_losses)),
                "weight_rel_err": math.sqrt(diff_sq / change_sq),
                "weight_max_err": w_max}

    tenants = {}
    for job in jobs:
        ref = solo(job)
        same_rows = solo(job, engine_rows=True)
        saved, _ = peft_io.load_adapter(
            os.path.join(out, f"{job.name}.safetensors"), device=dev)
        row = {"lr": job.lr, "scale": job.alpha / job.rank,
               "engine": apart(hist[job.name], saved["blocks"], ref),
               "engine_vs_solo_engine_rows": apart(
                   hist[job.name], saved["blocks"], same_rows),
               "solo_engine_rows": apart(*same_rows[:2], ref),
               "solo_plain_attention": apart(
                   *solo(job, attn_impl="plain")[:2], ref)}
        tenants[job.name] = row
        print(f"multitenant f32 k-vs-solo {job.name} (lr {job.lr:g}, scale "
              f"{row['scale']:g}, {n} steps, GPT-2 small at full width; "
              f"{'held' if job.name in held else 'drift witness'}): "
              + "; ".join(f"{key} max |loss err| {v['loss_err']:.3e}, "
                          f"weights |diff| / |trained change| "
                          f"{v['weight_rel_err']:.3e}, max |err| "
                          f"{v['weight_max_err']:.3e}"
                          for key, v in row.items() if isinstance(v, dict)))
    shutil.rmtree(out, ignore_errors=True)
    loss_err = max(tenants[t]["engine"]["loss_err"] for t in held)
    rows = [tenants[t]["engine_vs_solo_engine_rows"] for t in held]
    w_rel = max(r["weight_rel_err"] for r in rows)
    w_max = max(r["weight_max_err"] for r in rows)
    print(f"multitenant f32 k-vs-solo, held tenants: max |loss err| "
          f"{loss_err:.3e} (tolerance {MT['parity_tol']:g}); weights "
          f"against solo_engine_rows: |diff| / |trained change| "
          f"{w_rel:.3e} (tolerance {MT['parity_w_tol']:g}), max |err| "
          f"{w_max:.3e}")
    check(loss_err <= MT["parity_tol"] and w_rel <= MT["parity_w_tol"],
          f"multitenant k-vs-solo: loss {loss_err:.3e}, weights "
          f"{w_rel:.3e} relative ({w_max:.3e} max)")
    del params
    stats = {"loss_err": loss_err, "loss_tol": MT["parity_tol"],
             "weight_rel_err": w_rel, "weight_rel_tol": MT["parity_w_tol"],
             "weight_max_err": w_max, "tenants": tenants}
    return stats, launches, shapes


def mt_gemma(torch, kernels, work, gdir, ddir):
    """Run 4: Gemma-3-270M, two tenants, targets full, bf16, 3 steps."""
    out = os.path.join(work, "mt_gemma_out")
    jobs_file = write_jobs(
        os.path.join(work, "mt_gemma.json"), "gemma",
        [{"name": "ga", "lr": 2e-3, "seed": 1, "data_seed": 300},
         {"name": "gb", "lr": 4e-3, "alpha": 16.0, "seed": 2,
          "data_seed": 301}],
        {"rank": 8, "alpha": 32.0, "steps": MT["gemma_steps"]})
    argv = ["--jobs", jobs_file, "--pretrained_dir", gdir, "--data_dir",
            ddir, "--out_dir", out, "--slots", str(MT["gemma_slots"]),
            "--batch_size", str(MT["gemma_batch"]), "--seq_len",
            str(MT["gemma_seq"]), "--dtype", "bfloat16", "--log_interval",
            "1"]
    launches, wall, evs = run_multi_lora(kernels, "multitenant_gemma", argv)
    want = attn_launches(GEMMA_LAYERS, MT["gemma_steps"], MT["gemma_seq"],
                         256, torch.bfloat16)
    check(launches == want, f"multitenant gemma launches {launches}, "
          f"expected {want}")
    losses = tenant_losses(evs)
    check(sorted(losses) == ["ga", "gb"] and all(
        map(_finite, [x for v in losses.values() for x in v])),
        f"multitenant gemma losses {losses}")
    for name in ("ga", "gb"):
        check(os.path.exists(os.path.join(out, f"{name}.safetensors")),
              f"multitenant gemma: {name} not saved")
    return {"tenant_losses": losses, "wall_s": wall,
            "step_ms_p50": step_p50(evs, skip=1)}, launches


def mt_handoff(torch, dev, kernels, gdir, files):
    """Run 5: two engine-trained adapter files, manifest-verified, into a
    serve engine with lora_impl="fused"; one request each."""
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.data.tokenizer_bpe import GPT2BPETokenizer
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.lora.lora import LoRASpec, init_lora_gpt2
    from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine
    from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
    config, params_np = load_gpt2(gdir)
    params = convert.gpt2_params_from_numpy(params_np, device=dev,
                                            dtype=torch.bfloat16)
    tok = GPT2BPETokenizer.from_pretrained(gdir)
    max_prompt = 64 if config.n_positions >= 64 + MT["serve_new"] else 32
    template = init_lora_gpt2(config, LoRASpec(rank=MT["rank"]), 0,
                              dtype=torch.bfloat16, device=dev)
    zero_counts(kernels)
    eng = ServeEngine("gpt2", config, params, ServeConfig(
        num_slots=2, block_T=16, num_blocks=32, max_prompt=max_prompt,
        max_new_tokens=MT["serve_new"], dtype="bfloat16",
        lora_impl="fused"), bank=AdapterBank(template, capacity=2),
        device=dev)
    reqs = []
    for i, path in enumerate(files):
        eng.load_adapter(f"mt{i}", path)
        reqs.append(eng.submit(tok.encode(f" w00{i + 1} w002 w003"),
                               adapter=f"mt{i}"))
    eng.drain()
    eng.close()
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    for r in reqs:
        check(r.state == "finished" and len(r.tokens) == MT["serve_new"]
              and all(0 <= t < config.vocab_size for t in r.tokens),
              f"multitenant handoff request {r.state} {r.tokens}")
    check(launches["flash_fwd"] == LAYERS * len(files)
          and launches["paged"] > 0, f"handoff launches {launches}")
    print(f"multitenant handoff: served {[tok.decode(r.tokens) for r in reqs]}"
          f" from the engine-trained files (lora_impl fused)")
    return launches


def mt_orders(torch, dev):
    """The port's routed site (the per-row gather, models/lora_apply) at
    MT_ORDER_SHAPES in bf16, timed against the JAX package's dense order
    written here in torch (every adapter's delta for every row, routed by
    a one-hot [rows, k]; the port has no dense order) and held to it
    within one bf16 ulp of the largest output; then the routed dropout's
    mask on the card (ops/dropout.row_dropout)."""
    from mobilefinetuner_tpu_torch.models import lora_apply as la
    from mobilefinetuner_tpu_torch.ops.dropout import row_dropout
    bf = torch.bfloat16
    out = {}
    for name, rows, tpr, d_in, d_out, r, k in MT_ORDER_SHAPES:
        g = torch.Generator(device="cpu").manual_seed(rows + k)
        mk = lambda *s: torch.randn(s, generator=g).to(dev)  # noqa: E731
        shape = (rows, tpr) if tpr > 1 else (rows,)
        x, y = mk(*shape, d_in).to(bf), mk(*shape, d_out).to(bf)
        entry = {"A": mk(k, d_in, r) * d_in ** -0.5,
                 "B": mk(k, r, d_out) * 0.05, "scale": mk(k).abs() + 0.5,
                 "ids": torch.arange(rows, device=dev) % k}
        ids = entry["ids"]
        scale = entry["scale"][ids].reshape(-1, *[1] * (y.dim() - 1))
        A, Bm = entry["A"].to(bf), entry["B"].to(bf)

        def dense():
            route = (ids[:, None] == torch.arange(k, device=dev)).float()
            t1 = torch.einsum("b...i,kir->kb...r", x.float(), A.float())
            t2 = torch.einsum("kb...r,kro->kb...o",
                              t1.to(bf).float(), Bm.float())
            return la._finish(y, scale, torch.einsum("kb...o,bk->b...o",
                                                     t2, route))

        gather = lambda: la.maybe_lora(y, x, entry)  # noqa: E731
        times = timed({"gather": gather, "dense": dense}, 50)
        ref = gather().float()
        tol = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
        err = max_err(dense(), ref)
        out[name] = {"rows": rows, "tokens": rows * tpr, "d_in": d_in,
                     "d_out": d_out, "r": r, "k": k,
                     "gather_ms": times["gather"][0],
                     "gather_call_ms": times["gather"][1],
                     "dense_ms": times["dense"][0],
                     "dense_call_ms": times["dense"][1],
                     "dense_vs_gather_err": err, "tol": tol}
        print(f"multitenant routed site {name}: the port's gather "
              f"{times['gather'][1]:.4f} ms a call ({times['gather'][0]:.4f}"
              f" device), the JAX package's dense order "
              f"{times['dense'][1]:.4f} ms ({times['dense'][0]:.4f}); max "
              f"|err| {err:.3e} (tolerance {tol:g}, one bf16 ulp of the "
              f"largest output)")
        check(err <= tol, f"dense vs gather at {name}: {err:.3e}")
    xd = torch.ones(16, 128, 768, device=dev, dtype=bf)
    a = row_dropout(xd, 0.1, 99)
    kept = float((a != 0).float().mean())
    check(torch.equal(a, row_dropout(xd, 0.1, 99))
          and torch.equal(row_dropout(xd[:4], 0.1, 99), a[:4])
          and abs(kept - 0.9) < 0.01 and not torch.equal(a[0], a[1]),
          f"routed dropout on the card: kept {kept}")
    out["row_dropout_kept"] = kept
    return out


def mt_masked_rows(torch, fa, dev):
    """Idle slots feed all-zero attention_mask rows: rows 1-2 on fully
    masked batch rows, bf16 and f32, stay finite and agree with their
    plain versions (which give 0 there)."""
    out = {}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        q, k, v, pad = flash_inputs(torch, dev, dt, 4, 12, 12, 128, 64,
                                    (128, 0, 100, 0), seed=5)
        do = flash_inputs(torch, dev, dt, 4, 12, 12, 128, 64, (128,) * 4,
                          seed=6)[0]
        kw = dict(scale=0.125, is_causal=True)
        o, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
        ref_o, _ = fa.flash_attention_reference(q, k, v, pad, **kw)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        args = (q, k, v, pad, lse, delta, do)
        grads = fa.flash_attention_bwd_merged(*args, **kw)
        ref = fa.flash_bwd_merged_reference(*args, **kw)
        err = max(rel_err(o, ref_o),
                  *(rel_err(a, b) for a, b in zip(grads, ref)))
        finite = all(bool(torch.isfinite(t).all()) for t in (o, *grads))
        zero = float(o[1].float().abs().max()) == 0.0
        print(f"fully masked rows, {dt}: finite {finite}, out 0 there "
              f"{zero}, max err / max(1, |ref|) {err:.3e} (tolerance "
              f"{tol:g})")
        check(finite and zero and err <= tol,
              f"fully masked rows ({dt}): finite {finite}, err {err:.3e}")
        out[str(dt).split(".")[-1]] = err
    return out


def mt_f32_entries(torch, fa, dev, launches, shapes):
    """Rows 1 and 2 in f32 at the shape the path launched them (`shapes`,
    the flash forward's launches by (dtype, B, Hq, S, D) in the f32
    k-vs-solo run: one slot's rows per tenant, causal), on the 3xTF32
    kernels: held against the plain versions, timed in turns with their
    FMA first versions and beside SDPA, and bounded at the 3xTF32 rate."""
    check(len(shapes) == 1 and next(iter(shapes))[0] == torch.float32,
          f"multitenant f32 flash launches at shapes {shapes}")
    _, B, H, S, D = next(iter(shapes))
    q, k, v, pad = flash_inputs(torch, dev, torch.float32, B, H, H, S, D,
                                (S,) * B, seed=31)
    do = flash_inputs(torch, dev, torch.float32, B, H, H, S, D, (S,) * B,
                      seed=32)[0]
    kw = dict(scale=D ** -0.5, is_causal=True)
    o, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
    delta = (do * o).sum(-1, keepdim=True)
    args = (q, k, v, pad, lse, delta, do)
    grads = fa.flash_attention_bwd_merged(*args, **kw)
    ref = fa.flash_bwd_merged_reference(*args, **kw)
    f_err = max(max_err(o, ref_o), max_err(lse, ref_lse))
    b_err = max(max_err(a, b) for a, b in zip(grads, ref))
    check(f_err <= 1e-4 and b_err <= 1e-4, f"f32 rows 1-2 at the "
          f"multitenant shape: fwd {f_err:.3e}, bwd {b_err:.3e}")
    fma_fwd, fma_bwd = fma_flash(torch, fa, q, k, v, pad, **kw)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    allowed = torch.tril(torch.ones(S, S, dtype=torch.bool, device=dev))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, is_causal=True)
    pairs = B * H * S * (S + 1) // 2
    n = q.numel() * 4
    shape = (f"q {B}x{H}x{S}x{D} f32 causal (the f32 k-vs-solo run, k "
             f"{B // MT['batch']})")
    earlier = {"earlier_source": CSRC + "flash_attention_fwd.cu"}
    times = in_turns(lambda: fa.flash_attention_fwd(q, k, v, pad, **kw),
                     fma_fwd, 50)
    times.update(timed({
        "plain_ms": lambda: fa.flash_attention_reference(q, k, v, pad,
                                                         **kw),
        "library_ms": lambda: sdpa(q, k, v, attn_mask=allowed)}, 50))
    fwd = kernel_entry(
        "flash_attention_fwd", "flash_attention_fwd_tf32.cu",
        "flash_attention.py:162", launches["flash_fwd"], f_err, times,
        f32_bound(4 * n + B * S * 4 + B * H * S * 4, 4 * D * pairs),
        dict(earlier, shape=shape))
    times = in_turns(lambda: fa.flash_attention_bwd_merged(*args, **kw),
                     lambda: fma_bwd(lse, delta, do), 50)
    times.update(timed({
        "plain_ms": lambda: fa.flash_bwd_merged_reference(*args, **kw),
        "library_ms": lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True)}, 50))
    bwd = kernel_entry(
        "flash_attention_bwd_merged", "flash_attention_bwd_merged_tf32.cu",
        "flash_attention.py:415", launches["bwd_merged"], b_err, times,
        f32_bound(7 * n + 2 * B * H * S * 4 + B * S * 4, 10 * D * pairs),
        {"earlier_source": CSRC + "flash_attention_bwd_merged.cu",
         "shape": shape})
    return {"fwd": fwd, "bwd_merged": bwd}


def multitenant(torch, dev, work, kernels, gpt2_dirs, gemma_dirs):
    """The multi-tenant path: runs 1-5 (module docstring), each with its
    counts set to 0 just before it; returns (stats, the path's launches,
    the f32 rows 1-2 entries)."""
    from mobilefinetuner_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    stats, l_fused, files = mt_fused(torch, kernels, work, *gpt2_dirs)
    p50_k1, l_k1 = mt_k1(torch, kernels, work, *gpt2_dirs)
    stats["step_ms_p50_k1"] = p50_k1
    stats["step_time_vs_k1"] = stats["step_ms_p50_k8"] / p50_k1
    stats["f32_k_vs_solo"], l_par, par_shapes = mt_parity(
        torch, dev, kernels, gpt2_dirs[0])
    torch.cuda.empty_cache()
    stats["gemma"], l_gemma = mt_gemma(torch, kernels, work, *gemma_dirs)
    torch.cuda.empty_cache()
    l_hand = mt_handoff(torch, dev, kernels, gpt2_dirs[0], files[:2])
    stats["storage_stable"] = mt_storage_check(torch, dev, gpt2_dirs[0])
    stats["step_events_k8"] = mt_step_events(torch, dev, gpt2_dirs[0])
    stats["orders"] = mt_orders(torch, dev)
    stats["masked_rows_err"] = mt_masked_rows(torch, fa, dev)
    launches = {k: l_fused[k] + l_k1[k] + l_par[k] + l_gemma[k] + l_hand[k]
                for k in l_fused}
    f32 = mt_f32_entries(torch, fa, dev, l_par, par_shapes)
    stats["wall_s"] = time.perf_counter() - t0
    print(f"multitenant: k=8 step ms p50 {stats['step_ms_p50_k8']:.3f}, "
          f"k=1 {p50_k1:.3f} (ratio {stats['step_time_vs_k1']:.3f}), "
          f"{stats['tokens_per_s_k8']:.0f} tokens/s; {stats['refills']} "
          f"refills, {stats['finished']} finished, {stats['files']} files; "
          f"launches {launches}")
    return stats, launches, f32


def mt_step_events(torch, dev, gdir):
    """Where the fused k = 8 step's time goes (bf16, 8 slots x 2 rows x
    seq 128, synthetic batches, past warm-up): the device time of its
    kernels from torch.profiler (CUPTI), the host wall time a step, and
    the busy share."""
    import numpy as np
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.multitenant import (EngineConfig,
                                                       JobSpec,
                                                       MultiTenantEngine)
    config, params_np = load_gpt2(gdir)
    params = convert.gpt2_params_from_numpy(params_np, device=dev)
    b, S = MT["batch"], MT["seq"]

    def stream(job):
        rng = np.random.default_rng(job.data_seed)
        while True:
            ids = rng.integers(1, config.vocab_size, (b, S)).astype(
                np.int32)
            yield {"input_ids": ids, "labels": ids.copy(),
                   "attention_mask": np.ones((b, S), np.float32)}

    jobs = [JobSpec(name=f"e{i}", steps=1000, seed=i, data_seed=i)
            for i in range(MT["slots"])]
    eng = MultiTenantEngine("gpt2", config, params, jobs, stream,
                            EngineConfig(slots=MT["slots"],
                                         rows_per_tenant=b, seq_len=S,
                                         dtype="bfloat16", async_save=False,
                                         flush_every=1000), device=dev)
    eng.admit_pending()
    iters = 6
    evs, wall_ms = device_events(eng.step, iters)
    eng._buffered.clear()
    eng.mux.close()
    dev_ms = sum(us for _, us in evs) / 1e3 / iters
    by_name = collections.Counter()
    for name, us in evs:
        by_name[name] += us / 1e3 / iters
    out = {"device_ms": dev_ms, "wall_ms": wall_ms / iters,
           "device_busy_share": dev_ms / (wall_ms / iters),
           "top": [[n, ms] for n, ms in by_name.most_common(6)]}
    print(f"multitenant k=8 step: device {dev_ms:.3f} ms of "
          f"{out['wall_ms']:.3f} ms wall (busy {out['device_busy_share']:.3f}"
          f"); top {out['top'][:3]}")
    return out


def mt_storage_check(torch, dev, gdir):
    """Join, leave, refill and cancel on the card leave every bank and
    optimizer data_ptr() and total_traces() as they were after warm-up."""
    import numpy as np
    from mobilefinetuner_tpu_torch import convert
    from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
    from mobilefinetuner_tpu_torch.multitenant import (EngineConfig,
                                                       JobSpec,
                                                       MultiTenantEngine)
    config, params_np = load_gpt2(gdir)
    params = convert.gpt2_params_from_numpy(params_np, device=dev,
                                            dtype=torch.bfloat16)

    def stream(job):
        rng = np.random.default_rng(job.data_seed)
        while True:
            ids = rng.integers(1, config.vocab_size, (2, 64)).astype(
                np.int32)
            yield {"input_ids": ids, "labels": ids.copy(),
                   "attention_mask": np.ones((2, 64), np.float32)}

    jobs = [JobSpec(name=n, steps=s, seed=i, data_seed=i)
            for i, (n, s) in enumerate((("a", 5), ("b", 2), ("c", 2),
                                        ("d", 9)))]
    out = tempfile.mkdtemp(prefix="mt_storage_")
    eng = MultiTenantEngine("gpt2", config, params, jobs, stream,
                            EngineConfig(slots=2, rows_per_tenant=2,
                                         seq_len=64, dtype="bfloat16",
                                         prefetch=0, out_dir=out,
                                         flush_every=4), device=dev)
    ptrs = eng.storage_ptrs()
    eng.admit_pending()
    eng.step()
    warm = eng.total_traces()
    eng.step()                          # b finishes, c refills
    eng.step()
    eng.cancel("d")                     # pending -> cancelled
    eng.step()                          # c finishes, slot stays empty
    while eng._has_work():
        eng.step()
    eng.close()
    ok = (eng.storage_ptrs() == ptrs and eng.total_traces() == warm
          and not os.path.exists(os.path.join(out, "d.safetensors")))
    shutil.rmtree(out, ignore_errors=True)
    check(ok, f"multitenant storage: ptrs equal "
          f"{eng.storage_ptrs() == ptrs}, traces {eng.total_traces()} vs "
          f"{warm}")
    print(f"multitenant storage stable on the card: {len(ptrs)} leaves, "
          f"{warm} builds")
    return {"leaves": len(ptrs), "builds": warm}


def multitenant_only(torch, dev, kernels) -> int:
    """`--only multitenant`: the path on its own synthetic GPT-2 small,
    Gemma-3-270M and corpora."""
    from mobilefinetuner_tpu_torch.data.synthetic import (
        write_synthetic_corpus, write_synthetic_gemma270m,
        write_synthetic_gpt2)
    with tempfile.TemporaryDirectory() as work:
        dirs = {n: os.path.join(work, n)
                for n in ("gpt2", "wiki", "gemma", "gwiki")}
        write_synthetic_gpt2(dirs["gpt2"], seed=0)
        write_synthetic_gemma270m(dirs["gemma"], seed=0)
        for n in ("wiki", "gwiki"):
            write_synthetic_corpus(dirs[n], n_train_words=60_000, seed=0)
        stats, launches, f32 = multitenant(
            torch, dev, work, kernels, (dirs["gpt2"], dirs["wiki"]),
            (dirs["gemma"], dirs["gwiki"]))
    print(json.dumps({"multitenant": stats, "launches": launches,
                      "f32_rows": f32}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only", "multitenant"], ["--only", "f32_ce"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mobilefinetuner_tpu_torch.kernels import build
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    from mobilefinetuner_tpu_torch.ops import flash_attention as fa
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc
    from mobilefinetuner_tpu_torch.ops import lora_fused as lf
    kernels = kernel_wrappers()
    STREAMS["dir"] = tempfile.mkdtemp(prefix="chip_smoke_streams_")

    # 1. the card
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 2. build every kernel, in parallel
    built = build.build_all(verbose=True)
    print(f"built {sorted(built)} in {time.perf_counter() - t_start:.1f} s")
    for name, (path, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    ptxas = {name: ptxas_summary(log) for name, (_, log) in built.items()}
    for name in ("flash_attention_fwd_tf32",
                 "flash_attention_bwd_merged_tf32", "fused_ce_dh_tf32",
                 "fused_ce_dh_lora_tf32", "fused_ce_fwd_tf32",
                 "fused_ce_dbt_tf32", "fused_ce_fwd_lora_tf32",
                 "fused_ce_dw_tf32", "lora_epilogue_vec_f32",
                 "paged_decode_attention_vec_f32",
                 "decode_attention_split_f32"):
        check(all(row[2] == 0 and row[3] == 0 for row in ptxas[name]),
              f"{name} spills registers: {ptxas[name]}")
    if argv == ["--only", "f32_ce"]:
        check_wide_h(torch, fc, dev)
        zeros = {p: 0 for p in CE_F32_PATHS}
        entries = f32_ce_entries(
            torch, fc, lf, dev,
            {k: dict(zeros) for k in (*CE_KEYS, *CE_LORA_KEYS[:3])}, ptxas)
        # rows 1-2, 12 and 13 in f32 at the paths' shapes, on stand-in
        # prompt lengths (GPT-2's 8-128 tokens, Gemma's BOS + words)
        lens = {"gpt2": [8, 26, 45, 64, 83, 102, 121, GEN["gpt2_max"]],
                "gemma": [1 + n for n in GEN["gemma_words"]]}
        entries.update(f32_path_entries(
            torch, fa, da, dev, check_paged(torch, da, dev)["gemma_serve_f32"],
            {k: (None, v) for k, v in lens.items()},
            dict.fromkeys(("flash_fwd", "bwd_merged", "paged", "decode_gpt2",
                           "decode_gemma"), 0)))
        print(card)
        print(json.dumps({"f32_ce": entries}))
        return 0
    if argv:
        rc = multitenant_only(torch, dev, kernels)
        shutil.rmtree(STREAMS["dir"], ignore_errors=True)
        print(card)
        return rc

    # 3. each kernel against its plain version, then the model
    flash_err, flash_args = check_flash(torch, fa, dev)
    bwd = check_flash_bwd(torch, fa, dev)
    epi = check_epilogue(torch, lf, dev)
    paged_cases = check_paged(torch, da, dev)
    decode_cases = check_decode(torch, da, dev)
    ce_err, ce_args = check_fused_ce(torch, fc, dev)
    ce_lora_err, ce_lora_args = check_fused_ce_lora(torch, fc, dev)
    check_wide_h(torch, fc, dev)
    params32 = check_model(torch, dev)
    check_train_step(torch, dev, params32)
    del params32
    check_gemma(torch, dev)
    torch.cuda.empty_cache()

    # 4. the serving path, counts set to 0 just before it
    mark = f32_launches()
    launches_serve, serve_stats, eng, names = serve(torch, fa, da)
    mark = mark_f32("serve", mark)
    print(json.dumps({"serve": serve_stats}))
    prof = profile_serve(torch, eng, names)
    eng.close()
    del eng
    torch.cuda.empty_cache()
    gserve_stats, launches_gserve, eng, names = gemma_serve(torch, kernels,
                                                            card)
    mark = mark_f32("gemma_serve", mark)
    prof.update(profile_gemma_serve(torch, eng, names))
    del eng
    torch.cuda.empty_cache()
    zero_counts(kernels)
    gserve_stats["f32"], f32_step = gemma_serve_f32(torch, dev)
    launches_gserve_f32 = read_counts(kernels)
    gserve_stats["f32"]["launches"] = launches_gserve_f32
    mark = mark_f32("gemma_serve_f32", mark)
    gserve_stats["f32"]["decode_step"] = gemma_f32_step_events(torch, da,
                                                               f32_step)
    del f32_step
    print(json.dumps({"gemma_serve": gserve_stats,
                      "launches": launches_gserve}))
    torch.cuda.empty_cache()

    # 5. the training path, counts set to 0 just before it; 6. serve with
    # the trained adapter; 7. the Gemma paths and eval_ppl, counts set to
    # 0 just before each; 8. profile a GPT-2 and three Gemma train steps
    with tempfile.TemporaryDirectory() as work:
        train_stats, launches_train, adapter, model = train(
            torch, dev, work, kernels)
        mark = mark_f32("train", mark)
        train_stats.update(observed("train"))
        print(json.dumps({"train": train_stats,
                          "launches": launches_train}))
        serve_trained(torch, dev, adapter, model)
        prof.update(profile_train(torch, dev, model))
        prof.update(profile_gpt2_full_ft(torch, dev, model))
        del model
        torch.cuda.empty_cache()
        g2full_stats, launches_g2full = gpt2_full_ft(
            torch, work, kernels, train_stats["eval_ppl_before"],
            train_stats["eval_batches"])
        mark = mark_f32("gpt2_full_ft", mark)
        g2full_stats.update(observed("gpt2_full_ft"))
        print(json.dumps({"gpt2_full_ft": g2full_stats,
                          "launches": launches_g2full}))
        torch.cuda.empty_cache()
        # the recovery path: child processes, counts from their wrappers
        t0 = time.perf_counter()
        rec_stats, launches_rec = recovery(torch, work, kernels)
        mark = mark_f32("recovery", mark)
        rec_stats["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"recovery": rec_stats,
                          "launches": launches_rec}))
        # the observability plane: instruments on vs off, a capture, a
        # serving drain and a watchdog abort (children)
        t0 = time.perf_counter()
        obs_stats, launches_obs = observe(torch, work, kernels)
        mark = mark_f32("observe", mark)
        obs_stats["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"observe": obs_stats, "launches": launches_obs}))
        print(f"observe: step ms p50 {obs_stats['step_ms_p50_off']:.3f} "
              f"with every instrument off, {obs_stats['step_ms_p50_on']:.3f}"
              f" on ({100 * obs_stats['overhead_frac']:+.2f}%)")
        torch.cuda.empty_cache()
        gemma_stats, launches_gemma, gemma = gemma_train(torch, dev, work,
                                                         kernels)
        mark = mark_f32("gemma_train", mark)
        gemma_stats.update(observed("gemma_train"))
        print(json.dumps({"gemma_train": gemma_stats,
                          "launches": launches_gemma}))
        full_stats, launches_full = gemma_full_ft(torch, dev, work, kernels,
                                                  gemma)
        mark = mark_f32("gemma_full_ft", mark)
        full_stats.update(observed("gemma_full_ft"))
        print(json.dumps({"gemma_full_ft": full_stats,
                          "launches": launches_full}))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        deg_stats, launches_deg = degrade(torch, dev, work, kernels, gemma)
        mark = mark_f32("degrade", mark)
        deg_stats["wall_s"] = time.perf_counter() - t0
        print(json.dumps({"degrade": deg_stats, "launches": launches_deg}))
        torch.cuda.empty_cache()
        head_stats, launches_head, head_adapter, head_final = \
            gemma_lora_head(torch, dev, work, kernels, gemma)
        mark = mark_f32("gemma_lora_head", mark)
        head_stats.update(observed("gemma_lora_head"))
        print(json.dumps({"gemma_lora_head": head_stats,
                          "launches": launches_head}))
        torch.cuda.empty_cache()
        # the default dtype: the same LoRA runs and full fine-tuning in
        # f32, counts set to 0 just before each
        launches_f32, step_f32 = {}, {}
        for name in CE_F32_PATHS:
            if name == "gemma_full_ft_f32":
                f32_stats, launches_f32[name] = gemma_full_ft(
                    torch, dev, work, kernels, gemma, f32=True)
            else:
                f32_stats, launches_f32[name] = gemma_train_f32(
                    torch, dev, work, kernels, gemma,
                    name == "gemma_lora_head_f32")
            mark = mark_f32(name, mark)
            f32_stats.update(observed(name))
            step_f32[name] = f32_stats["step_device_ms"]
            print(json.dumps({name: f32_stats,
                              "launches": launches_f32[name]}))
            torch.cuda.empty_cache()
        print("f32 step device ms (CUDA-graph replays): " + ", ".join(
            f"{k} {v:.2f}" for k, v in step_f32.items()))
        eval_stats, launches_eval, eval_runs = eval_ppl_phase(
            torch, kernels, gemma, (head_adapter, head_final),
            (os.path.join(work, "gpt2"), os.path.join(work, "wiki"),
             adapter, train_stats["eval_batches"]))
        mark = mark_f32("eval_ppl", mark)
        print(json.dumps({"eval_ppl": eval_stats, "launches": eval_runs}))
        torch.cuda.empty_cache()
        gen_dirs = {"gpt2": (os.path.join(work, "gpt2"), adapter),
                    "gemma": (gemma[4], head_adapter)}
        gen_stats, launches_gen, gen_runs, gen_prompts = generate_phase(
            torch, dev, kernels, gen_dirs["gpt2"], gen_dirs["gemma"])
        mark = mark_f32("generate", mark)
        for fam in ("gpt2", "gemma"):
            dev_ms, wall_ms = decode_step_events(
                torch, dev, *gen_dirs[fam], fam, gen_prompts[fam][0])
            gen_stats[fam]["decode_step_events"] = {
                "device_ms": dev_ms, "wall_ms": wall_ms,
                "device_busy_share": dev_ms
                / gen_stats[fam]["decode_step_ms_p50"]}
        print(json.dumps({"generate": gen_stats, "launches": gen_runs}))
        torch.cuda.empty_cache()
        mmlu_stats, launches_mmlu, mmlu_runs, mmlu_flash = mmlu_phase(
            torch, dev, kernels, gen_dirs["gpt2"], gen_dirs["gemma"])
        mark = mark_f32("mmlu", mark)
        print(json.dumps({"mmlu": mmlu_stats, "launches": mmlu_runs}))
        torch.cuda.empty_cache()
        mt_stats, launches_mt, mt_f32 = multitenant(
            torch, dev, work, kernels,
            (os.path.join(work, "gpt2"), os.path.join(work, "wiki")),
            (gemma[4], gemma[5]))
        mark = mark_f32("multitenant", mark)
        print(json.dumps({"multitenant": mt_stats, "launches": launches_mt}))
        torch.cuda.empty_cache()
        prof.update(profile_gemma_train(torch, dev, gemma))
        prof.update(profile_gemma_train(torch, dev, gemma, head=True))
        torch.cuda.empty_cache()
        prof.update(profile_gemma_full_ft(torch, dev, gemma))
        del gemma
    print(json.dumps({"profile": prof}))

    # 9. times and bounds at the main paths' shapes
    q, k, v, pad = flash_args
    B, Hq, S, D = q.shape
    isz = q.element_size()
    allowed = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    allowed = allowed[None, None] & (pad > 0)[:, None, None, :]
    pairs = int(allowed.sum()) * Hq
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_qkv = q.numel()                       # elements of one [B,H,S,D]
    fl_times = timed({
        "ms": lambda: fa.flash_attention_fwd(q, k, v, pad),
        "plain_ms": lambda: fa.flash_attention_reference(q, k, v, pad),
        "library_ms": lambda: sdpa(q, k, v, attn_mask=allowed)})
    fl_bound = bound(4 * n_qkv * isz + pad.numel() * 4 + B * Hq * S * 4,
                     4 * D * pairs)

    (bq, bk, bv, bpad, lse, delta, do), kw = bwd["args"]
    leaves = [t.detach().clone().requires_grad_(True) for t in (bq, bk, bv)]
    lib_out = sdpa(*leaves, is_causal=True)
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, leaves, do, retain_graph=True)
    bargs = (bq, bk, bv, bpad, lse, delta, do)
    bwd_in = 4 * n_qkv * isz + 2 * B * Hq * S * 4 + bpad.numel() * 4
    merged_times = timed({
        "ms": lambda: fa.flash_attention_bwd_merged(*bargs, **kw),
        "plain_ms": lambda: fa.flash_bwd_merged_reference(*bargs, **kw),
        "library_ms": lib_bwd})
    dq_times = timed({
        "ms": lambda: fa.flash_attention_bwd_dq(*bargs, **kw),
        "plain_ms": lambda: fa.flash_bwd_split_reference(*bargs, **kw),
        "library_ms": lib_bwd})
    dkv_times = timed({
        "ms": lambda: fa.flash_attention_bwd_dkv(*bargs, **kw),
        "plain_ms": lambda: fa.flash_bwd_split_reference(*bargs, **kw),
        "library_ms": lib_bwd})

    epi_entries = {}   # launches: the main paths' runs at that shape
    for site, (err, (y, xa, b, es)) in epi.items():
        epi_entries[site] = kernel_entry(
            "lora_epilogue", "lora_epilogue_vec.cu", "lora_fused.py:78",
            EPI_BY_SHAPE[(y.dtype, *y.shape)], err,
            timed(epi_fns(torch, lf, y, xa, b, es)), epi_bound(y, xa, b),
            {"shape": f"y {y.shape[0]}x{y.shape[1]}, r {xa.shape[1]}, "
                      f"bf16"})

    pg_entries = {name: paged_entry(torch, da, paged_cases[name])
                  for name in ("serving", "gemma_serve")}

    dec_entries = {name: decode_entry(torch, da, decode_cases[name])
                   for name in ("gpt2_bench", "gemma_path")}

    ce_times, ce_bounds = fused_ce_times(torch, fc, ce_args)
    gemma_entries = gemma_kernel_entries(torch, fa, lf, dev)
    mmlu_entries = mmlu_kernel_entries(torch, fa, lf, dev, mmlu_flash)
    ce_f32 = {key: {p: launches_f32[p][key] for p in CE_F32_PATHS}
              for key in (*CE_KEYS, *CE_LORA_KEYS[:3])}
    for key, n in ce_f32.items():   # rows 6-8 (9-11) ran on their paths
        path = ("gemma_full_ft_f32" if key == "fused_ce_dw" else
                CE_F32_PATHS[int(key.endswith("_lora"))])
        check(n[path] > 0, f"{key} launched no time in f32 on {path}")
    f32_first = f32_ce_entries(torch, fc, lf, dev, ce_f32, ptxas)
    f32p = f32_path_entries(
        torch, fa, da, dev, paged_cases["gemma_serve_f32"], gen_prompts,
        {"flash_fwd": FLASH_BY_SHAPE[(torch.float32, 4, 4, 256, 256)],
         "bwd_merged": sum(F32_BY_PATH[p][1] for p in CE_F32_PATHS),
         "paged": launches_gserve_f32["paged"],
         "decode_gpt2": gen_runs["gpt2_tf32"]["decode"],
         "decode_gemma": gen_runs["gemma_tf32"]["decode"]})
    gserve_flash = gemma_serve_flash_entry(torch, fa, dev)
    serve_names = {"flash_fwd": "flash", "paged": "paged",
                   "decode": "decode"}

    def by_path(name):
        return {"serve": launches_serve.get(serve_names.get(name), 0),
                "gemma_serve": launches_gserve[name],
                "gemma_serve_f32": launches_gserve_f32[name],
                "generate": launches_gen[name],
                "train": launches_train[name],
                "gpt2_full_ft": launches_g2full[name],
                "gemma_train": launches_gemma[name],
                "gemma_full_ft": launches_full[name],
                "gemma_lora_head": launches_head[name],
                **{p: launches_f32[p][name] for p in CE_F32_PATHS},
                "eval_ppl": launches_eval[name],
                "mmlu": launches_mmlu[name],
                "recovery": launches_rec[name],
                "degrade": launches_deg[name],
                "observe": launches_obs[name],
                "multitenant": launches_mt[name]}

    def total(name):
        return sum(by_path(name).values())

    # rows 1, 2 and 5 by dtype: the 16-bit launches ran the _mma (_vec)
    # sources, the f32 ones the 3xTF32 (_vec_f32) sources; each source's
    # entry has its own
    check(f32_launches() == tuple(map(sum, zip(*F32_BY_PATH.values()))),
          f"f32 launches {f32_launches()} not all in {F32_BY_PATH}")
    f32_paths = {name: {p: n[i] for p, n in F32_BY_PATH.items() if n[i]}
                 for i, name in enumerate(("flash_fwd", "bwd_merged",
                                           "lora_epilogue"))}

    # rows 12 and 13 in f32 ran on the flash-decoding splits: on
    # gemma_serve_f32 (row 12) and generate's two f32 runs (row 13)
    f32_decode = f32p["decode_gpt2"]["launches"] \
        + f32p["decode_gemma"]["launches"]
    f32_paths["paged"] = {"gemma_serve_f32": f32p["paged"]["launches"]}
    f32_paths["decode"] = {"generate": f32_decode}

    def by_path_16(name):
        return {p: n - f32_paths[name].get(p, 0)
                for p, n in by_path(name).items()}

    for name in ("paged", "decode"):
        check(min(by_path_16(name).values()) >= 0,
              f"{name}: f32 launches {f32_paths[name]} exceed the paths' "
              f"{by_path(name)}")

    for name in ("flash_fwd", "bwd_merged", "lora_epilogue"):
        check(sum(f32_paths[name].values()) > 0
              and sum(by_path_16(name).values()) > 0,
              f"{name}: a source of it ran no time on the paths (f32 "
              f"{f32_paths[name]})")
    f32_fwd_main = max((e for e in mmlu_entries["flash_f32"]
                        if e["family"] == "gpt2"),
                       key=lambda e: e["bucket"])

    check(sum(EPI_BY_SHAPE.values()) == total("lora_epilogue"),
          f"epilogue launches by shape {sum(EPI_BY_SHAPE.values())} != "
          f"{total('lora_epilogue')}")

    kernels_line = [
        kernel_entry(
            "flash_attention_fwd", "flash_attention_fwd_mma.cu",
            "flash_attention.py:162", sum(by_path_16("flash_fwd").values()),
            flash_err, fl_times, fl_bound,
            {"launches_by_path": by_path_16("flash_fwd"),
             "ptxas": ptxas["flash_attention_fwd_mma"],
             "f32": "flash_attention_fwd_tf32.cu (its own entry)",
             "shape": f"q {B}x{Hq}x{S}x{D} bf16 causal (training)",
             "gemma": gemma_entries["flash_fwd"],
             "gemma_serve": dict(gserve_flash,
                                 launches=launches_gserve["flash_fwd"]),
             "mmlu": mmlu_entries["flash"]}),
        dict(f32_fwd_main, launches=sum(f32_paths["flash_fwd"].values()),
             launches_at_shape=f32_fwd_main["launches"],
             launches_by_path=f32_paths["flash_fwd"],
             ptxas=ptxas["flash_attention_fwd_tf32"],
             shapes=[mt_f32["fwd"], *mmlu_entries["flash_f32"]],
             gemma_train_f32=f32p["flash_fwd"]),
        kernel_entry(
            "flash_attention_bwd_merged", "flash_attention_bwd_merged_mma.cu",
            "flash_attention.py:415",
            sum(by_path_16("bwd_merged").values()),
            bwd["merged"], merged_times,
            bound(bwd_in + 3 * n_qkv * isz, 10 * D * pairs),
            {"launches_by_path": by_path_16("bwd_merged"),
             "ptxas": ptxas["flash_attention_bwd_merged_mma"],
             "f32": "flash_attention_bwd_merged_tf32.cu (its own entry)",
             "shape": f"q {B}x{Hq}x{S}x{D} bf16 causal (training)",
             "gemma": gemma_entries["bwd_merged"]}),
        dict(mt_f32["bwd_merged"],
             launches=sum(f32_paths["bwd_merged"].values()),
             launches_at_shape=mt_f32["bwd_merged"]["launches"],
             launches_by_path=f32_paths["bwd_merged"],
             ptxas=ptxas["flash_attention_bwd_merged_tf32"],
             gemma_train_f32=f32p["bwd_merged"]),
        kernel_entry(
            "flash_attention_bwd_dq", "flash_attention_bwd_split.cu",
            "flash_attention.py:269", total("bwd_dq"), bwd["dq"],
            dq_times, bound(bwd_in + n_qkv * isz, 6 * D * pairs),
            {"launches_by_path": by_path("bwd_dq")}),
        kernel_entry(
            "flash_attention_bwd_dkv", "flash_attention_bwd_split.cu",
            "flash_attention.py:362", total("bwd_dkv"), bwd["dkv"],
            dkv_times, bound(bwd_in + 2 * n_qkv * isz, 8 * D * pairs),
            {"launches_by_path": by_path("bwd_dkv")}),
        dict(epi_entries["attn_qkv"],
             launches=sum(by_path_16("lora_epilogue").values()),
             launches_by_path=by_path_16("lora_epilogue"),
             shape="attn_qkv: y 1024x2304, r 8, bf16",
             ptxas=ptxas["lora_epilogue_vec"],
             f32="lora_epilogue_vec_f32.cu (its own entry)",
             gemma=gemma_entries["lora_epilogue"],
             attn_proj=epi_entries["attn_proj"],
             mmlu_lm_head=mmlu_entries["lm_head"],
             decode={site: epi_entries[site] for site in (
                 "decode_attn_qkv", "decode_gate_proj", "decode_lm_head")}),
        dict(f32_first["lora_epilogue"],
             launches=sum(f32_paths["lora_epilogue"].values()),
             launches_by_path=f32_paths["lora_epilogue"],
             launches_at_shape=f32_first["lora_epilogue"]["launches"],
             launches_by_shape={f"{n}x{d}": c for (dt, n, d), c
                                in sorted(EPI_BY_SHAPE.items(),
                                          key=lambda kv: kv[0][1:])
                                if dt == torch.float32}),
        dict(pg_entries["serving"], launches=total("paged") - f32p["paged"][
                 "launches"],
             launches_by_path=by_path_16("paged"),
             ptxas=ptxas["paged_decode_attention_vec"],
             f32=dict(f32p["paged"],
                      ptxas=ptxas["paged_decode_attention_vec_f32"],
                      earlier_ptxas=ptxas["paged_decode_attention"],
                      launches_by_path={"gemma_serve_f32":
                                        f32p["paged"]["launches"]}),
             gemma=dict(pg_entries["gemma_serve"],
                        launches=launches_gserve["paged"])),
        dict(dec_entries["gpt2_bench"],
             launches=total("decode") - f32_decode,
             launches_by_path=by_path_16("decode"),
             ptxas=ptxas["decode_attention_mma"],
             f32=dict(f32p["decode_gpt2"],
                      ptxas=ptxas["decode_attention_split_f32"],
                      earlier_ptxas=ptxas["decode_attention"],
                      launches=f32_decode,
                      launches_at_shape=f32p["decode_gpt2"]["launches"],
                      gemma=f32p["decode_gemma"]),
             gemma=dec_entries["gemma_path"]),
    ]
    # the fused CE in bf16: every path but CE_F32_PATHS, whose launches
    # are the f32 entries' (rows 6, 7, 10 and 11's 3xTF32 sources have
    # their own)
    def by_path_ce16(key):
        return {p: n for p, n in by_path(key).items()
                if p not in CE_F32_PATHS}

    ce_shape = "R 128 (4 x 32 rows), V 262144, H 640, bf16 (gemma chunk)"
    own = {"fused_ce_fwd": "fused_ce_fwd_tf32.cu (its own entry)",
           "fused_ce_bwd_dh": "fused_ce_dh_tf32.cu (its own entry)",
           "fused_ce_bwd_dw": "fused_ce_dw_tf32.cu (its own entry)",
           "fused_ce_fwd_lora": "fused_ce_fwd_lora_tf32.cu (its own entry)",
           "fused_ce_bwd_dh_lora": "fused_ce_dh_lora_tf32.cu (its own "
                                   "entry)",
           "fused_ce_bwd_dw_lora": "fused_ce_dbt_tf32.cu (its own entry, "
                                   "dbt only)"}
    for name, key, line, err, source in (
            ("fused_ce_fwd", "fused_ce_fwd", "fused_ce.py:121",
             max(ce_err["lse"], ce_err["gold"]), "fused_ce_fwd_mma.cu"),
            ("fused_ce_bwd_dh", "fused_ce_dh", "fused_ce.py:196",
             ce_err["dh"], "fused_ce_dh_mma.cu"),
            ("fused_ce_bwd_dw", "fused_ce_dw", "fused_ce.py:224",
             ce_err["dw"], "fused_ce_dw_mma.cu")):
        extra = {"launches_by_path": by_path_ce16(key), "shape": ce_shape,
                 "ptxas": ptxas[source[:-3]],
                 "f32": own[name]}
        kernels_line.append(kernel_entry(
            name, source, line, sum(by_path_ce16(key).values()), err,
            ce_times[key], ce_bounds[key], extra))
        kernels_line.append(f32_first[name])
    ce_lora_times, ce_lora_bounds = fused_ce_lora_times(torch, fc,
                                                        ce_lora_args)
    lora_shape = "R 128, V 262144, H 640, r 8, bf16 (gemma chunk)"
    for name, key, line, err in (
            ("fused_ce_fwd_lora", "fused_ce_fwd_lora", "fused_ce.py:350",
             max(ce_lora_err["lse"], ce_lora_err["gold"])),
            ("fused_ce_bwd_dh_lora", "fused_ce_dh_lora", "fused_ce.py:384",
             max(ce_lora_err["dh"], ce_lora_err["dxa"])),
            ("fused_ce_bwd_dw_lora", "fused_ce_dw_lora", "fused_ce.py:421",
             ce_lora_err["dbt_only"])):
        source = {"fused_ce_fwd_lora": "fused_ce_fwd_lora_mma.cu",
                  "fused_ce_dh_lora": "fused_ce_dh_lora_mma.cu",
                  "fused_ce_dw_lora": "fused_ce_dbt_mma.cu"}[key]
        extra = {"launches_by_path": by_path_ce16(key),
                 "shape": lora_shape, "ptxas": ptxas[source[:-3]],
                 "f32": own[name]}
        if key == "fused_ce_dw_lora":
            extra["shape"] += ", dbt only (frozen head)"
            # the dW + dbt mode, every dtype, on fused_ce.cu's dw_kernel
            extra["dw_mode"] = kernel_entry(
                name, "fused_ce.cu", line, None,
                max(ce_lora_err["dw"], ce_lora_err["dbt"]),
                ce_lora_times["fused_ce_dw_lora_dw_mode"],
                ce_lora_bounds["fused_ce_dw_lora_dw_mode"],
                {"shape": lora_shape + ", dW and dbt",
                 "ptxas": [row for row in ptxas["fused_ce"]
                           if row[0].startswith("dw_kernel")]})
        kernels_line.append(kernel_entry(
            name, source, line, sum(by_path_ce16(key).values()), err,
            ce_lora_times[key], ce_lora_bounds[key], extra))
        kernels_line.append(f32_first[name])
    print(json.dumps({"bwd_sweep": bwd_sweep(torch, fa, dev)}))
    print(json.dumps({"admission": ADMISSION}))
    shutil.rmtree(STREAMS["dir"], ignore_errors=True)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
