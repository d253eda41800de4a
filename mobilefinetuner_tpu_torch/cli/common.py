"""Shared CLI machinery: the JAX package's flag groups and the core of its
training loop (port of mobilefinetuner_tpu/cli/common.py).

Ported: the training hyperparameters, `micro_batches` (the byte-pinned
step-batch stream, with `skip_steps` for resume), the async input
pipeline (`--prefetch`, `--prefetch_rss_mb`: data/prefetch.Prefetcher),
`evaluate`, the step / eval / save cadence, `--resume_from` (adapter or
full model + `.opt` sidecar, checksum-verified; `load_full_resume`), the
streaming-refetch retry budget (`--data_retries`, `--data_backoff_s`),
the pretokenized train split of the Gemma CLIs (`--pretokenized_path`),
the metrics CSV, the eval JSONL and the log lines, with the JAX CLIs'
columns and formats.

Every other flag keeps its JAX name, and its default here is "off"; a run
that asks for one raises NotImplementedError naming the ROADMAP.md port
item that brings it (`check_not_ported`): telemetry and the run registry,
the mesh, offload, the memory-admission ladder, rollback, fault
injection, the step governor, async checkpoint writes, checkpoint
lineage. Nothing is accepted and silently ignored.

The device is the CLIs' one addition: `--device` (default: the CUDA
card; `--device cpu` is an explicit choice, as the tests make it).
"""

from __future__ import annotations

import argparse
import itertools
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.core.logging import (JSONLWriter,
                                                    MetricsLogger,
                                                    get_logger)
from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)
from mobilefinetuner_tpu_torch.io.safetensors_io import (
    CheckpointIntegrityError, SafeTensorsReader, verify_report)
from mobilefinetuner_tpu_torch.ops.dropout import fold_in
from mobilefinetuner_tpu_torch.ops.loss import perplexity_from_loss
from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                     init_optimizer,
                                                     make_eval_step,
                                                     make_train_step)

log = get_logger()

# (args attribute, its "off" value, what it asks for, ROADMAP.md port item)
NOT_PORTED = (
    ("align_dump_dir", "", "the alignment harness (--align_dump_dir)", "P3"),
    ("async_save", 0, "background checkpoint writes (--async_save)", "P5"),
    ("keep_ckpts", 0, "checkpoint lineage and GC (--keep_ckpts)", "P5"),
    ("rollback_budget", 0, "in-process rollback (--rollback_budget)", "P5"),
    ("inject", "", "fault injection (--inject)", "P5"),
    ("on_preempt", "off", "the preemption drain (--on_preempt)", "P5"),
    ("on_oom_risk", "warn",
     "the memory-admission ladder (--on_oom_risk)", "P5"),
    ("hbm_cap_mb", 0, "the memory preflight (--hbm_cap_mb)", "P5"),
    ("opt_offload", False, "optimizer-state offload (--opt_offload)", "P9"),
    ("opt_offload_state_dtype", "float32",
     "optimizer-state offload (--opt_offload_state_dtype)", "P9"),
    ("opt_offload_master_dtype", "float32",
     "optimizer-state offload (--opt_offload_master_dtype)", "P9"),
    ("telemetry_out", "", "the telemetry stream (--telemetry_out)", "P6"),
    ("run_registry", "", "the run registry (--run_registry)", "P6"),
    ("profile_dir", "", "the profiler window (--profile_dir)", "P6"),
    ("spike_z", 0.0, "the loss-spike detector (--spike_z)", "P6"),
    ("watchdog", 0, "the hang watchdog (--watchdog)", "P6"),
    ("straggler_cadence", 0, "straggler attribution", "P6"),
    ("trace_spans", 0, "trace spans (--trace_spans)", "P6"),
    ("auto_profile", 0, "the flight recorder (--auto_profile)", "P6"),
    ("metrics_port", 0, "the metrics endpoint (--metrics_port)", "P6"),
    ("pm_interval", 0, "the step governor (--pm_interval)", "P6"),
    ("pm_schedule", "", "the step governor (--pm_schedule)", "P6"),
    ("shard_enable", False, "parameter offload (--shard_enable)", "P9"),
    ("mesh_data", 1, "a device mesh (--mesh_data)", "P9"),
    ("mesh_fsdp", 1, "a device mesh (--mesh_fsdp)", "P9"),
    ("sequence_parallel", False, "sequence parallelism", "P9"),
    ("multihost", False, "multi-host runs (--multihost)", "P9"),
    ("dist_coordinator", "", "multi-host runs (--dist_coordinator)", "P9"),
    ("dist_num_processes", 0, "multi-host runs", "P9"),
    ("dist_process_id", -1, "multi-host runs", "P9"),
)


def check_not_ported(args) -> None:
    """NotImplementedError for the first flag set to anything but its
    "off" value (NOT_PORTED)."""
    for attr, off, what, item in NOT_PORTED:
        if hasattr(args, attr) and getattr(args, attr) != off:
            raise NotImplementedError(
                f"{what} is not ported to mobilefinetuner_tpu_torch yet "
                f"(ROADMAP.md port item {item}); the JAX CLI has it")


# --------------------------- flag groups ------------------------------------

def add_train_flags(p: argparse.ArgumentParser, lr: float = 1e-4,
                    seq_len: int = 128, batch_size: int = 1):
    """Training hyperparameters, with the JAX CLIs' names and defaults."""
    g = p.add_argument_group("training")
    g.add_argument("--epochs", type=int, default=0,
                   help="epochs (overrides steps when > 0)")
    g.add_argument("--steps", type=int, default=0, help="training steps")
    g.add_argument("--batch_size", type=int, default=batch_size,
                   help="micro-batch size per accumulation step")
    g.add_argument("--grad_accum_steps", "--grad_accum", type=int, default=1)
    g.add_argument("--seq_len", type=int, default=seq_len)
    g.add_argument("--lr", type=float, default=lr)
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--warmup_steps", type=int, default=0)
    g.add_argument("--warmup_ratio", type=float, default=None,
                   help="overrides warmup_steps when set")
    g.add_argument("--clip_grad_norm", "--max_grad_norm", type=float,
                   default=1.0)
    g.add_argument("--lr_schedule", choices=["cosine", "linear", "constant"],
                   default="cosine")
    g.add_argument("--data_fraction", type=float, default=1.0)
    g.add_argument("--log_interval", type=int, default=1)
    g.add_argument("--eval_interval", type=int, default=0)
    g.add_argument("--eval_batches", type=int, default=50)
    g.add_argument("--eval_batch_size", type=int, default=2)
    g.add_argument("--save_every", type=int, default=0)
    g.add_argument("--ema_beta", type=float, default=0.9)
    g.add_argument("--seed", type=int, default=42)
    g.add_argument("--coupled_weight_decay", action="store_true",
                   help="L2-into-gradient decay (reference parity); "
                        "default is decoupled AdamW")
    g.add_argument("--metrics_csv", default="", help="CSV metrics sink")
    g.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32", help="compute dtype")
    g.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward "
                        "(torch.utils.checkpoint)")
    g.add_argument("--attention_impl", choices=["auto", "xla", "flash"],
                   default="auto",
                   help="'auto': the flash kernels on the card, the plain "
                        "attention on the CPU; 'flash': the flash path on "
                        "any device (its plain versions on the CPU); "
                        "'xla': the plain attention everywhere")
    g.add_argument("--lora_impl", choices=["auto", "naive", "fused"],
                   default="auto",
                   help="'auto': the LoRA epilogue kernel at every site on "
                        "the card, the naive order on the CPU; 'fused': "
                        "the epilogue path anywhere; 'naive': the parity "
                        "oracle (models/lora_apply.py)")
    g.add_argument("--no_model_dropout", action="store_true",
                   help="zero the checkpoint's embd/resid/attn pdrop")
    g.add_argument("--skip_nonfinite", type=int, default=0,
                   help="1 = a step with non-finite gradients leaves "
                        "params and optimizer state unchanged")
    g.add_argument("--verify_ckpt", type=int, default=1,
                   help="1 = verify --resume_from against its checksum "
                        "manifest before loading")
    g.add_argument("--data_retries", type=int, default=3,
                   help="retry budget of the streaming refetch path (the "
                        "in-RAM data path has none to retry)")
    g.add_argument("--data_backoff_s", type=float, default=0.5)
    g.add_argument("--prefetch", type=int, default=2,
                   help="async input pipeline (data/prefetch.py): a "
                        "background thread assembles host batches into a "
                        "bounded queue of this depth, and batch k+1 is "
                        "placed on the device (with its dropout seeds) "
                        "while step k is launched. 0 = synchronous. The "
                        "batch sequence is byte-identical either way "
                        "(resume included)")
    # not ported: accepted by name, refused unless off (check_not_ported)
    for name, kind, default in (
            ("--async_save", int, 0),
            ("--telemetry_out", str, ""), ("--run_registry", str, ""),
            ("--profile_dir", str, ""), ("--profile_start", int, 10),
            ("--profile_steps", int, 5), ("--spike_z", float, 0.0),
            ("--spike_beta", float, 0.98), ("--spike_warmup", int, 20),
            ("--watchdog", int, 0), ("--watchdog_mult", float, 10.0),
            ("--watchdog_min_s", float, 60.0),
            ("--straggler_cadence", int, 0),
            ("--straggler_mult", float, 1.5), ("--trace_spans", int, 0),
            ("--auto_profile", int, 0), ("--auto_profile_dir", str, ""),
            ("--auto_profile_steps", int, 2),
            ("--auto_profile_cooldown", float, 300.0),
            ("--auto_profile_budget", int, 2),
            ("--auto_profile_slow_mult", float, 3.0),
            ("--metrics_port", int, 0), ("--metrics_addr", str, "127.0.0.1"),
            ("--on_preempt", str, "off"), ("--rollback_budget", int, 0),
            ("--rollback_skip_streak", int, 3),
            ("--rollback_data_offset", int, 1), ("--keep_ckpts", int, 0),
            ("--inject", str, "")):
        g.add_argument(name, type=kind, default=default,
                       help="not ported yet (ROADMAP.md)")
    add_mem_flags(p)


def add_mem_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("memory admission (not ported yet, except "
                             "--prefetch_rss_mb)")
    g.add_argument("--hbm_cap_mb", type=int, default=0)
    g.add_argument("--hbm_headroom", type=float, default=0.1)
    g.add_argument("--on_oom_risk", choices=["fail", "degrade", "warn"],
                   default="warn",
                   help="'warn' = proceed without a preflight (the port "
                        "has none yet)")
    g.add_argument("--prefetch_rss_mb", type=int, default=0,
                   help="host-RSS shed guard of the input pipeline: "
                        "while the process RSS exceeds this many MB the "
                        "producer stops assembling lookahead batches "
                        "until the queue drains. 0 = off")


def add_align_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("alignment harness (not ported yet)")
    g.add_argument("--align_dump_dir", default="")
    g.add_argument("--align_steps", type=int, default=5)


def add_pm_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("step governor (not ported yet)")
    g.add_argument("--pm_interval", type=int, default=0)
    for name, default in (("--pm_batt_thresh", 20.0),
                          ("--pm_temp_thresh", 42.0), ("--pm_fb_high", 2.0),
                          ("--pm_fb_low", 0.5), ("--pm_ft_high", 2.0),
                          ("--pm_ft_low", 0.5), ("--pm_manual_batt", 100.0),
                          ("--pm_manual_temp", 30.0)):
        g.add_argument(name, type=float, default=default)
    g.add_argument("--pm_disable_batt", action="store_true")
    g.add_argument("--pm_disable_temp", action="store_true")
    g.add_argument("--pm_schedule", default="")


def add_shard_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("parameter offload (not ported yet)")
    g.add_argument("--shard_enable", action="store_true")
    g.add_argument("--shard_dir", default="")
    g.add_argument("--shard_budget_mb", type=int, default=512)
    g.add_argument("--shard_fp16_disk", type=int, default=1)
    g.add_argument("--shard_stream", type=int, default=1)


def add_mesh_flags(p: argparse.ArgumentParser):
    g = p.add_argument_group("device mesh (not ported yet)")
    g.add_argument("--mesh_data", type=int, default=1)
    g.add_argument("--mesh_fsdp", type=int, default=1)
    g.add_argument("--sequence_parallel", action="store_true")
    g.add_argument("--multihost", action="store_true")
    g.add_argument("--dist_coordinator", default="")
    g.add_argument("--dist_num_processes", type=int, default=0)
    g.add_argument("--dist_process_id", type=int, default=-1)


def setup_device(args) -> torch.device:
    """--device resolved (core/device.py); on the card, f32 matmuls and
    convolutions in full f32 (no TF32), as on the CPU."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def data_retry_kwargs(args) -> dict:
    """WT2Config kwargs of the streaming refetch's bounded retry
    (--data_retries, --data_backoff_s), for the train and eval datasets
    of every train CLI alike."""
    return {"retries": max(getattr(args, "data_retries", 0), 0),
            "retry_backoff_s": getattr(args, "data_backoff_s", 0.5)}


def gemma_datasets(args):
    """(train, valid or None) WikiText-2 datasets of the Gemma CLIs: the
    Gemma tokenizer of --model_dir without a BOS, pad_id from it; the
    train split from --pretokenized_path when given (a memmap of the .bin
    beside its `<bin>.meta.json` or `meta.json`; --pretokenized_meta is
    accepted for the reference CLI's sake and not read, as in the JAX
    CLI); the valid split only with --eval_interval."""
    from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
        GemmaTokenizer
    tok = GemmaTokenizer.from_pretrained(args.model_dir)

    def encode(s):
        return tok.encode(s, add_bos=False)

    train_ds = WikiText2Dataset(
        args.data_dir, "train",
        WT2Config(seq_len=args.seq_len, batch_size=args.batch_size,
                  data_fraction=args.data_fraction, seed=args.seed,
                  **data_retry_kwargs(args)),
        encode, tok.eos_id, pad_id=tok.pad_id,
        pretokenized_bin=getattr(args, "pretokenized_path", "") or None)
    valid_ds = None
    if args.eval_interval and args.data_dir:
        valid_ds = WikiText2Dataset(
            args.data_dir, "valid",
            WT2Config(seq_len=args.seq_len,
                      batch_size=args.eval_batch_size, shuffle=False,
                      **data_retry_kwargs(args)),
            encode, tok.eos_id, pad_id=tok.pad_id)
    return train_ds, valid_ds


def add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")


# --------------------------- loop helpers -----------------------------------

def load_full_resume(path: str):
    """The HF-keyed tensors of a full-model resume source: an HF checkpoint
    dir or a single safetensors file (both full fine-tuning CLIs)."""
    from mobilefinetuner_tpu_torch.io.checkpoints import load_hf_state_dict
    if os.path.isdir(path):
        return load_hf_state_dict(path)
    return SafeTensorsReader(path).load_all(promote_to_f32=True)


def resolve_total_steps(args, steps_per_epoch: int) -> int:
    """epochs overrides steps; neither = one epoch."""
    if args.epochs > 0:
        return max(args.epochs * steps_per_epoch, 1)
    if args.steps > 0:
        return args.steps
    return max(steps_per_epoch, 1)


def train_config_from_args(args, total_steps: int) -> TrainConfig:
    warmup_ratio = (args.warmup_ratio if args.warmup_ratio is not None
                    else args.warmup_steps / max(total_steps, 1))
    return TrainConfig(
        total_steps=total_steps, lr=args.lr, warmup_ratio=warmup_ratio,
        schedule=args.lr_schedule, clip_grad_norm=args.clip_grad_norm,
        grad_accum_steps=args.grad_accum_steps,
        weight_decay=args.weight_decay,
        coupled_weight_decay=args.coupled_weight_decay,
        skip_nonfinite=bool(args.skip_nonfinite))


def compute_dtype_from_args(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def attn_impl_from_args(args) -> str:
    """--attention_impl (the JAX names) -> ops.attention's impl."""
    return {"auto": "auto", "xla": "plain", "flash": "flash"}[
        args.attention_impl]


def micro_batches(dataset: WikiText2Dataset, accum: int,
                  skip_steps: int = 0) -> Iterator[tuple]:
    """(epoch, [accum*micro_b, ...] numpy step batch) forever, cycling
    epochs; the stream is continuous across epochs, so step s consumes
    micro-batches [s*accum, (s+1)*accum). skip_steps fast-forwards past
    consumed steps without building them: a resumed run continues the
    exact data order of an uninterrupted one."""
    nb = dataset.num_batches()
    if nb == 0:
        raise ValueError(
            "dataset yields zero batches (num_chunks < batch_size with "
            "drop_last=True: seq_len/batch_size too large or "
            "--data_fraction too small for this split)")
    b, S = dataset.config.batch_size, dataset.config.seq_len
    epoch, bi = divmod(skip_steps * accum, nb)
    order = dataset.chunk_order(epoch)
    while True:
        slices = []
        for _ in range(accum):
            if bi >= nb:
                bi = 0
                epoch += 1
                order = dataset.chunk_order(epoch)
            slices.append(order[bi * b:(bi + 1) * b])
            bi += 1
        rows = sum(len(s) for s in slices)
        ids = np.empty((rows, S), np.int32)
        mask = np.empty((rows, S), np.float32)
        labels = np.empty((rows, S), np.int32)
        r0 = 0
        for sl in slices:
            dataset.fill_rows(sl, ids, mask, labels, row0=r0)
            r0 += len(sl)
        yield epoch, {"input_ids": ids, "attention_mask": mask,
                      "labels": labels}


def place_batch(batch: dict, device: torch.device) -> dict:
    """numpy batch -> tensors on `device`: ids and labels as int64, the
    mask as float32. To a card the copy goes through pinned memory,
    asynchronously, so placing a batch does not wait for the card."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a)
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t
    return out


def evaluate(eval_step, trainable, frozen, dataset: WikiText2Dataset,
             max_batches: int, device: torch.device,
             prefetch: int = 2) -> dict:
    """Token-weighted mean NLL over the split -> {loss, ppl, tokens,
    batches}. The sums stay on the device and are read once at the end.
    Batches come through the same background producer and placement
    lookahead as training (prefetch=0: synchronous)."""
    source = dataset.epoch(0)
    if max_batches:
        source = itertools.islice(source, max_batches)
    total = count = None
    n = 0
    with Prefetcher(source, depth=prefetch,
                    place_fn=lambda b: place_batch(b, device)) as batches:
        for b in batches:
            s, c = eval_step(trainable, frozen, b)
            total = s.float() if total is None else total + s.float()
            count = c if count is None else count + c
            n += 1
    if n == 0:
        return {"loss": 0.0, "ppl": 1.0, "tokens": 0, "batches": 0}
    total, count = torch.stack([total, count.float()]).cpu().tolist()
    tokens = int(count)
    mean = total / max(tokens, 1)
    return {"loss": mean, "ppl": perplexity_from_loss(mean),
            "tokens": tokens, "batches": n}


def verify_resume(path: str, verify: bool) -> None:
    """--resume_from's integrity check (--verify_ckpt): a corrupt adapter
    or sidecar raises CheckpointIntegrityError; one written without a
    manifest loads with a warning. (The JAX CLI's fallback down the
    checkpoint lineage is not ported: ROADMAP.md port item P5.) An HF
    checkpoint directory (a full-model resume source) carries no
    manifest and is loaded as it is, as in the JAX CLIs."""
    if not verify or os.path.isdir(path):
        return
    for p in (path, path + ".opt"):
        if p != path and not os.path.exists(p):
            continue
        status, reason = verify_report(p)
        if status == "corrupt":
            raise CheckpointIntegrityError(
                f"{p}: integrity verification failed ({reason})")
        if status == "unverified":
            log.warning(f"{p}: no checksum manifest; loading unverified")


def maybe_resume_opt_state(args, trainable, tc: TrainConfig, mask=None):
    """(opt_state, start_step) from the `.opt` sidecar next to
    --resume_from, or (None, 0). The start step is the sidecar's
    `loop_step` metadata, else its Adam step counter."""
    from mobilefinetuner_tpu_torch.optim import adam as adam_mod
    path = getattr(args, "resume_from", "")
    if not path or not os.path.exists(path + ".opt"):
        return None, 0
    template = init_optimizer(trainable, tc, mask)
    opt_state, _ = adam_mod.load_state(path + ".opt", template)
    md = SafeTensorsReader(path + ".opt").metadata
    start_step = (int(md["loop_step"]) if "loop_step" in md
                  else int(opt_state["step"]))
    log.info(f"restored optimizer state @ step {start_step} "
             f"(adam step {int(opt_state['step'])})")
    return opt_state, start_step


class EMA:
    """EMA-smoothed loss (--ema_beta)."""

    def __init__(self, beta: float):
        self.beta = beta
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else \
            self.beta * self.value + (1 - self.beta) * x
        return self.value


_METRIC_KEYS = ("loss", "grad_norm", "lr", "param_norm", "update_ratio",
                "nonfinite_count", "skipped")


def run_training(args, *, trainable, frozen, loss_fn, nll_fn,
                 train_ds: WikiText2Dataset,
                 valid_ds: Optional[WikiText2Dataset], total_steps: int,
                 tc: TrainConfig, mask=None, start_step: int = 0,
                 opt_state=None,
                 save_hook: Optional[Callable] = None,
                 dropout_seed: Optional[int] = None, device=None):
    """The loop: steps from start_step to total_steps over
    micro_batches(skip_steps=start_step), an eval every --eval_interval
    steps and at the end, a save every --save_every steps (save_hook(step,
    trainable, opt_state, final=False)) and a final one.

    Each step's batch carries "dropout_seed" ([rows] int64, on the host):
    fold_in(fold_in(dropout_seed, step), row), so dropout masks depend
    only on the seed and the step, whatever resumed the run. Metrics stay
    on the device and are read in one transfer per log interval (the
    metrics CSV alone flushes every 50 steps). Returns (trainable,
    opt_state, history), history one dict per logged step.

    The input pipeline (--prefetch, default 2): a producer thread runs
    micro_batches into a bounded queue, and the consumer places batch
    k+1 (and forms its dropout seeds) before step k is launched
    (data/prefetch.Prefetcher, lookahead 1). Placement stays on this
    thread, on the step's stream: a copy from pinned memory is queued
    ahead of the step's kernels, never beside them. --prefetch 0 is the
    synchronous path with the same batches, byte for byte; a resume keeps
    skip_steps. The time the loop waits for its next batch is the CSV's
    host_wait_ms."""
    device = resolve_device(device)
    step_fn = make_train_step(loss_fn, tc, mask)
    eval_step = make_eval_step(nll_fn)
    if opt_state is None:
        opt_state = init_optimizer(trainable, tc, mask)
    metrics_csv = MetricsLogger(args.metrics_csv) if args.metrics_csv \
        else None
    eval_jsonl = JSONLWriter(args.eval_out) if getattr(args, "eval_out", "") \
        else None
    ema = EMA(args.ema_beta)
    history = []
    buffered = []  # [(step, epoch, tokens, device metrics)]
    clock = {"t": time.perf_counter(), "wait_ms": 0.0}
    flush_every = (min(args.log_interval, 1000) if args.log_interval
                   else (50 if metrics_csv else 1000))
    t_start = time.time()

    def flush_metrics(emit_log=True):
        if not buffered:
            return
        vals = torch.stack([torch.stack([m[k].float() for k in _METRIC_KEYS])
                            for _, _, _, m in buffered]).cpu().tolist()
        dt_ms = (time.perf_counter() - clock["t"]) * 1000 / len(buffered)
        wait_ms = clock["wait_ms"] / len(buffered)
        for (s, ep, toks, _), row in zip(buffered, vals):
            m = dict(zip(_METRIC_KEYS, row))
            avg = ema.update(m["loss"])
            history.append(dict(m, step=s + 1, epoch=ep, ema=avg,
                                step_time_ms=dt_ms, host_wait_ms=wait_ms,
                                tok_s=toks / (dt_ms / 1000)))
            if metrics_csv:
                metrics_csv.log(epoch=ep, step=s + 1, loss=m["loss"],
                                avg_loss=avg, lr=m["lr"],
                                grad_norm=m["grad_norm"],
                                step_time_ms=dt_ms, host_wait_ms=wait_ms,
                                tok_s=toks / (dt_ms / 1000))
        s, _, toks, _ = buffered[-1]
        m = history[-1]
        if emit_log and args.log_interval:
            log.info(f"step {s + 1}/{total_steps} loss={m['loss']:.4f} "
                     f"ema={ema.value:.4f} "
                     f"ppl={perplexity_from_loss(m['loss']):.2f} "
                     f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                     f"{toks / (dt_ms / 1000):.0f} tok/s "
                     f"host_wait={wait_ms:.1f}ms")
        buffered.clear()
        clock["t"] = time.perf_counter()
        clock["wait_ms"] = 0.0

    def run_eval(step, kind):
        ev = evaluate(eval_step, trainable, frozen, valid_ds,
                      args.eval_batches, device, prefetch=prefetch_depth)
        if kind == "eval":
            log.info(f"eval @ step {step}: loss={ev['loss']:.4f} "
                     f"ppl={ev['ppl']:.2f} ({ev['tokens']} tokens)")
        else:
            log.info(f"final eval: loss={ev['loss']:.4f} "
                     f"ppl={ev['ppl']:.2f}")
        if eval_jsonl:
            rec = {"type": kind, "step": step, "loss": ev["loss"],
                   "ppl": ev["ppl"], "tokens": ev["tokens"]}
            if kind == "eval":
                rec["time"] = time.time() - t_start
            eval_jsonl.write(rec)
        return ev

    prefetch_depth = max(getattr(args, "prefetch", 2), 0)

    def place_step(item):
        step, epoch, batch = item
        batch = place_batch(batch, device)
        if dropout_seed is not None:
            rows = batch["input_ids"].shape[0]
            step_seed = fold_in(dropout_seed, step)
            batch["dropout_seed"] = torch.tensor(
                [fold_in(step_seed, r) for r in range(rows)])
        return step, epoch, batch

    def numbered():
        gen = micro_batches(train_ds, tc.grad_accum_steps,
                            skip_steps=start_step)
        for step in itertools.count(start_step):
            epoch, batch = next(gen)
            yield step, epoch, batch

    stream = Prefetcher(
        itertools.islice(numbered(), max(total_steps - start_step, 0)),
        depth=prefetch_depth, place_fn=place_step, lookahead=1,
        rss_limit_mb=getattr(args, "prefetch_rss_mb", 0))
    evals = []
    with stream:
        for step in range(start_step, total_steps):
            t_wait = time.perf_counter()
            step_i, epoch, batch = next(stream)
            clock["wait_ms"] += (time.perf_counter() - t_wait) * 1000
            assert step_i == step       # strict order
            trainable, opt_state, metrics = step_fn(trainable, frozen,
                                                    opt_state, batch, step)
            toks = batch["input_ids"].shape[0] * batch["input_ids"].shape[1]
            buffered.append((step, epoch, toks, metrics))
            log_boundary = bool(args.log_interval) \
                and (step + 1) % args.log_interval == 0
            if log_boundary or (step + 1) % flush_every == 0:
                flush_metrics(emit_log=log_boundary)
            if (args.eval_interval and valid_ds is not None
                    and (step + 1) % args.eval_interval == 0):
                flush_metrics(emit_log=False)
                evals.append(run_eval(step + 1, "eval"))
                clock["t"] = time.perf_counter()  # eval time is not step's
            if args.save_every and save_hook and (step + 1) % \
                    args.save_every == 0 and (step + 1) < total_steps:
                flush_metrics(emit_log=False)
                save_hook(step + 1, trainable, opt_state, final=False)
                clock["t"] = time.perf_counter()
    flush_metrics()
    if valid_ds is not None and args.eval_interval:
        evals.append(run_eval(total_steps, "final_eval"))
    if save_hook:
        save_hook(total_steps, trainable, opt_state, final=True)
    if metrics_csv:
        metrics_csv.close()
    return trainable, opt_state, {"steps": history, "evals": evals}
