"""Shared CLI machinery: the JAX package's flag groups and its training
loop (port of mobilefinetuner_tpu/cli/common.py).

Ported: the training hyperparameters, `micro_batches` (the byte-pinned
step-batch stream, with `skip_steps` for resume), the async input
pipeline (`--prefetch`, `--prefetch_rss_mb`: data/prefetch.Prefetcher),
`evaluate`, the step / eval / save cadence, the metrics CSV, the eval
JSONL and the log lines, with the JAX CLIs' columns and formats; and the
run's fault tolerance, with the JAX CLIs' flags and defaults:
  - the telemetry stream (`--telemetry_out`, core/telemetry.py) and the
    loss-spike detector (`--spike_z`, `--spike_beta`, `--spike_warmup`);
  - snapshot-then-write checkpoints (`--async_save`, io/async_ckpt.py),
    the checkpoint lineage with its GC (`--keep_ckpts`) and the
    verified `--resume_from` that falls back down the lineage
    (`resolve_resume_from`, io/checkpoints.py);
  - the preemption drain (`--on_preempt`, core/preempt.py);
  - in-process rollback (`--rollback_budget`, `--rollback_skip_streak`,
    `--rollback_data_offset`) and fault injection (`--inject`);
  - the memory-admission preflight and degradation ladder
    (`--on_oom_risk`, `--hbm_cap_mb`, `--hbm_headroom`,
    core/memory_guard.py), on an analytic estimate of the step;
and the observability plane, with the JAX CLIs' flags and defaults:
  - the goodput meter (run_end.goodput) and MFU (step_stats.mfu, from
    the CLI's `flops_per_step` estimate and the card's peak);
  - the run registry (`--run_registry`, core/run_registry.py);
  - trace spans (`--trace_spans`), the profiler window
    (`--profile_dir`) and the flight recorder (`--auto_profile`,
    core/trace.py);
  - the hang watchdog (`--watchdog`, on by default), paused around every
    known long pause, a kernel build at first use included;
  - the metrics endpoint (`--metrics_port`, core/metrics_http.py) and
    the step governor (`--pm_*`, system/governor.py).

Every other flag keeps its JAX name, and its default here is "off"; a run
that asks for one raises NotImplementedError naming the ROADMAP.md port
item that brings it (`check_not_ported`): the mesh, offload and the
cross-host straggler attribution (P9), the alignment harness (P3).
Nothing is accepted and silently ignored.

The device is the CLIs' one addition: `--device` (default: the CUDA
card; `--device cpu` is an explicit choice, as the tests make it).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import math
import os
import sys
import time
import traceback
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core import cuda_stats
from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.core.logging import (JSONLWriter,
                                                    MetricsLogger,
                                                    get_logger)
from mobilefinetuner_tpu_torch.core.preempt import (EXIT_PREEMPTED,
                                                    PreemptionGuard)
from mobilefinetuner_tpu_torch.core.metrics_http import start_metrics
from mobilefinetuner_tpu_torch.core.run_registry import RunRegistry
from mobilefinetuner_tpu_torch.core.telemetry import (GoodputMeter,
                                                      HangWatchdog,
                                                      SpikeConfig,
                                                      SpikeDetector,
                                                      StepClock, Telemetry,
                                                      device_peak_flops,
                                                      device_probe, mfu_from,
                                                      run_manifest,
                                                      transformer_flops)
from mobilefinetuner_tpu_torch.core.trace import (AutoProfiler, Tracer,
                                                  write_chrome_trace_gz)
from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)
from mobilefinetuner_tpu_torch.io.async_ckpt import AsyncCheckpointer
from mobilefinetuner_tpu_torch.io.safetensors_io import SafeTensorsReader
from mobilefinetuner_tpu_torch.kernels import build as kernel_build
from mobilefinetuner_tpu_torch.models.gpt2 import param_count
from mobilefinetuner_tpu_torch.ops.dropout import fold_in
from mobilefinetuner_tpu_torch.ops.loss import perplexity_from_loss
from mobilefinetuner_tpu_torch.system.governor import (GovernorConfig,
                                                       StepGovernor)
from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                     init_optimizer,
                                                     make_eval_step,
                                                     make_train_step)

log = get_logger()

# (args attribute, its "off" value, what it asks for, ROADMAP.md port item)
NOT_PORTED = (
    ("align_dump_dir", "", "the alignment harness (--align_dump_dir)", "P3"),
    ("opt_offload", False, "optimizer-state offload (--opt_offload)", "P9"),
    ("opt_offload_state_dtype", "float32",
     "optimizer-state offload (--opt_offload_state_dtype)", "P9"),
    ("opt_offload_master_dtype", "float32",
     "optimizer-state offload (--opt_offload_master_dtype)", "P9"),
    ("straggler_cadence", 0,
     "cross-host straggler attribution (--straggler_cadence)", "P9"),
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
    g.add_argument("--async_save", type=int, default=1,
                   help="1 = snapshot-then-write checkpoints "
                        "(io/async_ckpt.py): a save blocks the loop only "
                        "for one batched copy into pinned host buffers; "
                        "the key mapping, encode and atomic write run on "
                        "a background thread (a depth-1 queue: a save "
                        "landing while one is pending replaces it, with "
                        "a ckpt_dropped event; final saves drain). 0 = "
                        "the synchronous oracle; the files are "
                        "byte-identical either way")
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
    g.add_argument("--prefetch", type=int, default=2,
                   help="async input pipeline (data/prefetch.py): a "
                        "background thread assembles host batches into a "
                        "bounded queue of this depth, and batch k+1 is "
                        "placed on the device (with its dropout seeds) "
                        "while step k is launched. 0 = synchronous. The "
                        "batch sequence is byte-identical either way "
                        "(resume included)")
    g.add_argument("--telemetry_out", default="",
                   help="append-only JSONL run-telemetry stream "
                        "(core/telemetry.py, the JAX package's schema): "
                        "run_start, mem_check, degrade, step_stats, "
                        "eval, checkpoint, ckpt_dropped, ckpt_verify, "
                        "anomaly, rollback, preempt, run_end. Appending "
                        "to an existing file continues its sequence "
                        "numbers. Render with tools/telemetry_report.py")
    g.add_argument("--spike_z", type=float, default=8.0,
                   help="loss-spike detector: an `anomaly` event when a "
                        "step's loss exceeds this many EMA standard "
                        "deviations (<= 0 disables)")
    g.add_argument("--spike_beta", type=float, default=0.98,
                   help="EMA decay of the spike detector")
    g.add_argument("--spike_warmup", type=int, default=20,
                   help="steps observed before the spike detector arms")
    g.add_argument("--on_preempt", choices=["drain", "off"],
                   default="drain",
                   help="SIGTERM/SIGINT handling (core/preempt.py): "
                        "'drain' finishes the step in flight, writes ONE "
                        "final atomic checkpoint, ends the stream with "
                        "run_end{reason=preempted} and exits with the "
                        f"resumable code {EXIT_PREEMPTED} (a second "
                        "signal aborts the drain); 'off' keeps the "
                        "default signal behaviour")
    g.add_argument("--data_retries", type=int, default=3,
                   help="retry budget of the streaming refetch path (the "
                        "in-RAM data path has none to retry)")
    g.add_argument("--data_backoff_s", type=float, default=0.5)
    g.add_argument("--skip_nonfinite", type=int, default=0,
                   help="1 = a step with non-finite gradients leaves "
                        "params and optimizer state unchanged")
    g.add_argument("--rollback_budget", type=int, default=0,
                   help="> 0 arms in-process rollback: on sustained "
                        "divergence (anomaly{kind=divergence}), a streak "
                        "of --rollback_skip_streak skipped or "
                        "non-finite steps, or a non-finite loss with the "
                        "skip guard off, the loop reloads the newest "
                        "verified lineage checkpoint and its .opt "
                        "sidecar, rebuilds the data stream and keeps "
                        "training, at most this many times a run (a "
                        "`rollback` event each). Needs --save_every. "
                        "0 = off")
    g.add_argument("--rollback_skip_streak", type=int, default=3,
                   help="consecutive skipped / non-finite steps that "
                        "trigger a rollback")
    g.add_argument("--rollback_data_offset", type=int, default=1,
                   help="extra data-stream steps skipped per rollback, so "
                        "the replayed window sees other batches; 0 "
                        "replays the original sequence")
    g.add_argument("--keep_ckpts", type=int, default=0,
                   help="keep only the K newest step-tagged checkpoints "
                        "in the lineage (<final>.lineage.json); older "
                        "files go AFTER the pruned lineage is published "
                        "(a kill mid-GC leaves orphans, never a lineage "
                        "naming deleted files); the final artifact is "
                        "never pruned. 0 = keep all")
    g.add_argument("--verify_ckpt", type=int, default=1,
                   help="1 = verify each checkpoint load (--resume_from "
                        "and rollback) against its checksum manifest; a "
                        "corrupt file is rejected with a "
                        "ckpt_verify{ok=false} event and the load falls "
                        "back down the lineage. 0 = trust the newest file")
    g.add_argument("--inject", default="",
                   help="fault injection: grad_nan:<step>[:<n>] poisons "
                        "n (default 1) step batches so the gradients go "
                        "non-finite; loss_spike:<step>[:<n>] scrambles n "
                        "batches' labels; slow_step:<step>:<ms>[:<n>] "
                        "sleeps before n steps; ckpt_corrupt flips a byte "
                        "in the newest lineage checkpoint after the first "
                        "periodic save; hbm_pressure:<mb> holds up to "
                        "<mb> MB of device ballast (on the card, at most "
                        "what the card has free) from the first dispatch "
                        "until the out-of-memory error it forces (the CPU "
                        "raises a simulated one at the first dispatch), "
                        "which the --on_oom_risk ladder takes. Each fires "
                        "once per process")
    add_observability_flags(g)
    # not ported: accepted by name, refused unless off (check_not_ported)
    g.add_argument("--straggler_cadence", type=int, default=0,
                   help="not ported yet (ROADMAP.md P9): the cross-host "
                        "straggler gather needs more than one process")
    g.add_argument("--straggler_mult", type=float, default=1.5,
                   help="not ported yet (ROADMAP.md P9)")
    add_mem_flags(p)


def add_observability_flags(g) -> None:
    """The observability plane's flags (the JAX CLIs' names, defaults and
    meanings): the run registry, the profiler window, the hang watchdog,
    trace spans, the flight recorder and the metrics endpoint."""
    g.add_argument("--run_registry", default="",
                   help="append-only run registry stream "
                        "(core/run_registry.py): one crash-safe `run` "
                        "record per invocation (id, git rev, config "
                        "fingerprint, platform, artifacts, terminal "
                        "status), finalized on any exit path; a "
                        "SIGKILLed run is settled to 'interrupted' on "
                        "the next registry open. Default: "
                        "$MFT_RUN_REGISTRY; empty = off")
    g.add_argument("--profile_dir", default="",
                   help="write a torch.profiler trace (CPU and CUDA "
                        "activities) of a few steady-state steps to this "
                        "directory, as a gzip Chrome trace")
    g.add_argument("--profile_start", type=int, default=10,
                   help="first profiled step (past the warm-up)")
    g.add_argument("--profile_steps", type=int, default=5)
    g.add_argument("--watchdog", type=int, default=1, choices=[0, 1, 2],
                   help="hang watchdog: a daemon thread dumps every "
                        "Python thread's stack (faulthandler) and emits "
                        "a `hang` telemetry event when no step completes "
                        "within watchdog_mult x the rolling-median step "
                        "time. 0 = off, 1 = report and keep waiting (the "
                        "deadline backs off 2x), 2 = report then abort "
                        "the process (exit 113). Kernel builds, evals "
                        "and saves pause the clock")
    g.add_argument("--watchdog_mult", type=float, default=10.0,
                   help="hang deadline = this many rolling-median step "
                        "times (floored at --watchdog_min_s)")
    g.add_argument("--watchdog_min_s", type=float, default=60.0,
                   help="hang deadline floor in seconds; also the "
                        "pre-first-step grace")
    g.add_argument("--trace_spans", type=int, default=0, choices=[0, 1],
                   help="1 = emit `span` events (core/trace.py) into the "
                        "telemetry stream: the goodput phases on a "
                        "'phase' track, each checkpoint write on 'ckpt', "
                        "each prefetch-producer batch on 'prefetch'; "
                        "tools/trace_export.py turns the stream into a "
                        "Perfetto timeline whose per-phase span sums "
                        "reconcile with run_end's goodput buckets. "
                        "Requires --telemetry_out")
    g.add_argument("--auto_profile", type=int, default=0, choices=[0, 1],
                   help="1 = flight recorder: a one-shot torch.profiler "
                        "capture when a sensor fires (a flush interval "
                        "slower than auto_profile_slow_mult x the rolling "
                        "median, a loss_spike/divergence anomaly, or the "
                        "hang watchdog before its report); each capture "
                        "is a `profile_capture` event and a "
                        "*.trace.json.gz in its own directory")
    g.add_argument("--auto_profile_dir", default="",
                   help="capture root (default: <telemetry_out>"
                        ".profiles); each capture lands in its own "
                        "cap<k>_<trigger>_step<n> subdirectory")
    g.add_argument("--auto_profile_steps", type=int, default=2,
                   help="steps per triggered capture")
    g.add_argument("--auto_profile_cooldown", type=float, default=300.0,
                   help="seconds between captures")
    g.add_argument("--auto_profile_budget", type=int, default=2,
                   help="max captures per run")
    g.add_argument("--auto_profile_slow_mult", type=float, default=3.0,
                   help="slow-step trigger: capture when a flush "
                        "interval's per-step time exceeds this multiple "
                        "of the rolling median (<= 0 disables the "
                        "slow-step sensor)")
    g.add_argument("--metrics_port", type=int, default=0,
                   help="serve a live OpenMetrics /metrics endpoint and "
                        "/healthz on this port (core/metrics_http.py), "
                        "fed from the telemetry emit path. 0 = off")
    g.add_argument("--metrics_addr", default="127.0.0.1",
                   help="bind address for --metrics_port")


def add_mem_flags(p: argparse.ArgumentParser):
    """The memory-admission knobs (core/memory_guard.py): the train CLIs'
    preflight and degradation ladder, the eval CLIs' preflight (no ladder
    there: 'degrade' acts as 'warn')."""
    g = p.add_argument_group("memory admission")
    g.add_argument("--hbm_cap_mb", type=int, default=0,
                   help="device capacity override in MB for the "
                        "admission preflight; 0 = the card's total "
                        "(torch.cuda.mem_get_info; a CPU run has none, "
                        "so its verdict is 'unknown'). The override "
                        "lets CPU tests drive the verdict")
    g.add_argument("--hbm_headroom", type=float, default=0.1,
                   help="admission margin: a config is OVER when its "
                        "estimate exceeds capacity x (1 - headroom)")
    g.add_argument("--on_oom_risk", choices=["fail", "degrade", "warn"],
                   default="degrade",
                   help="what a failed admission does: 'fail' raises "
                        "MemoryAdmissionError before the data stream "
                        "starts; 'degrade' walks the ladder (--remat, "
                        "then grad-accum x2 at a constant global batch; "
                        "offload is not ported) re-checking at each "
                        "rung, each decision a `degrade` event, and "
                        "raises naming the rungs tried when the last "
                        "one does not fit; a CUDA out-of-memory error at "
                        "a step's dispatch takes the same ladder; 'warn' "
                        "logs and proceeds. Verdict 'unknown' always "
                        "proceeds")
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
    """Step-governor flags (the reference CLIs' pm_* block; pm_interval 0
    and no schedule disable it)."""
    g = p.add_argument_group("step governor (pm_*)")
    g.add_argument("--pm_interval", type=int, default=0,
                   help="telemetry check every K steps; 0 disables")
    g.add_argument("--pm_batt_thresh", type=float, default=20.0)
    g.add_argument("--pm_temp_thresh", type=float, default=42.0)
    g.add_argument("--pm_fb_high", type=float, default=2.0)
    g.add_argument("--pm_fb_low", type=float, default=0.5)
    g.add_argument("--pm_ft_high", type=float, default=2.0)
    g.add_argument("--pm_ft_low", type=float, default=0.5)
    g.add_argument("--pm_manual_batt", type=float, default=100.0)
    g.add_argument("--pm_manual_temp", type=float, default=30.0)
    g.add_argument("--pm_disable_batt", action="store_true")
    g.add_argument("--pm_disable_temp", action="store_true")
    g.add_argument("--pm_schedule", default="",
                   help='deterministic override, e.g. "0-99:300,100-:50"')


def governor_from_args(args, event_sink=None) -> StepGovernor:
    """The run's StepGovernor from the pm_* flags (a CLI without them
    gets a disabled one)."""
    schedule = getattr(args, "pm_schedule", "")
    interval = getattr(args, "pm_interval", 0)
    cfg = GovernorConfig(
        enable=interval > 0 or bool(schedule),
        # 0 = telemetry disabled: a schedule-only run stays full speed on
        # uncovered steps; pm_interval > 0 makes uncovered steps fall
        # through to the telemetry policy
        check_interval_steps=interval,
        battery_threshold=getattr(args, "pm_batt_thresh", 20.0),
        temp_threshold=getattr(args, "pm_temp_thresh", 42.0),
        freq_batt_high=getattr(args, "pm_fb_high", 2.0),
        freq_batt_low=getattr(args, "pm_fb_low", 0.5),
        freq_temp_high=getattr(args, "pm_ft_high", 2.0),
        freq_temp_low=getattr(args, "pm_ft_low", 0.5),
        schedule=schedule,
        manual_battery=(None if getattr(args, "pm_disable_batt", False)
                        else getattr(args, "pm_manual_batt", 100.0)),
        manual_temp=(None if getattr(args, "pm_disable_temp", False)
                     else getattr(args, "pm_manual_temp", 30.0)),
    )
    return StepGovernor(cfg, event_sink=event_sink)


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


def step_flops(args, tc: TrainConfig, trainable, frozen, n_layer: int,
               n_head: int, head_dim: int, full_ft: bool) -> float:
    """The CLIs' `flops_per_step`: transformer_flops for one optimizer
    step of the global batch (batch_size x grad_accum_steps rows of
    seq_len), as the JAX CLIs estimate it."""
    return transformer_flops(
        param_count(trainable), param_count(frozen),
        args.batch_size * tc.grad_accum_steps, args.seq_len, n_layer,
        n_head, head_dim, full_ft=full_ft)


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


def resolve_resume_from(args) -> None:
    """Verify --resume_from against its checksum manifest (and its .opt
    sidecar) before anything loads it; a corrupt, truncated or stale file
    makes the resolution fall back down `<final>.lineage.json` to the
    newest verified entry (io/checkpoints.resolve_checkpoint) instead of
    crashing or loading garbage. args.resume_from is rewritten to the
    resolved path, so the adapter or model and the sidecar load from one
    artifact, and the per-candidate `ckpt_verify` verdicts wait on args
    for run_training to emit right after run_start. A file with no
    manifest and no verified alternative loads with a warning; nothing
    loadable raises CheckpointIntegrityError. An HF checkpoint directory
    (a full-model resume source) has no manifest or lineage and loads as
    it is."""
    path = getattr(args, "resume_from", "")
    if not path or os.path.isdir(path):
        return
    from mobilefinetuner_tpu_torch.io.checkpoints import resolve_checkpoint
    resolved, _step, events = resolve_checkpoint(
        path, verify=bool(getattr(args, "verify_ckpt", 1)))
    args._ckpt_verify_events = events
    if resolved != path:
        log.warning(f"--resume_from {path} failed integrity "
                    f"verification; falling back down the lineage to "
                    f"{resolved}")
        args.resume_from = resolved
    elif events and not events[0]["ok"]:
        log.warning(f"--resume_from {path}: {events[-1]['reason']} "
                    f"(loading unverified: no verified lineage "
                    f"alternative)")


def maybe_resume_opt_state(args, trainable, tc: TrainConfig, mask=None):
    """(opt_state, start_step) from the `.opt` sidecar next to
    --resume_from, or (None, 0). The start step is the sidecar's
    `loop_step` metadata, else the lineage's step for the file, else its
    Adam step counter (which lags the loop under --skip_nonfinite)."""
    from mobilefinetuner_tpu_torch.io.checkpoints import lineage_step_for
    from mobilefinetuner_tpu_torch.optim import adam as adam_mod
    path = getattr(args, "resume_from", "")
    if not path or not os.path.exists(path + ".opt"):
        return None, 0
    template = init_optimizer(trainable, tc, mask)
    opt_state, _ = adam_mod.load_state(path + ".opt", template)
    md = SafeTensorsReader(path + ".opt").metadata
    if "loop_step" in md:
        start_step = int(md["loop_step"])
    else:
        start_step = lineage_step_for(path)
        if start_step is None:
            start_step = int(opt_state["step"])
    log.info(f"restored optimizer state @ step {start_step} "
             f"(adam step {int(opt_state['step'])})")
    return opt_state, start_step


def record_ckpt_files(args, final_path: str, step: int, files) -> None:
    """The save hooks' tail: record a completed save into
    `<final_path>.lineage.json` and GC past --keep_ckpts (the lineage is
    published before any file goes). Runs on the writer thread; a failure
    is logged, not raised (the save's files are already durable)."""
    try:
        from mobilefinetuner_tpu_torch.io.checkpoints import \
            record_checkpoint
        record_checkpoint(final_path, step, list(files),
                          keep=max(getattr(args, "keep_ckpts", 0), 0))
    except Exception as e:
        log.warning(f"checkpoint lineage update failed: {e}")


def make_rollback_loader(tc: TrainConfig, mask, load_trainable):
    """run_training's `load_hook(path) -> (trainable, opt_state)`, the
    inverse of a CLI's save hook: `load_trainable(path)` gives the
    trainable tree on the run's device, and the `.opt` sidecar is
    restored against a template of the same structure on that device."""
    from mobilefinetuner_tpu_torch.optim import adam as adam_mod

    def load_hook(path):
        tr = load_trainable(path)
        opt, _ = adam_mod.load_state(path + ".opt",
                                     init_optimizer(tr, tc, mask))
        return tr, opt
    return load_hook


def parse_train_inject(spec: str):
    """--inject grammar -> (kind, step, n) | ('ckpt_corrupt', None, 1) |
    ('hbm_pressure', None, <mb>) | None, the JAX package's: a typo dies at
    startup with SystemExit. slow_step's third field is the sleep in ms,
    its optional fourth the repeat count."""
    if not spec:
        return None
    parts = spec.split(":")
    kind = parts[0]
    if kind == "ckpt_corrupt":
        return ("ckpt_corrupt", None, 1)
    if kind == "hbm_pressure":
        if len(parts) < 2:
            raise SystemExit(f"--inject hbm_pressure needs a ballast "
                             f"size in MB: {spec!r}")
        return ("hbm_pressure", None, max(int(parts[1]), 1))
    if kind == "slow_step":
        if len(parts) < 3:
            raise SystemExit(f"--inject slow_step needs a step and ms: "
                             f"slow_step:<step>:<ms>[:<n>], got {spec!r}")
        ms = float(parts[2])
        if not (ms >= 0) or math.isinf(ms):  # `not >=` catches NaN too
            raise SystemExit(f"--inject slow_step ms must be a finite "
                             f"non-negative number, got {parts[2]!r}")
        n = int(parts[3]) if len(parts) > 3 else 1
        return ("slow_step", int(parts[1]), max(n, 1))
    if kind not in ("grad_nan", "loss_spike"):
        raise SystemExit(
            f"--inject must be grad_nan:<step>[:<n>] | "
            f"loss_spike:<step>[:<n>] | slow_step:<step>:<ms>[:<n>] | "
            f"ckpt_corrupt | hbm_pressure:<mb>, got {spec!r}")
    if len(parts) < 2:
        raise SystemExit(f"--inject {kind} needs a step: {spec!r}")
    step = int(parts[1])
    n = int(parts[2]) if len(parts) > 2 else 1
    return (kind, step, max(n, 1))


class FaultInjector:
    """Host-side fault injection of the train path: batches are poisoned
    on the input side (a NaN `grad_scale` row that multiplies the
    gradients inside the step, scrambled labels for a real loss shift), a
    byte of a written checkpoint is flipped, a device ballast forces an
    out-of-memory error. Each fault fires once per process (a counter
    latches it): after a rollback replays the poisoned window the same
    steps run clean, so the recovery repeats, not the fault."""

    # MB the card keeps free beside the ballast, so that allocating it
    # succeeds and the step's own first large allocation fails
    BALLAST_SPARE_MB = 256

    def __init__(self, spec: str):
        parsed = parse_train_inject(spec)
        self.kind, self.at, self.n = parsed if parsed else (None, None, 0)
        self.fired = 0
        self.ballast = None
        self.slow_ms = (float(spec.split(":")[2])
                        if self.kind == "slow_step" else 0.0)

    @property
    def active(self) -> bool:
        return self.kind is not None

    def maybe_slow(self, step: int) -> None:
        """slow_step:<step>:<ms>[:<n>]: a host sleep before each of n
        steps from <step>."""
        if self.kind != "slow_step" or self.fired >= self.n \
                or step < self.at:
            return
        self.fired += 1
        log.warning(f"--inject slow_step: sleeping {self.slow_ms:.0f} ms "
                    f"before step {step} ({self.fired}/{self.n})")
        time.sleep(self.slow_ms / 1000.0)

    def arm_ballast(self, device: torch.device) -> None:
        """hbm_pressure:<mb>: allocate and hold up to <mb> MB on `device`
        before the first dispatch. On the card the ballast takes at most
        what `mem_get_info` reports free less BALLAST_SPARE_MB, so the
        step that follows runs out of memory for real (the admission
        preflight ran before the ballast existed, as the JAX preflight
        never saw the TPU ballast); on the CPU it is host memory."""
        if self.kind != "hbm_pressure" or self.fired \
                or self.ballast is not None:
            return
        mb = float(self.n)
        if device.type == "cuda":
            torch.cuda.empty_cache()   # free = all the card does not hold
        free_mb, _ = cuda_stats.free_and_total_mb(device)
        if free_mb is not None:
            mb = max(min(mb, free_mb - self.BALLAST_SPARE_MB), 0.0)
        self.ballast = torch.empty(int(mb * 2 ** 20), dtype=torch.uint8,
                                   device=device)
        log.warning(f"--inject hbm_pressure: holding {mb:.0f} MB of "
                    f"ballast on {device}")

    def maybe_oom_dispatch(self, step: int, device: torch.device) -> None:
        """The CPU cannot run out of device memory: raise ONE simulated
        RESOURCE_EXHAUSTED at the first dispatch there, so the ladder's
        recovery at dispatch runs end to end. On the card the ballast
        does it for real."""
        if self.kind != "hbm_pressure" or self.fired \
                or device.type == "cuda":
            return
        self.fired = 1
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: simulated OOM at dispatch of step "
            f"{step} (--inject hbm_pressure:{self.n} on a device that "
            f"cannot exhaust device memory)")

    def release_ballast(self) -> None:
        """The out-of-memory error the ballast was for has fired: let go
        of the ballast (the fault fires once)."""
        if self.kind == "hbm_pressure":
            self.fired = 1
            self.ballast = None

    def maybe_poison(self, step: int, batch: dict) -> dict:
        if self.kind == "grad_nan":
            # every batch carries the [rows] grad_scale while armed; only
            # the poison window carries NaN
            batch = dict(batch)
            poison = self.fired < self.n and step >= self.at
            if poison:
                self.fired += 1
            batch["grad_scale"] = np.full(
                batch["input_ids"].shape[0],
                np.nan if poison else 1.0, np.float32)
            if poison:
                log.warning(f"--inject grad_nan: NaN grads for step "
                            f"{step} ({self.fired}/{self.n})")
            return batch
        if self.kind == "loss_spike" and self.fired < self.n \
                and step >= self.at:
            self.fired += 1
            batch = dict(batch)
            batch["labels"] = np.roll(batch["labels"], 7, axis=-1)
            log.warning(f"--inject loss_spike: scrambled labels for "
                        f"step {step} ({self.fired}/{self.n})")
        return batch

    def maybe_corrupt_ckpt(self, ckpt_path: str) -> bool:
        """ckpt_corrupt: flip one payload byte of the newest lineage
        checkpoint (once). True when it fired."""
        if self.kind != "ckpt_corrupt" or self.fired:
            return False
        from mobilefinetuner_tpu_torch.io.checkpoints import lineage_entries
        entries = lineage_entries(ckpt_path)
        if not entries:
            return False
        victim = entries[0]["files"][0]
        try:
            with open(victim, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                b = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([b[0] ^ 0xFF]))
        except OSError as e:
            log.warning(f"--inject ckpt_corrupt failed: {e}")
            return False
        self.fired = 1
        log.warning(f"--inject ckpt_corrupt: flipped a byte in {victim}")
        return True


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


def _spike_detector(args) -> SpikeDetector:
    return SpikeDetector(SpikeConfig(
        zscore=getattr(args, "spike_z", 8.0),
        beta=getattr(args, "spike_beta", 0.98),
        warmup=getattr(args, "spike_warmup", 20)))


def _tool_name() -> str:
    """The entry point's name for the run registry (basename, no .py)."""
    return os.path.basename(sys.argv[0] or "train").replace(".py", "")


def run_training(args, *, trainable, frozen, loss_fn, nll_fn,
                 train_ds: WikiText2Dataset,
                 valid_ds: Optional[WikiText2Dataset], total_steps: int,
                 tc: TrainConfig, mask=None, start_step: int = 0,
                 opt_state=None,
                 save_hook: Optional[Callable] = None,
                 dropout_seed: Optional[int] = None, device=None,
                 load_hook: Optional[Callable] = None, ckpt_path: str = "",
                 footprint: mg.Footprint,
                 compute_dtype: torch.dtype,
                 flops_per_step: Optional[float] = None):
    """The loop: steps from start_step to total_steps over
    micro_batches(skip_steps=start_step), an eval every --eval_interval
    steps and at the end, a save every --save_every steps and a final
    one, all reported through the telemetry stream (--telemetry_out):
    `run_start` first, `run_end` exactly once on every exit path. Returns
    (trainable, opt_state, history), history {"steps": one dict per
    logged step, "evals": [...]}.

    save_hook(step, trainable, opt_state, final, ckpt) snapshots its trees
    (io/async_ckpt.timed_snapshot) and routes the write through `ckpt`
    (async_ckpt.submit): under --async_save the loop resumes after the
    snapshot. The writer is drained before run_end.

    Each step's batch carries "dropout_seed" ([rows] int64, on the host):
    fold_in(fold_in(dropout_seed, step), row), so dropout masks depend
    only on the seed and the step, whatever resumed the run. Metrics stay
    on the device and are read in one transfer per flush (the log
    interval; the metrics CSV alone flushes every 50 steps), which also
    emits one `step_stats` event and feeds the spike detector.

    The input pipeline (--prefetch, default 2): a producer thread runs
    micro_batches into a bounded queue, and the consumer places batch
    k+1 (and forms its dropout seeds) before step k is launched
    (data/prefetch.Prefetcher, lookahead 1), on the step's stream.
    --prefetch 0 is the synchronous path with the same batches.

    Memory admission (core/memory_guard.py): before the data stream
    exists, the step's analytic estimate (`footprint`, at the stream's
    micro-batch and sequence) is judged against the capacity; under
    --on_oom_risk degrade a failed check, or a CUDA out-of-memory error
    at a step's dispatch, walks remat -> accum_x2 (offload is ROADMAP.md
    P9, so the ladder ends there with MemoryAdmissionError). remat flips
    args.remat, which the CLIs' loss closures read at each call; accum_x2
    doubles the step's micro-batch count while the stream keeps the
    global batch. The step function is functional (the trees it was
    given are intact after a failed dispatch), so unlike the JAX loop,
    whose step donates its buffers, a retry needs no host copy of the
    state: the failed step's tensors, held by the exception's frames, are
    dropped, the cached blocks returned, and the same batch runs again.

    Rollback (load_hook = the save hook's inverse, ckpt_path = the final
    artifact whose lineage lists the checkpoints, --rollback_budget > 0):
    on divergence, a streak of skipped / non-finite steps, or a
    non-finite loss with the skip guard off, the newest verified lineage
    checkpoint at or below the trigger step is reloaded, the stream
    rebuilt with skip_steps + k * --rollback_data_offset, and training
    goes on with the same step function. The preemption drain
    (--on_preempt drain) is checked at every step boundary.

    Observability, as in the JAX loop: a GoodputMeter classifies every
    second of the run (init, compile — here a kernel build at first use,
    kernels/build.py —, step, input_wait, eval, checkpoint,
    governor_sleep, shutdown) into run_end.goodput; `flops_per_step` (the
    CLI's transformer_flops estimate for one optimizer step) over the
    flush interval's synced per-step time and the card's peak is
    step_stats.mfu (None on the CPU). The hang watchdog (--watchdog) is
    paused around builds, evals and saves; --trace_spans, --profile_dir,
    --auto_profile, --metrics_port, --run_registry and the pm_* governor
    are the JAX CLIs' flags. None of them adds device work: a run's
    losses are the same with every instrument on or off."""
    device = resolve_device(device)
    tel = Telemetry(getattr(args, "telemetry_out", ""))
    tel.emit("run_start", **run_manifest(vars(args), device))
    # the run registry (core/run_registry.py): the start record lands now,
    # so a SIGKILL mid-run is settled to "interrupted" on the next open;
    # end_run finalizes it on every exit path
    registry = RunRegistry.from_args(args)
    run_rec = registry.begin(
        "train", _tool_name(), config=vars(args), mesh=None,
        platform="gpu" if device.type == "cuda" else device.type,
        artifacts=[p for p in (tel.path, getattr(args, "out", "")) if p],
        telemetry=tel) if registry else None
    # --resume_from's verdicts (resolve_resume_from ran in the CLI, before
    # this stream existed): after run_start, which stays the first event
    for ev in getattr(args, "_ckpt_verify_events", None) or []:
        tel.emit("ckpt_verify", **ev)
    t_start = time.time()
    # one tracer for every span producer: the meter's phases, the
    # checkpoint writer, the prefetch producer
    tracer = (Tracer(tel.emit)
              if getattr(args, "trace_spans", 0) and tel.enabled else None)
    meter = GoodputMeter(tracer=tracer)
    state = {"done": 0}
    ckpt = guard = stream = metrics_csv = None
    governor = wd = metrics_srv = auto_prof = None
    exits = contextlib.ExitStack()

    def end_run(exit_name: str, steps: int, **extra):
        """Terminate the stream once on any exit path (emit and close are
        no-ops on a closed stream, so nested handlers compose). The
        writer is drained first: a snapshot already taken is a recovery
        point worth finishing, and its checkpoint event must land before
        run_end (its errors must not mask the exception in flight); an
        open capture lands its profile_capture, and the registry record
        its `run` end event, before run_end, which stays last."""
        if ckpt is not None:
            ckpt.close(raise_errors=False)
        if auto_prof is not None:
            auto_prof.close()
        if governor is not None:
            extra["governor_slept_ms"] = round(governor.total_slept_ms, 1)
        if run_rec is not None:
            run_rec.finalize(exit_name)
        tel.emit("run_end", steps=steps,
                 wall_s=round(time.time() - t_start, 3), exit=exit_name,
                 goodput=meter.summary(), **extra)
        tel.close()

    try:
        governor = governor_from_args(
            args, event_sink=lambda p: tel.emit("throttle", **p))
        # the metrics endpoint: a telemetry observer, so every number a
        # scraper reads came through the same emit as the stream; a bind
        # failure raises here, under the run_end contract
        if getattr(args, "metrics_port", 0) > 0:
            metrics_srv = start_metrics(
                tel, args.metrics_port,
                addr=getattr(args, "metrics_addr", "127.0.0.1"))
            log.info(f"metrics endpoint: http://{metrics_srv.addr}:"
                     f"{metrics_srv.port}/metrics (+ /healthz)")
        if getattr(args, "auto_profile", 0):
            prof_root = getattr(args, "auto_profile_dir", "") or (
                (tel.path + ".profiles") if tel.path
                else "auto_profile_traces")
            auto_prof = AutoProfiler(
                prof_root, sink=tel.emit,
                steps=getattr(args, "auto_profile_steps", 2),
                cooldown_s=getattr(args, "auto_profile_cooldown", 300.0),
                budget=getattr(args, "auto_profile_budget", 2))
        slow_mult = getattr(args, "auto_profile_slow_mult", 3.0)
        if getattr(args, "on_preempt", "drain") == "drain":
            guard = PreemptionGuard().install()
            if not guard.installed:
                guard = None
        ckpt = AsyncCheckpointer(enabled=bool(getattr(args, "async_save", 1)),
                                 event_sink=tel.emit, tracer=tracer)
        spikes = _spike_detector(args)
        if tel.resumed and tel.trailing_step_stats and start_step > 0:
            # a resumed run: re-seed the detector from the stream's earlier
            # losses so it does not re-enter warmup where resume bugs bite
            spikes.seed([r.get("loss") for r in tel.trailing_step_stats],
                        count_hint=max(r.get("step", 0)
                                       for r in tel.trailing_step_stats))
        # the hang watchdog (--watchdog 0 disables): no step within
        # watchdog_mult x the rolling-median step time dumps the stacks
        # and emits `hang`, then waits on (1) or aborts with exit 113 (2),
        # after flush_tail has made the stream end on a complete line
        wd_mode = getattr(args, "watchdog", 1)
        if wd_mode:
            def on_hang(p):
                if auto_prof is not None:
                    auto_prof.capture_now("hang", p["step"])
                tel.emit("hang", last_seq=tel.last_seq, **p)
                log.error(f"HANG: no step for {p['stall_s']:.1f}s "
                          f"(deadline {p['deadline_s']:.1f}s) after step "
                          f"{p['step']}; stacks -> {p['stacks_file']}, "
                          f"device probe: {p['device_probe']}, "
                          f"action: {p['action']}")
            wd = HangWatchdog(
                mult=getattr(args, "watchdog_mult", 10.0),
                min_deadline_s=getattr(args, "watchdog_min_s", 60.0),
                grace_s=getattr(args, "watchdog_min_s", 60.0),
                stacks_file=(tel.path + ".stacks") if tel.path else "",
                abort=wd_mode == 2, flush_fn=tel.flush_tail,
                probe_fn=device_probe(device), on_hang=on_hang)
        # wd.paused() at every known long pause; a no-op without a watchdog
        pause = wd.paused if wd is not None else contextlib.nullcontext
        step_clock = StepClock()
        # flops_per_step covers the run's global batch, so the peak is
        # the peak of every card the run spans: one, until ROADMAP.md P9
        peak_flops = device_peak_flops(
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
        # a kernel build at first use (kernels/build.py) is the port's
        # compile: charged to the `compile` bucket, out of the flush
        # interval's step time, with the watchdog paused (a cold checkout
        # must not fire a hang in its first step)
        clock = {"t": time.perf_counter(), "wait_ms": 0.0, "slept_ms": 0.0,
                 "build_ms": 0.0}

        @contextlib.contextmanager
        def kernel_build_phase():
            prev = meter.phase
            meter.enter("compile")
            t0 = time.perf_counter()
            try:
                with pause():
                    yield
            finally:
                clock["build_ms"] += (time.perf_counter() - t0) * 1000
                meter.enter(prev)
        exits.enter_context(kernel_build.watch_builds(kernel_build_phase))
        eval_step = make_eval_step(nll_fn)
        if opt_state is None:
            opt_state = init_optimizer(trainable, tc, mask)
        metrics_csv = MetricsLogger(args.metrics_csv) if args.metrics_csv \
            else None
        eval_jsonl = JSONLWriter(args.eval_out) \
            if getattr(args, "eval_out", "") else None
        ema = EMA(args.ema_beta)
        history, evals = [], []
        buffered = []  # [(step, epoch, tokens, device metrics)]
        flush_every = (min(args.log_interval, 1000) if args.log_interval
                       else (50 if metrics_csv else 1000))
        prefetch_depth = max(getattr(args, "prefetch", 2), 0)
        injector = FaultInjector(getattr(args, "inject", ""))
        peak = {"pending": False}   # the first flush reports the step peak
        tc_step = tc
        step_fn = make_train_step(loss_fn, tc_step, mask)

        def place_step(item):
            step, epoch, batch = item
            if injector.active:
                batch = injector.maybe_poison(step, batch)
            batch = place_batch(batch, device)
            if dropout_seed is not None:
                rows = batch["input_ids"].shape[0]
                step_seed = fold_in(dropout_seed, step)
                batch["dropout_seed"] = torch.tensor(
                    [fold_in(step_seed, r) for r in range(rows)])
            return step, epoch, batch

        def make_stream(from_step: int, data_skip: int) -> Prefetcher:
            """The numbered, placed step-batch stream from `from_step`;
            `data_skip` is the fast-forward in steps (== from_step on a
            resume; a rollback adds k * --rollback_data_offset)."""
            def numbered():
                gen = micro_batches(train_ds, tc.grad_accum_steps,
                                    skip_steps=data_skip)
                for step in itertools.count(from_step):
                    epoch, batch = next(gen)
                    yield step, epoch, batch
            return Prefetcher(
                itertools.islice(numbered(), max(total_steps - from_step, 0)),
                depth=prefetch_depth, place_fn=place_step, lookahead=1,
                rss_limit_mb=getattr(args, "prefetch_rss_mb", 0),
                tracer=tracer)

        # ---- memory admission and the degradation ladder ----------------
        oom_mode = getattr(args, "on_oom_risk", "warn")
        adm_cap = getattr(args, "hbm_cap_mb", 0)
        adm_headroom = getattr(args, "hbm_headroom", 0.1)
        rows = train_ds.config.batch_size * tc.grad_accum_steps
        rungs_applied: list = []

        def check_admission() -> mg.MemCheck:
            """The current rung's estimate judged and emitted (mem_check)."""
            est = mg.train_step_estimate_mb(
                footprint, trainable=trainable, frozen=frozen,
                opt_state=opt_state,
                micro_batch=rows // tc_step.grad_accum_steps,
                seq_len=train_ds.config.seq_len,
                remat=bool(getattr(args, "remat", False)),
                compute_dtype=compute_dtype)
            resident = (mg.tree_bytes(trainable) + mg.tree_bytes(frozen)
                        + mg.tree_bytes(opt_state)) / 2 ** 20
            c = mg.preflight(est, resident_mb=resident, cap_mb=adm_cap,
                             headroom=adm_headroom, device=device)
            tel.emit("mem_check", **c.event())
            log.info(f"memory admission: {c.describe()}")
            return c

        def over_check() -> mg.MemCheck:
            """A forced-over verdict for a real out-of-memory error at a
            dispatch (the device already said no)."""
            cap, src = mg.device_capacity_mb(adm_cap, device)
            return mg.MemCheck(est_mb=None, cap_mb=cap, verdict="over",
                               phase="dispatch", headroom=adm_headroom,
                               live_mb=cuda_stats.live_hbm_mb(device),
                               cap_source=src)

        def apply_rung(est_mb, at_step=None) -> bool:
            """Walk one rung of memory_guard.LADDER; False when no rung
            that applies is left (offload is not ported)."""
            nonlocal tc_step
            for rung in mg.LADDER:
                if rung in rungs_applied:
                    continue
                if rung == "remat":
                    if getattr(args, "remat", True):
                        continue  # already on: nothing left to give
                    args.remat = True
                    frm, to = "remat=off", "remat=on"
                elif rung == "accum_x2":
                    new_accum = tc_step.grad_accum_steps * 2
                    if new_accum > rows or rows % new_accum:
                        continue  # the step batch cannot split further
                    tc_step = dataclasses.replace(
                        tc_step, grad_accum_steps=new_accum)
                    frm = f"accum={new_accum // 2}"
                    to = f"accum={new_accum}"
                else:
                    continue  # offload: ROADMAP.md port item P9
                rungs_applied.append(rung)
                tel.emit("degrade", step=at_step,
                         **{"rung": rung, "from": frm, "to": to,
                            "est_mb": round(est_mb, 2) if est_mb else None})
                log.warning(
                    f"DEGRADE rung {len(rungs_applied)} ({rung}: {frm} -> "
                    f"{to})" + (f": estimate {est_mb:.0f} MB over capacity"
                                if est_mb else ""))
                return True
            return False

        if start_step < total_steps:
            check = check_admission()
            while check.verdict == "over" and oom_mode != "warn":
                if oom_mode == "fail":
                    raise mg.MemoryAdmissionError(
                        f"memory admission failed ({check.describe()}); "
                        f"rerun with a smaller config, --on_oom_risk "
                        f"degrade, or a larger device", check=check)
                if not apply_rung(check.est_mb):
                    raise mg.MemoryAdmissionError(
                        f"memory admission failed after exhausting the "
                        f"degradation ladder {tuple(rungs_applied)} "
                        f"({check.describe()})", check=check,
                        ladder=rungs_applied)
                step_fn = make_train_step(loss_fn, tc_step, mask)
                check = check_admission()
            if check.verdict == "over":
                log.warning(f"memory admission: {check.describe()} "
                            f"(--on_oom_risk warn: proceeding)")
            elif rungs_applied:
                log.warning(f"admitted after the degradation ladder "
                            f"{tuple(rungs_applied)}: {check.describe()}")

        def recover_dispatch_oom(err: BaseException, step: int) -> None:
            """An out-of-memory error escaped a step's dispatch: under
            --on_oom_risk degrade walk the rest of the ladder (one
            mem_check per rung) and let the loop retry the same batch;
            otherwise re-raise."""
            nonlocal step_fn
            if oom_mode != "degrade":
                raise err
            tel.emit("mem_check", **over_check().event())
            log.warning(f"out of memory at dispatch of step {step}: "
                        f"walking the degradation ladder")
            flush_metrics(emit_log=False)
            # the failed step's tensors live on in the traceback's frames
            traceback.clear_frames(err.__traceback__)
            injector.release_ballast()
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            while True:
                if not apply_rung(None, at_step=step):
                    raise mg.MemoryAdmissionError(
                        f"out of memory at dispatch of step {step} and the "
                        f"degradation ladder {tuple(rungs_applied)} is "
                        f"exhausted", ladder=rungs_applied) from err
                step_fn = make_train_step(loss_fn, tc_step, mask)
                if check_admission().verdict != "over":
                    break
            cuda_stats.reset_peak(device)
            peak["pending"] = device.type == "cuda"
            restart_interval()  # recovery is not step time

        stream = make_stream(start_step, start_step)
        # in-process rollback, armed only with the inverse load hook and a
        # lineage to roll back to
        rb = None
        if (load_hook is not None and ckpt_path
                and getattr(args, "rollback_budget", 0) > 0):
            rb = {"budget": int(args.rollback_budget), "count": 0,
                  "streak": 0, "due": None, "suppressed": False,
                  "skip_streak": max(
                      getattr(args, "rollback_skip_streak", 3), 1),
                  "offset": max(getattr(args, "rollback_data_offset", 1), 0)}

        def restart_interval():
            """A pause that is not step time (eval, save, recovery) ends:
            the flush interval starts again from now."""
            clock["t"] = time.perf_counter()
            clock["build_ms"] = 0.0

        def flush_metrics(emit_log=True):
            """One transfer for everything buffered since the last flush,
            then the CSV rows, the spike detector and the rollback
            triggers per step, and one step_stats event. The interval's
            per-step time (governor sleeps and kernel builds taken out)
            is synced by that transfer: it feeds the step clock, the
            watchdog's deadline, the slow-step trigger and MFU."""
            if not buffered:
                return
            vals = torch.stack([torch.stack([m[k].float()
                                             for k in _METRIC_KEYS])
                                for _, _, _, m in buffered]).cpu().tolist()
            dt_ms = ((time.perf_counter() - clock["t"]) * 1000
                     - clock["slept_ms"] - clock["build_ms"]) / len(buffered)
            wait_ms = clock["wait_ms"] / len(buffered)
            prior_n, prior_med = step_clock.n, step_clock.median_ms()
            step_clock.record(dt_ms / 1000.0)
            if wd is not None:
                wd.pet(buffered[-1][0], dt_ms / 1000.0)
            # the slow-step trigger: this interval ran a multiple of the
            # PRIOR rolling median (the slow sample does not judge itself);
            # the --profile_dir window keeps priority
            if (auto_prof is not None and slow_mult > 0 and prior_n >= 3
                    and prior_med > 0 and dt_ms > slow_mult * prior_med
                    and not prof["active"]):
                if auto_prof.trigger("slow_step", buffered[-1][0] + 1):
                    log.warning(f"auto_profile: step time {dt_ms:.1f} ms > "
                                f"{slow_mult:g}x rolling median "
                                f"{prior_med:.1f} ms: capturing "
                                f"{auto_prof.steps} step(s)")
            mfu = mfu_from(flops_per_step, dt_ms / 1000, peak_flops)
            extra = {}
            if peak["pending"]:
                extra["peak_mb"] = cuda_stats.peak_hbm_mb(device)
                peak["pending"] = False
            for (s, ep, toks, _), row in zip(buffered, vals):
                m = dict(zip(_METRIC_KEYS, row))
                loss = m["loss"]
                avg = ema.update(loss)
                anom = spikes.update(loss)
                if anom is not None:
                    tel.emit("anomaly", step=s + 1, loss=loss, ema=avg,
                             **anom)
                    log.warning(f"anomaly @ step {s + 1}: {anom['kind']} "
                                f"loss={loss:.4f}" + (
                                    f" z={anom['zscore']}"
                                    if anom["zscore"] else ""))
                    if auto_prof is not None and not prof["active"]:
                        auto_prof.trigger(anom["kind"], s + 1)
                if rb is not None:
                    # a single skipped step or a one-off spike never
                    # triggers; `suppressed` (a failed rollback) holds the
                    # triggers until a clean step ends the episode
                    bad = m["skipped"] > 0 or not math.isfinite(loss)
                    rb["streak"] = rb["streak"] + 1 if bad else 0
                    if not bad:
                        rb["suppressed"] = False
                    if rb["due"] is not None or rb["suppressed"]:
                        pass
                    elif anom is not None and anom["kind"] == "divergence":
                        rb["due"] = ("divergence", s + 1)
                    elif rb["streak"] >= rb["skip_streak"]:
                        rb["due"] = ("skip_streak", s + 1)
                    elif not math.isfinite(loss) and not tc.skip_nonfinite:
                        rb["due"] = ("nonfinite_loss", s + 1)
                history.append(dict(m, step=s + 1, epoch=ep, ema=avg,
                                    step_time_ms=dt_ms, host_wait_ms=wait_ms,
                                    tok_s=toks / (dt_ms / 1000)))
                if metrics_csv:
                    metrics_csv.log(epoch=ep, step=s + 1, loss=loss,
                                    avg_loss=avg, lr=m["lr"],
                                    grad_norm=m["grad_norm"],
                                    step_time_ms=dt_ms, host_wait_ms=wait_ms,
                                    tok_s=toks / (dt_ms / 1000), mfu=mfu)
            s, ep, toks, _ = buffered[-1]
            m = history[-1]
            tel.emit("step_stats", step=s + 1, loss=m["loss"], ema=ema.value,
                     lr=m["lr"], grad_norm=m["grad_norm"],
                     step_time_ms=dt_ms, host_wait_ms=wait_ms,
                     slept_ms=clock["slept_ms"],
                     tok_s=toks / (dt_ms / 1000), mfu=mfu,
                     param_norm=m["param_norm"],
                     update_ratio=m["update_ratio"],
                     nonfinite_count=int(m["nonfinite_count"]),
                     # a COUNT over the flush interval: no skip falls
                     # between flushes
                     skipped=sum(int(r[-1]) for r in vals),
                     hbm_mb=cuda_stats.live_hbm_mb(device),
                     queue_depth=stream.queue_depth(), host_step_ms=None,
                     **extra)
            if emit_log and args.log_interval:
                log.info(f"step {s + 1}/{total_steps} loss={m['loss']:.4f} "
                         f"ema={ema.value:.4f} "
                         f"ppl={perplexity_from_loss(m['loss']):.2f} "
                         f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                         f"{toks / (dt_ms / 1000):.0f} tok/s "
                         + (f"mfu={mfu:.3f} " if mfu is not None else "")
                         + f"host_wait={wait_ms:.1f}ms")
            buffered.clear()
            restart_interval()
            clock["wait_ms"] = 0.0
            clock["slept_ms"] = 0.0

        def run_eval(step, kind):
            """One evaluation, charged to the `eval` bucket with the
            watchdog paused (an eval may exceed any step deadline)."""
            back = meter.phase
            meter.enter("eval")
            with pause():
                ev = evaluate(eval_step, trainable, frozen, valid_ds,
                              args.eval_batches, device,
                              prefetch=prefetch_depth)
            meter.enter(back)
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
            tel.emit("eval", step=step, loss=ev["loss"], ppl=ev["ppl"],
                     tokens=ev["tokens"])
            return ev

        def attempt_rollback(reason: str, at_step: int):
            """Reload the newest verified lineage checkpoint at or below
            the trigger step, rebuild the stream past the poisoned window
            and return the resume step; None when no checkpoint qualifies
            (every verdict lands in the stream)."""
            nonlocal trainable, opt_state, stream, ema, spikes
            with pause():
                # the whole recovery is a known long pause: the drain of
                # an in-flight write, the lineage walk and the load
                try:  # the lineage must be settled: finish in-flight writes
                    ckpt.drain()
                except Exception as e:
                    log.warning(f"rollback: checkpoint drain failed ({e}); "
                                f"resolving against what is on disk")
                from mobilefinetuner_tpu_torch.io.checkpoints import \
                    resolve_checkpoint
                # max_step = at_step - 1: a checkpoint at the trigger boundary
                # may already hold the poisoned update
                resolved, to_step, events = resolve_checkpoint(
                    None, verify=bool(getattr(args, "verify_ckpt", 1)),
                    lineage_base=ckpt_path, max_step=at_step - 1)
                for ev in events:
                    tel.emit("ckpt_verify", **ev)
                if resolved is None or to_step is None:
                    tel.emit("rollback", step=at_step, reason=reason, ok=False,
                             to_step=None, steps_lost=None, ckpt=None,
                             data_offset=None, budget_left=rb["budget"])
                    log.warning(f"rollback wanted ({reason} @ step {at_step}) "
                                f"but no verified checkpoint exists: "
                                f"continuing without")
                    rb["streak"] = 0
                    rb["suppressed"] = True
                    return None
                trainable, opt_state = load_hook(resolved)
            rb["count"] += 1
            rb["budget"] -= 1
            rb["streak"] = 0
            data_offset = rb["count"] * rb["offset"]
            stream.close()
            stream = make_stream(to_step, to_step + data_offset)
            # fresh statistics for the restored trajectory; count_hint keeps
            # the detector armed
            ema = EMA(args.ema_beta)
            spikes = _spike_detector(args)
            spikes.seed([], count_hint=to_step)
            restart_interval()  # recovery is not step time
            tel.emit("rollback", step=at_step, reason=reason, ok=True,
                     to_step=to_step, steps_lost=at_step - to_step,
                     ckpt=resolved, data_offset=data_offset,
                     budget_left=rb["budget"])
            log.warning(f"ROLLBACK ({reason}): step {at_step} -> {to_step} "
                        f"from {resolved} ({at_step - to_step} step(s) "
                        f"lost, data offset +{data_offset}, budget left "
                        f"{rb['budget']})")
            return to_step

        # the --profile_dir window: one torch.profiler session over
        # [profile_start, profile_start + profile_steps), written as a
        # gzip Chrome trace when it closes; a profiler failure is logged
        # and never ends the run
        profile_dir = getattr(args, "profile_dir", "")
        prof_start = start_step + getattr(args, "profile_start", 10)
        prof_end = prof_start + getattr(args, "profile_steps", 5)
        prof = {"active": False, "session": None}

        def maybe_profile(step):
            if not profile_dir:
                return
            try:
                if step == prof_start and not prof["active"]:
                    from torch.profiler import ProfilerActivity, profile
                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if device.type == "cuda"
                        else [])
                    session = profile(activities=acts)
                    session.__enter__()
                    prof.update(active=True, session=session)
                elif step >= prof_end and prof["active"]:
                    session = prof["session"]
                    prof.update(active=False, session=None)
                    if device.type == "cuda":
                        # the queued steps land inside the window
                        torch.cuda.synchronize(device)
                    session.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    path = write_chrome_trace_gz(session, os.path.join(
                        profile_dir,
                        f"steps{prof_start}-{step}.trace.json.gz"))
                    log.info(f"profiler trace -> {path}")
            except Exception as e:  # profiling must never kill training
                log.warning(f"profiler: {e}")
                prof.update(active=False, session=None)

        def tick_sync(m):
            """The flight recorder's stop: the launched step is done."""
            return lambda: float(m["loss"])

        injector.arm_ballast(device)
        cuda_stats.reset_peak(device)
        peak["pending"] = device.type == "cuda"
        if wd is not None:
            wd.start()
        step = start_step
        try:
            while step < total_steps:
                meter.enter("input_wait")
                t_wait = time.perf_counter()
                step_i, epoch, batch = next(stream)
                clock["wait_ms"] += (time.perf_counter() - t_wait) * 1000
                meter.enter("step")
                assert step_i == step       # strict order
                maybe_profile(step)
                if injector.kind == "slow_step":
                    injector.maybe_slow(step)
                while True:
                    failure = None
                    try:
                        if injector.kind == "hbm_pressure":
                            injector.maybe_oom_dispatch(step, device)
                        trainable, opt_state, metrics = step_fn(
                            trainable, frozen, opt_state, batch, step)
                        break
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except Exception as e:
                        if not mg.is_resource_exhausted(e):
                            raise
                        failure = e
                    recover_dispatch_oom(failure, step)
                toks = batch["input_ids"].shape[0] \
                    * batch["input_ids"].shape[1]
                buffered.append((step, epoch, toks, metrics))
                if auto_prof is not None and auto_prof.active:
                    # count down an armed capture; its stop reads the loss
                    # first, so the launched step is inside the window
                    auto_prof.tick(step, sync=tick_sync(metrics))
                log_boundary = bool(args.log_interval) \
                    and (step + 1) % args.log_interval == 0
                if log_boundary or (step + 1) % flush_every == 0:
                    flush_metrics(emit_log=log_boundary)
                # idle reset only: the duration sample is the flush's
                if wd is not None:
                    wd.pet(step)
                if (args.eval_interval and valid_ds is not None
                        and (step + 1) % args.eval_interval == 0):
                    flush_metrics(emit_log=False)
                    evals.append(run_eval(step + 1, "eval"))
                    restart_interval()  # eval time is not step time
                if args.save_every and save_hook and (step + 1) % \
                        args.save_every == 0 and (step + 1) < total_steps:
                    flush_metrics(emit_log=False)
                    # the checkpoint bucket spans only this blocking call:
                    # under --async_save the snapshot; the write overlaps
                    # `step` on the writer thread
                    meter.enter("checkpoint")
                    with pause():  # a slow save is not a hang
                        save_hook(step + 1, trainable, opt_state,
                                  final=False, ckpt=ckpt)
                    meter.enter("step")
                    restart_interval()
                    if injector.kind == "ckpt_corrupt" and ckpt_path:
                        # flip a byte of the newest lineage entry once its
                        # write has landed: a later load must fall back
                        try:
                            ckpt.drain()
                        except Exception:
                            pass
                        injector.maybe_corrupt_ckpt(ckpt_path)
                meter.enter("governor_sleep")
                clock["slept_ms"] += governor.throttle(step)
                meter.enter("step")
                state["done"] = step + 1 - start_step
                if guard is not None and guard.triggered:
                    # the drain: the step in flight is done; flush, ONE
                    # final atomic checkpoint (final=True waits for the
                    # write), then the resumable exit
                    log.warning(f"{guard.signal_name} received: draining "
                                f"at step {step + 1} (final save, then "
                                f"exit {EXIT_PREEMPTED})")
                    flush_metrics(emit_log=False)
                    tel.emit("preempt", step=step + 1,
                             signal=guard.signal_name or "SIGTERM")
                    if save_hook is not None:
                        meter.enter("checkpoint")
                        with pause():  # a slow drain save is not a hang
                            save_hook(step + 1, trainable, opt_state,
                                      final=True, ckpt=ckpt)
                    meter.enter("shutdown")
                    end_run("preempted", state["done"], reason="preempted")
                    raise SystemExit(EXIT_PREEMPTED)
                if rb is not None and rb["due"] is not None:
                    # a flush in this iteration raised a trigger: act at
                    # the step boundary (the metrics buffer is empty)
                    reason, at_step = rb["due"]
                    rb["due"] = None
                    if rb["budget"] <= 0:
                        tel.emit("rollback", step=at_step, reason=reason,
                                 ok=False, to_step=None, steps_lost=None,
                                 ckpt=None, data_offset=None, budget_left=0)
                        log.warning(f"rollback budget exhausted; training "
                                    f"on through {reason} @ step {at_step}")
                        rb = None
                    else:
                        resumed = attempt_rollback(reason, at_step)
                        if resumed is not None:
                            step = resumed
                            continue
                step += 1
        finally:
            # a profiler window still open when the loop ends (or dies)
            # is closed here, so its trace lands on every exit path
            if prof["active"]:
                maybe_profile(prof_end)
        stream.close()
        meter.enter("shutdown")
        flush_metrics()
        if valid_ds is not None and args.eval_interval:
            evals.append(run_eval(total_steps, "final_eval"))
        if save_hook:
            # final=True drains the writer: this blocking span lands in
            # the checkpoint bucket
            meter.enter("checkpoint")
            with pause():
                save_hook(total_steps, trainable, opt_state, final=True,
                          ckpt=ckpt)
            meter.enter("shutdown")
        end_run("ok", total_steps - start_step)
        return trainable, opt_state, {"steps": history, "evals": evals}
    except BaseException as e:
        end_run(type(e).__name__, state["done"])
        raise
    finally:
        # no leaked producer, writer, watchdog or server thread, no open
        # capture, and the process's previous signal handlers back
        # (several runs may share a process)
        if wd is not None:
            wd.stop()
        if auto_prof is not None:
            auto_prof.close()
        if metrics_srv is not None:
            metrics_srv.close()
        exits.close()
        if stream is not None:
            stream.close()
        if ckpt is not None:
            ckpt.close(raise_errors=False)
        if metrics_csv is not None:
            metrics_csv.close()
        if guard is not None:
            guard.uninstall()


# --------------------------- the eval CLIs' preflight ------------------------

def eval_telemetry(args, device) -> Telemetry:
    """An eval CLI's stream, opened with its run_start."""
    tel = Telemetry(getattr(args, "telemetry_out", ""))
    tel.emit("run_start", **run_manifest(vars(args), device))
    return tel


def eval_run_record(args, tel: Telemetry, device, tool: str):
    """An eval CLI's run-registry record (--run_registry, else
    $MFT_RUN_REGISTRY; None when neither is set), begun right after
    run_start; the CLI finalizes it with "ok" before its run_end. A run
    that dies before is settled to "interrupted" on the next registry
    open, as in the JAX eval CLIs."""
    registry = RunRegistry.from_args(args)
    if registry is None:
        return None
    device = resolve_device(device)
    return registry.begin(
        "eval", tool, config=vars(args),
        platform="gpu" if device.type == "cuda" else device.type,
        artifacts=[p for p in (tel.path, getattr(args, "out", "")) if p],
        telemetry=tel)


def preflight_eval(est_mb: float, args, tel: Telemetry, device,
                   resident_mb: float = 0.0,
                   what: str = "eval step") -> mg.MemCheck:
    """An eval CLI's admission check on the analytic estimate of its
    largest batch, the train path's mem_check without the ladder (eval
    has no rung to walk: --on_oom_risk degrade acts as warn). Under
    'fail' an over verdict ends the stream with run_end and raises
    MemoryAdmissionError before the data loop starts."""
    check = mg.preflight(est_mb, resident_mb=0.0,
                         cap_mb=getattr(args, "hbm_cap_mb", 0),
                         headroom=getattr(args, "hbm_headroom", 0.1),
                         device=device)
    tel.emit("mem_check", **check.event())
    if check.verdict != "over":
        return check
    if getattr(args, "on_oom_risk", "warn") == "fail":
        tel.emit("run_end", steps=0, wall_s=0.0,
                 exit="MemoryAdmissionError", goodput=None)
        tel.close()
        raise mg.MemoryAdmissionError(
            f"{what} failed memory admission ({check.describe()})",
            check=check)
    log.warning(f"memory admission ({what}): {check.describe()} "
                f"(proceeding)")
    return check
