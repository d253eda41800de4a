"""The run-telemetry stream, the loss-spike detector and the run's
wall-clock and FLOP accounting (port of mobilefinetuner_tpu/core/
telemetry.py: the event schema and validator, the JSONL sink with its
observers, `run_manifest`, `SpikeConfig` / `SpikeDetector`, the goodput
meter, the step clock, the hang watchdog and MFU).

One run-scoped, crash-durable JSONL stream that the train and eval CLIs
write through, with the JAX package's event taxonomy (`EVENT_SCHEMA`)
unchanged: a line the port writes passes the JAX package's
`validate_event`, and `tools/telemetry_report.py` renders a port stream.
Every event is written and flushed on its own; a resumed run appends to
the same stream and continues its `seq`. Nothing here touches a device:
the train loop formats what its one metrics transfer a flush returned.

`run_manifest` fills the schema's `jax_version` with `NO_JAX` (no JAX is
in use) and adds `torch_version` and `cuda_version` (the schema is a
floor).

MFU: `transformer_flops` is the JAX package's analytic estimate, and
`device_peak_flops` reads a table of NVIDIA parts keyed on substrings of
`torch.cuda.get_device_name()` (the CPU and unknown cards give 0.0, so
MFU is None rather than a ratio against a made-up peak).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import faulthandler
import json
import math
import os
import statistics
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

# the run_start manifest's jax_version: the port runs no JAX
NO_JAX = "none (PyTorch port)"

# --------------------------- event taxonomy ---------------------------------

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))
_OPT_STR = (str, type(None))

# Per-event required payload fields and their allowed types. Every event
# additionally carries the envelope: event (str), seq (int, monotonic per
# stream), t (float unix time), and — since the fleet layer (DESIGN.md
# §14) — host (int process index; 0 on single-host, optional for
# back-compat with pre-fleet streams). Extra fields are ALLOWED (the
# schema is a floor, not a ceiling) so events can grow without breaking
# old readers.
EVENT_SCHEMA: Dict[str, Dict[str, tuple]] = {
    # one per run, always the stream's first event of that run
    "run_start": {
        "jax_version": (str,),
        "mesh_shape": (dict, type(None)),
        "process_count": (int,),
        "process_index": (int,),
        "device_kind": (str,),
        "device_count": (int,),
        "config": (dict,),
    },
    # one per compiled executable (wall time + XLA's own FLOP count +
    # compiled-peak HBM from the memory analysis)
    "compile": {
        "step": (int,),
        "wall_s": _NUM,
        "flops": _OPT_NUM,          # compiled.cost_analysis(); None if n/a
        "peak_hbm_mb": _OPT_NUM,
    },
    # periodic, one per metrics flush (interval-averaged timings; the
    # loss/health fields are the interval's LAST step). loss/ema are
    # null exactly when the value was non-finite (strict-JSON rule).
    "step_stats": {
        "step": (int,),
        "loss": _OPT_NUM,
        "ema": _OPT_NUM,
        "lr": _NUM,
        "grad_norm": _OPT_NUM,
        "step_time_ms": _NUM,
        "host_wait_ms": _NUM,
        "slept_ms": _OPT_NUM,       # governor sleep inside the interval
        "tok_s": _NUM,
        "mfu": _OPT_NUM,            # None when peak FLOPs unknown (CPU)
        "param_norm": _OPT_NUM,     # None on step builders without the
        "update_ratio": _OPT_NUM,   # on-device health metrics
        "nonfinite_count": _OPT_NUM,
        "skipped": _OPT_NUM,        # skip_nonfinite guard: COUNT of
                                    # skipped updates in this flush
                                    # interval (None on step builders
                                    # without the guard's metric)
        "hbm_mb": _OPT_NUM,         # null when neither live memory_stats
                                    # nor a compiled-peak estimate exists
                                    # (round 16: a backend without stats
                                    # used to masquerade as 0 MB)
        "queue_depth": _OPT_NUM,    # input-pipeline gauge (None: no stream)
        "host_step_ms": (dict, type(None)),  # {host: per-step ms} from the
                                    # last straggler-cadence gather; None
                                    # when --straggler_cadence is off
        "tenants": (dict, type(None)),  # round-18 multi-tenant engine:
                                    # {name: {slot, step, loss, tokens,
                                    # wait_ms}} per resident adapter job
                                    # (None / absent on solo training —
                                    # optional on read)
    },
    # governor throttle decision (system/governor.py event_sink)
    "throttle": {
        "step": (int,),
        "sleep_ms": _NUM,
        "battery": _OPT_NUM,
        "temp": _OPT_NUM,
        "source": (str,),           # "schedule" | "telemetry"
    },
    # host-side loss-spike / divergence detector fired (loss is null
    # exactly for kind=nonfinite_loss — strict-JSON rule), OR a
    # transient-but-survived incident: kind=data_retry (the streaming
    # data pipeline hit an I/O error and is backing off instead of
    # killing the run; extra fields carry attempt/error/backoff_s).
    # kind=divergence is the SUSTAINED form — divergence_run
    # consecutive spiking steps, a level-shift rather than a blip —
    # and is the rollback policy's trigger; one-off loss_spike events
    # deliberately are not (DESIGN.md §20).
    "anomaly": {
        "step": (int,),
        "kind": (str,),             # "loss_spike" | "divergence"
                                    # | "nonfinite_loss" | "data_retry"
        "loss": _OPT_NUM,
        "ema": _OPT_NUM,
        "zscore": _OPT_NUM,
    },
    # loss/ppl are null for evals that aren't NLL-shaped (eval_mmlu
    # reports macro_accuracy/micro_accuracy as extra fields instead)
    "eval": {
        "step": (int,),
        "loss": _OPT_NUM,
        "ppl": _OPT_NUM,
        "tokens": (int,),
    },
    # one per completed checkpoint WRITE (emitted by io/async_ckpt.py's
    # writer — possibly from its background thread). wall_s is the
    # BLOCKING cost the save charged to the step loop (snapshot only
    # under --async_save; snapshot + write on the sync oracle path) —
    # the number the goodput `checkpoint` bucket counts; write_ms/bytes/
    # mb_s describe the disk write, which under async overlaps `step`.
    "checkpoint": {
        "step": (int,),
        "final": (bool,),
        "wall_s": _NUM,
        # round-10 snapshot/write split (optional on READ: pre-async
        # streams carry only step/final/wall_s)
        "snapshot_ms": _NUM,
        "write_ms": _NUM,
        "bytes": (int,),
        "mb_s": _OPT_NUM,           # None when bytes/write_ms unknown
        "async": (bool,),
    },
    # a snapshot superseded before its write started: the async writer's
    # depth-1 queue coalesces to the newest snapshot when saves outpace
    # the disk (backpressure by dropping stale recovery points, not by
    # growing an unbounded queue of whole-tree host copies)
    "ckpt_dropped": {
        "step": (int,),             # the dropped snapshot's step
        "superseded_by": (int,),    # the snapshot that replaced it
    },
    # one host's measured per-step time pulled away from the fleet: fired
    # by the coordinator after a --straggler_cadence cross-host gather
    # when host_ms > straggler_mult * fleet median
    "straggler": {
        "step": (int,),
        "slow_host": (int,),        # NOT "host": that's the envelope's
                                    # writer stamp (the coordinator
                                    # emits this about another process)
        "host_ms": _NUM,            # the slow host's median step ms
        "fleet_ms": _NUM,           # fleet median over the same window
        "ratio": _NUM,              # host_ms / fleet_ms
    },
    # hang watchdog fired: no step completed within the armed deadline.
    # The Python stacks of every thread are in stacks_file (faulthandler
    # dump) and device_probe says whether a trivial device op still
    # completes ("ok" | "timeout" | "error:<type>" | "skipped").
    "hang": {
        "step": (int,),             # last COMPLETED step
        "stall_s": _NUM,            # time since the last completed step
        "deadline_s": _NUM,         # the armed deadline that expired
        "stacks_file": (str,),
        "device_probe": (str,),
        "action": (str,),           # "continue" | "abort"
    },
    # serving-request lifecycle (serve/engine.py): one event per phase
    # transition — enqueue (submit), admit (prefill issued; queue_ms),
    # first_token (ttft_ms closes), finish (new_tokens/ttft/tpot final),
    # and the TERMINAL failure phases the round-14 robustness layer
    # added: cancel, reject (admission refused: queue full / shed /
    # shutdown), timeout (deadline blown — queued requests never
    # prefill, active ones return partial output), error (the request
    # was in flight when a step-dispatch exception was contained). A
    # request emits EXACTLY ONE terminal phase (finish|cancel|reject|
    # timeout|error). The SLO numbers telemetry_report's TTFT/TPOT
    # percentiles, req/s, and reject/timeout/error rates are computed
    # from these.
    "request": {
        "id": (int,),
        "phase": (str,),            # REQUEST_PHASES (validated below)
        "prompt_tokens": (int,),
        "adapter": (int, type(None)),  # bank slot; None = base-only
        "queue_ms": _OPT_NUM,       # enqueue -> admission
        "new_tokens": _OPT_NUM,     # tokens generated so far
        "ttft_ms": _OPT_NUM,        # enqueue -> first token
        "tpot_ms": _OPT_NUM,        # mean per-token after the first
        "reason": _OPT_STR,         # terminal detail: a REQUEST_REASONS
                                    # policy string on reject/timeout, the
                                    # exception type name on error, else
                                    # None (optional on read: r11 streams)
        "rid": _OPT_NUM,            # round-22 fleet-wide request id the
                                    # router stamped at ingress; rides
                                    # every phase of the request so
                                    # trace_export --router can join the
                                    # router's route/queue spans to the
                                    # replica's lifecycle (None / absent
                                    # on requests submitted directly to
                                    # an engine, and on pre-r22 streams)
    },
    # cadenced serve-loop health snapshot (serve/engine.py health()):
    # queue depth, slot occupancy, page-pool headroom, rolling p95 step
    # latency, and the cumulative terminal-state counters — the
    # observable the operator's load-shed/deadline policy is tuned
    # against (telemetry_report renders queue max / occupancy mean /
    # free-page floor from these).
    "serve_stats": {
        "step": (int,),             # decode_steps at the snapshot
        "queue_depth": (int,),
        "active": (int,),           # occupied slots
        "occupancy": _NUM,          # active / num_slots
        "free_blocks": (int,),      # page-pool headroom
        "p95_step_ms": _OPT_NUM,    # rolling window; None before step 1
        "finished": (int,),         # cumulative terminal-state counters
        "cancelled": (int,),
        "rejected": (int,),
        "timeout": (int,),
        "error": (int,),
        # round-16 HBM fields (optional on read: r14 streams): live
        # device bytes (null on backends without memory_stats) and the
        # static KV-pool footprint the admission preflight charged
        "hbm_mb": _OPT_NUM,
        "pool_mb": _OPT_NUM,
        # round-20 mesh shape [dp, tp] (optional on read: pre-sharding
        # streams); [1, 1] is the single-chip engine
        "mesh": (list,),
        # round-21 shared-prefix fields (optional on read: pre-r21
        # streams): fraction of looked-up prompt tokens served from
        # cached pages (null until the first lookup, or with the cache
        # off) and cumulative copy-on-write page copies (full-hit
        # re-feeds splitting their divergence block)
        "prefix_hit_rate": _OPT_NUM,
        "cow_copies": _OPT_NUM,
        # round-22 pool-occupancy numerator (optional on read: pre-r22
        # streams): pages held by live requests — with free_blocks it
        # gives the registry's mft_serve_pool_occupancy gauge (parked
        # cache pages count as free in both fields)
        "blocks_in_use": _OPT_NUM,
    },
    # one memory-admission verdict (core/memory_guard.py, DESIGN.md
    # §21): immediately post-compile (phase=preflight), on a caught
    # RESOURCE_EXHAUSTED at dispatch (phase=dispatch), or at serve
    # build (phase=serve_build). est_mb = compiled peak + unaccounted
    # live bytes; cap_mb = --hbm_cap_mb | memory_stats bytes_limit |
    # device-kind table; verdict "unknown" when either side is
    # unavailable (admission never refuses on a guess).
    "mem_check": {
        "est_mb": _OPT_NUM,
        "cap_mb": _OPT_NUM,
        "verdict": (str,),          # "ok" | "over" | "unknown"
        "phase": (str,),
    },
    # one degradation-ladder decision (cli/common.run_training): a
    # failed preflight (or dispatch RESOURCE_EXHAUSTED) under
    # --on_oom_risk=degrade walked one rung — remat -> accum_x2 ->
    # offload — recompiling and re-preflighting after each. est_mb is
    # the estimate that FORCED the rung (the next mem_check carries
    # the post-rung estimate).
    "degrade": {
        "step": _OPT_NUM,           # None at preflight (no step ran yet)
        "rung": (str,),             # a memory_guard.LADDER name
        "from": (str,),
        "to": (str,),
        "est_mb": _OPT_NUM,
    },
    # one checkpoint-integrity verdict per candidate a load path
    # visited (io/checkpoints.resolve_checkpoint — --resume_from, the
    # in-process rollback, the serve AdapterBank hot-swap): ok=false
    # names why the candidate was rejected (checksum_mismatch:<tensor>,
    # manifest_missing/stale, malformed, size_mismatch) and the walk
    # falls back DOWN the lineage chain instead of crashing on — or
    # silently loading — the newest file (DESIGN.md §20).
    "ckpt_verify": {
        "path": (str,),
        "ok": (bool,),
        "reason": _OPT_STR,         # None exactly when ok
        "step": _OPT_NUM,           # lineage step; None when unknown
        "action": _OPT_STR,         # "load" | "reject"
    },
    # one in-process rollback decision (cli/common.run_training closing
    # the SpikeDetector loop, DESIGN.md §20): on sustained divergence /
    # a skipped-step streak / nonfinite loss the loop reloads the
    # last-known-good verified checkpoint WITHOUT restarting the
    # process or recompiling the step, fast-forwards the data stream,
    # and keeps training. ok=false records a rollback that could not
    # happen (no verified checkpoint, or budget exhausted).
    "rollback": {
        "step": (int,),             # the step the trigger fired at
        "reason": (str,),           # divergence | skip_streak |
                                    # nonfinite_loss | ...
        "ok": (bool,),
        "to_step": _OPT_NUM,        # resumed loop step (None on ok=false)
        "steps_lost": _OPT_NUM,     # step - to_step (recovery cost)
        "ckpt": _OPT_STR,           # the checkpoint file loaded
        "data_offset": _OPT_NUM,    # extra data-stream skip applied
        "budget_left": _OPT_NUM,    # --rollback_budget remaining
    },
    # preemption drain began (core/preempt.py + cli/common.run_training):
    # a SIGTERM/SIGINT was observed at a step boundary; what follows is
    # the final flush, one atomic checkpoint, and a run_end with
    # reason="preempted" — then exit EXIT_PREEMPTED (75, resumable).
    "preempt": {
        "step": (int,),             # the drain step (last completed + 1)
        "signal": (str,),           # "SIGTERM" | "SIGINT"
    },
    # one completed host span (core/trace.py Tracer, opt-in via
    # --trace_spans / ServeConfig.trace_spans): t0 is a MONOTONIC
    # time.perf_counter() stamp — the same clock as the envelope's
    # t_mono — and dur_ms the span's length, so tools/trace_export.py
    # places it on the wall timeline via the per-host (t - t_mono)
    # offset without NTP-step jitter. `track` names the Perfetto row
    # inside the host's process: "phase" (the GoodputMeter buckets),
    # "ckpt" (the async writer thread), "prefetch" (the producer
    # thread), "req:<id>" (one serve request's lifecycle).
    "span": {
        "name": (str,),
        "track": (str,),
        "t0": _NUM,
        "dur_ms": _NUM,
    },
    # one completed anomaly-triggered profiler capture (core/trace.py
    # AutoProfiler, --auto_profile): a sensor fired — slow_step |
    # loss_spike | divergence | straggler | hang — and the device
    # trace of the bad window landed at `path`, budget/cooldown
    # permitting. The event is the pointer a post-mortem follows from
    # the stream to the trace.
    "profile_capture": {
        "step": (int,),
        "trigger": (str,),
        "path": (str,),
        "steps": _OPT_NUM,          # capture length in steps (None on
                                    # the hang path's bounded hold)
        "budget_left": _OPT_NUM,
    },
    # one fleet-controller decision (tools/fleet_controller.py, written
    # to <telemetry_base>.controller): the recovery layer's own
    # timeline, rendered by fleet_report next to the goodput buckets so
    # recovery cost is a visible line, not a mystery gap in step reach.
    "controller": {
        "action": (str,),           # launch|down|restart|lost|shrink|
                                    # drain|give_up|stop
        "worker": (int, type(None)),  # subject host index; None = fleet
        "reason": _OPT_STR,         # hang | exit:<code> | preempted |
                                    # sigterm | lost worker <k> | ...
        "attempt": _OPT_NUM,        # restart attempt count for `worker`
        "backoff_s": _OPT_NUM,      # exponential backoff before relaunch
        "step": _OPT_NUM,           # worker's last observed step
        "recovery_s": _OPT_NUM,     # down-observed -> relaunched wall s
    },
    # one routing decision (tools/serve_router.py, round 22): the
    # router chose (or failed to choose) a replica for request `rid`
    # from its cadenced /metrics + /healthz scrape of every replica.
    # One event per ingress request, written to the ROUTER's own
    # stream (host 0 of the fleet base path; replica engines write the
    # .host<k> shards) — trace_export --router renders it as the
    # routing instant on the router's process row, and the serve-fleet
    # report section histograms the decisions per replica.
    "route": {
        "rid": (int,),              # fleet-wide request id (stamped here,
                                    # rides the replica's request events)
        "replica": (int, type(None)),  # chosen replica index; None when
                                    # no healthy replica could take it
        "policy": (str,),           # what decided the placement:
                                    # affinity (resident-adapter match) |
                                    # least_loaded (load score argmin) |
                                    # failover (first choice was down at
                                    # dispatch; rerouted) | reject (no
                                    # healthy candidate)
        "adapter": _OPT_STR,        # requested adapter name; None = base
        "queue_depth": _OPT_NUM,    # chosen replica's scraped depth at
                                    # decision time (None on reject)
        "occupancy": _OPT_NUM,      # chosen replica's scraped occupancy
        "scrape_age_ms": _OPT_NUM,  # staleness of the snapshot the
                                    # decision read (the scrape cadence
                                    # bounds it on a healthy fleet)
        "candidates": (int,),       # healthy replicas considered
    },
    # one multi-tenant job lifecycle transition (multitenant/engine.py,
    # DESIGN.md §23): admit (job -> slot), save (periodic step-tagged
    # checkpoint), finish (budget reached; final adapter saved at
    # `path`), cancel. `step` is the TENANT-LOCAL step counter; every
    # event also carries the optional `tenant` attribution field (see
    # validate_event) so cross-event filtering by tenant needs no
    # per-event special casing.
    "tenant": {
        "name": (str,),
        "slot": (int,),             # bank slot; -1 = not resident
        "phase": (str,),            # admit | save | finish | cancel
        "step": (int,),             # tenant-local steps completed
        "job_steps": _OPT_NUM,      # the job's step budget
        "tokens": _OPT_NUM,         # cumulative trained tokens
        "loss": _OPT_NUM,
        "path": _OPT_STR,           # saved artifact (save/finish)
    },
    # one per run on orderly exit; exit != "ok" names the exception type
    # (or "preempted" for a drained run — reason carries it too, for
    # consumers that filter on a dedicated field).
    # goodput: wall-clock bucket totals (seconds) from GoodputMeter — the
    # buckets sum to the run's wall time by construction (None on entry
    # points without a metered loop, e.g. the eval CLIs).
    "run_end": {
        "steps": (int,),
        "wall_s": _NUM,
        "exit": (str,),
        "goodput": (dict, type(None)),
        "reason": _OPT_STR,         # "preempted" on the drain path
    },
    # round-23 run registry (core/run_registry.py, DESIGN.md §28): one
    # append-only, self-contained record per run REGISTRATION — phase
    # "start" when the entrypoint opens (status "running"), phase "end"
    # when it finalizes (terminal status). Both phases re-emit the full
    # identity block (git rev, config fingerprint, platform, mesh) so a
    # registry line never needs a join to interpret; a start with no
    # matching end and a dead pid resolves to "interrupted" on the next
    # registry open. The same event is mirrored into the run's own
    # --telemetry_out stream as the observatory's join key.
    "run": {
        "run_id": (str,),
        "phase": (str,),            # "start" | "end" (closed set)
        "kind": (str,),             # "train" | "eval" | "serve" | "bench"
        "tool": (str,),             # entrypoint name (basename, no .py)
        "status": (str,),           # running | ok | interrupted | <type>
        "git_rev": _OPT_STR,        # None outside a git checkout
        "config_fingerprint": _OPT_STR,
        "platform": _OPT_STR,       # "cpu" | "tpu" | ... | None
        "mesh": (dict, type(None)),
        "pid": (int,),              # liveness probe for dead-run repair
        "artifacts": (list, type(None)),
        "wall_s": _OPT_NUM,         # None on start records
    },
    # round-23 longitudinal sentinel (tools/observatory.py): one verdict
    # per gated (platform, config, metric) series — the newest sample
    # against the rolling median + MAD band of its history. Emitted
    # through a Telemetry stream so the metrics registry folds
    # mft_trend_* gauges off the same record the verdict JSON carries.
    "trend": {
        "metric": (str,),
        "config": (str,),
        "platform": (str,),         # series are platform-split: a CPU
                                    # schema-pin row never gates a TPU
                                    # perf row
        "value": _OPT_NUM,          # newest sample
        "median": _OPT_NUM,         # rolling median of the history
        "mad": _OPT_NUM,            # median absolute deviation
        "z": _OPT_NUM,              # robust z of the newest sample
                                    # (signed: + is worse)
        "direction": _OPT_STR,      # "higher" | "lower" | None
        "regressed": (bool,),
        "run": (str,),              # newest sample's run label
        "n": (int,),                # samples in the series
    },
}


# The run-registry lifecycle's CLOSED phase set (core/run_registry.py):
# exactly one "start" and one "end" per run; the validator rejects any
# other spelling, mirroring REQUEST_PHASES.
RUN_PHASES = ("start", "end")


# Fields added AFTER a schema generation was already in the wild:
# current writers always emit them, but a reader must accept their
# ABSENCE so pre-fleet (round-8) streams still validate and render —
# when present they are type-checked as usual.
OPTIONAL_FIELDS: Dict[str, frozenset] = {
    "step_stats": frozenset({"host_step_ms", "skipped", "tenants"}),
    "serve_stats": frozenset({"hbm_mb", "pool_mb", "mesh",
                              "prefix_hit_rate", "cow_copies",
                              "blocks_in_use"}),
    "run_end": frozenset({"goodput", "reason"}),
    "checkpoint": frozenset({"snapshot_ms", "write_ms", "bytes", "mb_s",
                             "async"}),
    "request": frozenset({"reason", "rid"}),
    "ckpt_verify": frozenset({"reason", "step", "action"}),
    "rollback": frozenset({"to_step", "steps_lost", "ckpt",
                           "data_offset", "budget_left"}),
}


# The request lifecycle's CLOSED phase set (serve/engine.py): the
# validator rejects any other spelling, and the emit-site scan
# (tests/test_fleet.py) pins source literals against this tuple both
# directions — a new phase lands in schema, emitter, and report in one
# review or not at all.
REQUEST_PHASES = ("enqueue", "admit", "first_token", "finish", "cancel",
                  "reject", "timeout", "error")

# The closed set of POLICY reasons a reject/timeout carries (the error
# phase instead carries the contained exception's type name — an open
# set the scan cannot and should not pin):
#   queue_full  bounded admission refused the newest arrival
#   shed        the deadline-shed policy dropped a queued request to
#               make room for a new one
#   shutdown    drain in progress (SIGTERM): queued remainder rejected
#   deadline    the request's own deadline_ms expired
#   prompt_too_long  the prompt exceeds the engine's TRUE cap
#               (max(max_prompt, max_prompt_chunked), round 21): even
#               chunked admission cannot hold its pages + max_new
REQUEST_REASONS = frozenset({"queue_full", "shed", "shutdown", "deadline",
                             "prompt_too_long"})


def validate_event(rec: Any) -> Optional[str]:
    """None if `rec` satisfies the contract, else a human-readable reason.
    Shared by tests/test_telemetry.py and tools/telemetry_report.py so the
    validator cannot fork from the schema."""
    if not isinstance(rec, dict):
        return f"not an object: {type(rec).__name__}"
    ev = rec.get("event")
    if ev not in EVENT_SCHEMA:
        return f"unknown event type: {ev!r}"
    if not isinstance(rec.get("seq"), int) or rec["seq"] < 0:
        return f"{ev}: bad seq {rec.get('seq')!r}"
    if not isinstance(rec.get("t"), (int, float)):
        return f"{ev}: bad t {rec.get('t')!r}"
    # host is envelope, stamped by the fleet layer; optional so pre-fleet
    # streams still validate
    if "host" in rec and (not isinstance(rec["host"], int)
                          or isinstance(rec["host"], bool)
                          or rec["host"] < 0):
        return f"{ev}: bad host {rec.get('host')!r}"
    # t_mono is envelope too (round 17): a monotonic perf_counter stamp
    # next to wall `t`, so trace_export span alignment never jitters
    # across NTP steps. Optional on read — pre-round-17 streams carry
    # only `t` and must keep parsing in both report tools.
    if "t_mono" in rec and (isinstance(rec["t_mono"], bool)
                            or not isinstance(rec["t_mono"], (int, float))):
        return f"{ev}: bad t_mono {rec.get('t_mono')!r}"
    # tenant is the round-18 multi-tenant attribution field: ANY event
    # may carry it (the engine stamps its per-tenant lifecycle and save
    # events), and when present it must be a tenant name string —
    # optional on read, so every pre-multitenant stream validates
    # unchanged.
    if "tenant" in rec and not isinstance(rec["tenant"], (str, type(None))):
        return f"{ev}: bad tenant {rec.get('tenant')!r}"
    for field, types in EVENT_SCHEMA[ev].items():
        if field not in rec:
            if field in OPTIONAL_FIELDS.get(ev, ()):
                continue  # pre-fleet stream: absence is legal on read
            return f"{ev}: missing field {field!r}"
        v = rec[field]
        # bool is an int subclass; reject it where a number is expected
        if isinstance(v, bool) and bool not in types:
            return f"{ev}.{field}: bool where {types} expected"
        if not isinstance(v, types):
            return f"{ev}.{field}: {type(v).__name__} not in {types}"
    if ev == "request" and rec.get("phase") not in REQUEST_PHASES:
        return f"request: unknown phase {rec.get('phase')!r}"
    if ev == "run" and rec.get("phase") not in RUN_PHASES:
        return f"run: unknown phase {rec.get('phase')!r}"
    return None


# --------------------------- the JSONL sink ---------------------------------

def shard_path(path: str, host: int) -> str:
    """Per-host shard naming (DESIGN.md §14): the coordinator keeps the
    requested path, host k > 0 appends `.host<k>` — a single-host run
    keeps the pre-fleet path and schema (records additionally carry the
    `host` envelope stamp), and a pod run leaves one mergeable shard per
    process next to it."""
    if not path or host == 0:
        return path
    return f"{path}.host{host}"


def _scan_existing(path: str, trailing: int = 256):
    """(last_seq, trailing step_stats records) from the file's valid JSONL
    lines; (-1, []) when the file is absent/empty. Scans the whole file: it
    is read once at open, and a telemetry stream is small (one step_stats
    per flush, not per step). The trailing step_stats feed the spike
    detector's crash/resume re-seed (SpikeDetector.seed)."""
    last = -1
    tail: collections.deque = collections.deque(maxlen=trailing)
    try:
        with open(path, "rb") as f:
            for raw in f:
                try:
                    rec = json.loads(raw)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    continue  # truncated tail line from a crashed writer
                if not isinstance(rec, dict):
                    continue
                s = rec.get("seq")
                if isinstance(s, int):
                    last = max(last, s)
                if rec.get("event") == "step_stats":
                    tail.append(rec)
    except OSError:
        return -1, []
    return last, list(tail)


def _json_finite(v):
    """Replace non-finite floats (recursively) with None so every
    emitted line is strict RFC 8259 JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _json_finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_finite(x) for x in v]
    return v


class Telemetry:
    """Append-only JSONL event stream, one record per `emit` call.

    A falsy `path` (or enabled=False) writes nothing, so call sites never
    branch. Appending to an existing file continues its seq numbering —
    the crash/resume contract: one stream per run directory, ordered
    across process restarts. `resumed` is True exactly then, and
    `trailing_step_stats` holds the prior run's tail of step_stats
    records (the spike-detector re-seed source).

    `host` stamps every record's envelope with the writing process index
    (0: the port runs one process until ROADMAP.md port item P9; the JAX
    package's multi-host shards are `shard_path`'s names). emit is
    lock-serialized, so the checkpoint writer's thread, the prefetch
    producer and the hang watchdog report through the same stream as the
    step loop.

    Observers (`add_observer`) see every emitted record in-process: the
    metrics endpoint's registry (core/metrics_http.py) rides here, fed
    by the same emit as the file. They run under the emit lock on
    whichever thread emitted, even when the stream has no file, and an
    observer's exception never reaches the emitter.
    """

    def __init__(self, path: str = "", enabled: bool = True,
                 host: int = 0):
        self.path = path
        self.host = int(host)
        self.enabled = bool(path) and enabled
        self._f = None
        self._seq = 0
        self._lock = threading.Lock()
        self._closed = False
        self._observers: List[Callable] = []
        self.resumed = False
        self.trailing_step_stats: List[dict] = []
        if self.enabled:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            if os.path.exists(path):
                last, self.trailing_step_stats = _scan_existing(path)
                self._seq = last + 1
                self.resumed = last >= 0
            self._f = open(path, "a", encoding="utf-8")
            # a killed writer can leave a partial line with NO trailing
            # newline; terminate it so this run's first event starts a
            # fresh line instead of gluing itself onto the corpse
            if self._f.tell() > 0:
                with open(path, "rb") as rf:
                    rf.seek(-1, os.SEEK_END)
                    if rf.read(1) != b"\n":
                        self._f.write("\n")
                        self._f.flush()

    def emit(self, event: str, **fields) -> Optional[dict]:
        """Append one event; returns the record (None when nothing was
        written to a file). Per-event flush: the stream survives a
        SIGKILL mid-run. Non-finite floats are serialized as null —
        json.dumps' default NaN/Infinity literals are invalid RFC 8259
        and would break strict consumers (jq, JSON.parse) on exactly the
        divergence records the stream exists to capture; the `anomaly`
        event's kind field carries the non-finiteness."""
        with self._lock:
            # a closed stream is a no-op, observers included: nested
            # end-of-run handlers compose without a second run_end
            if self._closed:
                return None
            writable = self.enabled and self._f is not None
            if not writable and not self._observers:
                return None
            # envelope last: a payload field may not shadow the stream's
            # identity keys (event/seq/t/t_mono/host) — the straggler
            # event learned this the hard way (its slow-host field is
            # named slow_host for exactly this reason). t_mono is the
            # monotonic sibling of wall `t`: span alignment
            # in trace_export reads the per-host (t - t_mono) offset,
            # immune to NTP steps moving wall time mid-run.
            rec = {**{k: _json_finite(v) for k, v in fields.items()},
                   "event": event, "seq": self._seq, "t": time.time(),
                   "t_mono": time.perf_counter(), "host": self.host}
            self._seq += 1
            if writable:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
            for ob in self._observers:
                try:
                    ob(rec)
                except Exception:
                    pass  # a broken observer must not kill the emitter
            return rec if writable else None

    def add_observer(self, fn: Callable[[dict], Any]) -> None:
        """Register an in-process consumer of every emitted record
        (called under the emit lock, record at a time, exceptions
        swallowed)."""
        with self._lock:
            self._observers.append(fn)

    def flush_tail(self) -> None:
        """Durability barrier before a hard exit (`os._exit` skips every
        Python-level cleanup): take the emit lock, so no write is
        mid-flight on another thread, flush and fsync, and
        newline-terminate the file if its last byte is not a newline.
        After this the stream's tail is a complete line."""
        with self._lock:
            if self._f is None or not self.enabled:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
                with open(self.path, "rb+") as rf:
                    rf.seek(0, os.SEEK_END)
                    if rf.tell() > 0:
                        rf.seek(-1, os.SEEK_END)
                        if rf.read(1) != b"\n":
                            rf.write(b"\n")
                            rf.flush()
                            os.fsync(rf.fileno())
            except OSError:
                pass  # best effort: the abort proceeds regardless

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            self.enabled = False
            self._closed = True

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def last_seq(self) -> int:
        """seq of the most recently emitted record (-1: none yet); the
        hang event reports it."""
        return self._seq - 1

    @classmethod
    def for_process(cls, path: str, process_index: int = 0) -> "Telemetry":
        """The stream of this process: process 0 writes `path`, process k
        its `.host<k>` shard (`shard_path`), each record host-stamped.
        The port runs one process (scale-out is ROADMAP.md P9), so the
        index is the caller's to give."""
        if not path:
            return cls("")
        return cls(shard_path(path, process_index), host=process_index)


def run_manifest(config: dict, device=None) -> dict:
    """The run_start payload: the flags (JSON scalars only), the versions
    and the device the run is on (`device`: None = the CUDA card when one
    is present)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    on_card = dev.type == "cuda"
    return {
        "jax_version": NO_JAX,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "mesh_shape": None,
        "process_count": 1,          # one process: scale-out is P9
        "process_index": 0,
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "config": {k: v for k, v in sorted(config.items())
                   if isinstance(v, (str, int, float, bool, type(None)))},
    }


# --------------------------- loss-spike detector ----------------------------

@dataclasses.dataclass
class SpikeConfig:
    """EMA + z-score divergence detector knobs (--spike_* flags).
    zscore <= 0 disables the detector entirely."""
    zscore: float = 8.0    # fire when (loss - ema) / std exceeds this
    beta: float = 0.98     # EMA decay for mean AND variance
    warmup: int = 20       # observations before the detector arms
    # sustained-divergence threshold: this many CONSECUTIVE spiking
    # steps escalate the anomaly kind from loss_spike (transient blip)
    # to divergence (level-shift) — the distinction the rollback policy
    # keys on, so one bad batch never triggers a rollback but a run
    # walking away from its loss curve does. <= 0 disables escalation.
    divergence_run: int = 3


class SpikeDetector:
    """Host-side loss-spike detector over the flushed per-step losses.

    Keeps an EMA of the loss and an EMA of squared deviation; a step
    whose z-score exceeds the threshold (after warmup) is an anomaly —
    the run keeps training (policy belongs to the operator, not the
    loop) but the event stream records exactly when it went wrong
    instead of silently training through divergence. A non-finite loss
    is always anomalous, warmup or not.
    """

    def __init__(self, config: Optional[SpikeConfig] = None):
        self.config = config or SpikeConfig()
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.count: int = 0
        self._nonfinite: bool = False  # inside a non-finite run?
        self.streak: int = 0  # consecutive spiking steps (divergence)

    def update(self, loss: float) -> Optional[dict]:
        """Feed one per-step loss; returns {kind, zscore} when anomalous,
        else None. A spiking sample is WINSORIZED into the EMA (clamped
        to mean + zscore·std) rather than excluded or taken raw: raw
        inclusion would let one spike inflate the variance and mask the
        next, full exclusion would mean a persistent level-shift (e.g. a
        LR bump settling loss on a new plateau) fires on every step
        forever — clamped updates walk the EMA toward the new level, so
        the detector re-arms after the transition."""
        c = self.config
        if c.zscore <= 0:
            return None
        if not math.isfinite(loss):
            # NaN is absorbing (every later loss stays NaN): fire on the
            # TRANSITION only, or a 100k-step diverged run would emit one
            # anomaly line per remaining step — the same stream-sizing
            # rule the throttle events follow
            if self._nonfinite:
                return None
            self._nonfinite = True
            return {"kind": "nonfinite_loss", "zscore": None}
        self._nonfinite = False
        if self.mean is None:
            # first OBSERVED loss: seed the mean but never clobber the
            # observation count — a rollback re-arms the detector via
            # seed([], count_hint=step) with no losses to feed, and
            # resetting to 1 here would silently re-enter warmup
            # exactly when a recurring divergence needs catching
            self.mean = loss
            self.count += 1
            return None
        dev = loss - self.mean
        std = math.sqrt(self.var)
        z = dev / std if std > 0 else 0.0
        armed = self.count >= c.warmup
        out = None
        if armed and std > 0 and z > c.zscore:
            # a streak of consecutive spiking steps is not a blip but a
            # level-shift: escalate the kind to `divergence` at
            # divergence_run — the distinct trigger the rollback policy
            # consumes (a transient loss_spike must never roll a run
            # back). The streak resets on fire so a long excursion
            # re-fires every divergence_run-th step, not every step.
            self.streak += 1
            kind = "loss_spike"
            if 0 < c.divergence_run <= self.streak:
                kind = "divergence"
                self.streak = 0
            out = {"kind": kind, "zscore": round(z, 2)}
            loss = self.mean + c.zscore * std  # winsorize
            dev = loss - self.mean
        else:
            self.streak = 0
        self.mean = c.beta * self.mean + (1 - c.beta) * loss
        self.var = c.beta * self.var + (1 - c.beta) * dev * dev
        self.count += 1
        return out

    def seed(self, losses: Sequence[float], count_hint: int = 0) -> int:
        """Re-seed from a resumed run's trailing flushed losses (the
        telemetry stream's step_stats tail) so a crash/resume does NOT
        re-enter warmup: a fresh detector needs `warmup` observations
        before arming, and a spike in the first post-resume steps — the
        exact window where resume bugs (stale optimizer state, data-order
        skew) bite — would be silently missed. The historical losses walk
        the EMA mean/variance to the pre-crash level without firing
        (seeding never emits), and `count_hint` (the resumed step number)
        bumps the observation count past warmup even when the stream's
        flush cadence kept fewer than `warmup` step_stats lines. Returns
        the number of samples consumed."""
        fed = 0
        for loss in losses:
            if not isinstance(loss, (int, float)) \
                    or not math.isfinite(loss):
                continue
            if self.mean is None:
                self.mean = float(loss)
            else:
                dev = float(loss) - self.mean
                c = self.config
                self.mean = c.beta * self.mean + (1 - c.beta) * float(loss)
                self.var = c.beta * self.var + (1 - c.beta) * dev * dev
            self.count += 1
            fed += 1
        self.count = max(self.count, int(count_hint))
        return fed


# --------------------------- goodput accounting -----------------------------

# Every second of a run's wall-clock lands in exactly one bucket:
#   init           process start -> first batch requested (model load,
#                  placement, stream construction)
#   compile        blocked building kernels: in the port, the nvcc build
#                  of a kernel library at its first use (kernels/build.py;
#                  0 with a warm build/kernels/)
#   step           dispatching/retiring optimizer steps (the productive
#                  bucket; includes the flush transfer, which is time
#                  spent WAITING for useful device work)
#   input_wait     step loop blocked pulling the next batch from the
#                  input pipeline (host-bound: tokenization/refetch)
#   eval           in-loop + final evaluation
#   checkpoint     save_hook wall time
#   governor_sleep duty-cycle throttle sleeps (deliberate idleness)
#   shutdown       post-loop teardown until run_end
GOODPUT_BUCKETS = ("init", "compile", "step", "input_wait", "eval",
                   "checkpoint", "governor_sleep", "shutdown")


class GoodputMeter:
    """Wall-clock classifier: at any instant the run is in exactly ONE
    phase, `enter(phase)` charges the elapsed time to the previous one,
    so the buckets sum to total wall-clock by construction. `summary()`
    is the run_end `goodput` payload.

    With a `tracer` (core/trace.py, --trace_spans) every phase segment
    also lands as a `span` event on the "phase" track: the transition
    that charges the bucket emits the span, so the exported timeline's
    per-bucket span sums reconcile with run_end's buckets
    (tools/trace_export.py prints the check)."""

    def __init__(self, tracer=None):
        self.buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._phase = "init"
        self._mark = time.perf_counter()
        self._tracer = tracer

    @property
    def phase(self) -> str:
        return self._phase

    def enter(self, phase: str) -> None:
        assert phase in self.buckets, phase
        now = time.perf_counter()
        self.buckets[self._phase] += now - self._mark
        if self._tracer is not None:
            self._tracer.emit_span(self._phase, "phase", self._mark,
                                   (now - self._mark) * 1000.0)
        self._mark = now
        self._phase = phase

    def summary(self) -> dict:
        """Close the current phase and render {total_s, productive_frac,
        <bucket>_s...}. productive_frac = step / total. total_s is the
        sum of the ROUNDED buckets, so the emitted record itself
        satisfies the sum-to-total identity."""
        self.enter(self._phase)  # charge the open phase through `now`
        out = {f"{b}_s": round(v, 4) for b, v in self.buckets.items()}
        total = round(sum(out.values()), 6)
        out["total_s"] = total
        out["productive_frac"] = round(
            out["step_s"] / total, 4) if total > 0 else 0.0
        return out


# --------------------------- step-time window -------------------------------

class StepClock:
    """Rolling host-side per-step time window (re-exported as
    train.trainer.StepClock).

    The step loop feeds it the FLUSH-INTERVAL synced per-step average
    (the same number step_stats.step_time_ms publishes, governor sleep
    excluded): under asynchronous launches a per-iteration wall clock
    measures only launch latency. Consumers read the median, which one
    build- or eval-inflated sample does not shift. `reset()` starts a
    fresh window."""

    def __init__(self, window: int = 512):
        self._durs: collections.deque = collections.deque(maxlen=window)

    def record(self, seconds: float) -> None:
        self._durs.append(max(float(seconds), 0.0))

    @property
    def n(self) -> int:
        return len(self._durs)

    def median_s(self) -> float:
        return statistics.median(self._durs) if self._durs else 0.0

    def median_ms(self) -> float:
        return self.median_s() * 1000.0

    def reset(self) -> None:
        self._durs.clear()


# --------------------------- hang watchdog ----------------------------------

class HangWatchdog:
    """Daemon-thread deadline on step completion.

    State machine: GRACE (armed at start(), deadline `grace_s`, covering
    pre-first-step setup; a kernel build is wrapped in paused() by the
    caller, as cli/common.run_training does) -> ARMED (after the first
    pet(), deadline max(mult x rolling-median step time,
    min_deadline_s), re-armed by every pet; SUSPENDED across known long
    pauses — eval, checkpoint — via suspend()/resume()) -> FIRED
    (deadline expired with no pet: dump every Python thread's stack via
    faulthandler to `stacks_file`, probe the device with a trivial op
    under a bounded side-thread join, report through `on_hang`, then
    either re-arm with a doubled deadline — so a wedged run logs
    O(log) hang events, not one per deadline — or abort the process
    with exit code 113 after `flush_fn`). stop() ends the thread.

    Everything observable is injectable (`probe_fn`, `abort_fn`,
    `flush_fn`) so the injected-stall tests are deterministic and never
    kill the test process.
    """

    def __init__(self, mult: float = 10.0, min_deadline_s: float = 60.0,
                 grace_s: float = 300.0,
                 on_hang: Optional[Callable[[dict], Any]] = None,
                 stacks_file: str = "", abort: bool = False,
                 probe_fn: Optional[Callable[[], Any]] = None,
                 abort_fn: Optional[Callable[[int], Any]] = None,
                 window: int = 31, probe_timeout_s: float = 5.0,
                 flush_fn: Optional[Callable[[], Any]] = None):
        self.mult = float(mult)
        self.min_deadline_s = float(min_deadline_s)
        self.grace_s = float(grace_s)
        self.on_hang = on_hang
        self.stacks_file = stacks_file or os.path.join(
            tempfile.gettempdir(), f"hang_stacks_{os.getpid()}.txt")
        self.abort = bool(abort)
        self._probe_fn = probe_fn
        self._abort_fn = abort_fn or os._exit
        self._flush_fn = flush_fn
        self._probe_timeout_s = float(probe_timeout_s)
        self._clock = StepClock(window=window)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._suspended = False
        self._last_pet = time.perf_counter()
        self._last_step = -1
        self._deadline_s = max(self.grace_s, self.min_deadline_s)
        self._backoff = 1.0
        self.fired = 0  # hang events raised
        self._thread: Optional[threading.Thread] = None

    # -- step-loop side -----------------------------------------------------
    def start(self) -> "HangWatchdog":
        # the grace clock starts here, not at construction
        self._last_pet = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="hang-watchdog")
        self._thread.start()
        return self

    def pet(self, step: int, step_s: Optional[float] = None) -> None:
        """A step completed: re-arm the idle deadline; with `step_s`,
        also feed a duration sample and recompute the deadline (the loop
        pets every iteration and feeds samples at flush boundaries,
        where the per-step time is synced)."""
        with self._lock:
            if step_s is not None:
                self._clock.record(step_s)
                self._deadline_s = max(self.mult * self._clock.median_s(),
                                       self.min_deadline_s)
            self._backoff = 1.0
            self._last_step = step
            self._last_pet = time.perf_counter()
        self._wake.set()

    def touch(self) -> None:
        """Reset the idle clock without a completed step."""
        with self._lock:
            self._last_pet = time.perf_counter()
        self._wake.set()

    def suspend(self) -> None:
        """Stop the deadline clock across a long pause the loop knows
        about (eval, checkpoint save, a kernel build)."""
        with self._lock:
            self._suspended = True
        self._wake.set()

    def resume(self) -> None:
        """End a suspend(): the idle clock restarts from now."""
        with self._lock:
            self._suspended = False
            self._last_pet = time.perf_counter()
        self._wake.set()

    @contextlib.contextmanager
    def paused(self):
        """suspend()/resume() as a with-block."""
        self.suspend()
        try:
            yield
        finally:
            self.resume()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- watchdog-thread side -----------------------------------------------
    def _probe_device(self) -> str:
        """Run the probe in a bounded side thread: a wedged device may
        never return, and the watchdog thread must survive to report."""
        if self._probe_fn is None:
            return "skipped"
        result = {}

        def go():
            try:
                self._probe_fn()
                result["r"] = "ok"
            except BaseException as e:  # noqa: BLE001 - report, not mask
                result["r"] = f"error:{type(e).__name__}"

        t = threading.Thread(target=go, daemon=True, name="hang-probe")
        t.start()
        t.join(timeout=self._probe_timeout_s)
        return result.get("r", "timeout")

    def _dump_stacks(self) -> None:
        try:
            with open(self.stacks_file, "a") as f:
                f.write(f"=== hang at {time.strftime('%Y-%m-%d %H:%M:%S')}"
                        f" (last step {self._last_step}) ===\n")
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
        except OSError:
            pass  # the report event still fires

    def _run(self) -> None:
        while not self._stop:
            with self._lock:
                deadline = self._deadline_s * self._backoff
                idle = time.perf_counter() - self._last_pet
                suspended = self._suspended
            if suspended:
                self._wake.wait(timeout=0.25)
                self._wake.clear()
                continue
            if idle < deadline:
                self._wake.wait(timeout=max(deadline - idle, 0.02))
                self._wake.clear()
                continue
            # deadline expired with no completed step: FIRED
            self._dump_stacks()
            probe = self._probe_device()
            self.fired += 1
            payload = {"step": self._last_step,  # last COMPLETED step
                       "stall_s": round(idle, 3),
                       "deadline_s": round(deadline, 3),
                       "stacks_file": self.stacks_file,
                       "device_probe": probe,
                       "action": "abort" if self.abort else "continue"}
            if self.on_hang is not None:
                try:
                    self.on_hang(payload)
                except Exception:
                    pass  # reporting failure must not kill the watchdog
            if self.abort:
                # a wedged device cannot be unwound by raising in another
                # thread: hard exit, after the caller's flush barrier
                # (Telemetry.flush_tail) so the stream ends with the
                # complete hang record
                if self._flush_fn is not None:
                    try:
                        self._flush_fn()
                    except Exception:
                        pass  # the abort proceeds regardless
                self._abort_fn(113)
                return
            with self._lock:
                self._last_pet = time.perf_counter()
                self._backoff *= 2.0  # O(log) events while truly wedged


def device_probe(device) -> Callable[[], None]:
    """The watchdog's device probe, run on its bounded side thread, never
    on the step thread: on the card a synchronize of `device`
    (set_device first: the current device is per thread), which returns
    only when the card has finished what was queued; on the CPU a
    trivial op."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda: torch.zeros(()).add_(1)

    def probe():
        torch.cuda.set_device(device)
        torch.cuda.synchronize(device)
    return probe


# --------------------------- partial goodput (reader side) ------------------

def partial_goodput(events: Sequence[dict]) -> dict:
    """Best-effort goodput buckets for a TRUNCATED stream (killed run, no
    run_end): compile and checkpoint wall times are explicit, governor
    sleep totals ride in step_stats.slept_ms, and input-wait is the
    flush-interval host-wait fraction applied to the observed step span.
    Marked partial=True; the buckets do NOT sum to wall-clock."""
    compile_s = sum(e.get("wall_s") or 0.0 for e in events
                    if e.get("event") == "compile")
    ckpt_s = sum(e.get("wall_s") or 0.0 for e in events
                 if e.get("event") == "checkpoint")
    stats = [e for e in events if e.get("event") == "step_stats"]
    sleep_s = sum((e.get("slept_ms") or 0.0) for e in stats) / 1000.0
    times = sum(e.get("step_time_ms") or 0.0 for e in stats)
    waits = sum(e.get("host_wait_ms") or 0.0 for e in stats)
    wait_frac = waits / times if times > 0 else 0.0
    first_t = events[0]["t"] if events else 0.0
    last_t = events[-1]["t"] if events else 0.0
    span = max(last_t - first_t, 0.0)
    return {
        "partial": True,
        "compile_s": round(compile_s, 4),
        "checkpoint_s": round(ckpt_s, 4),
        "governor_sleep_s": round(sleep_s, 4),
        "input_wait_frac_of_step": round(wait_frac, 4),
        "observed_span_s": round(span, 4),
    }


# --------------------------- FLOP / MFU accounting --------------------------

def transformer_flops(n_params_active, n_params_frozen, B, S, n_layer,
                      n_head, head_dim, full_ft):
    """FLOPs per optimizer step (forward+backward), the standard
    estimate: matmul fwd = 2*N*T; backward dx = 2*N*T always (the loss
    gradient flows through frozen weights to reach LoRA/embedding
    sites), dW only for trained weights; + attention 2*2*B*H*S^2*D fwd,
    doubled in bwd."""
    T = B * S
    N = n_params_active + n_params_frozen
    fwd = 2 * N * T
    bwd = 2 * N * T + 2 * (n_params_active if not full_ft else N) * T
    attn = 4 * B * n_layer * n_head * S * S * head_dim
    return fwd + bwd + 3 * attn


# Dense bf16 tensor-core peak FLOP/s per card, by lower-cased substring of
# torch.cuda.get_device_name(); matched longest substring first. Source:
# NVIDIA H100 Tensor Core GPU datasheet, "BF16 Tensor Core" row, whose
# figures are with sparsity: half of them is the dense peak (H100 SXM
# 1,979 -> 989 TFLOP/s; H100 PCIe 1,513 -> 756 TFLOP/s). The SXM part
# names itself "NVIDIA H100 80GB HBM3".
DEVICE_PEAK_FLOPS = {
    "h100 80gb hbm3": 989e12,
    "h100 pcie": 756e12,
}


def device_peak_flops(device_kind: Optional[str] = None) -> float:
    """Peak dense bf16 FLOP/s of one card, whatever the run's dtype; 0.0
    when unknown (the CPU, a card not in the table), so that MFU is
    None rather than a ratio against a made-up peak. `device_kind`
    None: the name of CUDA device 0 when there is one, else "cpu"."""
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    kind = device_kind.lower()
    for sub in sorted(DEVICE_PEAK_FLOPS, key=len, reverse=True):
        if sub in kind:
            return DEVICE_PEAK_FLOPS[sub]
    return 0.0


def mfu_from(flops_per_step: Optional[float], step_time_s: float,
             peak_flops: float) -> Optional[float]:
    """Model FLOP utilization for one step; None when either side of the
    ratio is unknown (no analytic estimate, or no known peak)."""
    if not flops_per_step or step_time_s <= 0 or peak_flops <= 0:
        return None
    return flops_per_step / step_time_s / peak_flops
