"""Continuous-batching serve loop: static slots, paged KV, adapter routing,
the shared-prefix cache, chunked prefill and per-slot sampling (port of
mobilefinetuner_tpu/serve/engine.py, GPT-2 and Gemma-3).

The scheduler's unit of work is one DECODE STEP over `num_slots` static
slots. Requests are admitted into free slots and evicted the step they
finish; every tensor the step sees keeps its shape:

    tok [S]      the token each slot feeds this step
    pos [S]      its cache position (tokens already cached)
    tbl [S, M]   per-slot block tables into the shared page pool
    aid [S]      per-slot adapter index into the resident bank
    temp/topk/topp/seed [S]   per-slot sampling state (cfg.sampling)

Idle slots are DATA, not branches: pos=0, tbl=trash, temperature 0,
outputs ignored. Greedy decode (temperature 0) is the oracle: per-request
tokens equal the JAX engine's on the same weights (tests/test_torch_serve
*.py, f32 on the CPU), with or without the prefix cache and chunking.

Admission takes one of three paths (`_admit`):
  * one-shot prefill: a full cache miss within max_prompt (the flash
    forward kernel on the card);
  * full hit: every prompt block is cached, so no prefill at all; the
    last prompt token is fed again through the decode step, whose write
    lands in a copy of the last shared page (copy-on-write);
  * chunked: a partial hit or a prompt beyond max_prompt (up to
    max_prompt_chunked) prefills its uncached suffix in static bucket
    widths, chunks of all requests spending at most one widest bucket of
    prompt tokens a step(), between decode steps.
With `prefix_cache`, every full prompt block is chain-hashed
(serve/prefix_cache.py) with the KV-producing weights' identity (base,
or adapter name and reload generation), and pages whose last reference
drops while the cache maps them PARK instead of freeing.

Sampling is data too: temperature / top-k / top-p and the request's seed
ride the slot arrays, and the draw is keyed on (seed, the emitted token's
absolute position) (models/generate.sample_per_row), so cache on or off
and chunked or one-shot admission give the same stream for a seed. One
decode step serves mixed greedy and sampled slots.

Scheduling is FCFS with conservative page reservation: a request is
admitted only when its worst case (prompt + max_new_tokens pages) fits
what the pool has left after every resident's worst case; pages are
handed out lazily, so `append` can never fail mid-flight. Every terminal
transition goes through `_terminal`, so a request is counted once and
releases exactly its pages, whatever path ends it (finish, cancel,
deadline, contained step error).

Host syncs, as in the JAX engine: the first token after a prefill or a
final chunk, and the step's `nxt.cpu()`. The pools are updated in place
(the JAX engine donated them to functional updates instead).

The engine runs the JAX engine's five programs, each built once for each
static signature and replayed, as the JAX engine's compiled programs are:

    program          signature        static inputs -> outputs
    decode step      -                tok, pos, tbl [S, M], aid and the
                                      sampling state [S] -> nxt [S]
    one-shot prefill max_prompt       ids, mask [1, max_prompt], aid and
                                      the sampling state [1] -> tok0 [1],
                                      the prompt's K/V [L, KV, max_prompt, D]
    prompt-page write max_prompt      the prefill's K/V, block_ids
                                      [max_prompt // block_T] -> the pools
    prefill chunk    each bucket W    ids [1, W], start, n_tok (device
                                      scalars), tbl [1, M], aid [W] and the
                                      sampling state [1] -> tok [1], the pools
    page copy        -                src, dst [1] -> the pools

Each program reads only static device buffers allocated when the engine
is built and writes only such buffers and the pools. Before each call its
host inputs go into those buffers through pinned staging, one
non-blocking `copy_` a dtype group (`_Staged`), after the adapter ids are
validated on the host. Each program's routed adapter tree is built once
over its `aid` buffer and reads the bank's leaves where they are. The
first token's choice (the argmax, or sample_per_row keyed on its absolute
position: the prefill's from its mask, a chunk's start + n_tok, a decode
step's pos + 1) runs inside the program. On the card each program is a
CUDA graph (kernels/graphs.StepGraph): its first call runs it eagerly
(every kernel built and loaded), the second captures and replays it,
every later one replays it. On the CPU the same bodies run eagerly. A
hot-swap writes the bank in place and containment zeroes the pools in
place, so neither costs a capture; reassigning the pools, the params or
the bank's tree drops every graph (`_refresh`), and each program captures
again at its next call. A capture or replay that fails raises into the
caller's containment; nothing falls back to eager dispatch (the private
`_eager` constructor argument keeps every program eager on the card, for
comparisons only).

`trace_counts`, as the JAX engine's (keys prefill, decode_step,
write_prefill, prefill_chunk, cow_copy): the programs built, one for each
static signature (shapes, dtypes and static arguments). On the card each
key counts its program's graph captures, so after exactly one call of a
signature the key reads 0 where the JAX engine's reads 1, and from the
second call on they agree; elsewhere (and with `_eager`) each key counts
a signature the first time it is seen (the one-shot prefill is padded to
max_prompt and the chunks come in the static bucket widths, so the counts
are finite, as in JAX). `total_traces()` adds the bank's `trace_count`.

Precision: the engine sets `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False when it is built, so an f32
engine computes in full f32 on the card (TF32 would keep ~3 digits).

Telemetry, as in the JAX engine: with a `telemetry` stream the engine
writes run_start and its build-time mem_check, one `request` event per
lifecycle phase (enqueue, admit, first_token, and exactly one terminal
phase: finish, cancel, reject, timeout or error), `ckpt_verify` for an
adapter file it loads, `preempt`, a `serve_stats` snapshot every
`stats_every` decode steps and `run_end` at close(). `trace_spans` adds
the queue, prefill (one per one-shot prefill or chunk) and decode spans
of each request on its own `req:<id>` track. Every timestamp is taken
after the host has the token it stands for (the first token's sync, the
step's `.cpu()`), never at a launch. A `watchdog` (core/telemetry
.HangWatchdog, its lifecycle the caller's) is petted after every decode
step. `install_preemption()` arms the drain: the first SIGTERM / SIGINT,
seen at the next step boundary, stops admissions, rejects the queue
with reason "shutdown" and lets the in-flight requests finish; close()
then records run_end{exit=preempted}; a second signal raises
KeyboardInterrupt. `health()` is read from the metrics endpoint's
threads (/healthz answers 503 while draining).

`lora_impl` is validated and recorded: the multi-adapter path takes the
per-row gather under every value (models/lora_apply.py), and run_start
records that per target (`lora_impl_resolved`).

Not ported yet, and refused by name: the (dp, tp) mesh (ROADMAP.md port
item P9).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.core.preempt import PreemptionGuard
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry, run_manifest
from mobilefinetuner_tpu_torch.core.trace import Tracer
from mobilefinetuner_tpu_torch.kernels.graphs import StepGraph
from mobilefinetuner_tpu_torch.lora.lora import (bank_size, check_adapter_ids,
                                                 route_rows, tree_leaves)
from mobilefinetuner_tpu_torch.models.generate import (
    gemma3_decode_step_paged, gemma3_prefill, gemma3_prefill_chunk,
    gpt2_decode_step_paged, gpt2_prefill, gpt2_prefill_chunk,
    sample_per_row)
from mobilefinetuner_tpu_torch.models.lora_apply import (impl_summary,
                                                        validate_lora_impl)
from mobilefinetuner_tpu_torch.ops.attention import validate_attn_impl
from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.serve.paged_kv import (TRASH_BLOCK,
                                                      BlockAllocator,
                                                      OutOfBlocks, blocks_for,
                                                      init_pools,
                                                      write_prompt_blocks)
from mobilefinetuner_tpu_torch.serve.prefix_cache import (PrefixCache,
                                                          chain_keys)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = {"gpt2": (gpt2_prefill, gpt2_decode_step_paged,
                     gpt2_prefill_chunk),
            "gemma": (gemma3_prefill, gemma3_decode_step_paged,
                      gemma3_prefill_chunk)}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mobilefinetuner_tpu_torch yet "
        f"(ROADMAP.md port item {item}); the JAX engine has it")


@dataclasses.dataclass
class ServeConfig:
    """Engine shape knobs: together they fix the pool's memory footprint
    and every tensor shape the step sees."""
    num_slots: int = 8        # concurrent requests per decode step
    block_T: int = 16         # tokens per KV page
    num_blocks: int = 512     # pool pages incl. the reserved trash page
    max_prompt: int = 64      # one-shot prompts right-padded to this
    max_new_tokens: int = 64  # per-request generation cap
    dtype: str = "float32"    # weights + compute + cache dtype
    attn_impl: str = "auto"   # auto (the kernels) | plain | flash
    lora_impl: str = "auto"   # auto | naive | fused (models/lora_apply)
    max_queue: int = 0        # FCFS queue cap; 0 = unbounded
    shed_policy: str = "reject"   # or "deadline": shed the queued request
                                  # closest to its deadline
    on_step_error: str = "fail_active"  # or "raise" after containing
    hbm_cap_mb: int = 0       # capacity override MB; 0 = the device's
    hbm_headroom: float = 0.1  # admission margin
    prefix_cache: bool = False  # shared-prefix KV reuse
    max_prompt_chunked: int = 0  # the true prompt cap under chunked
                              # admission (a block_T multiple above
                              # max_prompt); 0 = no chunk-only admission
    chunk_buckets: tuple = ()  # static chunk widths (block_T multiples);
                              # () = doubling widths up to max_prompt
    sampling: bool = False    # per-slot temperature / top-k / top-p / seed
    stats_every: int = 0      # serve_stats cadence (decode steps); 0 = off
    trace_spans: bool = False  # queue / prefill / decode `span` events
    # --- the serve mesh, a later port slice (validate refuses)
    mesh_dp: int = 1
    mesh_tp: int = 1

    @property
    def true_cap(self) -> int:
        """The real prompt ceiling: max_prompt one-shot, or
        max_prompt_chunked when chunked admission extends it."""
        return max(self.max_prompt, self.max_prompt_chunked)

    def validate(self) -> None:
        if self.mesh_dp * self.mesh_tp != 1:
            raise _not_ported("the (dp, tp) serve mesh", "P9")
        validate_lora_impl(self.lora_impl)
        validate_attn_impl(self.attn_impl)
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{self.dtype!r}")
        if self.max_prompt % self.block_T:
            raise ValueError(
                f"max_prompt ({self.max_prompt}) must be a multiple of "
                f"block_T ({self.block_T})")
        if self.num_slots < 1 or self.max_new_tokens < 1:
            raise ValueError("num_slots and max_new_tokens must be >= 1")
        if self.max_queue < 0 or self.stats_every < 0:
            raise ValueError("max_queue and stats_every must be >= 0")
        if self.shed_policy not in ("reject", "deadline"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'deadline', got "
                f"{self.shed_policy!r}")
        if self.on_step_error not in ("fail_active", "raise"):
            raise ValueError(
                f"on_step_error must be 'fail_active' or 'raise', got "
                f"{self.on_step_error!r}")
        if self.max_prompt_chunked:
            if self.max_prompt_chunked % self.block_T:
                raise ValueError(
                    f"max_prompt_chunked ({self.max_prompt_chunked}) "
                    f"must be a multiple of block_T ({self.block_T})")
            if self.max_prompt_chunked <= self.max_prompt:
                raise ValueError(
                    f"max_prompt_chunked ({self.max_prompt_chunked}) "
                    f"must exceed max_prompt ({self.max_prompt}): prompts "
                    f"within max_prompt prefill one-shot")
        for w in self.chunk_buckets:
            if w < 1 or w % self.block_T:
                raise ValueError(
                    f"chunk_buckets entries must be positive block_T "
                    f"({self.block_T}) multiples, got {w}")
        # the pool must hold at least one worst-case request, or FCFS
        # admission can never fire and drain() spins forever
        worst = blocks_for(self.true_cap + self.max_new_tokens - 1,
                           self.block_T)
        if self.num_blocks - 1 < worst:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold one "
                f"worst-case request: true prompt cap ({self.true_cap}) + "
                f"max_new_tokens - 1 columns need {worst} pages plus the "
                f"reserved trash page (have {self.num_blocks - 1} "
                f"allocatable)")


@dataclasses.dataclass
class Request:
    """One generation request and its timeline."""
    id: int
    prompt: List[int]
    max_new_tokens: int
    adapter: Optional[str] = None      # resident bank name; None = base
    # queued -> active -> one of TERMINAL
    state: str = "queued"
    reason: Optional[str] = None
    rid: Optional[int] = None          # a router's fleet-wide request id;
                                       # rides every request event and span
    tokens: List[int] = dataclasses.field(default_factory=list)
    enqueue_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    deadline_t: float = 0.0            # absolute perf_counter; 0 = none
    # sampling (a sampling engine only): temperature 0 = the greedy oracle
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # engine-internal
    slot: int = -1
    aid: int = 0
    blocks: List[int] = dataclasses.field(default_factory=list)
    worst_blocks: int = 0
    # chunked admission and prefix hits
    prefill_pos: int = 0               # prompt tokens already cached
    prefilling: bool = False           # suffix chunks still pending
    awaiting_first: bool = False       # full hit: the next decode step
                                       # emits token 1
    cache_keys: List[bytes] = dataclasses.field(default_factory=list,
                                                repr=False)

    TERMINAL = ("finished", "cancelled", "rejected", "timeout", "error")
    # the terminal `request` phase each terminal state emits
    PHASE = {"finished": "finish", "cancelled": "cancel",
             "rejected": "reject", "timeout": "timeout", "error": "error"}

    @property
    def done(self) -> bool:
        return self.state in self.TERMINAL

    @property
    def ttft_ms(self) -> Optional[float]:
        if not self.first_token_t:
            return None
        return (self.first_token_t - self.enqueue_t) * 1000.0

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean per-token latency after the first token."""
        if not self.finish_t or len(self.tokens) < 2:
            return None
        return ((self.finish_t - self.first_token_t)
                / (len(self.tokens) - 1) * 1000.0)


class _Staged:
    """A program's static device inputs by name, from `spec` {name:
    (shape, dtype)}: each dtype group is one device tensor whose views are
    the inputs, beside one host staging tensor (pinned on the card).
    `stage(**arrays)` writes host arrays into the staging and copies each
    group with one non-blocking `copy_`; it first waits for the last
    stage's copies, which read the same staging."""

    def __init__(self, device: torch.device, spec: dict):
        pin = device.type == "cuda"
        sizes: dict = {}
        where = {}
        for name, (shape, dtype) in spec.items():
            n = int(np.prod(shape, dtype=np.int64))
            where[name] = (dtype, sizes.get(dtype, 0), n, shape)
            sizes[dtype] = sizes.get(dtype, 0) + n
        self._pairs = {dt: (torch.zeros(n, dtype=dt, pin_memory=pin),
                            torch.zeros(n, dtype=dt, device=device))
                       for dt, n in sizes.items()}
        self.buf = {}
        self._host = {}
        for name, (dt, o, n, shape) in where.items():
            host, dev = self._pairs[dt]
            self.buf[name] = dev[o:o + n].view(shape)
            self._host[name] = host[o:o + n].numpy().reshape(shape)
        self._copied = torch.cuda.Event() if pin else None

    def stage(self, **arrays) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in arrays.items():
            self._host[name][...] = a
        for host, dev in self._pairs.values():
            dev.copy_(host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


def _seed64(seed: int) -> int:
    """A request seed as the int64 with its low 64 bits."""
    seed &= (1 << 64) - 1
    return seed - (1 << 64) if seed >> 63 else seed


class ServeEngine:
    """The serving loop: submit() + step() (or drain()).

    family: "gpt2" | "gemma"; params: the base tree (models/gpt2.py or
    models/gemma3.py layout), cast to cfg.dtype on `device`; bank:
    optional AdapterBank for per-slot adapter routing. telemetry:
    optional core.telemetry.Telemetry (module docstring); watchdog:
    optional HangWatchdog, petted after each decode step. `device=None`
    is the CUDA card (core/device.py). The engine is single-threaded:
    every mutation comes from the serve loop; health() is also read by
    the metrics endpoint's threads (its step-time window under
    `_health_lock`, the rest scalar snapshots). `_eager` (private: tests
    and chip_smoke.py compare against it) runs every program eagerly on
    the card instead of replaying its graph.
    """

    def __init__(self, family: str, config, params,
                 cfg: Optional[ServeConfig] = None,
                 bank: Optional[AdapterBank] = None, telemetry=None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 watchdog=None, device=None, _eager: bool = False):
        cfg = cfg or ServeConfig()
        cfg.validate()
        if family == "gpt2":
            L, KV, D = config.n_layer, config.n_head, config.head_dim
            if cfg.true_cap + cfg.max_new_tokens > config.n_positions:
                raise ValueError(
                    f"prompt cap + max_new_tokens = "
                    f"{cfg.true_cap + cfg.max_new_tokens} exceeds "
                    f"n_positions={config.n_positions}")
        elif family == "gemma":
            L = config.num_hidden_layers
            KV, D = config.num_key_value_heads, config.head_dim
        else:
            raise ValueError(f"unknown family {family!r}")
        self._prefill_fn, self._step_fn, self._chunk_fn = FAMILIES[family]
        self.device = resolve_device(device)
        # full-f32 matmuls and convolutions on the card (module docstring)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.family, self.config, self.cfg = family, config, cfg
        self.bank = bank
        self.eos_id, self.pad_id = eos_id, pad_id
        self.dtype = DTYPES[cfg.dtype]
        S = cfg.num_slots
        # block tables cover the true cap
        self.M = blocks_for(cfg.true_cap + cfg.max_new_tokens - 1,
                            cfg.block_T)

        # ---- memory admission before anything is allocated: params at
        # the engine's dtype + adapter bank + both KV pools
        itemsize = self.dtype.itemsize
        per_block_mb = 2 * L * KV * cfg.block_T * D * itemsize / 2 ** 20
        self.pool_mb = per_block_mb * cfg.num_blocks
        params_mb = sum(x.numel() for _, x in tree_leaves(params)) \
            * itemsize / 2 ** 20
        bank_mb = 0.0 if bank is None else sum(
            x.numel() * x.element_size()
            for _, x in tree_leaves(bank.tree)) / 2 ** 20
        self.mem_check = mg.analytic_check(
            params_mb + bank_mb + self.pool_mb, cap_mb=cfg.hbm_cap_mb,
            headroom=cfg.hbm_headroom, device=self.device)
        if self.mem_check.verdict == "over":
            budget = (self.mem_check.cap_mb * (1 - cfg.hbm_headroom)
                      - params_mb - bank_mb)
            max_blocks = max(int(budget // per_block_mb), 0)
            max_slots = max((max_blocks - 1) // self.M, 0)
            raise mg.MemoryAdmissionError(
                f"serve config refused at build: "
                f"{self.mem_check.describe()} (params {params_mb:.0f} MB "
                f"+ adapter bank {bank_mb:.0f} MB + KV pool "
                f"{self.pool_mb:.0f} MB). Max feasible "
                f"num_blocks={max_blocks} ({per_block_mb:.2f} MB/page), "
                f"which serves at most num_slots={max_slots} worst-case "
                f"requests of {self.M} pages each", check=self.mem_check)

        self.params = _tree_to(params, self.device, self.dtype)
        self.alloc = BlockAllocator(cfg.num_blocks)
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.alloc, cfg.block_T) if cfg.prefix_cache
            else None)
        self.cow_copies = 0
        # adapter reload generations, part of the KV identity of prefix
        # keys: a reloaded tenant's stale pages become unreachable
        self._adapter_gen: collections.Counter = collections.Counter()
        # static chunk widths: the smallest covering the remaining suffix,
        # else the widest, whose tail rides later steps. The default caps
        # at max_prompt (the one-dispatch prefill budget), so a long
        # prompt walks several chunks with decode steps between them
        self.chunk_buckets: tuple = tuple(sorted(set(cfg.chunk_buckets)))
        if not self.chunk_buckets:
            cap = blocks_for(cfg.max_prompt, cfg.block_T) * cfg.block_T
            w, ws = cfg.block_T, []
            while w < cap:
                ws.append(w)
                w *= 2
            ws.append(cap)
            self.chunk_buckets = tuple(sorted(set(ws)))
        self.pool_k, self.pool_v = init_pools(
            cfg.num_blocks, L, KV, cfg.block_T, D, self.dtype, self.device)
        self._tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._tbl = np.full((S, self.M), TRASH_BLOCK, np.int32)
        self._aid = np.zeros(S, np.int64)
        # per-slot sampling state: data, not branches (temperature 0 =
        # the argmax, idle slots and greedy requests alike)
        self._temp = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.ones(S, np.float32)
        self._seed = np.zeros(S, np.int64)
        self._slots: List[Optional[Request]] = [None] * S
        self._init_programs(L, KV, D, graphed=not _eager)
        self.queue: collections.deque = collections.deque()
        self.decode_steps = 0
        self.decode_s = 0.0     # wall time in decode steps, host sync incl.
        self.prefills = 0       # one-shot prefills
        self.chunks = 0         # prefill chunks
        self.full_hits = 0      # admissions with every prompt block cached
        self._next_id = 0
        self._t0 = time.perf_counter()
        self._closed = False
        self.draining = False           # admissions stopped for good
        self.guard: Optional[PreemptionGuard] = None
        self.watchdog = watchdog        # pet()-only: the caller starts and
                                        # stops it
        self._health_lock = threading.Lock()
        # fault-injection seam: called with decode_steps right before every
        # step dispatch, inside the containment try
        self.step_hook: Optional[Callable[[int], None]] = None
        self._step_ms: collections.deque = collections.deque(maxlen=256)
        self.counts: collections.Counter = collections.Counter()
        # True while a pool write (prompt pages, a chunk, a page copy)
        # runs: a failure there leaves the pools suspect, so containment
        # must rebuild them
        self._pools_at_risk = False
        self.telemetry = telemetry or Telemetry("")
        self.tracer = Tracer(self.telemetry.emit, enabled=cfg.trace_spans)
        self.telemetry.emit("run_start", **run_manifest({
            "serve_family": family, "num_slots": S,
            "block_T": cfg.block_T, "num_blocks": cfg.num_blocks,
            "max_prompt": cfg.max_prompt,
            "max_new_tokens": cfg.max_new_tokens, "dtype": cfg.dtype,
            "attn_impl": cfg.attn_impl, "lora_impl": cfg.lora_impl,
            "lora_impl_resolved": self._lora_impl_resolved(),
            "adapter_slots": bank.capacity if bank else 0,
            "max_queue": cfg.max_queue, "shed_policy": cfg.shed_policy,
            "on_step_error": cfg.on_step_error,
            "stats_every": cfg.stats_every,
            "mesh_dp": cfg.mesh_dp, "mesh_tp": cfg.mesh_tp,
            "prefix_cache": cfg.prefix_cache,
            "max_prompt_chunked": cfg.max_prompt_chunked,
            "chunk_buckets": list(self.chunk_buckets),
            "sampling": cfg.sampling}, self.device))
        # the admission verdict that let this engine build (a refusal
        # raised before the stream existed)
        self.telemetry.emit("mem_check", **self.mem_check.event())

    # ------------------------------------------------------------ helpers ---
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def total_traces(self) -> int:
        return sum(self.trace_counts.values()) + (
            self.bank.trace_count if self.bank else 0)

    def _note(self, program: str, *signature) -> None:
        """Count `program` the first time `signature` is seen (an eager
        program's build, as a jit traces once a signature)."""
        key = (program,) + signature
        if key not in self._signatures:
            self._signatures.add(key)
            self.trace_counts[program] += 1

    # ---------------------------------------------------------- programs ---
    def _init_programs(self, L: int, KV: int, D: int, graphed: bool) -> None:
        """Every program's static inputs (`_Staged`) and outputs, and its
        StepGraph: one for each (program, signature) (module
        docstring)."""
        cfg, S, M, dev = self.cfg, self.cfg.num_slots, self.M, self.device
        i64, i32, f32 = torch.int64, torch.int32, torch.float32

        def sampling(n):
            return {"temp": ((n,), f32), "topk": ((n,), i64),
                    "topp": ((n,), f32), "seed": ((n,), i64)}
        P, Wmax = cfg.max_prompt, self.chunk_buckets[-1]
        self._step_in = _Staged(dev, {
            "tok": ((S,), i64), "pos": ((S,), i64), "aid": ((S,), i64),
            "tbl": ((S, M), i32), **sampling(S)})
        # the prompt-page write's block ids ride the prefill's staging
        self._prefill_in = _Staged(dev, {
            "ids": ((1, P), i64), "mask": ((1, P), i64), "aid": ((1,), i64),
            "block_ids": ((P // cfg.block_T,), i32), **sampling(1)})
        # one staging for every bucket: a width-W chunk reads the first W
        # ids and adapter ids; start_n holds (start, n_tok)
        self._chunk_in = _Staged(dev, {
            "ids": ((Wmax,), i64), "aid": ((Wmax,), i64),
            "start_n": ((2,), i64), "tbl": ((1, M), i32), **sampling(1)})
        self._cow_in = _Staged(dev, {"src": ((1,), i64), "dst": ((1,), i64)})
        self._buf = self._step_in.buf
        self._nxt = torch.zeros(S, dtype=i64, device=dev)
        self._tok0 = torch.zeros(1, dtype=i64, device=dev)
        self._chunk_tok = torch.zeros(1, dtype=i64, device=dev)
        self._prompt_k = torch.zeros(L, KV, P, D, dtype=self.dtype,
                                     device=dev)
        self._prompt_v = torch.zeros_like(self._prompt_k)

        # the programs built, by the JAX engine's names (module docstring)
        self.trace_counts: collections.Counter = collections.Counter()
        self._signatures: set = set()

        def graph(body, program):
            return StepGraph(
                body, dev, graphed=graphed,
                on_capture=lambda: self.trace_counts.update([program]))
        self._decode_graph = graph(self._decode_body, "decode_step")
        self._prefill_graph = graph(self._prefill_body, "prefill")
        self._write_graph = graph(self._write_body, "write_prefill")
        self._chunk_graphs = {
            W: graph(functools.partial(self._chunk_body, W), "prefill_chunk")
            for W in self.chunk_buckets}
        self._cow_graph = graph(self._cow_body, "cow_copy")
        self._inputs: tuple = (None,) * 4
        self._routed = self._prefill_routed = None
        self._chunk_routed: dict = {}

    def graphs(self) -> dict:
        """{(program, signature): StepGraph} of every program (module
        docstring); the signature is () for a program with a single
        one."""
        P = self.cfg.max_prompt
        return {("decode_step", ()): self._decode_graph,
                ("prefill", (P,)): self._prefill_graph,
                ("write_prefill", (P,)): self._write_graph,
                **{("prefill_chunk", (W,)): g
                   for W, g in self._chunk_graphs.items()},
                ("cow_copy", ()): self._cow_graph}

    def _refresh(self) -> None:
        """Before any program runs: when the params, the pools or the
        bank's tree were reassigned (or at the first call), what a graph
        captured is stale: route the adapter trees over the static `aid`
        buffers anew and drop every graph, so each program captures again
        at its next call."""
        bank_tree = self.bank.tree if self.bank is not None else None
        inputs = (self.params, self.pool_k, self.pool_v, bank_tree)
        if all(a is b for a, b in zip(inputs, self._inputs)):
            return
        self._inputs = inputs

        def route(ids):
            return None if bank_tree is None else route_rows(bank_tree, ids)
        self._routed = route(self._step_in.buf["aid"])
        self._prefill_routed = route(self._prefill_in.buf["aid"])
        aid = self._chunk_in.buf["aid"]
        self._chunk_routed = {W: route(aid[:W]) for W in self.chunk_buckets}
        for g in self.graphs().values():
            g.reset()

    def _check_aid(self, aid) -> None:
        """Adapter ids validated on the host before a program gathers
        them: out of range, a gather would fault or serve another
        tenant's weights."""
        if self.bank is not None:
            check_adapter_ids(bank_size(self.bank.tree), aid)

    def _run(self, graph: StepGraph, program: str, *signature) -> None:
        """Run or replay one program; an eager one counts its signature
        the first time it is seen (a graphed one counts its captures)."""
        self._refresh()
        if not graph.graphed:
            self._note(program, *signature)
        graph()

    def _pick(self, logits, b: dict, pos_next):
        """The emitted tokens of `logits` [R, V] inside a program: the
        argmax, or on a sampling engine sample_per_row with the program's
        sampling buffers `b`, keyed on the emitted tokens' absolute
        positions `pos_next` [R]."""
        if not self.cfg.sampling:
            return logits.argmax(-1)
        return sample_per_row(logits, b["temp"], b["topk"], b["topp"],
                              b["seed"], pos_next)

    def _decode_body(self) -> None:
        """The decode step over its static buffers: a CUDA graph's body on
        the card, the eager step elsewhere."""
        b = self._buf
        logits, _, _ = self._step_fn(
            self.config, self.params, self.pool_k, self.pool_v, b["tok"],
            b["pos"], b["tbl"], lora=self._routed, compute_dtype=self.dtype,
            attn_impl=self.cfg.attn_impl)
        self._nxt.copy_(self._pick(logits, b, b["pos"] + 1))

    def _prefill_body(self) -> None:
        """The one-shot prefill: the first token at the mask's length and
        the prompt's K/V into their static buffers."""
        b = self._prefill_in.buf
        logits, (k, v) = self._prefill_fn(
            self.config, self.params, b["ids"], b["mask"],
            compute_dtype=self.dtype, lora=self._prefill_routed,
            attn_impl=self.cfg.attn_impl)
        self._prompt_k.copy_(k[:, 0])
        self._prompt_v.copy_(v[:, 0])
        self._tok0.copy_(self._pick(logits, b, b["mask"].sum(-1)))

    def _write_body(self) -> None:
        """The prefill's K/V scattered into its pages (write_prompt_blocks),
        table rows past the prompt into the trash page."""
        write_prompt_blocks(self.pool_k, self.pool_v, self._prompt_k,
                            self._prompt_v,
                            self._prefill_in.buf["block_ids"])

    def _chunk_body(self, W: int) -> None:
        """One width-W prefill chunk; its token at start + n_tok (only the
        final chunk's is read)."""
        b = self._chunk_in.buf
        sn = b["start_n"]
        logits, _, _ = self._chunk_fn(
            self.config, self.params, self.pool_k, self.pool_v,
            b["ids"][:W].view(1, W), sn[0], sn[1], b["tbl"],
            lora=self._chunk_routed[W], compute_dtype=self.dtype)
        self._chunk_tok.copy_(self._pick(logits, b, sn[:1] + sn[1:]))

    def _cow_body(self) -> None:
        """The copy-on-write page copy, pool[dst] = pool[src], by indexed
        copies at device indices."""
        b = self._cow_in.buf
        for pool in (self.pool_k, self.pool_v):
            pool.index_copy_(0, b["dst"], pool.index_select(0, b["src"]))

    def _decode(self) -> np.ndarray:
        """One decode step over every slot: validate the routing, stage
        the slot arrays, run or replay the step, read `nxt` back (the
        serve loop's one host sync a step)."""
        self._check_aid(self._aid)
        self._step_in.stage(tok=self._tok, pos=self._pos, aid=self._aid,
                            tbl=self._tbl, temp=self._temp, topk=self._topk,
                            topp=self._topp, seed=self._seed)
        self._run(self._decode_graph, "decode_step")
        return self._nxt.cpu().numpy()

    def _slot_sampling(self, slot: int) -> dict:
        """Slot `slot`'s sampling state, for a [1]-row program's staging."""
        return {"temp": self._temp[slot], "topk": self._topk[slot],
                "topp": self._topp[slot], "seed": self._seed[slot]}

    def _lora_impl_resolved(self) -> Optional[str]:
        """The adapters' order per target (models/lora_apply.py), or None
        without a bank."""
        if self.bank is None:
            return None
        return impl_summary(self.bank.tree["blocks"], self.cfg.lora_impl,
                            self.device, routed=True)

    @property
    def active(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def _committed_blocks(self) -> int:
        """Pages the residents may still demand (their reservations)."""
        return sum(r.worst_blocks - len(r.blocks) for r in self.active)

    def _emit_request(self, req: Request, phase: str) -> None:
        self.telemetry.emit(
            "request", id=req.id, phase=phase,
            prompt_tokens=len(req.prompt),
            adapter=req.aid if req.adapter is not None else None,
            queue_ms=((req.admit_t - req.enqueue_t) * 1000.0
                      if req.admit_t else None),
            new_tokens=len(req.tokens) or None,
            ttft_ms=req.ttft_ms, tpot_ms=req.tpot_ms, reason=req.reason,
            rid=req.rid)

    def _req_span(self, name: str, req: Request, t0: float,
                  dur_ms: float, **extra) -> None:
        """One span on the request's own `req:<id>` track (a router's
        `rid` rides along)."""
        if req.rid is not None:
            extra.setdefault("rid", req.rid)
        self.tracer.emit_span(name, f"req:{req.id}", t0, dur_ms,
                              id=req.id, **extra)

    def _terminal(self, req: Request, state: str,
                  reason: Optional[str] = None) -> None:
        """THE terminal transition: every path out of the lifecycle ends
        here, once, with exactly one terminal `request` phase. The caller
        releases slot and pages first."""
        if state not in Request.TERMINAL:
            raise ValueError(f"not a terminal state: {state!r}")
        if req.done:
            raise RuntimeError(f"request {req.id} already {req.state}")
        req.state = state
        req.reason = reason
        req.finish_t = time.perf_counter()
        self.counts[state] += 1
        self._emit_request(req, phase=Request.PHASE[state])
        if self.tracer.enabled:
            # the request's last span: decode for an admitted request
            # (admit -> terminal), queue for one that died waiting
            if req.admit_t:
                self._req_span("decode", req, req.admit_t,
                               (req.finish_t - req.admit_t) * 1000.0,
                               outcome=state)
            else:
                self._req_span("queue", req, req.enqueue_t,
                               (req.finish_t - req.enqueue_t) * 1000.0,
                               outcome=state)

    # ------------------------------------------------------------ tenancy ---
    def load_adapter(self, name: str, source, verify: bool = True) -> int:
        """Hot-swap `source` into the resident bank under `name`: an
        adapter tree (lora/lora.py layout), or a path that
        AdapterBank.load_file reads (a native adapter file, verified
        against its checksum manifest, or an HF-PEFT directory).
        Replacing a resident that queued or active requests route to is
        refused. The name's generation is bumped, so prefix pages cached
        under its old weights are never served again. A file's
        verification verdict is a `ckpt_verify` event (a corrupt file
        raises CheckpointIntegrityError after its ok=false event)."""
        if self.bank is None:
            raise RuntimeError("engine was built without an adapter bank")
        if name in self.bank.resident and self._adapter_in_use(name):
            raise RuntimeError(
                f"adapter {name!r} is routed by in-flight requests; "
                f"drain them before replacing it")
        if isinstance(source, dict):
            slot = self.bank.load(name, source)
        else:
            from mobilefinetuner_tpu_torch.io.safetensors_io import \
                CheckpointIntegrityError
            try:
                slot = self.bank.load_file(name, source, verify=verify)
            except CheckpointIntegrityError as e:
                self.telemetry.emit("ckpt_verify", path=str(source),
                                    ok=False, reason=str(e), step=None,
                                    action="reject")
                raise
            if verify:
                self.telemetry.emit("ckpt_verify", path=str(source),
                                    ok=True, reason=None, step=None,
                                    action="load")
        self._adapter_gen[name] += 1
        return slot

    def evict_adapter(self, name: str) -> int:
        if self.bank is None:
            raise RuntimeError("engine was built without an adapter bank")
        if self._adapter_in_use(name):
            raise RuntimeError(
                f"adapter {name!r} is routed by in-flight requests")
        slot = self.bank.evict(name)
        self._adapter_gen[name] += 1
        return slot

    def _kv_identity(self, req: Request) -> str:
        """The KV-producing weights hashed into prefix keys: the base, or
        adapter name and reload generation."""
        if req.adapter is None:
            return "base"
        return f"{req.adapter}:{self._adapter_gen[req.adapter]}"

    def _adapter_in_use(self, name: str) -> bool:
        # queued requests count: submit() resolved their slot already
        return any(r.adapter == name
                   for r in list(self.queue) + self.active)

    # ------------------------------------------------------------ intake ----
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 0,
               adapter: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0,
               rid: Optional[int] = None) -> Request:
        """Enqueue one request (admission happens inside step()).
        temperature / top_k / top_p / seed need a sampling engine;
        temperature 0 is the greedy oracle and a seed is deterministic. A
        prompt beyond the true cap, a full bounded queue or a drain in
        progress gives a request that is already terminal
        (state="rejected"): check `.state`. `rid` is a router's request
        id, carried by the request's events."""
        if self._closed:
            raise RuntimeError("submit() on a closed ServeEngine")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if (temperature or top_k or top_p != 1.0 or seed) \
                and not self.cfg.sampling:
            raise ValueError(
                "sampling parameters need a sampling-enabled engine "
                "(ServeConfig.sampling=True)")
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        n_new = max_new_tokens or self.cfg.max_new_tokens
        if not 0 < n_new <= self.cfg.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {n_new} outside (0, "
                f"{self.cfg.max_new_tokens}]")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        aid = 0
        if adapter is not None:
            if self.bank is None:
                raise RuntimeError(
                    "request names an adapter but the engine has no bank")
            aid = self.bank.slot(adapter)   # KeyError if not resident
        req = Request(id=self._next_id, prompt=prompt, max_new_tokens=n_new,
                      adapter=adapter, aid=aid,
                      rid=int(rid) if rid is not None else None,
                      enqueue_t=time.perf_counter(),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), seed=int(seed))
        if deadline_ms is not None:
            req.deadline_t = req.enqueue_t + deadline_ms / 1000.0
        self._next_id += 1
        self._emit_request(req, phase="enqueue")
        if len(prompt) > self.cfg.true_cap:
            self._terminal(req, "rejected", reason="prompt_too_long")
            return req
        if self.draining:   # a drain in progress: admissions are closed
            self._terminal(req, "rejected", reason="shutdown")
            return req
        if self.cfg.max_queue and len(self.queue) >= self.cfg.max_queue:
            victim = None
            if self.cfg.shed_policy == "deadline":
                dl = [r for r in self.queue if r.deadline_t]
                if dl:
                    victim = min(dl, key=lambda r: r.deadline_t)
            if victim is None:
                self._terminal(req, "rejected", reason="queue_full")
                return req
            self.queue.remove(victim)
            self._terminal(victim, "rejected", reason="shed")
        self.queue.append(req)
        return req

    def cancel(self, req: Request) -> None:
        """Evict a queued or active request (frees its slot + pages)."""
        if req.state == "queued":
            self.queue.remove(req)
        elif req.state == "active":
            self._release(req)
        else:
            return
        self._terminal(req, "cancelled")

    # ------------------------------------------------------------ the loop --
    def _admit(self, req: Request, slot: int) -> None:
        """Slot grant + path dispatch: one-shot prefill (a full miss
        within max_prompt), full-hit re-feed (every prompt block cached),
        or chunked suffix prefill (a partial hit, or a long prompt)."""
        cfg, P = self.cfg, len(req.prompt)
        req.worst_blocks = blocks_for(P + req.max_new_tokens - 1,
                                      cfg.block_T)
        req.slot, req.state = slot, "active"
        if self.bank is None:
            req.aid = 0
        elif req.adapter is not None:
            req.aid = self.bank.slot(req.adapter)
        else:
            req.aid = self.bank.base_slot  # zero slot: serve the base
        self._slots[slot] = req
        self._aid[slot] = req.aid
        if cfg.sampling:
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._seed[slot] = _seed64(req.seed)
        cached: List[int] = []
        if self.prefix is not None:
            req.cache_keys = chain_keys(req.prompt, cfg.block_T,
                                        self._kv_identity(req))
            cached = self.prefix.lookup(req.cache_keys)
            self.prefix.note_lookup(len(cached) * cfg.block_T, P)
        C = len(cached) * cfg.block_T    # cached prefix, tokens
        if C == P:                       # full hit (P a block multiple)
            self._admit_full_hit(req, cached)
        elif C == 0 and P <= cfg.max_prompt:
            self._admit_prefill(req)
        else:                            # suffix hit, or a long prompt
            self._admit_chunked(req, cached, C)

    def _first_token(self, req: Request, tok0: int,
                     now: Optional[float] = None) -> None:
        """A prefill's or final chunk's first token, on the host: the
        slot starts decoding at position P, and every full prompt block it
        computed becomes shareable (first writer wins; decode never
        rewrites prompt columns)."""
        slot, P = req.slot, len(req.prompt)
        req.first_token_t = now or time.perf_counter()
        req.tokens.append(tok0)
        self._tok[slot], self._pos[slot] = tok0, P
        self._tbl[slot] = TRASH_BLOCK
        self._tbl[slot, :len(req.blocks)] = req.blocks
        if self.prefix is not None:
            for key, b in zip(req.cache_keys, req.blocks):
                self.prefix.register(key, b)
        self._emit_request(req, phase="first_token")
        if (self.eos_id is not None and tok0 == self.eos_id) \
                or req.max_new_tokens == 1:
            self._finish(req)

    def _admit_prefill(self, req: Request) -> None:
        """The one-shot prefill + prompt-page scatter."""
        cfg, slot, P = self.cfg, req.slot, len(req.prompt)
        req.blocks = self.alloc.alloc(blocks_for(P, cfg.block_T))
        ids = np.full((1, cfg.max_prompt), self.pad_id, np.int64)
        mask = np.zeros((1, cfg.max_prompt), np.int64)
        ids[0, :P], mask[0, :P] = req.prompt, 1
        # the prompt pages; table rows past the prompt stay trash
        block_ids = np.full(cfg.max_prompt // cfg.block_T, TRASH_BLOCK,
                            np.int32)
        block_ids[:len(req.blocks)] = req.blocks
        self._check_aid([req.aid])
        t_prefill = time.perf_counter()
        self._prefill_in.stage(ids=ids, mask=mask, aid=req.aid,
                               block_ids=block_ids,
                               **self._slot_sampling(slot))
        self._run(self._prefill_graph, "prefill", cfg.max_prompt)
        self.prefills += 1
        self._pools_at_risk = True
        self._run(self._write_graph, "write_prefill", cfg.max_prompt)
        self._pools_at_risk = False
        tok0 = int(self._tok0.item())    # host sync: the first token
        now = req.admit_t = time.perf_counter()
        if self.tracer.enabled:
            # the queue span closes where the prefill begins; the prefill
            # span runs through the first token's host sync
            self._req_span("queue", req, req.enqueue_t,
                           (t_prefill - req.enqueue_t) * 1000.0)
            self._req_span("prefill", req, t_prefill,
                           (now - t_prefill) * 1000.0)
        self._emit_request(req, phase="admit")
        self._first_token(req, tok0, now)

    def _admit_full_hit(self, req: Request, cached: List[int]) -> None:
        """Every prompt block is cached: no prefill. The last prompt token
        is fed again through the decode step (pos = P - 1), which emits
        the first token; that step writes column P - 1, in the last shared
        page, so the page is copied first (copy-on-write)."""
        slot, P = req.slot, len(req.prompt)
        # acquire every cached page before alloc() could evict one
        for b in cached:
            self.alloc.acquire(b)
        dst = self.alloc.alloc(1)[0]
        src = cached[-1]
        # drop our reference on the source first: req.blocks then lists
        # exactly the pages to release if the copy fails (parking keeps
        # the contents, and nothing allocates before the copy reads them)
        self.alloc.free([src], park=self.prefix.park)
        req.blocks = cached[:-1] + [dst]
        self._pools_at_risk = True
        self._cow_in.stage(src=src, dst=dst)
        self._run(self._cow_graph, "cow_copy")
        self._pools_at_risk = False
        self.cow_copies += 1
        self.full_hits += 1
        req.admit_t = time.perf_counter()
        req.awaiting_first = True
        self._tok[slot] = req.prompt[-1]
        self._pos[slot] = P - 1
        self._tbl[slot] = TRASH_BLOCK
        self._tbl[slot, :len(req.blocks)] = req.blocks
        if self.tracer.enabled:
            # no prefill span: the whole prompt came from cached pages
            self._req_span("queue", req, req.enqueue_t,
                           (req.admit_t - req.enqueue_t) * 1000.0)
        self._emit_request(req, phase="admit")

    def _admit_chunked(self, req: Request, cached: List[int],
                       C: int) -> None:
        """Chunked admission: the uncached suffix prefills in bucket-width
        chunks (_prefill_chunk), interleaved with decode. The slot holds
        idle data (pos=0, tbl=trash) until the final chunk lands the first
        token."""
        slot, P = req.slot, len(req.prompt)
        for b in cached:
            self.alloc.acquire(b)        # pin before alloc() can evict
        req.blocks = list(cached) + self.alloc.alloc(
            blocks_for(P, self.cfg.block_T) - len(cached))
        req.prefill_pos = C
        req.prefilling = True
        req.admit_t = time.perf_counter()
        self._tok[slot] = self._pos[slot] = 0
        self._tbl[slot] = TRASH_BLOCK
        if self.tracer.enabled:
            self._req_span("queue", req, req.enqueue_t,
                           (req.admit_t - req.enqueue_t) * 1000.0)
        self._emit_request(req, phase="admit")

    def _bucket(self, req: Request) -> int:
        """The chunk width for `req`'s remaining suffix."""
        remaining = len(req.prompt) - req.prefill_pos
        return next((w for w in self.chunk_buckets if w >= remaining),
                    self.chunk_buckets[-1])

    def _prefill_chunk(self, req: Request) -> None:
        """ONE chunk of `req`'s pending suffix; the final chunk's last row
        gives the request's first token."""
        slot, P = req.slot, len(req.prompt)
        start = req.prefill_pos
        W = self._bucket(req)
        n_tok = min(P - start, W)
        # the staging holds the widest bucket; a width-W chunk reads the
        # first W ids, and one request's rows all route its adapter
        ids = np.full(self.chunk_buckets[-1], self.pad_id, np.int64)
        ids[:n_tok] = req.prompt[start:start + n_tok]
        tbl = np.full((1, self.M), TRASH_BLOCK, np.int32)
        tbl[0, :len(req.blocks)] = req.blocks
        self._check_aid([req.aid])
        t_chunk = time.perf_counter()
        self._chunk_in.stage(ids=ids, aid=req.aid, start_n=(start, n_tok),
                             tbl=tbl, **self._slot_sampling(slot))
        self._pools_at_risk = True
        self._run(self._chunk_graphs[W], "prefill_chunk", W)
        self._pools_at_risk = False
        self.chunks += 1
        req.prefill_pos += n_tok
        if self.tracer.enabled:
            self._req_span("prefill", req, t_chunk,
                           (time.perf_counter() - t_chunk) * 1000.0)
        if req.prefill_pos < P:
            return
        req.prefilling = False
        # host sync: the first token
        self._first_token(req, int(self._chunk_tok.item()))

    def _release(self, req: Request) -> None:
        park = self.prefix.park if self.prefix is not None else None
        self.alloc.free(req.blocks, park=park)
        req.blocks = []
        req.prefilling = req.awaiting_first = False
        s = req.slot
        if s < 0:   # admission died before the slot was taken
            return
        self._slots[s] = None
        self._tok[s] = self._pos[s] = self._aid[s] = 0
        self._tbl[s] = TRASH_BLOCK
        self._temp[s], self._topk[s], self._topp[s] = 0.0, 0, 1.0
        self._seed[s] = 0

    def _finish(self, req: Request) -> None:
        self._release(req)
        self._terminal(req, "finished")

    def _expire(self, now: float) -> List[Request]:
        """Time out every request past its deadline: queued ones without
        ever prefilling, active ones at this step boundary with their
        partial output kept."""
        out: List[Request] = []
        for req in [r for r in self.queue
                    if r.deadline_t and now >= r.deadline_t]:
            self.queue.remove(req)
            self._terminal(req, "timeout", reason="deadline")
            out.append(req)
        for req in [r for r in self.active
                    if r.deadline_t and now >= r.deadline_t]:
            self._release(req)
            self._terminal(req, "timeout", reason="deadline")
            out.append(req)
        return out

    def _contain_step_error(self, e: BaseException) -> List[Request]:
        """A step exception reached the scheduler: fail each active request
        (state=error, reason=<exception type>), release exactly its pages,
        and zero the pools so the next admission starts clean; the prefix
        cache forgets every page, since the contents are gone. The queue
        is untouched. The pools are zeroed in place, so every program's
        graph stays valid: containment costs no capture (as the JAX
        engine's costs no retrace)."""
        name = type(e).__name__
        failed: List[Request] = []
        for req in self.active:
            self._release(req)
            self._terminal(req, "error", reason=name)
            failed.append(req)
        self.pool_k.zero_()
        self.pool_v.zero_()
        if self.prefix is not None:
            self.prefix.flush()
        self._pools_at_risk = False
        return failed

    def _admit_queue(self, done: List[Request]) -> None:
        """FCFS admission under the worst-case page reservation."""
        cfg = self.cfg
        while self.queue and not self.draining:
            free = [i for i, r in enumerate(self._slots) if r is None]
            if not free:
                break
            req = self.queue[0]
            worst = blocks_for(len(req.prompt) + req.max_new_tokens - 1,
                               cfg.block_T)
            if self.alloc.free_blocks - self._committed_blocks() < worst:
                break
            self.queue.popleft()
            try:
                self._admit(req, free[0])
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # a failed prefill kills ONE request, not the engine
                self._release(req)
                self._terminal(req, "error", reason=type(e).__name__)
                done.append(req)
                if self._pools_at_risk:
                    done.extend(self._contain_step_error(e))
                if cfg.on_step_error == "raise":
                    raise
                continue
            if req.state == "finished":  # eos/cap hit on the first token
                done.append(req)

    def _run_chunks(self, done: List[Request]) -> bool:
        """Prefill chunks, oldest request first, until this step's budget
        of one widest bucket of prompt tokens is spent (several short
        suffixes share a step). False when a chunk failed and containment
        ended the step."""
        budget = self.chunk_buckets[-1]
        while budget > 0:
            chunking = [r for r in self.active if r.prefilling]
            if not chunking:
                break
            req = min(chunking, key=lambda r: r.id)
            W = self._bucket(req)
            if W > budget:
                break                    # the next chunk outlives the budget
            try:
                self._prefill_chunk(req)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # the chunk writes the pools: every resident is suspect
                done.extend(self._contain_step_error(e))
                if self.cfg.on_step_error == "raise":
                    raise
                return False
            budget -= W
            if req.done:                 # eos/cap on the final chunk
                done.append(req)
        return True

    def step(self) -> List[Request]:
        """One scheduler iteration: observe a preemption signal, expire
        deadlines, admit what fits (unless draining), run this step's
        prefill chunks, then one decode step for every slot past its
        prefill. Returns every request that reached a terminal state on
        this iteration."""
        cfg = self.cfg
        done: List[Request] = []
        # a signal is observed at the step boundary, never inside a
        # launch: stop admissions, reject the queue, finish the in-flight
        if self.guard is not None and self.guard.triggered \
                and not self.draining:
            self.telemetry.emit("preempt", step=self.decode_steps,
                                signal=self.guard.signal_name or "SIGTERM")
            done.extend(self.begin_shutdown())
        done.extend(self._expire(time.perf_counter()))
        self._admit_queue(done)
        if not self._run_chunks(done):
            return done
        # mid-prefill requests hold idle slot data: the step runs over
        # every slot, but only rows past their prefill advance
        live = [r for r in self.active if not r.prefilling]
        if not live:
            return done
        # a slot crossing a page boundary this step takes its next page
        # (guaranteed by the admission reservation)
        for req in live:
            j = int(self._pos[req.slot]) // cfg.block_T
            if j == len(req.blocks):
                try:
                    req.blocks.append(self.alloc.append())
                except OutOfBlocks as e:  # pragma: no cover — invariant
                    raise OutOfBlocks(
                        f"reservation accounting failed for request "
                        f"{req.id}: {e}") from e
                self._tbl[req.slot, j] = req.blocks[-1]

        t_step = time.perf_counter()
        try:
            if self.step_hook is not None:
                self.step_hook(self.decode_steps)
            nxt = self._decode()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            done.extend(self._contain_step_error(e))
            if cfg.on_step_error == "raise":
                raise
            return done
        self.decode_steps += 1
        step_s = time.perf_counter() - t_step
        self.decode_s += step_s
        with self._health_lock:
            self._step_ms.append(step_s * 1000.0)
        if self.watchdog is not None:
            self.watchdog.pet(self.decode_steps, step_s)
        for req in live:
            s = req.slot
            self._pos[s] += 1
            self._tok[s] = int(nxt[s])
            req.tokens.append(int(nxt[s]))
            if req.awaiting_first:
                # full-hit re-feed: this step emitted the first token
                req.awaiting_first = False
                req.first_token_t = time.perf_counter()
                self._emit_request(req, phase="first_token")
            if (self.eos_id is not None and req.tokens[-1] == self.eos_id) \
                    or len(req.tokens) >= req.max_new_tokens:
                self._finish(req)
                done.append(req)
        if cfg.stats_every and self.decode_steps % cfg.stats_every == 0:
            self.emit_stats()
        return done

    def drain(self) -> List[Request]:
        """step() until queue and slots are empty; returns every request
        that reached a terminal state along the way, submission order."""
        done: List[Request] = []
        while not self.idle:
            done.extend(self.step())
        return sorted(done, key=lambda r: r.id)

    # ------------------------------------------------------------ shutdown --
    def install_preemption(
            self, guard: Optional[PreemptionGuard] = None
    ) -> PreemptionGuard:
        """Arm the SIGTERM / SIGINT drain (the serve side of
        run_training's --on_preempt): the first signal is observed at the
        next step boundary — admissions stop, the queue is rejected with
        reason "shutdown", in-flight requests decode to completion, and
        close() records run_end{exit=preempted, reason=preempted}. A
        second signal raises KeyboardInterrupt out of the drain. Main
        thread only (signal semantics): elsewhere the guard stays
        uninstalled."""
        self.guard = guard or PreemptionGuard()
        if not self.guard.installed:
            self.guard.install()
        return self.guard

    def begin_shutdown(self, reason: str = "shutdown") -> List[Request]:
        """Stop admissions for good and reject every queued request;
        in-flight requests keep decoding (step()/drain() finish them).
        Returns the rejected requests."""
        self.draining = True
        out: List[Request] = []
        while self.queue:
            req = self.queue.popleft()
            self._terminal(req, "rejected", reason=reason)
            out.append(req)
        return out

    # ------------------------------------------------------------ health ----
    def health(self) -> dict:
        """Loop vitals: status ("draining" once admissions closed: the
        metrics endpoint's /healthz answers 503 then), queue depth,
        occupancy, page headroom, rolling p95 step latency, device
        memory, the prefix cache's hit rate, page copies and parked
        pages, and the terminal-state counters."""
        with self._health_lock:
            ms = sorted(self._step_ms)
        p95 = (round(ms[min(int(0.95 * len(ms)), len(ms) - 1)], 3)
               if ms else None)
        mem = (torch.cuda.memory_allocated(self.device) / 2 ** 20
               if self.device.type == "cuda" else None)
        return {
            "status": "draining" if self.draining else "ok",
            "queue_depth": len(self.queue),
            "active": len(self.active),
            "occupancy": round(len(self.active) / self.cfg.num_slots, 4),
            "free_blocks": self.alloc.free_blocks,
            "blocks_in_use": self.alloc.in_use,
            "p95_step_ms": p95,
            "decode_steps": self.decode_steps,
            "draining": self.draining,
            "hbm_mb": round(mem, 2) if mem is not None else None,
            "pool_mb": round(self.pool_mb, 2),
            "mesh": [self.cfg.mesh_dp, self.cfg.mesh_tp],
            "prefix_hit_rate": (self.prefix.hit_rate
                                if self.prefix is not None else None),
            "cow_copies": self.cow_copies,
            "parked_blocks": self.alloc.parked_blocks,
            "counts": {s: int(self.counts.get(s, 0))
                       for s in Request.TERMINAL},
        }

    def emit_stats(self) -> None:
        """One `serve_stats` snapshot into the stream (step() calls this
        every `stats_every` decode steps)."""
        h = self.health()
        self.telemetry.emit(
            "serve_stats", step=self.decode_steps,
            queue_depth=h["queue_depth"], active=h["active"],
            occupancy=h["occupancy"], free_blocks=h["free_blocks"],
            blocks_in_use=h["blocks_in_use"],
            p95_step_ms=h["p95_step_ms"], hbm_mb=h["hbm_mb"],
            pool_mb=h["pool_mb"], mesh=h["mesh"],
            prefix_hit_rate=h["prefix_hit_rate"],
            cow_copies=h["cow_copies"], **h["counts"])

    # ------------------------------------------------------------ teardown --
    def close(self, exit: str = "ok", reason: Optional[str] = None) -> None:
        """Refuse further submits and end the stream (idempotent). A drain
        that a preemption signal started records run_end{exit=preempted,
        reason=preempted}, as a drained training run does."""
        if self._closed:
            return
        self._closed = True
        if self.guard is not None:
            self.guard.uninstall()
        if exit == "ok" and self.guard is not None and self.guard.triggered:
            exit, reason = "preempted", "preempted"
        self.telemetry.emit(
            "run_end", steps=self.decode_steps,
            wall_s=time.perf_counter() - self._t0, exit=exit,
            goodput=None, reason=reason)
        self.telemetry.close()

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, *_) -> None:
        # an exception unwinding is not a clean exit: exit="error" with
        # the exception type as the reason
        if exc_type is None:
            self.close()
        else:
            self.close(exit="error", reason=exc_type.__name__)


def _tree_to(tree, device, dtype):
    """A nested dict of tensors moved to `device`, floating leaves cast to
    `dtype`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device, dtype if t.is_floating_point() else t.dtype)
