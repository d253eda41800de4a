"""Continuous-batching serve loop: static slots, paged KV, adapter routing
(port of mobilefinetuner_tpu/serve/engine.py, greedy GPT-2 serving).

The scheduler's unit of work is one DECODE STEP over `num_slots` static
slots. Requests are admitted into free slots (one prefill each) and
evicted the step they finish; every tensor the step sees keeps its shape:

    tok [S]      the token each slot feeds this step
    pos [S]      its cache position (tokens already cached)
    tbl [S, M]   per-slot block tables into the shared page pool
    aid [S]      per-slot adapter index into the resident bank

Idle slots are DATA, not branches: pos=0, tbl=trash, outputs ignored.
Greedy decode is the oracle: per-request tokens equal the JAX engine's on
the same weights (tests/test_torch_serve.py, f32 on the CPU).

Scheduling is FCFS with conservative page reservation: a request is
admitted only when its worst case (prompt + max_new_tokens pages) fits
what the pool has left after every resident's worst case; pages are
handed out lazily, so `append` can never fail mid-flight. Every terminal
transition goes through `_terminal`, so a request is counted once and
releases exactly its pages, whatever path ends it (finish, cancel,
deadline, contained step error).

Two host syncs per request and step, as in the JAX engine: `int(tok0)`
after a prefill and the step's `nxt.cpu()`. The pools are updated in
place (the JAX engine donated them to functional updates instead).

Precision: the engine sets `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` to False when it is built, so an f32
engine computes in full f32 on the card (TF32 would keep ~3 digits).

Not ported yet, and refused by name: prefix cache, chunked prefill and
sampling (ROADMAP.md port item P7), telemetry, trace spans and serve
stats (P6), preemption drain (P5), the (dp, tp) mesh (P9), Gemma-3
serving (P7).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.lora.lora import assign_adapters, tree_leaves
from mobilefinetuner_tpu_torch.models.generate import (gpt2_decode_step_paged,
                                                       gpt2_prefill)
from mobilefinetuner_tpu_torch.models.lora_apply import validate_lora_impl
from mobilefinetuner_tpu_torch.ops.attention import validate_attn_impl
from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.serve.paged_kv import (TRASH_BLOCK,
                                                      BlockAllocator,
                                                      OutOfBlocks, blocks_for,
                                                      init_pools,
                                                      write_prompt_blocks)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    max_prompt: int = 64      # prompts right-padded to this (block_T mult)
    max_new_tokens: int = 64  # per-request generation cap
    dtype: str = "float32"    # weights + compute + cache dtype
    attn_impl: str = "auto"   # auto (the kernels) | plain | flash
    lora_impl: str = "auto"   # auto | naive: the multi-adapter gather
    max_queue: int = 0        # FCFS queue cap; 0 = unbounded
    shed_policy: str = "reject"   # or "deadline": shed the queued request
                                  # closest to its deadline
    on_step_error: str = "fail_active"  # or "raise" after containing
    hbm_cap_mb: int = 0       # capacity override MB; 0 = the device's
    hbm_headroom: float = 0.1  # admission margin
    # --- JAX-engine features later port slices bring (validate refuses)
    stats_every: int = 0
    trace_spans: bool = False
    mesh_dp: int = 1
    mesh_tp: int = 1
    prefix_cache: bool = False
    max_prompt_chunked: int = 0
    chunk_buckets: tuple = ()
    sampling: bool = False

    def validate(self) -> None:
        if self.prefix_cache:
            raise _not_ported("prefix_cache", "P7")
        if self.max_prompt_chunked or self.chunk_buckets:
            raise _not_ported("chunked prefill (max_prompt_chunked, "
                              "chunk_buckets)", "P7")
        if self.sampling:
            raise _not_ported("sampling", "P7")
        if self.stats_every or self.trace_spans:
            raise _not_ported("serve telemetry (stats_every, trace_spans)",
                              "P6")
        if self.mesh_dp * self.mesh_tp != 1:
            raise _not_ported("the (dp, tp) serve mesh", "P9")
        validate_lora_impl(self.lora_impl)
        if self.lora_impl == "fused":
            raise _not_ported("lora_impl='fused' on the multi-adapter "
                              "serving path (the cost-model dense order)",
                              "P7")
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
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        if self.shed_policy not in ("reject", "deadline"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'deadline', got "
                f"{self.shed_policy!r}")
        if self.on_step_error not in ("fail_active", "raise"):
            raise ValueError(
                f"on_step_error must be 'fail_active' or 'raise', got "
                f"{self.on_step_error!r}")
        # the pool must hold at least one worst-case request, or FCFS
        # admission can never fire and drain() spins forever
        worst = blocks_for(self.max_prompt + self.max_new_tokens - 1,
                           self.block_T)
        if self.num_blocks - 1 < worst:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold one "
                f"worst-case request: max_prompt ({self.max_prompt}) + "
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
    tokens: List[int] = dataclasses.field(default_factory=list)
    enqueue_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    deadline_t: float = 0.0            # absolute perf_counter; 0 = none
    slot: int = -1
    aid: int = 0
    blocks: List[int] = dataclasses.field(default_factory=list)
    worst_blocks: int = 0

    TERMINAL = ("finished", "cancelled", "rejected", "timeout", "error")

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


class ServeEngine:
    """The serving loop: submit() + step() (or drain()).

    family: "gpt2"; params: the base tree (models/gpt2.py layout), cast to
    cfg.dtype on `device`; bank: optional AdapterBank for per-slot
    adapter routing. `device=None` is the CUDA card (core/device.py).
    The engine is single-threaded: every call comes from the serve loop.
    """

    def __init__(self, family: str, config, params,
                 cfg: Optional[ServeConfig] = None,
                 bank: Optional[AdapterBank] = None, telemetry=None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 watchdog=None, device=None):
        cfg = cfg or ServeConfig()
        cfg.validate()
        if telemetry is not None or watchdog is not None:
            raise _not_ported("serve telemetry (telemetry, watchdog)", "P6")
        if family == "gemma":
            raise _not_ported("Gemma-3 serving", "P7")
        if family != "gpt2":
            raise ValueError(f"unknown family {family!r}")
        if cfg.max_prompt + cfg.max_new_tokens > config.n_positions:
            raise ValueError(
                f"prompt cap + max_new_tokens = "
                f"{cfg.max_prompt + cfg.max_new_tokens} exceeds "
                f"n_positions={config.n_positions}")
        self.device = resolve_device(device)
        # full-f32 matmuls and convolutions on the card (module docstring)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        L, KV, D = config.n_layer, config.n_head, config.head_dim
        self.family, self.config, self.cfg = family, config, cfg
        self.bank = bank
        self.eos_id, self.pad_id = eos_id, pad_id
        self.dtype = DTYPES[cfg.dtype]
        S = cfg.num_slots
        self.M = blocks_for(cfg.max_prompt + cfg.max_new_tokens - 1,
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
        self.pool_k, self.pool_v = init_pools(
            cfg.num_blocks, L, KV, cfg.block_T, D, self.dtype, self.device)
        self._tok = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._tbl = np.full((S, self.M), TRASH_BLOCK, np.int32)
        self._aid = np.zeros(S, np.int64)
        self._slots: List[Optional[Request]] = [None] * S
        self.queue: collections.deque = collections.deque()
        self.decode_steps = 0
        self.decode_s = 0.0     # wall time in decode steps, host sync incl.
        self.prefills = 0
        self._next_id = 0
        self._closed = False
        # fault-injection seam: called with decode_steps right before every
        # step dispatch, inside the containment try
        self.step_hook: Optional[Callable[[int], None]] = None
        self._step_ms: collections.deque = collections.deque(maxlen=256)
        self.counts: collections.Counter = collections.Counter()
        # True while the prompt-page write runs: a failure there leaves
        # the pools suspect, so containment must rebuild them
        self._pools_at_risk = False

    # ------------------------------------------------------------ helpers ---
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _route(self, aid: np.ndarray):
        """Bank slots -> per-row lora tree (the ids-gather routing)."""
        if self.bank is None:
            return None
        return assign_adapters(self.bank.tree, aid)

    @property
    def active(self) -> List[Request]:
        return [r for r in self._slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def _committed_blocks(self) -> int:
        """Pages the residents may still demand (their reservations)."""
        return sum(r.worst_blocks - len(r.blocks) for r in self.active)

    def _terminal(self, req: Request, state: str,
                  reason: Optional[str] = None) -> None:
        """THE terminal transition: every path out of the lifecycle ends
        here, once. The caller releases slot and pages first."""
        if state not in Request.TERMINAL:
            raise ValueError(f"not a terminal state: {state!r}")
        if req.done:
            raise RuntimeError(f"request {req.id} already {req.state}")
        req.state = state
        req.reason = reason
        req.finish_t = time.perf_counter()
        self.counts[state] += 1

    # ------------------------------------------------------------ tenancy ---
    def load_adapter(self, name: str, source, verify: bool = True) -> int:
        """Hot-swap `source` into the resident bank under `name`: an
        adapter tree (lora/lora.py layout), or a path that
        AdapterBank.load_file reads (a native adapter file, verified
        against its checksum manifest, or an HF-PEFT directory).
        Replacing a resident that queued or active requests route to is
        refused."""
        if self.bank is None:
            raise RuntimeError("engine was built without an adapter bank")
        if name in self.bank.resident and self._adapter_in_use(name):
            raise RuntimeError(
                f"adapter {name!r} is routed by in-flight requests; "
                f"drain them before replacing it")
        if isinstance(source, dict):
            return self.bank.load(name, source)
        return self.bank.load_file(name, source, verify=verify)

    def evict_adapter(self, name: str) -> int:
        if self.bank is None:
            raise RuntimeError("engine was built without an adapter bank")
        if self._adapter_in_use(name):
            raise RuntimeError(
                f"adapter {name!r} is routed by in-flight requests")
        return self.bank.evict(name)

    def _adapter_in_use(self, name: str) -> bool:
        # queued requests count: submit() resolved their slot already
        return any(r.adapter == name
                   for r in list(self.queue) + self.active)

    # ------------------------------------------------------------ intake ----
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 0,
               adapter: Optional[str] = None,
               deadline_ms: Optional[float] = None) -> Request:
        """Enqueue one request (admission happens inside step()). A prompt
        beyond max_prompt, or a full bounded queue, comes back already
        terminal (state="rejected"): check `.state`."""
        if self._closed:
            raise RuntimeError("submit() on a closed ServeEngine")
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
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
                      enqueue_t=time.perf_counter())
        if deadline_ms is not None:
            req.deadline_t = req.enqueue_t + deadline_ms / 1000.0
        self._next_id += 1
        if len(prompt) > self.cfg.max_prompt:
            self._terminal(req, "rejected", reason="prompt_too_long")
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
        """Slot grant + one-shot prefill + prompt-page scatter."""
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
        req.blocks = self.alloc.alloc(blocks_for(P, cfg.block_T))
        ids = np.full((1, cfg.max_prompt), self.pad_id, np.int64)
        mask = np.zeros((1, cfg.max_prompt), np.int64)
        ids[0, :P], mask[0, :P] = req.prompt, 1
        logits, (k, v) = gpt2_prefill(
            self.config, self.params, self._dev(ids), self._dev(mask),
            compute_dtype=self.dtype,
            lora=self._route(np.asarray([req.aid], np.int64)),
            attn_impl=cfg.attn_impl)
        self.prefills += 1
        tok0 = logits[0].argmax(-1)
        # scatter the prompt pages; table rows past the prompt stay trash
        block_ids = np.full(cfg.max_prompt // cfg.block_T, TRASH_BLOCK,
                            np.int32)
        block_ids[:len(req.blocks)] = req.blocks
        self._pools_at_risk = True
        write_prompt_blocks(self.pool_k, self.pool_v, k[:, 0], v[:, 0],
                            self._dev(block_ids))
        self._pools_at_risk = False
        tok0 = int(tok0)                 # host sync: the first token
        req.admit_t = req.first_token_t = time.perf_counter()
        req.tokens.append(tok0)
        self._tok[slot], self._pos[slot] = tok0, P
        self._tbl[slot] = TRASH_BLOCK
        self._tbl[slot, :len(req.blocks)] = req.blocks
        if (self.eos_id is not None and tok0 == self.eos_id) \
                or req.max_new_tokens == 1:
            self._finish(req)

    def _release(self, req: Request) -> None:
        self.alloc.free(req.blocks)
        req.blocks = []
        s = req.slot
        if s < 0:   # admission died before the slot was taken
            return
        self._slots[s] = None
        self._tok[s] = self._pos[s] = self._aid[s] = 0
        self._tbl[s] = TRASH_BLOCK

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
        and zero the pools so the next admission starts clean. The queue
        is untouched."""
        name = type(e).__name__
        failed: List[Request] = []
        for req in self.active:
            self._release(req)
            self._terminal(req, "error", reason=name)
            failed.append(req)
        self.pool_k.zero_()
        self.pool_v.zero_()
        self._pools_at_risk = False
        return failed

    def step(self) -> List[Request]:
        """One scheduler iteration: expire deadlines, admit what fits, then
        one decode step for every active slot. Returns every request that
        reached a terminal state on this iteration."""
        cfg = self.cfg
        done: List[Request] = self._expire(time.perf_counter())
        # FCFS admission under the worst-case page reservation
        while self.queue:
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

        live = self.active
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
            logits, _, _ = gpt2_decode_step_paged(
                self.config, self.params, self.pool_k, self.pool_v,
                self._dev(self._tok), self._dev(self._pos),
                self._dev(self._tbl), lora=self._route(self._aid),
                compute_dtype=self.dtype, attn_impl=cfg.attn_impl)
            # the serve loop's ONE host sync per decode step
            nxt = logits.argmax(-1).cpu().numpy()
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
        self._step_ms.append(step_s * 1000.0)
        for req in live:
            s = req.slot
            self._pos[s] += 1
            self._tok[s] = int(nxt[s])
            req.tokens.append(int(nxt[s]))
            if (self.eos_id is not None and req.tokens[-1] == self.eos_id) \
                    or len(req.tokens) >= req.max_new_tokens:
                self._finish(req)
                done.append(req)
        return done

    def drain(self) -> List[Request]:
        """step() until queue and slots are empty; returns every request
        that reached a terminal state along the way, submission order."""
        done: List[Request] = []
        while not self.idle:
            done.extend(self.step())
        return sorted(done, key=lambda r: r.id)

    def install_preemption(self, guard=None):
        raise _not_ported("preemption drain (install_preemption)", "P5")

    # ------------------------------------------------------------ health ----
    def health(self) -> dict:
        """Loop vitals: queue depth, occupancy, page headroom, rolling p95
        step latency, device memory and the terminal-state counters."""
        ms = sorted(self._step_ms)
        p95 = (round(ms[min(int(0.95 * len(ms)), len(ms) - 1)], 3)
               if ms else None)
        mem = (torch.cuda.memory_allocated(self.device) / 2 ** 20
               if self.device.type == "cuda" else None)
        return {
            "queue_depth": len(self.queue),
            "active": len(self.active),
            "occupancy": round(len(self.active) / self.cfg.num_slots, 4),
            "free_blocks": self.alloc.free_blocks,
            "blocks_in_use": self.alloc.in_use,
            "p95_step_ms": p95,
            "decode_steps": self.decode_steps,
            "hbm_mb": round(mem, 2) if mem is not None else None,
            "pool_mb": round(self.pool_mb, 2),
            "counts": {s: int(self.counts.get(s, 0))
                       for s in Request.TERMINAL},
        }

    # ------------------------------------------------------------ teardown --
    def close(self) -> None:
        """Refuse further submits (idempotent)."""
        self._closed = True


def _tree_to(tree, device, dtype):
    """A nested dict of tensors moved to `device`, floating leaves cast to
    `dtype`."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device, dtype if t.is_floating_point() else t.dtype)
