"""Multi-tenant LoRA training engine: k adapter jobs through one shared
base forward (port of mobilefinetuner_tpu/multitenant/engine.py).

Many personal adapters fine-tune against the SAME frozen base; one CLI
process per job leaves the memory-bound LoRA step mostly idle. The engine
fuses k jobs into one train step:

  - the adapter bank is a stacked [k, ...] tree (lora.stack_adapters);
    every micro-batch row carries its adapter id and the ids-routed
    models/lora_apply._multi_lora makes slot j's gradient the sum of its
    own rows' contributions: one base forward serves every tenant;
  - Adam m / v / step are stacked [k, ...] with per-slot step counters,
    LRs and budgets (optim/adam.multi_adam_update, train/trainer
    .make_multi_train_step), so each tenant's update is the solo step's;
  - slots are fixed and tenancy is data. The bank's and the optimizer's
    tensors are allocated once: every step and every admission, release,
    refill and cancel writes slot j in place (torch.no_grad), so the
    data_ptr() of every leaf never changes. `trace_counts` counts the
    builds of the step function and of the slot writer, which happen
    once each: `total_traces()` stays flat after warm-up;
  - per-tenant streams multiplex round-robin through per-tenant bounded
    Prefetchers (TenantMux): a stalled tenant cannot starve the other
    k - 1 producers, and the step loop's wait is charged to it;
  - each finished adapter saves through io/async_ckpt (bank snapshot ->
    lora.unstack_adapter slot slice -> the solo CLIs' peft_io writer,
    manifest, lineage and an optional PEFT export): a bank-trained
    adapter file is byte-identical to a solo-trained one, so
    serve.AdapterBank.load_file hot-loads it manifest-verified. The
    writer holds one pending save, which a newer save supersedes; a save
    of another tenant first drains it, so no tenant's save is dropped
    for another's.

Host syncs: a step copies its batch and one [5, k] schedule tensor up
through pinned memory and reads nothing back; the per-step metric
tensors stay on the device until a metrics flush copies them all to the
host at once. Idle slots feed all-zero attention_mask rows whose
gradients the masked update discards.

Dropout (jobs' shared rate > 0): micro-batch a of global step s runs the
model with dropout seed fold_in(fold_in(dropout_seed, s), a), and each
routed LoRA site draws one mask per row from it (ops/dropout.row_dropout);
the bits are not the JAX engine's threefry keys.

Telemetry rides the stream: `tenant` lifecycle events (admit, save,
finish, cancel), a per-tenant `tenants` section in step_stats, and the
shared async writer's checkpoint events.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry, run_manifest
from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
from mobilefinetuner_tpu_torch.io import async_ckpt
from mobilefinetuner_tpu_torch.io.checkpoints import record_checkpoint
from mobilefinetuner_tpu_torch.lora import peft_io
from mobilefinetuner_tpu_torch.lora.lora import (assign_adapters,
                                                 init_lora_gemma3,
                                                 init_lora_gpt2,
                                                 stack_adapters,
                                                 trainable_mask,
                                                 unstack_adapter)
from mobilefinetuner_tpu_torch.multitenant.jobspec import (JobSpec,
                                                           validate_jobs)
from mobilefinetuner_tpu_torch.ops.dropout import fold_in
from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_rows
from mobilefinetuner_tpu_torch.optim.adam import (flatten, init_multi_state,
                                                  tree_map)
from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                     make_multi_train_step)

log = get_logger()

# the per-slot metric vectors of make_multi_train_step, in flush order
METRIC_KEYS = ("loss", "grad_norm", "lr", "tokens", "param_norm",
               "update_ratio", "nonfinite_count", "skipped", "active")


@dataclasses.dataclass
class EngineConfig:
    """Engine shape knobs: together they fix the one step every tenant
    shares. Per-job quantities (LR, budget, alpha, seeds, save policy)
    live in JobSpec as data."""
    slots: int = 2            # concurrent adapter jobs per step
    rows_per_tenant: int = 1  # micro-batch rows each tenant contributes
    grad_accum_steps: int = 1
    seq_len: int = 128
    dtype: str = "float32"    # compute dtype
    clip_grad_norm: float = 1.0
    weight_decay: float = 0.0
    schedule: str = "cosine"  # the schedule SHAPE is engine-wide; peak LR,
                              # warmup and budget are per-job data
    min_lr_ratio: float = 0.1
    lora_impl: str = "auto"
    skip_nonfinite: bool = False
    prefetch: int = 2         # per-tenant bounded queue depth (0 = sync)
    flush_every: int = 10     # buffered-metrics flush cadence (steps)
    async_save: bool = True
    out_dir: str = ""         # default save root for spec-less save_path
    dropout_seed: int = 1234  # engine-level dropout seed (the rate is the
                              # jobs' common value)

    def validate(self) -> None:
        if self.slots < 1 or self.rows_per_tenant < 1 \
                or self.grad_accum_steps < 1:
            raise ValueError(
                "slots, rows_per_tenant, and grad_accum_steps must be "
                ">= 1")
        if self.prefetch < 0 or self.flush_every < 1:
            raise ValueError("prefetch must be >= 0, flush_every >= 1")

    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


class TenantMux:
    """Per-tenant bounded input queues, pulled round-robin (slot order)
    into one combined step batch. Each tenant has its own Prefetcher
    (producer thread + bounded queue of `depth` step batches), so a
    stalled tenant stream never blocks the other producers nor grows host
    memory without bound; `wait_ms[name]` accumulates exactly the time
    `pull(name)` blocked (the per-tenant wait in step_stats)."""

    def __init__(self, depth: int = 2):
        self.depth = max(int(depth), 0)
        self._pf: Dict[str, Prefetcher] = {}
        self.wait_ms: Dict[str, float] = {}

    def add(self, name: str, source: Iterable) -> None:
        if name in self._pf:
            raise ValueError(f"tenant {name!r} already has a stream")
        # lookahead=0: the mux holds HOST batches only, so the bound on
        # buffered batches per tenant is exactly `depth`
        self._pf[name] = Prefetcher(source, depth=self.depth, lookahead=0)
        self.wait_ms[name] = 0.0

    def remove(self, name: str) -> None:
        pf = self._pf.pop(name, None)
        if pf is not None:
            pf.close()
        # a departed tenant's residual wait leaves with its stream
        self.wait_ms.pop(name, None)

    def pull(self, name: str):
        """Next step batch for `name`; blocks on a stalled producer and
        charges the wait to that tenant alone."""
        t0 = time.perf_counter()
        try:
            batch = next(self._pf[name])
        except StopIteration:
            raise RuntimeError(
                f"tenant {name!r}'s data stream ended before its step "
                f"budget (streams must cycle epochs like "
                f"cli/common.micro_batches)") from None
        self.wait_ms[name] += (time.perf_counter() - t0) * 1000.0
        return batch

    def queue_depth(self, name: Optional[str] = None) -> int:
        if name is not None:
            pf = self._pf.get(name)
            return pf.queue_depth() if pf is not None else 0
        return sum(pf.queue_depth() for pf in self._pf.values())

    def take_waits(self) -> Dict[str, float]:
        """Drain the per-tenant wait accumulators (one flush interval)."""
        out, self.wait_ms = self.wait_ms, {n: 0.0 for n in self.wait_ms}
        return out

    def close(self) -> None:
        for pf in self._pf.values():
            pf.close()
        self._pf.clear()


class _Tenant:
    """One admitted (or pending) job's runtime state."""

    __slots__ = ("spec", "slot", "steps_done", "tokens", "last_loss",
                 "status", "save_path")

    def __init__(self, spec: JobSpec, out_dir: str):
        self.spec = spec
        self.slot = -1
        self.steps_done = 0
        self.tokens = 0           # cumulative valid tokens trained
        self.last_loss: Optional[float] = None
        self.status = "pending"   # pending|active|finished|cancelled
        self.save_path = spec.resolved_save_path(out_dir)


class MultiTenantEngine:
    """Drive with run() (admit -> step until every job finishes) or
    admit_pending() / step() / cancel(); close() drains the async writer
    and ends the telemetry stream.

    family: "gpt2" | "gemma"; config: the model config; params: the
    frozen base tree (tensors on `device`, shared by every tenant);
    make_stream(job) -> iterator of per-tenant numpy step batches
    ({input_ids, attention_mask, labels} of [rows_per_tenant *
    grad_accum_steps, seq_len]) cycling epochs forever. device: None is
    the CUDA card (core/device.py).
    """

    def __init__(self, family: str, config, params, jobs: List[JobSpec],
                 make_stream: Callable[[JobSpec], Iterable],
                 cfg: Optional[EngineConfig] = None,
                 telemetry: Optional[Telemetry] = None, device=None):
        cfg = cfg or EngineConfig()
        cfg.validate()
        if family == "gpt2":
            self._init_lora = init_lora_gpt2
            self._forward = _gpt2_forward
            default_init = "gpt2"
        elif family == "gemma":
            self._init_lora = init_lora_gemma3
            self._forward = _gemma_forward
            default_init = "peft"
        else:
            raise ValueError(f"unknown model family {family!r}")
        validate_jobs(jobs)
        self.device = resolve_device(device)
        self.family = family
        self.config = config
        self.cfg = cfg
        self.params = params
        self.k = cfg.slots
        self._default_init = default_init
        self._dropout = jobs[0].dropout      # shared (validate_jobs)
        self._make_stream = make_stream
        self.tel = telemetry or Telemetry("", enabled=False)
        self.trace_counts: collections.Counter = collections.Counter()

        # the stacked bank: slot shapes from the SHARED spec (rank and
        # targets validated equal); empty slots are all-zero (delta 0)
        template = self._init_lora(
            config, jobs[0].lora_spec(default_init), 0, device=self.device)
        zero = tree_map(torch.zeros_like, template)
        self.bank = stack_adapters([zero] * self.k)
        self.mask = trainable_mask(self.bank)
        self._tc = TrainConfig(
            total_steps=1, lr=0.0, warmup_ratio=0.0,
            schedule=cfg.schedule, min_lr_ratio=cfg.min_lr_ratio,
            clip_grad_norm=cfg.clip_grad_norm,
            grad_accum_steps=cfg.grad_accum_steps,
            weight_decay=cfg.weight_decay,
            skip_nonfinite=cfg.skip_nonfinite)
        self.opt = init_multi_state(self.bank, self._tc.adam(), self.k,
                                    self.mask)

        # per-slot schedule / apply data, HOST arrays sent with each step:
        # rows step, total, lr, warmup_ratio, active. Tenant changes
        # write these, never the step.
        self._sched = np.zeros((5, self.k), np.float32)
        self._sched[1] = 1.0
        self._step_fn = None
        self._slot_leaves = None
        # every micro-batch carries every slot's rows in slot order
        self._mb_ids = np.repeat(np.arange(self.k, dtype=np.int64),
                                 cfg.rows_per_tenant)

        self.tenants: Dict[str, _Tenant] = {
            j.name: _Tenant(j, cfg.out_dir) for j in jobs}
        self.pending: collections.deque = collections.deque(
            self.tenants[j.name] for j in jobs)
        self.slot_tenant: List[Optional[_Tenant]] = [None] * self.k
        self.mux = TenantMux(depth=cfg.prefetch)
        self._zero_batch = None
        self.global_step = 0
        self._buffered: List[tuple] = []   # (gstep, names, metrics)
        self._t_interval = time.perf_counter()
        self._ema: Optional[float] = None
        self.ckpt = async_ckpt.AsyncCheckpointer(
            enabled=cfg.async_save, event_sink=self.tel.emit)
        self._last_saver: Optional[str] = None
        self._closed = False
        self._t_start = time.time()
        self.tel.emit("run_start", **run_manifest(
            {"engine": "multitenant", "family": family,
             "slots": self.k, "jobs": [j.name for j in jobs],
             "rows_per_tenant": cfg.rows_per_tenant,
             "grad_accum_steps": cfg.grad_accum_steps,
             "seq_len": cfg.seq_len, "dtype": cfg.dtype,
             "schedule": cfg.schedule, "lora_impl": cfg.lora_impl},
            self.device))

    # ------------------------------------------------------------ info ----
    def total_traces(self) -> int:
        return sum(self.trace_counts.values())

    def storage_ptrs(self) -> Dict[str, int]:
        """{path: data_ptr()} of every bank and optimizer leaf: the
        engine's stable-storage contract (module docstring)."""
        out = {f"bank/{p}": t.data_ptr()
               for p, t in flatten(self.bank).items()}
        out.update({f"opt/{p}": t.data_ptr()
                    for p, t in flatten(self.opt).items()})
        return out

    @property
    def active(self) -> List[_Tenant]:
        return [t for t in self.slot_tenant if t is not None]

    def _has_work(self) -> bool:
        return bool(self.pending or self.active)

    # ------------------------------------------------------- admission ----
    def _write_slot(self, fresh: Optional[dict], j: int) -> None:
        """Slot j of the bank <- `fresh` (None: zeros), and slot j's Adam
        m / v / v_hat and step counter <- 0, in place: the one writer of
        admission, release, refill and cancel."""
        if self._slot_leaves is None:
            self.trace_counts["admit"] += 1
            bank = flatten(self.bank)
            opt = [t for p, t in flatten(self.opt).items()
                   if p != "step" and t.dim() and t.shape[0] == self.k]
            self._slot_leaves = (list(bank.items()), opt)
        bank_leaves, opt_leaves = self._slot_leaves
        new = None if fresh is None else flatten(fresh)
        with torch.no_grad():
            for path, leaf in bank_leaves:
                if new is None:
                    leaf[j].zero_()
                else:
                    leaf[j].copy_(new[path])
            for leaf in opt_leaves:
                leaf[j].zero_()
            self.opt["step"][j] = 0

    def admit_pending(self) -> int:
        """Fill free slots from the pending queue; returns jobs admitted."""
        n = 0
        for j in range(self.k):
            if self.slot_tenant[j] is None and self.pending:
                self._admit(self.pending.popleft(), j)
                n += 1
        return n

    def _admit(self, tenant: _Tenant, j: int) -> None:
        spec = tenant.spec
        fresh = self._init_lora(self.config,
                                spec.lora_spec(self._default_init),
                                spec.seed, device=self.device)
        self._write_slot(fresh, j)
        self._sched[:, j] = (0.0, spec.steps, spec.lr, spec.warmup_ratio,
                             1.0)
        tenant.slot = j
        tenant.status = "active"
        self.slot_tenant[j] = tenant
        self.mux.add(spec.name, self._make_stream(spec))
        self.tel.emit("tenant", name=spec.name, slot=j, phase="admit",
                      step=0, job_steps=spec.steps, tokens=0, loss=None,
                      path=None, tenant=spec.name)
        log.info(f"tenant {spec.name!r} -> slot {j} "
                 f"(lr={spec.lr:g}, {spec.steps} steps)")

    def _release_slot(self, tenant: _Tenant) -> None:
        """Zero the slot (a stale id can only reach a zero delta), free
        it, and refill it from the pending queue."""
        j = tenant.slot
        self._write_slot(None, j)
        self._sched[:, j] = (0.0, 1.0, 0.0, 0.0, 0.0)
        self.slot_tenant[j] = None
        tenant.slot = -1
        self.mux.remove(tenant.spec.name)
        if self.pending:
            self._admit(self.pending.popleft(), j)

    def cancel(self, name: str) -> None:
        """Cancel a pending or active job (no save); its slot refills."""
        t = self.tenants[name]
        slot = t.slot
        if t.status == "pending":
            self.pending.remove(t)
        elif t.status == "active":
            self._flush_metrics()
            self._release_slot(t)
        else:
            return
        t.status = "cancelled"
        self.tel.emit("tenant", name=name, slot=slot, phase="cancel",
                      step=t.steps_done, job_steps=t.spec.steps,
                      tokens=t.tokens, loss=t.last_loss, path=None,
                      tenant=name)

    # ------------------------------------------------------------ step ----
    def _build_step(self):
        self.trace_counts["train_step"] += 1
        cfg, config = self.cfg, self.config
        compute_dtype = cfg.compute_dtype()
        mb_ids = self._mb_ids

        def loss_rows(tr, frozen, mb):
            routed = assign_adapters(tr, mb_ids)
            logits = self._forward(config, frozen, mb, routed,
                                   compute_dtype, self._dropout,
                                   mb.get("dropout_seed"), cfg.lora_impl)
            return lm_cross_entropy_rows(logits, mb["labels"])

        return make_multi_train_step(loss_rows, self._tc, self.k, self.mask)

    def _batch_template(self):
        if self._zero_batch is None:
            rows = self.cfg.rows_per_tenant * self.cfg.grad_accum_steps
            S = self.cfg.seq_len
            self._zero_batch = {
                "input_ids": np.zeros((rows, S), np.int32),
                "attention_mask": np.zeros((rows, S), np.float32),
                "labels": np.zeros((rows, S), np.int32)}
        return self._zero_batch

    def _assemble(self) -> dict:
        """Pull one step batch per active slot (idle slots contribute zero
        rows the masked update ignores) and interleave them so each accum
        micro-batch carries every tenant's rows: row (a, slot, r) ->
        a*k*b + slot*b + r. Host numpy arrays."""
        A = self.cfg.grad_accum_steps
        b = self.cfg.rows_per_tenant
        S = self.cfg.seq_len
        k = self.k
        per_slot = []
        for j in range(k):
            t = self.slot_tenant[j]
            if t is None:
                per_slot.append(self._batch_template())
            else:
                tb = self.mux.pull(t.spec.name)
                if isinstance(tb, tuple):   # (epoch, batch) generators
                    tb = tb[-1]
                per_slot.append(tb)
        batch = {}
        for key, dt in (("input_ids", np.int32),
                        ("attention_mask", np.float32),
                        ("labels", np.int32)):
            buf = np.empty((A * k * b, S), dt)
            for a in range(A):
                for j, tb in enumerate(per_slot):
                    buf[a * k * b + j * b:a * k * b + (j + 1) * b] = \
                        tb[key][a * b:(a + 1) * b]
            batch[key] = buf
        batch["adapter_ids"] = np.tile(self._mb_ids, A)
        return batch

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, through pinned memory
        without waiting for the card; int32 becomes int64."""
        t = torch.from_numpy(a)
        if t.dtype == torch.int32:
            t = t.long()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def step(self) -> None:
        """One fused optimizer step over every resident tenant, then the
        bookkeeping: per-slot step counters, flush cadence, completions
        (save + refill) at the step boundary."""
        if not self.active:
            self.admit_pending()
            if not self.active:
                return
        if self._step_fn is None:
            self._step_fn = self._build_step()
        batch = {key: self._to_device(a)
                 for key, a in self._assemble().items()}
        if self._dropout > 0:
            step_seed = fold_in(self.cfg.dropout_seed, self.global_step)
            batch["dropout_seeds"] = [
                fold_in(step_seed, a)
                for a in range(self.cfg.grad_accum_steps)]
        sched_t = self._to_device(self._sched)
        sched = {"step": sched_t[0], "total": sched_t[1], "lr": sched_t[2],
                 "warmup_ratio": sched_t[3], "active": sched_t[4] > 0.5}
        # the step writes the bank and the optimizer state in place
        _, _, metrics = self._step_fn(self.bank, self.params, self.opt,
                                      batch, sched)
        names = tuple(t.spec.name if t is not None else None
                      for t in self.slot_tenant)
        self._buffered.append((self.global_step, names, metrics))
        self.global_step += 1
        done: List[_Tenant] = []
        for j, t in enumerate(self.slot_tenant):
            if t is None:
                continue
            self._sched[0, j] += 1
            t.steps_done += 1
            spec = t.spec
            if t.steps_done >= spec.steps:
                done.append(t)
            elif spec.save_every and t.steps_done % spec.save_every == 0:
                self._save_tenant(t, final=False)
        if self.global_step % self.cfg.flush_every == 0:
            self._flush_metrics()
        for t in done:
            self._finish(t)

    def run(self) -> None:
        """Admit, step until every job is finished, final flush."""
        self.admit_pending()
        while self._has_work():
            self.step()
        self._flush_metrics()

    # ----------------------------------------------------------- saves ----
    def _save_tenant(self, tenant: _Tenant, final: bool) -> None:
        """One tenant's save through the shared async writer: the blocking
        part is one bank snapshot; the slot slice, the safetensors write
        (atomic, with its manifest), the lineage record and the optional
        PEFT export run on the writer thread."""
        # flush first: the tenant event reports tokens / loss, which only
        # advance at a flush
        self._flush_metrics()
        spec = tenant.spec
        j = tenant.slot
        step = tenant.steps_done
        path = tenant.save_path
        if not final:
            root, ext = os.path.splitext(path)
            path = f"{root}_step{step}{ext}"
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        bank_h, snap_ms = async_ckpt.timed_snapshot(self.bank)
        lspec = spec.lora_spec(self._default_init)
        name = spec.name
        final_path = tenant.save_path

        def write():
            tree = unstack_adapter(bank_h, j)
            peft_io.save_adapter(path, tree, lspec,
                                 extra_metadata={"tenant": name,
                                                 "loop_step": str(step)})
            try:
                record_checkpoint(final_path, step, [path],
                                  keep=max(spec.keep_ckpts, 0))
            except Exception as e:
                log.warning(f"tenant {name!r} lineage update failed: {e}")
            if final and spec.peft_export_dir:
                peft_io.export_peft(spec.peft_export_dir, tree, lspec,
                                    self.family)
            return [path]

        if self._last_saver not in (None, name):
            # the writer keeps one pending save and the newest supersedes
            # it: right within one tenant, never across two
            self.ckpt.drain()
        self._last_saver = name
        async_ckpt.submit(self.ckpt, step, write, final=final,
                          snapshot_ms=snap_ms)
        self.tel.emit("tenant", name=name, slot=j, phase="save",
                      step=step, job_steps=spec.steps,
                      tokens=tenant.tokens, loss=tenant.last_loss,
                      path=path, tenant=name)

    def _finish(self, tenant: _Tenant) -> None:
        self._save_tenant(tenant, final=True)  # flushes first
        tenant.status = "finished"
        self.tel.emit("tenant", name=tenant.spec.name, slot=tenant.slot,
                      phase="finish", step=tenant.steps_done,
                      job_steps=tenant.spec.steps, tokens=tenant.tokens,
                      loss=tenant.last_loss, path=tenant.save_path,
                      tenant=tenant.spec.name)
        log.info(f"tenant {tenant.spec.name!r} finished at step "
                 f"{tenant.steps_done} -> {tenant.save_path}")
        self._release_slot(tenant)

    # --------------------------------------------------------- metrics ----
    def _flush_metrics(self) -> None:
        """One device-to-host copy for everything buffered since the last
        flush: per-slot [k] metric vectors are attributed to the tenant
        resident in that slot AT THAT STEP (refills mid-interval keep
        their history straight), aggregates land as a schema-valid
        step_stats with the per-tenant `tenants` section, and the mux's
        per-tenant waits ride along."""
        if not self._buffered:
            return
        host = torch.stack([
            torch.stack([m[key].double() for key in METRIC_KEYS])
            for _, _, m in self._buffered]).cpu().numpy()
        fetched = [dict(zip(METRIC_KEYS, row)) for row in host]
        dt_ms = ((time.perf_counter() - self._t_interval) * 1000.0
                 / len(self._buffered))
        waits = self.mux.take_waits()
        tenants_out: Dict[str, dict] = {}
        total_tokens = 0.0
        for (gstep, names, _), m in zip(self._buffered, fetched):
            for j, name in enumerate(names):
                if name is None:
                    continue
                t = self.tenants[name]
                toks = float(m["tokens"][j])
                t.tokens += int(toks)
                total_tokens += toks
                if m["active"][j]:
                    t.last_loss = float(m["loss"][j])
        last = fetched[-1]
        names = self._buffered[-1][1]
        act = [j for j in range(self.k) if names[j] is not None]
        for j in act:
            t = self.tenants[names[j]]
            tenants_out[names[j]] = {
                "slot": j, "step": t.steps_done,
                "loss": t.last_loss, "tokens": t.tokens,
                "wait_ms": round(waits.get(names[j], 0.0), 2)}

        def mean(key):
            vals = [float(last[key][j]) for j in act]
            return sum(vals) / len(vals) if vals else 0.0

        w, l = last["tokens"], last["loss"]
        wsum = float(sum(w[j] for j in act)) or 1.0
        loss = float(sum(l[j] * w[j] for j in act)) / wsum
        self._ema = loss if self._ema is None else \
            0.9 * self._ema + 0.1 * loss
        n_steps = len(self._buffered)
        step_time_s = max(dt_ms / 1000.0, 1e-9)
        self.tel.emit(
            "step_stats", step=self.global_step, loss=loss,
            ema=self._ema, lr=mean("lr"), grad_norm=mean("grad_norm"),
            step_time_ms=dt_ms,
            host_wait_ms=sum(waits.values()) / n_steps,
            slept_ms=None, tok_s=total_tokens / n_steps / step_time_s,
            mfu=None, param_norm=mean("param_norm"),
            update_ratio=mean("update_ratio"),
            nonfinite_count=int(sum(int(last["nonfinite_count"][j])
                                    for j in act)),
            skipped=int(sum(int(fm["skipped"][j]) for fm in fetched
                            for j in act)),
            hbm_mb=None, queue_depth=self.mux.queue_depth(),
            host_step_ms=None, tenants=tenants_out)
        self._buffered.clear()
        self._t_interval = time.perf_counter()

    # -------------------------------------------------------- lifecycle ----
    def close(self, exit_name: str = "ok") -> None:
        """Drain the async writer, stop the tenant producers, end the
        stream with run_end (exactly once)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._flush_metrics()
            self.ckpt.close(raise_errors=exit_name == "ok")
        finally:
            self.mux.close()
            self.tel.emit("run_end", steps=self.global_step,
                          wall_s=round(time.time() - self._t_start, 3),
                          exit=exit_name, goodput=None)
            self.tel.close()

    def __enter__(self) -> "MultiTenantEngine":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        # an exception's run_end names its type; writer errors must not
        # mask it
        self.close("ok" if exc_type is None else exc_type.__name__)


# --------------------------- family forwards --------------------------------

def _gpt2_forward(config, frozen, mb, routed, compute_dtype, dropout, seed,
                  lora_impl):
    from mobilefinetuner_tpu_torch.models import gpt2
    return gpt2.forward(config, frozen, mb["input_ids"],
                        attention_mask=mb["attention_mask"], lora=routed,
                        compute_dtype=compute_dtype, lora_dropout=dropout,
                        dropout_seed=seed, lora_impl=lora_impl)


def _gemma_forward(config, frozen, mb, routed, compute_dtype, dropout, seed,
                   lora_impl):
    from mobilefinetuner_tpu_torch.models import gemma3
    return gemma3.forward(config, frozen, mb["input_ids"],
                          attention_mask=mb["attention_mask"],
                          lora=routed, compute_dtype=compute_dtype,
                          lora_dropout=dropout, dropout_seed=seed,
                          lora_impl=lora_impl)
