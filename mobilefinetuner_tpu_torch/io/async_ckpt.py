"""Snapshot-then-write checkpointing (port of
mobilefinetuner_tpu/io/async_ckpt.py: `snapshot`, `timed_snapshot`,
`tree_bytes`, `CheckpointDrainTimeout`, `AsyncCheckpointer`, `submit`).

A save splits in two:

  - **snapshot**, the step loop's only blocking work: every CUDA leaf of
    the tree is copied into a fresh pinned host buffer with one
    non-blocking copy each, all issued before one synchronisation (an
    event on the current stream), so the copies overlap each other and
    the loop waits once. A buffer is never reused: each snapshot owns its
    buffers until the writer drops them, so the step that runs next, or
    the next snapshot, cannot change what a queued write reads. CPU
    leaves are cloned (the loop's own tensors may be replaced, never the
    snapshot's); numpy leaves pass through.
  - **write** (`AsyncCheckpointer`): key mapping, the bf16 encode and the
    safetensors write run on one background thread, through writers that
    publish atomically (`safetensors_io.atomic_publish`: a kill mid-write
    leaves the previous file loadable). A depth-1 queue: a save that
    lands while one is pending replaces it (`ckpt_dropped`), so at most
    one whole-tree host copy waits. `final=True` drains. A background
    write error is raised at the next save, drain or close; close stops
    the thread even after an error.

`enabled=False` is the synchronous oracle (`--async_save 0`): the same
write function runs inline, so the files are byte-identical either way.
The `checkpoint` event is emitted here, where the split is measured:
`wall_s` / `snapshot_ms` the blocking part (the number the run's goodput
`checkpoint` bucket counts), `write_ms` / `bytes` / `mb_s` the write,
which under async overlaps the `step` bucket. With a `tracer`
(--trace_spans) each write is also a `span` on the "ckpt" track, emitted
from the writer thread.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch


# ----------------------------- snapshot -------------------------------------

def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def snapshot(tree):
    """A host copy of a tree of tensors: each CUDA leaf into its own new
    pinned buffer (non-blocking copies, then one wait for all of them),
    each CPU leaf cloned, anything else passed through."""
    devices = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x, non_blocking=True)
        devices.add(x.device)
        return buf

    host = _map(copy, tree)
    for device in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
    return host


def timed_snapshot(tree):
    """(host tree, blocking ms): the number the checkpoint event reports
    as `snapshot_ms`."""
    t0 = time.perf_counter()
    host = snapshot(tree)
    return host, (time.perf_counter() - t0) * 1000.0


def tree_bytes(host_tree) -> int:
    """Total bytes of a snapshot's leaves."""
    total = 0
    for x in _leaves(host_tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, np.ndarray):
            total += x.nbytes
    return int(total)


# ----------------------------- background writer -----------------------------

class CheckpointDrainTimeout(TimeoutError):
    """A bounded drain or close expired with a write still in flight (the
    writer thread is wedged). Names the stuck step; the unfinished write
    cannot corrupt a published checkpoint."""

    def __init__(self, step: int, timeout: float):
        self.step = step
        self.timeout = timeout
        super().__init__(
            f"checkpoint write for step {step} still in flight after "
            f"{timeout:.1f}s drain timeout (writer thread wedged; the "
            f"unfinished write cannot corrupt any published checkpoint)")


class _SaveItem:
    __slots__ = ("step", "write_fn", "final", "snapshot_ms", "done")

    def __init__(self, step, write_fn, final, snapshot_ms):
        self.step = step
        self.write_fn = write_fn
        self.final = final
        self.snapshot_ms = snapshot_ms
        self.done = threading.Event()


class AsyncCheckpointer:
    """The snapshot-then-write pipeline of one training run.

    `save(step, write_fn, final=..., snapshot_ms=...)` hands a
    zero-argument `write_fn`, closed over an already snapshotted host
    tree, to the writer thread; `write_fn` returns the paths it wrote.
    event_sink has `Telemetry.emit`'s signature (the stream's own lock
    serialises the writer thread's events with the loop's)."""

    def __init__(self, enabled: bool = True,
                 event_sink: Optional[Callable] = None, tracer=None):
        self.enabled = bool(enabled)
        self._sink = event_sink
        self._tracer = tracer
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pending: Optional[_SaveItem] = None
        self._inflight: Optional[_SaveItem] = None
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.dropped = 0   # snapshots replaced before their write began
        self.written = 0   # completed writes

    # -- step-loop side -------------------------------------------------------

    def save(self, step: int, write_fn: Callable[[], Iterable[str]], *,
             final: bool = False, snapshot_ms: float = 0.0) -> None:
        """Queue (async) or perform (sync) one write; final=True drains.
        Raises a stored background-write error instead of queueing more
        work onto a broken writer."""
        self._raise_pending_error()
        if not self.enabled:
            self._write(_SaveItem(step, write_fn, final, snapshot_ms))
            self._raise_pending_error()
            return
        item = _SaveItem(step, write_fn, final, snapshot_ms)
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="ckpt-writer")
                self._thread.start()
            if self._pending is not None:
                # depth 1: the newest snapshot replaces the pending one
                old = self._pending
                self._pending = item
                self.dropped += 1
                old.done.set()
                self._emit("ckpt_dropped", step=old.step,
                           superseded_by=item.step)
            else:
                self._pending = item
            self._work.notify()
        if final:
            self.drain()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until nothing is pending or in flight; re-raise a
        background-write error. A bounded drain that expires raises
        CheckpointDrainTimeout naming the in-flight step."""
        while True:
            with self._lock:
                item = self._inflight or self._pending
            if item is None:
                break
            if not item.done.wait(timeout):
                raise CheckpointDrainTimeout(item.step, timeout or 0.0)
        self._raise_pending_error()

    def close(self, raise_errors: bool = True,
              drain_timeout: float = 600.0) -> None:
        """Drain (bounded), then stop and join the writer thread, on every
        path: a write error (re-raised with raise_errors) and a wedged
        writer (abandoned after a short join) included."""
        wedged = False
        try:
            self.drain(timeout=drain_timeout)
        except CheckpointDrainTimeout:
            wedged = True
            if raise_errors:
                raise
        except BaseException:
            if raise_errors:
                raise
        finally:
            with self._lock:
                self._stop = True
                self._work.notify()
            if self._thread is not None:
                self._thread.join(timeout=0.2 if wedged else 30.0)
                self._thread = None

    # -- writer side ----------------------------------------------------------

    def _raise_pending_error(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err

    def _emit(self, event: str, **fields):
        if self._sink is not None:
            self._sink(event, **fields)

    def _write(self, item: _SaveItem) -> None:
        t0 = time.perf_counter()
        try:
            paths = list(item.write_fn() or ())
        except BaseException as e:  # raised at the next save/drain/close
            with self._lock:
                self._error = e
            return
        finally:
            item.done.set()
        write_ms = (time.perf_counter() - t0) * 1000.0
        if self._tracer is not None:
            self._tracer.emit_span(f"ckpt_write(step {item.step})",
                                   "ckpt", t0, write_ms, step=item.step)
        nbytes = 0
        for p in paths:
            try:
                nbytes += os.path.getsize(p)
            except OSError:
                pass
        self.written += 1
        # wall_s: what this save blocked the loop for (the snapshot under
        # async, snapshot + write when synchronous)
        blocking_ms = item.snapshot_ms + (0.0 if self.enabled else write_ms)
        self._emit("checkpoint", step=item.step, final=item.final,
                   wall_s=round(blocking_ms / 1000.0, 4),
                   snapshot_ms=round(item.snapshot_ms, 3),
                   write_ms=round(write_ms, 3), bytes=nbytes,
                   mb_s=(round(nbytes / 2 ** 20 / (write_ms / 1000.0), 2)
                         if write_ms > 0 and nbytes else None),
                   **{"async": self.enabled})

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._work.wait()
                if self._pending is None and self._stop:
                    return
                self._inflight, self._pending = self._pending, None
                item = self._inflight
            try:
                self._write(item)
            finally:
                with self._lock:
                    self._inflight = None


def submit(ckpt: Optional[AsyncCheckpointer], step: int,
           write_fn: Callable[[], Iterable[str]], *, final: bool = False,
           snapshot_ms: float = 0.0) -> None:
    """Save-hook helper: through the run's checkpointer when the loop
    passed one, else inline."""
    if ckpt is None:
        write_fn()
        return
    ckpt.save(step, write_fn, final=final, snapshot_ms=snapshot_ms)
