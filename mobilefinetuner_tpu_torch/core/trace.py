"""Host-span tracing and anomaly-triggered profiler capture (port of
mobilefinetuner_tpu/core/trace.py: `Tracer`, `AutoProfiler`).

The telemetry stream (core/telemetry.py) records WHAT happened; this
module records WHEN: `span` events carry a monotonic begin stamp and a
duration on a named TRACK, so a whole run — the goodput meter's phases,
the serve loop's per-request queue/prefill/decode lifecycle, the
async-checkpoint writer thread, the prefetch producer — renders as one
timeline after `tools/trace_export.py` converts the stream. Spans ride
the same crash-durable JSONL stream as every other event (one `span`
record per completed span, emitted at span end).

Clock discipline: span `t0` uses time.perf_counter(), the clock of the
telemetry envelope's `t_mono` stamp, so the exporter places spans on the
wall-clock timeline via the per-host (t - t_mono) offset.

Span emission is opt-in (--trace_spans / ServeConfig.trace_spans).
Everything on the Tracer path is host-side: no device access.

`AutoProfiler` (--auto_profile) is the flight recorder: a one-shot
torch.profiler capture (CPU and CUDA activities) armed when a sensor
fires — a slow step, a loss spike or divergence, the hang watchdog
before an abort — under a capture budget and a cooldown. Each capture
lands in its own directory as a gzip Chrome trace named
`<capture>.trace.json.gz`, the name `tools/trace_export.py --profile
<dir>` looks for, and each completed capture is a `profile_capture`
event. One process holds one torch.profiler at a time: the caller keeps
its other profiling windows apart from a capture.
"""

from __future__ import annotations

import contextlib
import gzip
import os
import shutil
import threading
import time
from typing import Callable, Optional


def write_chrome_trace_gz(prof, path: str) -> str:
    """A finished torch.profiler session's Chrome trace, gzipped to
    `path` (written beside it first, then compressed and removed)."""
    raw = path[:-3] if path.endswith(".gz") else path + ".json"
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as fin, gzip.open(path, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    os.remove(raw)
    return path


class Tracer:
    """Span emitter over a telemetry sink (`Telemetry.emit` signature).

    One emit site for the whole repo: every producer — the goodput
    meter, the serve engine, the checkpoint writer, the prefetch
    producer — routes through `emit_span`, so the `span` event shape
    cannot fork between threads or subsystems. Thread-safety is the
    sink's problem (Telemetry.emit is lock-serialized), which is what
    lets the checkpoint writer and prefetch producer threads trace
    through the same stream as the step loop.
    """

    def __init__(self, sink: Optional[Callable] = None,
                 enabled: bool = True):
        self._sink = sink
        self.enabled = bool(sink) and enabled

    def emit_span(self, name: str, track: str, t0: float, dur_ms: float,
                  **extra) -> None:
        """Record one completed span: `t0` is a time.perf_counter()
        stamp (the envelope's t_mono clock), dur_ms its length. Extra
        fields ride along (the schema is a floor)."""
        if not self.enabled:
            return
        self._sink(event="span", name=name, track=track,
                   t0=round(t0, 6), dur_ms=round(dur_ms, 3), **extra)

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **extra):
        """Lexical span: emits on exit, exception or not (the span that
        raised is exactly the one a post-mortem wants on the timeline)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit_span(name, track, t0,
                           (time.perf_counter() - t0) * 1000.0, **extra)


class AutoProfiler:
    """One-shot anomaly-triggered torch.profiler capture (--auto_profile).

    State machine: IDLE -> (sensor trigger, budget left, cooldown
    elapsed) -> CAPTURING (a profiler started for its own subdirectory;
    the step loop calls `tick` after each step and the capture stops
    after `steps` of them, syncing the device first so the trace holds
    the launched work) -> COOLDOWN.
    A `profile_capture` event records every completed capture — step,
    trigger kind, path, budget left — so the stream says where the
    trace of the bad step lives.

    The hang path is different: when the watchdog fires, the step loop
    is by definition not ticking, so `capture_now` takes a bounded
    capture on the CALLER's thread (start, hold, stop) — whatever the
    device is doing while wedged lands in the trace, before a
    --watchdog 2 abort can os._exit.

    `profiler_start`/`profiler_stop` are injectable so tests never
    depend on the profiler; the default binds lazily to
    torch.profiler.profile (nothing is imported at module load) and
    writes `<path>/<basename>.trace.json.gz` at the stop. Failures
    inside the profiler NEVER propagate — a broken capture must not
    kill the training run it was meant to diagnose.

    Thread-safety: `capture_now` runs on the WATCHDOG thread while
    `trigger`/`tick` run on the step loop, so every state transition is
    lock-serialized — without it, a loop that unwedges during a hang
    capture's hold could tick the hold capture to a premature stop and
    double-finish it (and two threads could double-start the one
    profiler). The lock is held across `capture_now`'s bounded hold:
    blocking a just-unwedged loop for the hold is noise next to the
    stall that fired the watchdog, and it is what keeps the profiler
    single-owner.
    """

    def __init__(self, out_dir: str, sink: Optional[Callable] = None,
                 steps: int = 2, cooldown_s: float = 300.0,
                 budget: int = 2,
                 profiler_start: Optional[Callable[[str], None]] = None,
                 profiler_stop: Optional[Callable[[], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.out_dir = out_dir
        self._sink = sink
        self.steps = max(int(steps), 1)
        self.cooldown_s = float(cooldown_s)
        self.budget = max(int(budget), 0)
        self._clock = clock
        self._lock = threading.Lock()
        self._start = profiler_start or self._torch_start
        self._stop = profiler_stop or self._torch_stop
        self._prof = None      # the default profiler's live session
        self._prof_path: Optional[str] = None
        self._last_capture_t: Optional[float] = None
        self._active_path: Optional[str] = None
        self._steps_left = 0
        self._trigger: Optional[str] = None
        self._n = 0
        self.captured = 0  # completed captures (test observable)

    def _torch_start(self, path: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        self._prof, self._prof_path = prof, path

    def _torch_stop(self) -> None:
        prof, path = self._prof, self._prof_path
        self._prof = self._prof_path = None
        if prof is None:
            return
        prof.__exit__(None, None, None)
        write_chrome_trace_gz(prof, os.path.join(
            path, os.path.basename(path) + ".trace.json.gz"))

    @property
    def active(self) -> bool:
        return self._active_path is not None

    def _ready(self) -> bool:
        if self.active or self.budget <= 0:
            return False
        if self._last_capture_t is not None and \
                self._clock() - self._last_capture_t < self.cooldown_s:
            return False
        return True

    def _capture_path(self, trigger: str, step: int) -> str:
        path = os.path.join(self.out_dir,
                            f"cap{self._n}_{trigger}_step{step}")
        self._n += 1
        return path

    def trigger(self, kind: str, step: int) -> bool:
        """A sensor fired: start a capture unless one is active, the
        budget is spent, or the cooldown has not elapsed. Returns True
        exactly when a capture STARTED."""
        with self._lock:
            if not self._ready():
                return False
            path = self._capture_path(kind, step)
            try:
                os.makedirs(path, exist_ok=True)
                self._start(path)
            except Exception:
                return False  # a broken profiler must not kill the run
            self._active_path = path
            self._trigger = kind
            self._steps_left = self.steps
            return True

    def tick(self, step: int, sync: Optional[Callable] = None) -> bool:
        """One step completed under an active capture; stops the trace
        after `steps` ticks (running `sync` first so the async-
        dispatched device work is actually IN the window). Returns True
        when the capture completed on this tick."""
        with self._lock:
            if not self.active:
                return False
            self._steps_left -= 1
            if self._steps_left > 0:
                return False
            if sync is not None:
                try:
                    sync()
                except Exception:
                    pass
            return self._finish(step, steps=self.steps)

    def capture_now(self, kind: str, step: int,
                    hold_s: float = 1.0) -> bool:
        """Bounded immediate capture for callers with no step loop to
        tick — the hang watchdog's pre-exit hook: start, hold while the
        wedged device does whatever it is doing, stop, record. Never
        raises. Holds the lock for the whole start-hold-stop so the
        step loop can never tick this capture to a premature stop."""
        with self._lock:
            if not self._ready():
                return False
            path = self._capture_path(kind, step)
            try:
                os.makedirs(path, exist_ok=True)
                self._start(path)
            except Exception:
                return False
            self._active_path, self._trigger = path, kind
            time.sleep(max(hold_s, 0.0))
            # steps=None: a bounded hold, not a counted step window
            # (the schema documents exactly this)
            return self._finish(step, steps=None)

    def _finish(self, step: int, steps) -> bool:
        # caller holds self._lock; `steps` is what the capture ACTUALLY
        # covered (None for the hang path's bounded hold), not the
        # configured window — a close() mid-capture reports the steps
        # that ran, so post-mortem tooling never overstates the trace
        path, trigger = self._active_path, self._trigger
        try:
            self._stop()
        except Exception:
            self._active_path = None
            return False
        self._active_path = None
        self._last_capture_t = self._clock()
        self.budget -= 1
        self.captured += 1
        if self._sink is not None:
            self._sink(event="profile_capture", step=step,
                       trigger=trigger, path=path, steps=steps,
                       budget_left=self.budget)
        return True

    def close(self) -> None:
        """Stop a capture left open by an exiting loop (the trace of
        the steps that DID run is still worth keeping — and reported
        with the tick count that actually elapsed)."""
        with self._lock:
            if self.active:
                self._finish(-1, steps=self.steps - self._steps_left)
