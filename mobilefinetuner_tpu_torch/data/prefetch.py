"""Input pipeline with a background batch producer and a placement
lookahead (port of mobilefinetuner_tpu/data/prefetch.py).

Host work between device steps (tokenization, batch assembly, the copy
to the card) can leave the card idle. `Prefetcher` takes it off the
consumer's critical path in two stages:

  producer thread  runs the host-side batch generator into a bounded FIFO
                   queue of `depth` items. ONE thread consumes the
                   generator, so the queue order is the generator order.
  lookahead        `place_fn` (for the card: cli/common.place_batch, a
                   pinned-memory `.to(device, non_blocking=True)` copy)
                   runs for the `lookahead` items after the one being
                   returned, so their copies are queued on the stream
                   while the caller still launches step k.

Determinism: the prefetched stream yields the same batches, in the same
order, as the synchronous path: same generator, consumed in order,
placed in order. `depth=0` is the synchronous path: no thread, no
lookahead, the same interface.

Errors and shutdown: a generator that raises in the producer thread
re-raises the same exception at the consumer's `__next__`, after every
batch produced before it. `close()` (also `__exit__` and `__del__`) stops
the producer even when it waits on a full queue (it only ever waits with
a timeout and re-checks a stop event) and joins the thread.

`rss_limit_mb` > 0 is the host-memory shed guard: while the process RSS
(core/memory_guard.host_rss_mb) is above it and the consumer still has
queued batches, the producer holds off assembling the next one.

`tracer` (core/trace.Tracer, --trace_spans): each batch the producer
thread assembles lands as a `span` on the "prefetch" track, so the
exported timeline shows host batch assembly beside the device steps.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.core.memory_guard import host_rss_mb

_DONE = object()


class _Failure:
    """A producer-side exception, carried through the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterator over `source` with a background producer and a placement
    lookahead.

    source: any iterable of batches (its `__next__` is the host work that
    moves off the critical path). depth: bounded queue size; 0 disables
    both the thread and the lookahead. place_fn: per-item placement,
    applied in order, `lookahead` items ahead of the consumer.
    rss_limit_mb, rss_fn: the shed guard (module docstring); rss_fn
    stands in for host_rss_mb in tests, and a sensor that returns None
    turns the guard off. tracer: producer spans (module docstring).
    """

    def __init__(self, source: Iterable, depth: int = 2,
                 place_fn: Optional[Callable[[Any], Any]] = None,
                 lookahead: int = 1, rss_limit_mb: float = 0,
                 rss_fn: Optional[Callable[[], Optional[float]]] = None,
                 tracer=None):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self._tracer = tracer
        self._place = place_fn if place_fn is not None else (lambda x: x)
        self._lookahead = max(lookahead, 0) if depth > 0 else 0
        self._buf: collections.deque = collections.deque()
        self._exhausted = False
        self._closed = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._rss_limit = max(float(rss_limit_mb), 0.0)
        self._rss_fn = rss_fn if rss_fn is not None else host_rss_mb
        self._rss_logged = False
        self.rss_sheds = 0     # batches held back under memory pressure
        if depth > 0:
            self._q = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce, args=(source,),
                name="batch-producer", daemon=True)
            self._thread.start()
        else:
            self._it = iter(source)

    # -- producer thread -----------------------------------------------------

    def _put(self, item) -> bool:
        """A queue put that stays responsive to close(); False = stop."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _shed_on_rss(self) -> None:
        """Hold the producer while host RSS exceeds the limit and the
        consumer has queued batches to drain (a starved consumer always
        gets its next batch: shedding slows, never deadlocks)."""
        if not self._rss_limit:
            return
        rss = self._rss_fn()
        if rss is None:
            self._rss_limit = 0.0        # unreadable sensor: guard off
            return
        if rss <= self._rss_limit:
            return
        self.rss_sheds += 1
        if not self._rss_logged:
            self._rss_logged = True
            get_logger().warning(
                f"host RSS {rss:.0f} MB over the {self._rss_limit:.0f} MB "
                f"prefetch guard: holding the producer until it clears")
        while not self._stop.is_set() and self._q.qsize() > 0:
            rss = self._rss_fn()
            if rss is None or rss <= self._rss_limit:
                break
            self._stop.wait(0.02)

    def _produce(self, source):
        try:
            it = iter(source)
            n = 0
            while True:
                self._shed_on_rss()
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    self._put(_DONE)
                    return
                if self._tracer is not None:
                    self._tracer.emit_span(
                        f"produce[{n}]", "prefetch", t0,
                        (time.perf_counter() - t0) * 1000.0)
                n += 1
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - carried to the consumer
            self._put(_Failure(e))

    # -- consumer side -------------------------------------------------------

    def _get(self):
        """The next raw item, or the _DONE / _Failure marker."""
        if self._thread is None:
            try:
                return next(self._it)
            except StopIteration:
                return _DONE
            except BaseException as e:  # noqa: BLE001 - same deferral
                return _Failure(e)
        return self._q.get()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        # keep lookahead + 1 placed items: before item k is returned,
        # items k+1 .. k+lookahead are placed
        while not self._exhausted and len(self._buf) < self._lookahead + 1:
            item = self._get()
            if item is _DONE:
                self._exhausted = True
            elif isinstance(item, _Failure):
                # raised only after everything produced before it: where
                # the synchronous path would raise
                self._exhausted = True
                self._error = item.exc
            else:
                self._buf.append(self._place(item))
        if self._buf:
            return self._buf.popleft()
        err, self._error = self._error, None
        self.close()
        if err is not None:
            raise err
        raise StopIteration

    def queue_depth(self) -> int:
        """Batches buffered ahead of the consumer (the producer's queue
        plus the placed lookahead): the `step_stats.queue_depth` gauge; 0
        on the synchronous path."""
        q = self._q.qsize() if self._q is not None else 0
        return q + len(self._buf)

    # -- lifecycle -----------------------------------------------------------

    def close(self, join_timeout: float = 5.0):
        """Stop the producer and release the queue. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._buf.clear()
        if self._thread is not None:
            self._stop.set()
            try:                          # unblock a producer's full put
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=join_timeout)
            self._thread = None

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close(join_timeout=0.1)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
