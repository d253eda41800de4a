"""A step captured once as a CUDA graph and replayed, with every kernel's
launch count kept exact.

On PyTorch, the counterpart of the JAX package's programs compiled once
and replayed (`jax.jit`) is a CUDA graph: `StepGraph` runs a step's body
eagerly once (every kernel it launches is built and loaded then: nvcc
must not run inside a capture), captures it at the second call, and
replays the graph from then on. The body reads only tensors that live as
long as the graph (static buffers the caller refills with `copy_` before
each call) and writes only such tensors.

A kernel wrapper counts its launches in Python when it is called: its
`launches` int and, on some wrappers, the `by_shape` / `by_dtype`
Counters. A capture calls every wrapper while nothing runs, and a replay
calls none. So the change the counters took over the capture is taken
back out at once and added again on every replay: the counts equal those
of an eager run of the same steps. Wrappers register with `counted`.
"""

from __future__ import annotations

import collections
import gc
from typing import Callable, List, Optional

import torch

TALLIES = ("by_shape", "by_dtype")
_COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper whose `launches` (and `by_shape` /
    `by_dtype`, where it has them) StepGraph keeps exact under replay."""
    if fn not in _COUNTED:
        _COUNTED.append(fn)
    return fn


def launch_snapshot() -> list:
    """[(wrapper, launches, {tally: Counter copy})] of every registered
    wrapper, now."""
    return [(fn, fn.launches,
             {a: collections.Counter(getattr(fn, a)) for a in TALLIES
              if hasattr(fn, a)})
            for fn in _COUNTED]


def launch_delta(before: list) -> list:
    """The counters' change since `before` (a launch_snapshot), in its
    layout, wrappers that did not move left out."""
    out = []
    for fn, n, tallies in before:
        moved = {}
        for a, old in tallies.items():
            now = getattr(fn, a)
            d = {k: now.get(k, 0) - old.get(k, 0)
                 for k in set(now) | set(old)}
            moved[a] = {k: v for k, v in d.items() if v}
        if fn.launches != n or any(moved.values()):
            out.append((fn, fn.launches - n, moved))
    return out


def add_launches(delta: list, sign: int = 1) -> None:
    """Add `delta` (a launch_delta) to the counters, `sign` times; a tally
    entry that falls to 0 is removed, as if it had never counted."""
    for fn, n, tallies in delta:
        fn.launches += sign * n
        for a, d in tallies.items():
            tally = getattr(fn, a)
            for k, v in d.items():
                tally[k] += sign * v
                if not tally[k]:
                    del tally[k]


class StepGraph:
    """`body()` (no arguments; it reads and writes only tensors that
    outlive the graph) on `device`.

    On a CUDA device with `graphed`, the first call runs the body eagerly
    on a side stream (the warm-up: kernels built and loaded, lazy library
    state made), the second captures it into a CUDA graph and replays it
    (a capture runs nothing), every later call replays it. Elsewhere, or
    without `graphed`, every call runs the body eagerly: one body on every
    device. `calls` counts the calls, `captures` the captures, and
    `on_capture` is called at each; `reserved` is the device memory (bytes)
    the caching allocator reserved during the last capture, the graph's
    private pool. `reset()` drops the graph, for inputs that were
    reallocated: the next call captures again. Garbage collection is off
    while a capture runs. A capture or replay that fails raises; nothing
    falls back to the eager body."""

    def __init__(self, body: Callable[[], None], device,
                 graphed: bool = True,
                 on_capture: Optional[Callable[[], None]] = None):
        self.body = body
        self.graphed = graphed and torch.device(device).type == "cuda"
        self.on_capture = on_capture
        self.calls = 0
        self.captures = 0
        self.reserved = 0
        self._graph: Optional["torch.cuda.CUDAGraph"] = None
        self._delta: list = []
        self._warm = False

    @property
    def graph(self) -> Optional["torch.cuda.CUDAGraph"]:
        """The captured graph, None before a capture or after reset()."""
        return self._graph

    def reset(self) -> None:
        self._graph, self._delta = None, []

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        before = launch_snapshot()
        self.captures += 1
        if self.on_capture is not None:
            self.on_capture()
        # no garbage collection inside the capture: a collection that
        # frees another graph destroys it, which CUDA does not permit
        # while a stream captures (the capture fails)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a metrics or watchdog thread touching the card
            # meanwhile does not invalidate this thread's capture
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                # read after the capture's entry, which empties the cache
                reserved = torch.cuda.memory_reserved()
                self.body()
        finally:
            if collecting:
                gc.enable()
            delta = launch_delta(before)
            add_launches(delta, -1)     # the capture ran nothing
        self.reserved = torch.cuda.memory_reserved() - reserved
        self._graph, self._delta = graph, delta

    def __call__(self) -> None:
        self.calls += 1
        if not self.graphed:
            self.body()
            return
        if not self._warm:
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.body()
            cur.wait_stream(side)
            self._warm = True
            return
        if self._graph is None:
            self._capture()
        self._graph.replay()
        add_launches(self._delta)
