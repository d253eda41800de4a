"""Preemption drain: SIGTERM / SIGINT become an orderly last-step save
(port of mobilefinetuner_tpu/core/preempt.py).

`PreemptionGuard` turns the signal into a flag that
cli/common.run_training checks at every step boundary: the step in
flight completes, the metrics flush, one final atomic checkpoint lands
(the drain waits for the write), the stream ends with `run_end`
{exit="preempted", reason="preempted"}, and the process exits with
`EXIT_PREEMPTED`, a resumable code distinct from a crash. A second
signal during the drain raises KeyboardInterrupt: the operator outranks
a wedged save.
"""

from __future__ import annotations

import signal
from typing import Dict, Optional, Tuple

# EX_TEMPFAIL, "temporary failure, retry later": the resumable exit
EXIT_PREEMPTED = 75


class PreemptionGuard:
    """Signal handler -> drain flag. Installs only on the main thread
    (Python's rule for `signal.signal`); elsewhere `installed` stays
    False and the caller keeps the default behaviour. `uninstall()`
    restores the previous handlers, so several runs in one process never
    stack handlers."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = signals
        self.triggered = False
        self.signal_name: Optional[str] = None
        self.installed = False
        self._prev: Dict[int, object] = {}

    def _handler(self, signum, frame):
        if self.triggered:
            raise KeyboardInterrupt(
                f"second {signal.Signals(signum).name} during drain")
        self.triggered = True
        self.signal_name = signal.Signals(signum).name

    def install(self) -> "PreemptionGuard":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self.installed = True
        except ValueError:
            # not the main thread: put back what was installed
            self.uninstall()
        return self

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError, OSError):
                pass
        self._prev.clear()
        self.installed = False
