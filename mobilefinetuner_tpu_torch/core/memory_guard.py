"""Device-memory admission (port of mobilefinetuner_tpu/core/memory_guard.py,
the serving part: `MemoryAdmissionError`, `MemCheck`, `analytic_check`).

The serve engine sums params + adapter bank + KV pools before it
allocates anything and refuses a config that cannot fit. Capacity comes
from `hbm_cap_mb` when given (the tests drive the verdict with it), else
from `torch.cuda.mem_get_info()` on a CUDA device; a CPU device without an
override has no capacity to compare against, so its verdict is
"unknown" and admission never refuses on a guess. The compiled-program
`preflight` and the training degradation ladder come with the training
slice. `host_rss_mb` is the host-side signal of data/prefetch.py's shed
guard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


class MemoryAdmissionError(RuntimeError):
    """A config that cannot fit device memory was refused before anything
    was allocated."""

    def __init__(self, message: str, check: "MemCheck" = None):
        super().__init__(message)
        self.check = check


def device_capacity_mb(override_mb: float = 0, device=None
                       ) -> Tuple[Optional[float], str]:
    """(capacity MB or None, source): "flag" for the override,
    "mem_get_info" for a CUDA device, "unknown" otherwise."""
    if override_mb:
        return float(override_mb), "flag"
    if device is not None and torch.device(device).type == "cuda":
        _, total = torch.cuda.mem_get_info(torch.device(device))
        return total / 2 ** 20, "mem_get_info"
    return None, "unknown"


@dataclasses.dataclass
class MemCheck:
    """One admission verdict."""
    est_mb: Optional[float]
    cap_mb: Optional[float]
    verdict: str                   # "ok" | "over" | "unknown"
    headroom: float = 0.1
    cap_source: str = "unknown"

    def describe(self) -> str:
        est = f"{self.est_mb:.0f} MB" if self.est_mb else "unknown"
        cap = (f"{self.cap_mb:.0f} MB ({self.cap_source})"
               if self.cap_mb else "unknown")
        return (f"estimated {est} vs capacity {cap} under "
                f"{self.headroom:.0%} headroom -> {self.verdict}")


def _verdict(est_mb: Optional[float], cap_mb: Optional[float],
             headroom: float) -> str:
    if not est_mb or not cap_mb:
        return "unknown"
    return "over" if est_mb > cap_mb * (1.0 - headroom) else "ok"


def analytic_check(est_mb: float, cap_mb: float = 0, headroom: float = 0.1,
                   device=None) -> MemCheck:
    """Admission check from an analytic estimate, computed before anything
    is allocated so a refusal costs nothing."""
    cap, source = device_capacity_mb(override_mb=cap_mb, device=device)
    return MemCheck(est_mb=float(est_mb), cap_mb=cap,
                    verdict=_verdict(est_mb, cap, headroom),
                    headroom=headroom, cap_source=source)


def host_rss_mb() -> Optional[float]:
    """This process's resident set size in MB (Linux /proc/self/statm;
    None where unavailable): the pressure signal the prefetch producer's
    shed guard reads before the OS OOM-killer picks a victim."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20
    except (OSError, ValueError, IndexError):
        return None
