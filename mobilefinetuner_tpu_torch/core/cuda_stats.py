"""Device-memory readings for the train loop and the admission preflight
(the port's counterpart of mobilefinetuner_tpu/core/xla_stats.py, whose
XLA memory analysis has no PyTorch equivalent: nothing is compiled ahead).

`memory_stat` reads one key of `torch.cuda.memory_stats`; `live_hbm_mb`
is the bytes the caching allocator holds for live tensors
(`step_stats.hbm_mb`); `peak_hbm_mb` the most it held since the last
`reset_peak`. A CPU device has no such reading: every function returns
None for it, never 0, so a stream never shows "nothing allocated" where
the truth is "this device cannot say".
"""

from __future__ import annotations

from typing import Optional

import torch


def _cuda(device) -> Optional[torch.device]:
    """`device` as a CUDA device (None = the current card), or None when
    it is not one or no card is present."""
    if device is None:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_available() else None)
    device = torch.device(device)
    return device if device.type == "cuda" else None


def memory_stat(device, key: str, default=None):
    """One guarded read of `torch.cuda.memory_stats(device)[key]`: a
    missing or non-numeric entry, or a device that is not a card, gives
    `default`, never an exception."""
    dev = _cuda(device)
    if dev is None:
        return default
    try:
        v = torch.cuda.memory_stats(dev).get(key, default)
    except (RuntimeError, AssertionError):
        return default
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    return v


def live_hbm_mb(device=None) -> Optional[float]:
    """MB the caching allocator holds for live tensors on `device` (None
    on a CPU device)."""
    v = memory_stat(device, "allocated_bytes.all.current")
    return None if v is None else v / 2 ** 20


def peak_hbm_mb(device=None) -> Optional[float]:
    """The most MB held for live tensors since the last `reset_peak`
    (None on a CPU device)."""
    v = memory_stat(device, "allocated_bytes.all.peak")
    return None if v is None else v / 2 ** 20


def reset_peak(device=None) -> None:
    """Start a new peak window on `device` (no-op off the card)."""
    dev = _cuda(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)


def free_and_total_mb(device=None):
    """(free MB, total MB) of the card as the CUDA driver reports it
    (`mem_get_info`: other processes' memory too), or (None, None)."""
    dev = _cuda(device)
    if dev is None:
        return None, None
    free, total = torch.cuda.mem_get_info(dev)
    return free / 2 ** 20, total / 2 ** 20
