"""Where the port's entry points run.

Every entry point (`ServeEngine`, `serve.bench.build_engine`,
`models.gpt2.init_params`, the `convert` functions) takes a `device`.
`None` means the CUDA card; when there is none they raise rather than
carry on on the CPU, so a run that was meant for the card can never
silently measure the host. The CPU is always an explicit choice
(`device="cpu"`), as the tests make it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` -> the current CUDA device, or RuntimeError without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' explicitly to "
            "run on the host (the port's entry points default to the card)")
    return torch.device("cuda", torch.cuda.current_device())
