"""Device-memory admission (port of mobilefinetuner_tpu/core/memory_guard.py:
`MemoryAdmissionError`, `MemCheck`, `preflight`, `analytic_check`, the
degradation ladder's `LADDER` and `is_resource_exhausted`).

An admission decision is made before anything expensive happens: the
serve engine sums params + adapter bank + KV pools before it allocates
them, and the train loop judges its step before the data stream exists.

  est_mb   the JAX package judges XLA's memory analysis of the compiled
           step. Eager PyTorch compiles nothing ahead, so the port's
           estimate is analytic, from shapes alone and the same on the
           CPU and on the card (`train_step_estimate_mb`): the resident
           trees, the gradients, the new trees and the per-leaf
           temporaries of the functional Adam update, the weights cast
           to the compute dtype, the activations (every layer's, or under
           remat each layer's input plus one layer's) and the loss
           buffers. It is a sum of parts that do not all live at once,
           so it stays at or above the measured peak of a step; plus the
           live device bytes that the step's own trees do not account
           for (another allocation, a ballast).
  cap_mb   `hbm_cap_mb` when given (the tests drive the verdict with it),
           else the card's total from `torch.cuda.mem_get_info`; a CPU
           device without an override has no capacity to compare against.
  verdict  "over" when est_mb exceeds cap_mb under the headroom margin,
           "ok" when it fits, "unknown" when either side is missing:
           admission never refuses on a guess.

`host_rss_mb` is the host-side signal of data/prefetch.py's shed guard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from mobilefinetuner_tpu_torch.core import cuda_stats


class MemoryAdmissionError(RuntimeError):
    """A config that cannot fit device memory was refused: at preflight
    (nothing ran), at serve build, or after the degradation ladder ran
    dry (`ladder` records every rung attempted)."""

    def __init__(self, message: str, check: "MemCheck" = None,
                 ladder: Tuple[str, ...] = ()):
        super().__init__(message)
        self.check = check
        self.ladder = tuple(ladder)


# The ordered, bounded degradation ladder: cheapest semantic change
# first. remat recomputes identical math; accum x2 halves the micro-batch
# at a constant global batch (only float reassociation moves, <= 1e-5);
# offload (ROADMAP.md port item P9) changes placement, not values.
LADDER = ("remat", "accum_x2", "offload")


def device_capacity_mb(override_mb: float = 0, device=None
                       ) -> Tuple[Optional[float], str]:
    """(capacity MB or None, source): "flag" for the override,
    "mem_get_info" for a CUDA device, "unknown" otherwise."""
    if override_mb:
        return float(override_mb), "flag"
    _, total = cuda_stats.free_and_total_mb(device) \
        if device is not None else (None, None)
    if total:
        return total, "mem_get_info"
    return None, "unknown"


@dataclasses.dataclass
class MemCheck:
    """One admission verdict. `event()` is the `mem_check` telemetry
    payload; `describe()` the line the error or the log carries."""
    est_mb: Optional[float]
    cap_mb: Optional[float]
    verdict: str                   # "ok" | "over" | "unknown"
    phase: str = "preflight"       # preflight | dispatch | serve_build
    headroom: float = 0.1
    live_mb: Optional[float] = None       # live device MB at the check
    cap_source: str = "unknown"

    @property
    def cap_frac(self) -> Optional[float]:
        if not self.est_mb or not self.cap_mb:
            return None
        return round(self.est_mb / self.cap_mb, 4)

    def event(self) -> dict:
        return {"est_mb": round(self.est_mb, 2) if self.est_mb else None,
                "cap_mb": round(self.cap_mb, 2) if self.cap_mb else None,
                "verdict": self.verdict, "phase": self.phase,
                "headroom": self.headroom, "cap_frac": self.cap_frac,
                # the JAX event's XLA memory-analysis peak: nothing is
                # compiled ahead here
                "compiled_mb": None,
                "live_mb": (round(self.live_mb, 2)
                            if self.live_mb is not None else None),
                "cap_source": self.cap_source}

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


def preflight(est_mb: float, resident_mb: float = 0.0, cap_mb: float = 0,
              headroom: float = 0.1, device=None,
              phase: str = "preflight") -> MemCheck:
    """Admission check of a step whose analytic estimate (which already
    counts the resident trees, `resident_mb`) is `est_mb`, plus the live
    device bytes beyond those trees, against the capacity under the
    headroom margin."""
    live = cuda_stats.live_hbm_mb(device) if device is not None else None
    extra = max(live - resident_mb, 0.0) if live is not None else 0.0
    est = est_mb + extra
    cap, source = device_capacity_mb(override_mb=cap_mb, device=device)
    return MemCheck(est_mb=est, cap_mb=cap,
                    verdict=_verdict(est, cap, headroom), phase=phase,
                    headroom=headroom, live_mb=live, cap_source=source)


def analytic_check(est_mb: float, cap_mb: float = 0, headroom: float = 0.1,
                   device=None, phase: str = "serve_build") -> MemCheck:
    """Admission check from an analytic estimate, computed before anything
    is allocated so a refusal costs nothing."""
    cap, source = device_capacity_mb(override_mb=cap_mb, device=device)
    return MemCheck(est_mb=float(est_mb), cap_mb=cap,
                    verdict=_verdict(est_mb, cap, headroom), phase=phase,
                    headroom=headroom, cap_source=source)


def is_resource_exhausted(err: BaseException) -> bool:
    """True for the card's out-of-memory error (the caching allocator's
    `torch.cuda.OutOfMemoryError`) and for the status text the JAX
    package matches (its injected simulation raises it on the CPU): the
    dispatch signal the degradation ladder treats as a failed admission
    rather than a crash."""
    return (isinstance(err, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(err))


# --------------------------- the step's analytic estimate --------------------

_MB = 2 ** 20
# allocations no tree accounts for: the matmul library's workspace, the
# allocator's 512-byte rounding, the step's scalars
_SLACK_BYTES = 64 * _MB


@dataclasses.dataclass(frozen=True)
class Footprint:
    """A model's memory per token of a micro-batch, by the part of the
    step that holds it (bytes)."""
    n_layers: int
    act_bytes: float          # one layer's saved activations, a token
    layer_in_bytes: float     # one layer's input, a token (remat keeps it)
    loss_bytes: float         # the loss's buffers, a token
    loss_fixed_bytes: float = 0.0   # loss buffers independent of tokens


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def gpt2_footprint(config, compute_dtype: torch.dtype,
                   seq_len: int) -> Footprint:
    """GPT-2: per layer and token, the block's saved tensors in the
    compute dtype (layer norms, qkv, attention out, projections, the
    4x MLP and its GELU, with room for the LoRA branches) plus the plain
    attention's f32 scores and probabilities over the sequence (the flash
    kernels keep only the lse, so on the card this over-counts), the
    dropout masks and the norms' f32 statistics; the loss holds the
    [tokens, V] logits in the compute dtype, their f32 copy, the
    softmax and its gradient."""
    c = _itemsize(compute_dtype)
    d, H, V = config.n_embd, config.n_head, config.vocab_size
    act = c * 28 * d + 8 * d + H * seq_len * (8 + c) + 64
    return Footprint(n_layers=config.n_layer, act_bytes=act,
                     layer_in_bytes=c * d, loss_bytes=V * (2 * c + 12))


def gemma3_footprint(config, compute_dtype: torch.dtype, seq_len: int,
                     loss_chunks: int, head_trains: bool) -> Footprint:
    """Gemma-3: per layer and token, the block's saved tensors (four
    RMS norms, q / k / v with their norms and rotary outputs, attention
    out, o, the gated MLP's gate / up / GELU / product / down) in the
    compute dtype, the plain attention's f32 scores and probabilities and
    the norms' f32 statistics; the chunked loss holds one chunk's f32
    logits, softmax and gradient (the plain body; the fused kernels hold
    O(rows)), and a trained tied head two [V, H] f32 gradients while the
    chunks' contributions add up."""
    c = _itemsize(compute_dtype)
    h, I, V = config.hidden_size, config.intermediate_size, config.vocab_size
    qkv = (config.num_attention_heads + 2 * config.num_key_value_heads) \
        * config.head_dim
    act = (c * (10 * h + 6 * qkv + 6 * I)
           + config.num_attention_heads * seq_len * (8 + c) + 64)
    return Footprint(
        n_layers=config.num_hidden_layers, act_bytes=act,
        layer_in_bytes=c * h, loss_bytes=12 * V / max(loss_chunks, 1),
        loss_fixed_bytes=(8 * V * h if head_trains else 0.0))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None and hasattr(tree, "element_size"):
        yield tree


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensor leaves."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def train_step_estimate_mb(fp: Footprint, *, trainable, frozen, opt_state,
                           micro_batch: int, seq_len: int, remat: bool,
                           compute_dtype: torch.dtype) -> float:
    """The analytic peak of one optimizer step (MB): falls strictly when
    remat turns on (L layer inputs + one layer's activations < L layers'
    activations) and when the micro-batch halves."""
    tb, fb, ob = tree_bytes(trainable), tree_bytes(frozen), \
        tree_bytes(opt_state)
    leaves = list(_leaves(trainable))
    grad_f32 = sum(4 * t.numel() for t in leaves)
    largest = max((4 * t.numel() for t in leaves), default=0)
    n_params = sum(t.numel() for t in leaves) \
        + sum(t.numel() for t in _leaves(frozen))
    c = _itemsize(compute_dtype)
    casts = n_params * c if c < 4 else 0
    tokens = micro_batch * seq_len
    if remat:
        acts = tokens * (fp.n_layers * fp.layer_in_bytes + fp.act_bytes)
    else:
        acts = tokens * fp.n_layers * fp.act_bytes
    total = (tb + fb + ob            # resident trees
             + 3 * grad_f32          # accumulated, averaged, clipped grads
             + tb + ob               # the update's new trees
             + 4 * largest           # the update's per-leaf temporaries
             + casts + acts
             + tokens * fp.loss_bytes + fp.loss_fixed_bytes
             + 2 * tokens * 20       # the placed batch and its lookahead
             + _SLACK_BYTES)
    return total / _MB


def eval_estimate_mb(fp: Footprint, *, params, rows: int, seq_len: int,
                     compute_dtype: torch.dtype,
                     head_rows_bytes: float = 0.0) -> float:
    """The analytic peak of one no-grad forward over [rows, seq_len] (MB):
    the weights and their compute-dtype cast, one layer's activations at a
    time, the loss buffers (or `head_rows_bytes` for a head over a few
    rows only)."""
    c = _itemsize(compute_dtype)
    n = sum(t.numel() for t in _leaves(params))
    tokens = rows * seq_len
    total = (tree_bytes(params) + (n * c if c < 4 else 0)
             + tokens * (fp.act_bytes + fp.layer_in_bytes)
             + (tokens * fp.loss_bytes if not head_rows_bytes
                else head_rows_bytes)
             + _SLACK_BYTES)
    return total / _MB


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
