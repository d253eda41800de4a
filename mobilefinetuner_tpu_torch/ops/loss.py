"""Language-model cross-entropy (port of mobilefinetuner_tpu/ops/loss.py,
the full-logits forms; the chunked loss and its fused kernels come with
the Gemma slice, ROADMAP.md port item P3).

  - the HF label shift happens INSIDE, exactly once (logits[:, :-1] vs
    labels[:, 1:]): callers pass unshifted labels and must not shift;
  - IGNORE_INDEX = -100 positions add nothing and are not counted;
  - "mean" divides by the number of valid tokens;
  - the logsumexp runs in f32 whatever the logits' dtype.

The gradient is torch autograd of this forward, as the JAX package's is
jax autodiff of its own.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

IGNORE_INDEX = -100


def _token_nll(logits, labels, ignore_index: int):
    """Per-token NLL (f32) and validity mask, no shift."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, lse - gold, 0.0), valid


def _shifted(logits, labels, ignore_index):
    return _token_nll(logits[:, :-1, :], labels[:, 1:], ignore_index)


def lm_cross_entropy(logits, labels, ignore_index: int = IGNORE_INDEX,
                     reduction: str = "mean"):
    """Causal-LM loss over UNSHIFTED labels [B, S] for logits [B, S, V]:
    a scalar for "mean"/"sum", [B, S-1] for "none"."""
    nll, valid = _shifted(logits, labels, ignore_index)
    if reduction == "none":
        return nll
    total = nll.sum()
    if reduction == "sum":
        return total
    return total / torch.clamp_min(valid.sum(), 1)


def lm_cross_entropy_sum(logits, labels, ignore_index: int = IGNORE_INDEX
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll, valid_token_count): the train step's accumulation form."""
    nll, valid = _shifted(logits, labels, ignore_index)
    return nll.sum(), valid.sum()


def lm_cross_entropy_rows(logits, labels, ignore_index: int = IGNORE_INDEX
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (sum_nll [B], valid_token_count [B])."""
    nll, valid = _shifted(logits, labels, ignore_index)
    return nll.sum(-1), valid.sum(-1)


def lm_cross_entropy_with_count(logits, labels,
                                ignore_index: int = IGNORE_INDEX
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_loss, valid_token_count), for token-weighted evaluation."""
    nll, valid = _shifted(logits, labels, ignore_index)
    count = valid.sum()
    return nll.sum() / torch.clamp_min(count, 1), count


def perplexity_from_loss(loss) -> float:
    """ppl = exp(mean NLL); a host float (one read of a device scalar)."""
    return math.exp(float(loss))
