"""Language-model cross-entropy (port of mobilefinetuner_tpu/ops/loss.py:
the full-logits forms and the chunked loss; the vocab-parallel mesh path
is ROADMAP.md port item P9).

  - the HF label shift happens INSIDE, exactly once (logits[:, :-1] vs
    labels[:, 1:]): callers pass unshifted labels and must not shift;
  - IGNORE_INDEX = -100 positions add nothing and are not counted;
  - "mean" divides by the number of valid tokens;
  - the logsumexp runs in f32 whatever the logits' dtype.

The gradient is torch autograd of this forward, as the JAX package's is
jax autodiff of its own.

`chunked_lm_cross_entropy(_sum)` projects the hidden states onto the
(tied) head one sequence chunk at a time, so the full [B, S, V] logits
never exist. `impl` picks the chunk body:
  auto   on a CUDA tensor, ops/fused_ce.fused_ce_nll_sum: the fused CE
         kernels, which save O(rows) state, so no checkpoint wraps them;
         on the CPU, `plain`. (The JAX package's "auto" picks XLA
         everywhere, from a TPU measurement; that rule is not carried
         over.)
  plain  the chunk's [B, chunk, V] logits in f32 (the head cast to the
         hidden dtype, f32 products), their logsumexp and gold logit,
         under torch.utils.checkpoint so the backward recomputes them,
         as the JAX scan body runs under jax.checkpoint.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mobilefinetuner_tpu_torch.ops.fused_ce import fused_ce_nll_sum

IGNORE_INDEX = -100
LOSS_IMPLS = ("auto", "plain")
LM_HEAD_NOT_PORTED = (
    "an lm_head adapter on the chunked loss needs the fused CE head-adapter "
    "kernels (PERF.md rows 9-11: _fwd_kernel_lora, _dh_kernel_lora, "
    "_dw_kernel_lora), not ported yet (ROADMAP.md section 2)")


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


def chunk_len(S: int, num_chunks: int) -> int:
    """Length of each chunk `_shift_and_chunk` makes of a [B, S, H] input:
    the S - 1 shifted positions padded up to a multiple of num_chunks."""
    Sm1 = S - 1
    return (Sm1 + ((-Sm1) % num_chunks)) // num_chunks


def _shift_and_chunk(hidden, labels, ignore_index: int, num_chunks: int):
    """[B, S, H] -> [num_chunks, B, chunk, H] and labels to
    [num_chunks, B, chunk]: positions 0..S-2 predict labels 1..S-1, the
    pad tail is ignored."""
    B, S, H = hidden.shape
    chunk = chunk_len(S, num_chunks)
    pad = num_chunks * chunk - (S - 1)
    hidden_s = F.pad(hidden[:, :-1, :], (0, 0, 0, pad))
    labels_s = F.pad(labels[:, 1:], (0, pad), value=ignore_index)
    hs = hidden_s.reshape(B, num_chunks, chunk, H).transpose(0, 1)
    ls = labels_s.reshape(B, num_chunks, chunk).transpose(0, 1)
    return hs, ls


def validate_loss_impl(impl: str) -> str:
    if impl not in LOSS_IMPLS:
        raise ValueError(f"loss impl must be one of {LOSS_IMPLS}, got "
                         f"{impl!r}")
    return impl


def _plain_chunk(h, w, lab, ignore_index: int):
    logits = h.float() @ w.float().T           # [B, chunk, V] f32
    nll, valid = _token_nll(logits, lab, ignore_index)
    return nll.sum(), valid.sum()


def _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index: int,
                     num_chunks: int, impl: str, lora_head, mesh):
    validate_loss_impl(impl)
    if mesh is not None:
        raise NotImplementedError(
            "the vocab-parallel chunked CE over a device mesh is not "
            "ported yet (ROADMAP.md port item P9)")
    if lora_head is not None:
        raise NotImplementedError(LM_HEAD_NOT_PORTED)
    fused = impl == "auto" and hidden.device.type != "cpu"
    # the head in the compute dtype: under bf16 the products read bf16
    # operands (f32 accumulation either way)
    w = lm_head_w.to(hidden.dtype)
    hs, ls = _shift_and_chunk(hidden, labels, ignore_index, num_chunks)
    total = torch.zeros((), device=hidden.device)
    count = torch.zeros((), dtype=torch.long, device=hidden.device)
    for h, lab in zip(hs, ls):
        if fused:
            s, n = fused_ce_nll_sum(h, w, lab, ignore_index)
        else:
            s, n = torch.utils.checkpoint.checkpoint(
                _plain_chunk, h, w, lab, ignore_index, use_reentrant=False)
        total = total + s
        count = count + n
    return total, count


def chunked_lm_cross_entropy(hidden, lm_head_w, labels,
                             ignore_index: int = IGNORE_INDEX,
                             num_chunks: int = 8, impl: str = "auto",
                             lora_head=None, mesh=None) -> torch.Tensor:
    """Mean causal-LM loss without the [B, S, V] logits: hidden [B, S, H]
    final hidden states, lm_head_w [V, H] (HF layout), labels [B, S]
    unshifted. lora_head (an lm_head adapter) and mesh (the vocab-parallel
    path) raise NotImplementedError until they are ported."""
    total, count = _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index,
                                    num_chunks, impl, lora_head, mesh)
    return total / torch.clamp_min(count, 1).float()


def chunked_lm_cross_entropy_sum(hidden, lm_head_w, labels,
                                 ignore_index: int = IGNORE_INDEX,
                                 num_chunks: int = 8, impl: str = "auto",
                                 lora_head=None, mesh=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll, valid_token_count) of the chunked loss: the train step's
    accumulation form (see chunked_lm_cross_entropy)."""
    return _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index,
                            num_chunks, impl, lora_head, mesh)


def perplexity_from_loss(loss) -> float:
    """ppl = exp(mean NLL); a host float (one read of a device scalar)."""
    return math.exp(float(loss))
