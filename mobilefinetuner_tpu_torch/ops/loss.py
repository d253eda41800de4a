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
         kernels, which save O(rows) state, so no checkpoint wraps them,
         for every chunk shape they take (`use_fused_ce`, from
         ops/fused_ce.fused_ce_eligible: a Gemma-3 hidden size of 2,304
         or 2,560 is `plain`); on the CPU, `plain`. (The JAX package's
         "auto" picks XLA everywhere, from a TPU measurement; that rule
         is not carried over. Its eligibility check is.)
  plain  the chunk's [B, chunk, V] logits in f32 (the head cast to the
         hidden dtype, f32 products), their logsumexp and gold logit,
         under torch.utils.checkpoint so the backward recomputes them,
         as the JAX scan body runs under jax.checkpoint.

A LoRA adapter on the tied head (`lora_head`, {A [H, r], B [r, V],
scale}) adds scale * (h @ A) @ B to each chunk's logits: inside the
head-adapter kernels' tile loop on the `auto` route (ops/fused_ce.py rows
9-11), chunk-locally in the `plain` body, so the [B, S, V] delta never
exists either. `lora_impl` "naive" (the adapter's parity oracle, as in
models/lora_apply.py) sends an adapted head to the plain body on any
device; "auto" and "fused" leave the route to `impl` (the JAX package's
rule "kernel only under fused" is a TPU threshold and is not carried
over). Train-mode dropout on the adapter's branch input (`lora_dropout`
with an integer `dropout_seed`) drops the full hidden state once with
the site seed fold_in(seed, 2000), as the models' full-logits lm_head
sites do, and is chunked alongside it; the base logits always read the
undropped hidden state.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mobilefinetuner_tpu_torch.models.lora_apply import validate_lora_impl
from mobilefinetuner_tpu_torch.ops.dropout import fold_in, inverted_dropout
from mobilefinetuner_tpu_torch.ops.fused_ce import (fused_ce_eligible,
                                                    fused_ce_nll_sum,
                                                    head_bottleneck)

IGNORE_INDEX = -100
LOSS_IMPLS = ("auto", "plain")
# dropout site key of the lm_head adapter's branch (models' forward too)
LM_HEAD_SITE = 2000


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


def _plain_chunk(h, w, lab, ignore_index: int, hb, lora_head):
    logits = h.float() @ w.float().T           # [B, chunk, V] f32
    if lora_head is not None:
        # the adapter's chunk-local delta, (hb @ A) @ B f32-accumulated,
        # its scale folded as the kernel route folds it
        B, C, H = hb.shape
        xa, bt = head_bottleneck(hb.reshape(B * C, H), lora_head)
        logits = logits + (xa.float() @ bt.float().T).reshape(B, C, -1)
    nll, valid = _token_nll(logits, lab, ignore_index)
    return nll.sum(), valid.sum()


def use_fused_ce(hidden, lm_head_w, num_chunks: int, impl: str,
                 lora_head, lora_impl: str) -> bool:
    """Whether the chunked loss runs its chunks of hidden [B, S, H]
    against lm_head_w [V, H] on the fused CE kernels: `impl` "auto", a
    tensor off the CPU, the adapter not forced onto its naive oracle, and
    a chunk shape every kernel of its forward and backward takes
    (fused_ce_eligible, decided before any launch)."""
    if impl != "auto" or hidden.device.type == "cpu" \
            or (lora_head is not None and lora_impl == "naive"):
        return False
    B, S, H = hidden.shape
    r = 0 if lora_head is None else lora_head["A"].shape[-1]
    return fused_ce_eligible(B * chunk_len(S, num_chunks),
                             lm_head_w.shape[0], H, r, hidden.dtype,
                             head_grad=lm_head_w.requires_grad)


def _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index: int,
                     num_chunks: int, impl: str, lora_head, mesh,
                     lora_impl: str, lora_dropout: float,
                     dropout_seed: Optional[int]):
    validate_loss_impl(impl)
    validate_lora_impl(lora_impl)
    if mesh is not None:
        raise NotImplementedError(
            "the vocab-parallel chunked CE over a device mesh is not "
            "ported yet (ROADMAP.md port item P9)")
    fused = use_fused_ce(hidden, lm_head_w, num_chunks, impl, lora_head,
                         lora_impl)
    # the head in the compute dtype: under bf16 the products read bf16
    # operands (f32 accumulation either way)
    w = lm_head_w.to(hidden.dtype)
    hs, ls = _shift_and_chunk(hidden, labels, ignore_index, num_chunks)
    hbs = hs
    if lora_head is not None and lora_dropout > 0.0 \
            and dropout_seed is not None:
        dropped = inverted_dropout(hidden, lora_dropout,
                                   fold_in(dropout_seed, LM_HEAD_SITE))
        hbs, _ = _shift_and_chunk(dropped, labels, ignore_index, num_chunks)
    total = torch.zeros((), device=hidden.device)
    count = torch.zeros((), dtype=torch.long, device=hidden.device)
    for h, hb, lab in zip(hs, hbs, ls):
        if fused:
            s, n = fused_ce_nll_sum(h, w, lab, ignore_index,
                                    lora_head=lora_head, branch_hidden=hb)
        else:
            s, n = torch.utils.checkpoint.checkpoint(
                _plain_chunk, h, w, lab, ignore_index, hb, lora_head,
                use_reentrant=False)
        total = total + s
        count = count + n
    return total, count


def chunked_lm_cross_entropy(hidden, lm_head_w, labels,
                             ignore_index: int = IGNORE_INDEX,
                             num_chunks: int = 8, impl: str = "auto",
                             lora_head=None, mesh=None,
                             lora_impl: str = "auto",
                             lora_dropout: float = 0.0,
                             dropout_seed: Optional[int] = None
                             ) -> torch.Tensor:
    """Mean causal-LM loss without the [B, S, V] logits: hidden [B, S, H]
    final hidden states, lm_head_w [V, H] (HF layout), labels [B, S]
    unshifted. lora_head: an optional lm_head adapter entry; lora_impl,
    lora_dropout, dropout_seed: its route and branch dropout (module
    docstring). mesh (the vocab-parallel path) raises NotImplementedError
    until it is ported."""
    total, count = _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index,
                                    num_chunks, impl, lora_head, mesh,
                                    lora_impl, lora_dropout, dropout_seed)
    return total / torch.clamp_min(count, 1).float()


def chunked_lm_cross_entropy_sum(hidden, lm_head_w, labels,
                                 ignore_index: int = IGNORE_INDEX,
                                 num_chunks: int = 8, impl: str = "auto",
                                 lora_head=None, mesh=None,
                                 lora_impl: str = "auto",
                                 lora_dropout: float = 0.0,
                                 dropout_seed: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll, valid_token_count) of the chunked loss: the train step's
    accumulation form (see chunked_lm_cross_entropy)."""
    return _chunked_nll_sum(hidden, lm_head_w, labels, ignore_index,
                            num_chunks, impl, lora_head, mesh, lora_impl,
                            lora_dropout, dropout_seed)


def perplexity_from_loss(loss) -> float:
    """ppl = exp(mean NLL); a host float (one read of a device scalar)."""
    return math.exp(float(loss))
