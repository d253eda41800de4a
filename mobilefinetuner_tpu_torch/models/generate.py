"""Serving programs for GPT-2 (port of mobilefinetuner_tpu/models/
generate.py: `gpt2_prefill` and `gpt2_decode_step_paged`; contiguous
generate(), chunked prefill, sampling and Gemma-3 come with later slices).

Serve sequences start at position 0 with no padding inside (the engine
right-pads only the prompt tail), so a slot's attendable columns are
simply col <= pos.

The pools are updated IN PLACE: the decode step scatters the fed token's
K/V into its page before attending (write before read, on one stream),
where the JAX engine donated the pool buffers to a functional update.
Idle slots all write trash page 0 at offset 0; which duplicate wins is
unspecified, and no live slot ever reads that page.
"""

from __future__ import annotations

import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops.attention import validate_attn_impl
from mobilefinetuner_tpu_torch.ops.decode_attention import (
    paged_attention, paged_decode_attention)

NEG_INF = -1e30


def _head_lora(logits, h, lora_b):
    """An optional "lm_head" adapter entry at a logits projection site."""
    if lora_b is None or "lm_head" not in lora_b:
        return logits
    return maybe_lora(logits, h, lora_b["lm_head"], None)


def gpt2_prefill(config: GPT2Config, params, input_ids, attention_mask,
                 compute_dtype=torch.float32, lora=None,
                 attn_impl: str = "auto"):
    """[B, P] right-padded prompts -> (next-token logits [B, V] f32 at each
    row's last real position, (k, v) caches [L, B, H, P, D]). attn_impl as
    in ops.attention.attention."""
    x, (pk, pv) = gpt2.hidden_states(
        config, params, input_ids, attention_mask, lora=lora,
        compute_dtype=compute_dtype, collect_kv=True, attn_impl=attn_impl)
    n_real = attention_mask.sum(-1).long()
    last = x[torch.arange(x.shape[0], device=x.device), n_real - 1]
    logits = last @ params["wte"].to(compute_dtype).T
    lora_b = None if lora is None else lora.get("blocks")
    logits = _head_lora(logits, last, lora_b)
    return logits.float(), (pk, pv)


def gpt2_decode_step_paged(config: GPT2Config, params, pool_k, pool_v,
                           tok, pos, tbl, lora=None,
                           compute_dtype=torch.float32,
                           attn_impl: str = "auto"):
    """One continuous-batching decode step over the paged KV pools.

    pool_k/pool_v [NB, L, H, bT, D] (updated in place); tok [S] the token
    each slot feeds; pos [S] its cache position; tbl [S, M] int32 block
    tables (idle slots -> trash block 0). Returns (logits [S, V] f32,
    pool_k, pool_v).

    attn_impl: "auto" = paged_decode_attention (the kernel for CUDA pools,
    or ValueError for pools it does not take; the plain version for CPU
    pools), "plain" = paged_attention on any device."""
    validate_attn_impl(attn_impl)
    S, M = tbl.shape
    NB, L, H, bT, D = pool_k.shape
    E = config.n_embd
    eps = config.layer_norm_epsilon
    lora_b = None if lora is None else lora.get("blocks")
    attend = paged_attention if attn_impl == "plain" \
        else paged_decode_attention

    x = (params["wte"][tok].to(compute_dtype)
         + params["wpe"][pos].to(compute_dtype))              # [S, E]
    cols = torch.arange(M * bT, device=pos.device)
    ok = cols[None, :] <= pos[:, None]                        # [S, M*bT]
    blk = tbl[torch.arange(S, device=tbl.device), pos // bT].long()
    off = pos % bT

    for i in range(L):
        bp = gpt2.layer_params(params, i, compute_dtype)
        h = gpt2.layer_norm(x, bp["ln_1"]["g"], bp["ln_1"]["b"], eps)
        q, k, v = gpt2.qkv_proj(config, bp, h, lora_b, i).split(E, dim=-1)
        q, k, v = (t.reshape(S, H, D) for t in (q, k, v))
        # write before read: the fed token's K/V land in its current page
        pool_k[blk, i, :, off, :] = k.to(pool_k.dtype)
        pool_v[blk, i, :, off, :] = v.to(pool_v.dtype)
        ctx = attend(q[:, :, None, :].contiguous(), pool_k, pool_v, tbl, i,
                     ok, D ** -0.5)
        ctx = ctx.reshape(S, E).to(compute_dtype)
        x = gpt2.mlp_and_proj(bp, x, ctx, lora_b, i, eps)
    x = gpt2.layer_norm(x, params["ln_f"]["g"].to(compute_dtype),
                        params["ln_f"]["b"].to(compute_dtype), eps)
    logits = x @ params["wte"].to(compute_dtype).T
    logits = _head_lora(logits, x, lora_b)
    return logits.float(), pool_k, pool_v
