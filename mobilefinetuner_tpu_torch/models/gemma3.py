"""Gemma-3 text decoder in PyTorch (port of mobilefinetuner_tpu/models/
gemma3.py: training and inference forward, and the K/V collection of the
generate prefill; offload and sequence parallelism are not ported,
ROADMAP.md port item P9).

Parameters keep the JAX package's names and stacked [L, ...] layout,
linear weights [in, out], as a nested dict of tensors:

    {"embed": [V, H],
     "blocks": {"input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln":
                [L, H], "attn": {"q_w", "k_w", "v_w", "o_w", "q_norm",
                "k_norm"}, "mlp": {"gate_w", "up_w", "down_w"}},
     "final_norm": [H]}

so `convert.gemma3_params_from_numpy` carries a JAX tree over unchanged.
Per block: sandwich norms (input_ln -> attention -> post_attn_ln ->
residual; pre_ffn_ln -> gelu_tanh(gate) * up -> down -> post_ffn_ln ->
residual), RMSNorm with (1 + w) in f32, per-head q/k RMSNorm before RoPE,
GQA, the query scale query_pre_attn_scalar ** -0.5. The JAX model picks
each layer's RoPE table and mask with a traced bool under its layer scan;
here the choice is plain Python per layer from `layer_types`: global
layers use `rope_theta` and full causal attention, local ones
`rope_local_base_freq` and the `sliding_window`. The lm_head is tied to
the embedding table.

LoRA enters through `lora=` at 7 sites a layer, site ids 0-6 (q, k, v, o,
gate, up, down) as in the JAX `_block`; `dropout_seed` (an int,
ops/dropout.py) turns on LoRA dropout, each site's seed folded from the
layer's. `attn_impl` reaches the flash kernels through ops/attention.py
(D = 256, GQA, the window), `lora_impl` the epilogue kernel through
models/lora_apply.py. `remat` recomputes each block in the backward
(torch.utils.checkpoint).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mobilefinetuner_tpu_torch.core.config import Gemma3TextConfig
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops.attention import attention
from mobilefinetuner_tpu_torch.ops.dropout import fold_in
from mobilefinetuner_tpu_torch.ops.rope import apply_rope, rope_cos_sin

# LoRA target of each site id within a block (the JAX `_block` order)
SITES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj")


def rms_norm(x, w, eps, dtype=None):
    """Gemma RMSNorm: x / rms(x) * (1 + w) in f32, cast to `dtype`
    (default x's)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(dtype or x.dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def init_params(config: Gemma3TextConfig, seed: int = 0,
                dtype=torch.float32, device=None) -> Dict[str, Any]:
    """Random init: N(0, 0.02) weights, zero norm weights (the (1 + w)
    convention makes them unit gains). Drawn from a seeded CPU
    torch.Generator, so a seed gives the same weights on every device;
    `device=None` is the CUDA card."""
    device = resolve_device(device)
    c = config
    L, H, D = c.num_hidden_layers, c.hidden_size, c.head_dim
    nq, nkv, inter = (c.num_attention_heads, c.num_key_value_heads,
                      c.intermediate_size)
    gen = torch.Generator().manual_seed(int(seed))

    def n(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(device, dtype)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "embed": n(c.vocab_size, H),
        "blocks": {
            "input_ln": z(L, H),
            "attn": {"q_w": n(L, H, nq * D), "k_w": n(L, H, nkv * D),
                     "v_w": n(L, H, nkv * D), "o_w": n(L, nq * D, H),
                     "q_norm": z(L, D), "k_norm": z(L, D)},
            "post_attn_ln": z(L, H),
            "pre_ffn_ln": z(L, H),
            "mlp": {"gate_w": n(L, H, inter), "up_w": n(L, H, inter),
                    "down_w": n(L, inter, H)},
            "post_ffn_ln": z(L, H),
        },
        "final_norm": z(H),
    }


def layer_params(params, i: int, dtype) -> Dict[str, Any]:
    """Layer i's weights sliced out of the [L, ...] stacks, in `dtype`."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i].to(dtype)
    return take(params["blocks"])


def _block(c: Gemma3TextConfig, bp, x, padding_mask, rope, window,
           lora_b, i: int, seed: Optional[int], lora_dropout: float,
           lora_impl: str, attn_impl: str):
    """One Gemma-3 block on x [B, S, H]; rope = (cos, sin) of this layer's
    theta, window = its sliding window (None on a global layer). Returns
    (x, (k, v)): k after the q/k-norm and RoPE, [B, Hkv, S, D]."""
    eps = c.rms_norm_eps
    B, S, _ = x.shape
    nq, nkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def lora(y, x_in, site):
        name = SITES[site]
        entry = None if lora_b is None else lora_b.get(name)
        return maybe_lora(y, x_in, entry, i, lora_dropout,
                          None if seed is None else fold_in(seed, site),
                          lora_impl)

    def heads(t, n):
        return t.reshape(B, S, n, D).transpose(1, 2)

    a = bp["attn"]
    h = rms_norm(x, bp["input_ln"], eps)
    q = heads(lora(h @ a["q_w"], h, 0), nq)
    k = heads(lora(h @ a["k_w"], h, 1), nkv)
    v = heads(lora(h @ a["v_w"], h, 2), nkv)
    q = apply_rope(rms_norm(q, a["q_norm"], eps), *rope)
    k = apply_rope(rms_norm(k, a["k_norm"], eps), *rope)
    ctx = attention(q, k, v, impl=attn_impl,
                    scale=c.query_pre_attn_scalar ** -0.5, is_causal=True,
                    sliding_window=window, padding_mask=padding_mask)
    ctx = ctx.transpose(1, 2).reshape(B, S, nq * D)
    attn_out = rms_norm(lora(ctx @ a["o_w"], ctx, 3), bp["post_attn_ln"],
                        eps)
    x = x + attn_out

    m = bp["mlp"]
    h = rms_norm(x, bp["pre_ffn_ln"], eps)
    gate = lora(h @ m["gate_w"], h, 4)
    up = lora(h @ m["up_w"], h, 5)
    act = gelu_tanh(gate) * up
    down = rms_norm(lora(act @ m["down_w"], act, 6), bp["post_ffn_ln"], eps)
    return x + down, (k, v)


def hidden_states(config: Gemma3TextConfig, params, input_ids,
                  attention_mask=None, lora=None,
                  compute_dtype=torch.float32, remat: bool = False,
                  lora_dropout: float = 0.0,
                  dropout_seed: Optional[int] = None,
                  attn_impl: str = "auto", lora_impl: str = "auto",
                  collect_kv: bool = False):
    """Final-norm hidden states [B, S, H]; with collect_kv also every
    layer's K (after q/k-norm and RoPE) and V stacked to [L, B, Hkv, S, D]
    (the generate prefill). attn_impl: "auto" (the flash kernels off the
    CPU), "plain" or "flash" (ops/attention.py); lora_impl:
    models/lora_apply.py; dropout_seed None = eval mode."""
    if remat and collect_kv:
        raise ValueError("collect_kv (generate prefill) runs without remat")
    c = config
    B, S = input_ids.shape
    x = params["embed"][input_ids].to(compute_dtype)
    # sqrt(hidden) embedding scale, rounded to the compute dtype first as
    # HF does (sqrt(640) is 25.25 in bf16)
    x = x * torch.tensor(c.hidden_size ** 0.5, dtype=compute_dtype)
    if attention_mask is not None:
        # mask-derived positions (HF convention)
        positions = torch.clamp(
            torch.cumsum(attention_mask.long(), dim=-1) - 1, min=0)
    else:
        positions = torch.arange(S, device=input_ids.device)
    ropes = {True: rope_cos_sin(positions, c.head_dim, c.rope_theta),
             False: rope_cos_sin(positions, c.head_dim,
                                 c.rope_local_base_freq)}
    lora_b = None if lora is None else lora.get("blocks")
    ks, vs = [], []
    for i in range(c.num_hidden_layers):
        glob = c.is_global_layer(i)
        args = (attention_mask, ropes[glob],
                None if glob else c.sliding_window, lora_b, i,
                None if dropout_seed is None else fold_in(dropout_seed, i),
                lora_dropout, lora_impl, attn_impl)
        bp = layer_params(params, i, compute_dtype)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x_, bp_=bp, args_=args: _block(c, bp_, x_,
                                                      *args_)[0],
                x, use_reentrant=False)
            continue
        x, (k, v) = _block(c, bp, x, *args)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"].to(compute_dtype), c.rms_norm_eps)
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def forward(config: Gemma3TextConfig, params, input_ids,
            attention_mask=None, lora=None, compute_dtype=torch.float32,
            remat: bool = False, lora_dropout: float = 0.0,
            dropout_seed: Optional[int] = None, attn_impl: str = "auto",
            lora_impl: str = "auto"):
    """Logits [B, S, V] through the tied lm_head, plus an "lm_head"
    adapter entry's delta (its branch dropout seeded fold_in(seed, 2000),
    the LoRA epilogue kernel on the card at d_out = V). Materializes
    [B, S, V]: training goes through ops/loss.chunked_lm_cross_entropy_sum
    (with lora_head=) instead."""
    x = hidden_states(config, params, input_ids, attention_mask, lora,
                      compute_dtype, remat, lora_dropout, dropout_seed,
                      attn_impl, lora_impl)
    logits = x @ params["embed"].to(compute_dtype).T
    lora_b = None if lora is None else lora.get("blocks")
    if lora_b is not None and "lm_head" in lora_b:
        logits = maybe_lora(
            logits, x, lora_b["lm_head"], None, lora_dropout,
            None if dropout_seed is None else fold_in(dropout_seed, 2000),
            lora_impl)
    return logits
