"""GPT-2 family decoder in PyTorch (port of mobilefinetuner_tpu/models/
gpt2.py, inference: no dropout, remat, offload or sequence parallelism).

Pre-LN blocks with fused-QKV attention, gelu_new MLP, final LN and the
tied lm_head x @ wte^T. Parameters keep the JAX package's names and its
stacked [L, ...] HF Conv1D [in, out] layout, as a nested dict of tensors:

    {"wte": [V, E], "wpe": [P, E],
     "blocks": {"ln_1": {"g", "b"}, "attn": {"qkv_w", "qkv_b", "proj_w",
                "proj_b"}, "ln_2": {...}, "mlp": {"fc_w", "fc_b",
                "proj_w", "proj_b"}},       # each leaf [L, ...]
     "ln_f": {"g": [E], "b": [E]}}

so `convert.gpt2_params_from_numpy` carries a JAX tree over unchanged and
both packages compute the same function. LoRA enters functionally through
`lora=` (see lora/lora.py).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.lora.lora import GPT2_SPLIT_QKV_SLOTS
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops.attention import attention


def layer_norm(x, g, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * g + b
    return out.to(x.dtype)


def gelu_new(x):
    """tanh-approximate gelu (HF gelu_new)."""
    return F.gelu(x, approximate="tanh")


def init_params(config: GPT2Config, seed: int = 0, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """Random init: N(0, 0.02) weights, zero biases, unit LN gains. Drawn
    from a seeded CPU torch.Generator, so a seed gives the same weights on
    every device; `device=None` is the CUDA card (core/device.py)."""
    device = resolve_device(device)
    E, L, V, P = (config.n_embd, config.n_layer, config.vocab_size,
                  config.n_positions)
    gen = torch.Generator().manual_seed(int(seed))

    def n(*shape):
        return (torch.randn(shape, generator=gen) * 0.02).to(device, dtype)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def o(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "wte": n(V, E),
        "wpe": n(P, E),
        "blocks": {
            "ln_1": {"g": o(L, E), "b": z(L, E)},
            "attn": {"qkv_w": n(L, E, 3 * E), "qkv_b": z(L, 3 * E),
                     "proj_w": n(L, E, E), "proj_b": z(L, E)},
            "ln_2": {"g": o(L, E), "b": z(L, E)},
            "mlp": {"fc_w": n(L, E, 4 * E), "fc_b": z(L, 4 * E),
                    "proj_w": n(L, 4 * E, E), "proj_b": z(L, E)},
        },
        "ln_f": {"g": o(E), "b": z(E)},
    }


def layer_params(params, i: int, dtype) -> Dict[str, Dict[str, Any]]:
    """Layer i's weights sliced out of the [L, ...] stacks, in `dtype`."""
    return {grp: {name: w[i].to(dtype) for name, w in leaves.items()}
            for grp, leaves in params["blocks"].items()}


def qkv_proj(config: GPT2Config, bp, h, lora_b, i: int):
    """h @ qkv_w + qkv_b with the fused and split-QKV adapter deltas."""
    E = config.n_embd
    qkv = h @ bp["attn"]["qkv_w"] + bp["attn"]["qkv_b"]
    if lora_b is None:
        return qkv
    qkv = maybe_lora(qkv, h, lora_b.get("attn_qkv"), i)
    if any(name in lora_b for name in GPT2_SPLIT_QKV_SLOTS):
        parts = list(qkv.split(E, dim=-1))
        for name, slot in GPT2_SPLIT_QKV_SLOTS.items():
            parts[slot] = maybe_lora(parts[slot], h, lora_b.get(name), i)
        qkv = torch.cat(parts, dim=-1)
    return qkv


def mlp_and_proj(bp, x, ctx, lora_b, i: int, eps: float):
    """The rest of a block after attention: out-projection + residual,
    then the MLP + residual."""
    entry = (lambda name: None) if lora_b is None else lora_b.get
    proj = ctx @ bp["attn"]["proj_w"] + bp["attn"]["proj_b"]
    x = x + maybe_lora(proj, ctx, entry("attn_proj"), i)
    h = layer_norm(x, bp["ln_2"]["g"], bp["ln_2"]["b"], eps)
    fc = h @ bp["mlp"]["fc_w"] + bp["mlp"]["fc_b"]
    act = gelu_new(maybe_lora(fc, h, entry("mlp_fc_in"), i))
    out = act @ bp["mlp"]["proj_w"] + bp["mlp"]["proj_b"]
    return x + maybe_lora(out, act, entry("mlp_fc_out"), i)


def hidden_states(config: GPT2Config, params, input_ids,
                  attention_mask=None, lora=None,
                  compute_dtype=torch.float32, collect_kv: bool = False,
                  attn_impl: str = "auto"):
    """Final-LN hidden states [B, S, E]; with collect_kv also every layer's
    (k, v) head tensors stacked to [L, B, H, S, D]. attn_impl: "auto" (the
    flash kernel off the CPU) or "plain" (ops.attention.attention)."""
    B, S = input_ids.shape
    H, D, E = config.n_head, config.head_dim, config.n_embd
    eps = config.layer_norm_epsilon
    if attention_mask is not None:
        # HF convention: positions count only unmasked tokens
        positions = torch.clamp(
            torch.cumsum(attention_mask.long(), dim=-1) - 1, min=0)
        pos_emb = params["wpe"][positions]
    else:
        pos_emb = params["wpe"][:S][None]
    x = (params["wte"][input_ids] + pos_emb).to(compute_dtype)
    lora_b = None if lora is None else lora.get("blocks")

    def heads(t):
        return t.reshape(B, S, H, D).transpose(1, 2).contiguous()

    ks, vs = [], []
    for i in range(config.n_layer):
        bp = layer_params(params, i, compute_dtype)
        h = layer_norm(x, bp["ln_1"]["g"], bp["ln_1"]["b"], eps)
        q, k, v = qkv_proj(config, bp, h, lora_b, i).split(E, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        ctx = attention(q, k, v, impl=attn_impl, is_causal=True,
                        padding_mask=attention_mask)
        ctx = ctx.transpose(1, 2).reshape(B, S, E)
        x = mlp_and_proj(bp, x, ctx, lora_b, i, eps)
    x = layer_norm(x, params["ln_f"]["g"].to(compute_dtype),
                   params["ln_f"]["b"].to(compute_dtype), eps)
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def forward(config: GPT2Config, params, input_ids, attention_mask=None,
            lora=None, compute_dtype=torch.float32,
            attn_impl: str = "auto"):
    """Logits [B, S, V] through the tied lm_head (plus an "lm_head"
    adapter entry's delta)."""
    x = hidden_states(config, params, input_ids, attention_mask, lora,
                      compute_dtype, attn_impl=attn_impl)
    logits = x @ params["wte"].to(compute_dtype).T
    lora_b = None if lora is None else lora.get("blocks")
    if lora_b is not None and "lm_head" in lora_b:
        logits = maybe_lora(logits, x, lora_b["lm_head"], None)
    return logits
