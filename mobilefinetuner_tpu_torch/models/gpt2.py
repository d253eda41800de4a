"""GPT-2 family decoder in PyTorch (port of mobilefinetuner_tpu/models/
gpt2.py: inference and training; offload and sequence parallelism are not
ported, ROADMAP.md port item P9).

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

Training: `dropout_seed` (an int, ops/dropout.py) turns on train-mode
dropout at the JAX package's sites, each with its own seed folded from it
as the JAX model folds its keys: embeddings (1000), per layer i (i), and
within a layer the LoRA branches (0 attn_qkv, 1 attn_proj, 2 mlp_fc_in,
3 mlp_fc_out, 4-6 the split q/k/v), the attention probs (9) and the two
residual branches (7, 8); the lm_head adapter (2000). `remat` recomputes
each block in the backward (torch.utils.checkpoint); seeded dropout
replays its masks there. `attn_impl` reaches the flash backward kernels
through autograd (ops/attention.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.core.device import resolve_device
from mobilefinetuner_tpu_torch.lora.lora import GPT2_SPLIT_QKV_SLOTS
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops.attention import attention
from mobilefinetuner_tpu_torch.ops.dropout import fold_in, inverted_dropout


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


def param_count(tree) -> int:
    """Elements of every tensor leaf of a nested dict (the JAX package's
    models.gpt2.param_count over a tree)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return int(tree.numel()) if isinstance(tree, torch.Tensor) else 0


def layer_params(params, i: int, dtype) -> Dict[str, Dict[str, Any]]:
    """Layer i's weights sliced out of the [L, ...] stacks, in `dtype`."""
    return {grp: {name: w[i].to(dtype) for name, w in leaves.items()}
            for grp, leaves in params["blocks"].items()}


def _fold(seed: Optional[int], data: int) -> Optional[int]:
    return None if seed is None else fold_in(seed, data)


def _lora_site(lora_b, i, seed, lora_dropout, lora_impl):
    """site(y, x_in, name, slot): maybe_lora for target `name` of layer i,
    its dropout seed folded from the layer's seed by `slot`."""
    def site(y, x_in, name, slot):
        entry = None if lora_b is None else lora_b.get(name)
        return maybe_lora(y, x_in, entry, i, lora_dropout,
                          _fold(seed, slot), lora_impl)
    return site


def qkv_proj(config: GPT2Config, bp, h, lora_b, i: int,
             seed: Optional[int] = None, lora_dropout: float = 0.0,
             lora_impl: str = "auto"):
    """h @ qkv_w + qkv_b with the fused and split-QKV adapter deltas."""
    E = config.n_embd
    qkv = h @ bp["attn"]["qkv_w"] + bp["attn"]["qkv_b"]
    if lora_b is None:
        return qkv
    site = _lora_site(lora_b, i, seed, lora_dropout, lora_impl)
    qkv = site(qkv, h, "attn_qkv", 0)
    if any(name in lora_b for name in GPT2_SPLIT_QKV_SLOTS):
        parts = list(qkv.split(E, dim=-1))
        for name, slot in GPT2_SPLIT_QKV_SLOTS.items():
            parts[slot] = site(parts[slot], h, name, 4 + slot)
        qkv = torch.cat(parts, dim=-1)
    return qkv


def mlp_and_proj(bp, x, ctx, lora_b, i: int, eps: float,
                 seed: Optional[int] = None, lora_dropout: float = 0.0,
                 lora_impl: str = "auto", resid_pdrop: float = 0.0):
    """The rest of a block after attention: out-projection (+ residual
    dropout) + residual, then the MLP (+ residual dropout) + residual."""
    site = _lora_site(lora_b, i, seed, lora_dropout, lora_impl)
    proj = ctx @ bp["attn"]["proj_w"] + bp["attn"]["proj_b"]
    proj = site(proj, ctx, "attn_proj", 1)
    x = x + inverted_dropout(proj, resid_pdrop, _fold(seed, 7))
    h = layer_norm(x, bp["ln_2"]["g"], bp["ln_2"]["b"], eps)
    fc = h @ bp["mlp"]["fc_w"] + bp["mlp"]["fc_b"]
    act = gelu_new(site(fc, h, "mlp_fc_in", 2))
    out = act @ bp["mlp"]["proj_w"] + bp["mlp"]["proj_b"]
    out = site(out, act, "mlp_fc_out", 3)
    return x + inverted_dropout(out, resid_pdrop, _fold(seed, 8))


def _block(config: GPT2Config, bp, x, padding_mask, lora_b, i: int,
           seed: Optional[int], lora_dropout: float, lora_impl: str,
           attn_impl: str):
    """One pre-LN block; returns (x, (k, v) head tensors [B, H, S, D])."""
    B, S, E = x.shape
    H, D = config.n_head, config.head_dim
    eps = config.layer_norm_epsilon

    def heads(t):
        return t.reshape(B, S, H, D).transpose(1, 2).contiguous()

    h = layer_norm(x, bp["ln_1"]["g"], bp["ln_1"]["b"], eps)
    q, k, v = qkv_proj(config, bp, h, lora_b, i, seed, lora_dropout,
                       lora_impl).split(E, dim=-1)
    q, k, v = heads(q), heads(k), heads(v)
    attn_seed = _fold(seed, 9) if config.attn_pdrop > 0.0 else None
    ctx = attention(q, k, v, impl=attn_impl, is_causal=True,
                    padding_mask=padding_mask,
                    attn_dropout=config.attn_pdrop, dropout_seed=attn_seed)
    ctx = ctx.transpose(1, 2).reshape(B, S, E)
    x = mlp_and_proj(bp, x, ctx, lora_b, i, eps, seed, lora_dropout,
                     lora_impl, config.resid_pdrop)
    return x, (k, v)


def hidden_states(config: GPT2Config, params, input_ids,
                  attention_mask=None, lora=None,
                  compute_dtype=torch.float32, collect_kv: bool = False,
                  attn_impl: str = "auto", remat: bool = False,
                  lora_dropout: float = 0.0,
                  dropout_seed: Optional[int] = None,
                  lora_impl: str = "auto"):
    """Final-LN hidden states [B, S, E]; with collect_kv also every layer's
    (k, v) head tensors stacked to [L, B, H, S, D]. attn_impl: "auto" (the
    flash kernels off the CPU), "plain" or "flash" (ops.attention);
    lora_impl: models/lora_apply.py; dropout_seed None = eval mode."""
    if remat and collect_kv:
        raise ValueError("collect_kv (serving prefill) runs without remat")
    B, S = input_ids.shape
    if attention_mask is not None:
        # HF convention: positions count only unmasked tokens
        positions = torch.clamp(
            torch.cumsum(attention_mask.long(), dim=-1) - 1, min=0)
        pos_emb = params["wpe"][positions]
    else:
        pos_emb = params["wpe"][:S][None]
    x = (params["wte"][input_ids] + pos_emb).to(compute_dtype)
    x = inverted_dropout(x, config.embd_pdrop, _fold(dropout_seed, 1000))
    lora_b = None if lora is None else lora.get("blocks")

    ks, vs = [], []
    for i in range(config.n_layer):
        bp = layer_params(params, i, compute_dtype)
        seed = _fold(dropout_seed, i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x_, bp_=bp, i_=i, s_=seed: _block(
                    config, bp_, x_, attention_mask, lora_b, i_, s_,
                    lora_dropout, lora_impl, attn_impl)[0],
                x, use_reentrant=False)
            continue
        x, (k, v) = _block(config, bp, x, attention_mask, lora_b, i, seed,
                           lora_dropout, lora_impl, attn_impl)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = layer_norm(x, params["ln_f"]["g"].to(compute_dtype),
                   params["ln_f"]["b"].to(compute_dtype),
                   config.layer_norm_epsilon)
    if collect_kv:
        return x, (torch.stack(ks), torch.stack(vs))
    return x


def forward(config: GPT2Config, params, input_ids, attention_mask=None,
            lora=None, compute_dtype=torch.float32,
            attn_impl: str = "auto", remat: bool = False,
            lora_dropout: float = 0.0, dropout_seed: Optional[int] = None,
            lora_impl: str = "auto"):
    """Logits [B, S, V] through the tied lm_head (plus an "lm_head"
    adapter entry's delta)."""
    x = hidden_states(config, params, input_ids, attention_mask, lora,
                      compute_dtype, attn_impl=attn_impl, remat=remat,
                      lora_dropout=lora_dropout, dropout_seed=dropout_seed,
                      lora_impl=lora_impl)
    logits = x @ params["wte"].to(compute_dtype).T
    lora_b = None if lora is None else lora.get("blocks")
    if lora_b is not None and "lm_head" in lora_b:
        logits = maybe_lora(logits, x, lora_b["lm_head"], None,
                            lora_dropout, _fold(dropout_seed, 2000),
                            lora_impl)
    return logits
