"""Autoregressive generation with a KV cache, for GPT-2 and Gemma-3, and
the serving programs (port of mobilefinetuner_tpu/models/generate.py:
`SampleConfig`, the sampling helpers, `sample_per_row`, `gpt2_generate`,
`gemma3_generate` with `_gemma_chunked_prefill`, `left_pad`, and the
serve engine's `gpt2_prefill` / `gemma3_prefill`, `gpt2_prefill_chunk` /
`gemma3_prefill_chunk` and `gpt2_decode_step_paged` /
`gemma3_decode_step_paged`).

Contiguous generation (`*_generate`, the generate CLI):
  * prefill = one full-sequence forward of the LEFT-padded prompts that
    also returns every layer's K/V (`collect_kv=True`; the flash forward
    kernel on the card), or for Gemma with `prefill_chunk` the prompt in
    W-token windows against the growing cache;
  * the caches are [L, B, KV, T, D] tensors (T = P + N), allocated once;
    each decode step writes the fed token's K/V in place at column P + t
    and attends through ops/decode_attention.decode_attention over
    `kc[i]`, a contiguous view since L is the outer dimension (row 13's
    kernel on the card, `attn_impl="plain"` its plain version);
  * N = max_new_tokens tokens come from N - 1 decode steps: step t feeds
    token t and samples token t + 1, so no trailing forward is wasted;
    eos stops a row, which emits pad from then on;
  * positions are mask-derived per row (HF convention), and Gemma's local
    layers window over POSITION ids, as the padded-batch forward does.

Nothing in the decode loop reads the card back: the loop enqueues every
step and the host meets the card only at the end (or at `events`). The
decode step is built once and replayed (`_decode_loop`): it reads the
fed token, the step index `t` and the finished rows from static device
buffers, so on the card it is a CUDA graph captured at the second step
(kernels/graphs.StepGraph) and replayed for the rest; `graph_captures`
counts the captures. `t` is a device scalar: it sets the cache column
(an index write at a device index) and the validity mask. Greedy steps
run whole in the graph (argmax, eos bookkeeping, t + 1); a sampled draw
(torch.multinomial on the generator) stays outside it, on the logits the
graph writes, so the ids for a seed equal the eager ones. The private
`_eager` argument of `*_generate` keeps every step eager on the card, for
comparisons only.

Sampling draws from an explicit torch.Generator (seed 0 when none is
given). The JAX package draws from jax.random's threefry stream, which
this cannot reproduce: under sampling the two packages' tokens differ;
greedy decoding and the top-k / top-p filter masks are identical.

LoRA: `lora=` applies an adapter dynamically at every site of the prefill
and the decode steps (one adapter through the epilogue kernel on the
card, or a stack routed per row); merging it first (lora.merge_gpt2 /
merge_gemma3) and passing lora=None gives the same tokens.

Serving: serve sequences start at position 0 with no padding inside (the
engine right-pads only the prompt tail), so a slot's attendable columns
are simply col <= pos, and on Gemma's local layers also pos - col <
sliding_window. The pools are updated IN PLACE: the decode step scatters
the fed token's K/V into its page before attending (write before read,
on one stream), where the JAX engine donated the pool buffers to a
functional update. Idle slots all write trash page 0 at offset 0; which
duplicate wins is unspecified, and no live slot ever reads that page.
A prefill CHUNK (chunked admission, prefix-cache suffixes) attends the
pages earlier chunks wrote and its own causal rows under one joint
softmax, in plain torch: the JAX package computes it in XLA, not in a
Pallas kernel. Its K/V make a round trip through the pool dtype before
the within-chunk attention, so they are the values the pages will hold.
Its `start` and `n_tok` may be 0-d device tensors: every shape then
depends on the bucket width alone, so the serve engine replays one CUDA
graph a width (serve/engine.py).

Per-slot sampling (`sample_per_row`, the serve engine): temperature,
top-k and top-p are per-row tensors; temperature <= 0 rows take the
argmax bit for bit. The draw is the port's own rule, not threefry: a
uniform u from the splitmix `fold_in_tensor(seed, position)` of the
request's seed and the emitted token's absolute position
(ops/dropout.py), picked by inverse CDF over the filtered row in vocab
order. It is computed on the device from tensors, so the same seed gives
the same tokens however the prompt entered the pool.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.kernels.graphs import StepGraph
from mobilefinetuner_tpu_torch.models import gemma3, gpt2
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops.attention import validate_attn_impl
from mobilefinetuner_tpu_torch.ops.decode_attention import (
    decode_attention, paged_attention, paged_decode_attention, xla_reference)
from mobilefinetuner_tpu_torch.ops.dropout import fold_in_tensor
from mobilefinetuner_tpu_torch.ops.rope import apply_rope, rope_cos_sin

NEG_INF = -1e30
# the decode step's CUDA-graph captures in this process ("decode_step")
graph_captures: collections.Counter = collections.Counter()


def _head_lora(logits, h, lora_b, lora_impl: str = "auto"):
    """An optional "lm_head" adapter entry at a logits projection site."""
    if lora_b is None or "lm_head" not in lora_b:
        return logits
    return maybe_lora(logits, h, lora_b["lm_head"], None, impl=lora_impl)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0     # <= 0 or greedy=True -> argmax
    top_k: int = 0               # 0 = off
    top_p: float = 1.0           # 1.0 = off
    greedy: bool = False
    eos_id: Optional[int] = None
    pad_id: int = 0


def _filter_logits(logits, cfg: SampleConfig):
    """Top-k then top-p filtering (HF order) of [B, V] logits: filtered
    entries become NEG_INF."""
    V = logits.shape[-1]
    if cfg.top_k and cfg.top_k < V:
        kth = torch.sort(logits, dim=-1).values[:, V - cfg.top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if cfg.top_p < 1.0:
        # a stable descending sort, as jnp.argsort(-logits)
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(logits, -1, sort_idx), dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass (exclusive) is < top_p; the
        # first token is always kept
        keep_sorted = (cum - probs) < cfg.top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx,
                                                     keep_sorted)
        logits = torch.where(keep, logits, NEG_INF)
    return logits


def _sample(logits, generator: torch.Generator, cfg: SampleConfig):
    """[B, V] f32 logits -> [B] int32 token ids: the first argmax when
    greedy, else a draw from the filtered softmax at the temperature."""
    if cfg.greedy or cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _filter_logits(logits / cfg.temperature, cfg)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_per_row(logits, temperature, top_k, top_p, seed, pos):
    """Per-row sampling for the serve engine's slot batch: [S, V] logits
    with per-row temperature [S] f32, top_k [S] int, top_p [S] f32, and
    the request seed [S] int64 and emitted token's absolute position [S]
    that key the draw -> [S] int64 token ids. temperature <= 0 rows take
    the argmax of the logits (idle slots and greedy requests); top_k <= 0
    and top_p >= 1 turn each filter off per row. The filters are
    _filter_logits' (top-k then top-p, HF order) with vector parameters;
    the draw is the inverse CDF of the filtered softmax at the uniform of
    fold_in_tensor(seed, pos)'s top 53 bits."""
    S, V = logits.shape
    logits = logits.float()
    greedy = logits.argmax(-1)
    scaled = logits / temperature.float().clamp_min(1e-6)[:, None]
    k_eff = torch.where((top_k > 0) & (top_k < V), top_k, V).long()
    kth = torch.sort(scaled, dim=-1).values.gather(1, (V - k_eff)[:, None])
    scaled = torch.where(scaled < kth, NEG_INF, scaled)
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(scaled, -1, sort_idx), dim=-1)
    keep_sorted = (torch.cumsum(probs, dim=-1) - probs) \
        < top_p.float().clamp(max=1.0)[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    p = torch.softmax(torch.where(keep, scaled, NEG_INF), dim=-1)
    cdf = torch.cumsum(p.double(), dim=-1)
    u = (fold_in_tensor(seed, pos) >> 10).double() * 2.0 ** -53
    idx = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None],
                             right=True)[:, 0]
    # u * total can round up to the total: take the last kept entry then
    last = V - 1 - (p > 0).flip(-1).float().argmax(-1)
    return torch.where(temperature <= 0, greedy, torch.minimum(idx, last))


def _advance(tok_raw, done, cfg: SampleConfig):
    """eos bookkeeping: emit pad for finished rows, mark rows that just
    emitted eos as finished AFTER emitting it."""
    tok = torch.where(done, torch.full_like(tok_raw, cfg.pad_id), tok_raw)
    if cfg.eos_id is not None:
        done = done | (tok_raw == cfg.eos_id)
    return tok, done


def _col_positions(attention_mask, P: int, T: int):
    """Position ids of every cache column [B, T]: prompt columns use
    mask-derived positions (HF convention), generated column P + j has
    position n_real + j."""
    m = attention_mask.long()
    n_real = m.sum(-1)
    prompt_pos = torch.clamp(torch.cumsum(m, dim=-1) - 1, min=0)
    gen_pos = n_real[:, None] + torch.arange(T - P, device=m.device)[None]
    return torch.cat([prompt_pos, gen_pos], dim=-1)


def _col_valid(attention_mask, P: int, T: int, t):
    """[B, T] bool: the cache columns attendable at decode step t (a
    device scalar; prompt columns per the mask, generated columns up to
    P + t)."""
    B = attention_mask.shape[0]
    cols = torch.arange(T, device=attention_mask.device)
    prompt = torch.cat([attention_mask.bool(),
                        torch.ones(B, T - P, dtype=torch.bool,
                                   device=attention_mask.device)], dim=-1)
    return prompt & (cols[None, :] <= P + t)


def left_pad(seqs, pad_id: int):
    """[[ids...], ...] -> (input_ids [B, P], attention_mask [B, P]) int32
    numpy arrays with LEFT padding (cache writes share one column)."""
    P = max(len(s) for s in seqs)
    B = len(seqs)
    ids = np.full((B, P), pad_id, np.int32)
    mask = np.zeros((B, P), np.int32)
    for i, s in enumerate(seqs):
        if len(s):
            ids[i, P - len(s):] = s
            mask[i, P - len(s):] = 1
    return ids, mask


def _mark(events: Optional[List]) -> None:
    """Record a CUDA event on the current stream into `events` (a list), a
    step boundary the caller times; nothing when events is None."""
    if events is not None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)


def _caches(pk, pv, N: int):
    """[L, B, KV, P + N, D] caches holding the prefill's K/V in the first
    P columns, zeros after."""
    L, B, KV, P, D = pk.shape
    kc = pk.new_zeros(L, B, KV, P + N, D)
    vc = pv.new_zeros(L, B, KV, P + N, D)
    kc[:, :, :, :P] = pk
    vc[:, :, :, :P] = pv
    return kc, vc


def _decode_loop(step, logits0, generator, cfg: SampleConfig, N: int,
                 events: Optional[List], graphed: bool = True):
    """Sample token 0 from the prefill logits, then N - 1 decode steps;
    returns the emitted ids [B, N] int32. Each step runs `body` over the
    static buffers tok [B], t (the step index, a device scalar) and done
    [B]: a CUDA graph from the second step on the card (module
    docstring), eager elsewhere or without `graphed`."""
    done = torch.zeros(logits0.shape[0], dtype=torch.bool,
                       device=logits0.device)
    tok, done = _advance(_sample(logits0.float(), generator, cfg), done, cfg)
    _mark(events)
    toks = [tok]
    tok = tok.clone()
    t = torch.zeros((), dtype=torch.long, device=logits0.device)
    greedy = cfg.greedy or cfg.temperature <= 0.0
    logits = torch.empty(logits0.shape, dtype=torch.float32,
                         device=logits0.device)

    def body():
        out = step(tok, t).float()
        if greedy:
            nxt, fin = _advance(_sample(out, generator, cfg), done, cfg)
            tok.copy_(nxt)
            done.copy_(fin)
        else:
            logits.copy_(out)
        t.add_(1)

    graph = StepGraph(body, logits0.device, graphed=graphed,
                      on_capture=lambda: graph_captures.update(
                          ["decode_step"]))
    for _ in range(N - 1):
        graph()
        if not greedy:
            nxt, fin = _advance(_sample(logits, generator, cfg), done, cfg)
            tok.copy_(nxt)
            done.copy_(fin)
        toks.append(tok.clone())
        _mark(events)
    return torch.stack(toks, dim=1)


def _generator(generator: Optional[torch.Generator], device):
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


# ----------------------------------------------------------- GPT-2 ----------

def gpt2_decoder(config: GPT2Config, params, kc, vc, attention_mask,
                 lora=None, compute_dtype=torch.float32,
                 lora_impl: str = "auto", attn_impl: str = "auto"):
    """The decode step of gpt2_generate over caches kc/vc [L, B, H, T, D]
    whose first P = attention_mask.shape[1] columns hold the left-padded
    prompt: step(tok [B], t) feeds token t at column P + t (position
    n_real + t), writes its K/V there in place and returns the next-token
    logits [B, V] in the compute dtype. t is a 0-d int64 tensor on the
    caches' device, so one captured step serves every t. attn_impl:
    "auto" = the row-13 kernel for CUDA caches (ValueError for caches it
    does not take), the plain version for CPU caches; "plain" =
    xla_reference anywhere."""
    validate_attn_impl(attn_impl)
    L, B, H, T, D = kc.shape
    P = attention_mask.shape[1]
    E, eps = config.n_embd, config.layer_norm_epsilon
    cd = compute_dtype
    lora_b = None if lora is None else lora.get("blocks")
    attend = xla_reference if attn_impl == "plain" else decode_attention
    n_real = attention_mask.sum(-1).long()
    blocks = [gpt2.layer_params(params, i, cd) for i in range(L)]
    ln_f = (params["ln_f"]["g"].to(cd), params["ln_f"]["b"].to(cd))
    wte = params["wte"].to(cd)

    def step(tok, t):
        pos = n_real + t
        col = (P + t).reshape(1)
        x = params["wte"][tok].to(cd) + params["wpe"][pos].to(cd)  # [B, E]
        valid = _col_valid(attention_mask, P, T, t)
        for i, bp in enumerate(blocks):
            h = gpt2.layer_norm(x, bp["ln_1"]["g"], bp["ln_1"]["b"], eps)
            q, k, v = gpt2.qkv_proj(config, bp, h, lora_b, i,
                                    lora_impl=lora_impl).split(E, dim=-1)
            q, k, v = (z.reshape(B, H, D) for z in (q, k, v))
            # write before read, at the device column P + t
            kc[i].index_copy_(2, col, k.to(kc.dtype)[:, :, None])
            vc[i].index_copy_(2, col, v.to(vc.dtype)[:, :, None])
            ctx = attend(q[:, :, None].contiguous(), kc[i], vc[i], valid,
                         D ** -0.5)
            x = gpt2.mlp_and_proj(bp, x, ctx.reshape(B, E).to(cd), lora_b,
                                  i, eps, lora_impl=lora_impl)
        x = gpt2.layer_norm(x, *ln_f, eps)
        return _head_lora(x @ wte.T, x, lora_b, lora_impl)

    return step


def gpt2_generate(config: GPT2Config, params, input_ids, attention_mask,
                  cfg: SampleConfig,
                  generator: Optional[torch.Generator] = None,
                  compute_dtype=torch.float32, lora=None,
                  lora_impl: str = "auto", attn_impl: str = "auto",
                  events: Optional[List] = None, _eager: bool = False):
    """Generate [B, max_new_tokens] int32 ids from LEFT-padded prompts
    [B, P]: a full-forward prefill (collect_kv), then N - 1 decode steps
    over [L, B, H, P + N, D] caches (gpt2_decoder). lora: an adapter tree
    applied dynamically at every site. attn_impl: "auto" (the flash and
    row-13 kernels on the card, the plain versions on the CPU) or "plain".
    events: a list to receive CUDA events before the prefill, after it,
    after the decode set-up and the first sample, and after each decode
    step: the caller times the phases from them. The decode steps replay
    one CUDA graph on the card (module docstring); `_eager` keeps them
    eager (comparisons only)."""
    B, P = input_ids.shape
    N = cfg.max_new_tokens
    T = P + N
    if T > config.n_positions:
        # learned absolute positions: checked before the N <= 0 return so
        # an over-long prompt errors however many tokens were asked for
        raise ValueError(
            f"prompt ({P}) + max_new_tokens ({N}) = {T} exceeds "
            f"n_positions={config.n_positions}")
    if N <= 0:
        return torch.zeros((B, 0), dtype=torch.int32,
                           device=input_ids.device)
    validate_attn_impl(attn_impl)
    generator = _generator(generator, input_ids.device)
    lora_b = None if lora is None else lora.get("blocks")
    _mark(events)
    with torch.no_grad():
        x, (pk, pv) = gpt2.hidden_states(
            config, params, input_ids, attention_mask, lora=lora,
            compute_dtype=compute_dtype, collect_kv=True,
            attn_impl=attn_impl, lora_impl=lora_impl)
        last = x[:, -1]
        logits0 = _head_lora(last @ params["wte"].to(compute_dtype).T, last,
                             lora_b, lora_impl)
        _mark(events)
        kc, vc = _caches(pk, pv, N)
        step = gpt2_decoder(config, params, kc, vc, attention_mask, lora,
                            compute_dtype, lora_impl, attn_impl)
        return _decode_loop(step, logits0, generator, cfg, N, events,
                            graphed=not _eager)


# ---------------------------------------------------------- Gemma-3 ---------

def _gemma_lora(lora_b, lora_impl):
    def site(y, x_in, name, i):
        entry = None if lora_b is None else lora_b.get(name)
        return maybe_lora(y, x_in, entry, i, impl=lora_impl)
    return site


def _gemma_chunked_prefill(c: Gemma3TextConfig, params, blocks, input_ids,
                           attention_mask, lora_b, T: int, compute_dtype,
                           W: int, lora_impl: str = "auto"):
    """Windowed prefill for long prompts: the prompt in W-token windows,
    each window's attention reading the cache of everything before it and
    itself, so score memory is O(W * P) instead of O(P^2). P must be a
    multiple of W. Returns (last hidden [B, H], kc, vc [L, B, Hkv, T, D]).
    The per-window attention is plain torch, as the JAX package leaves it
    to XLA: scores against the cache with explicit validity masks (prompt
    mask AND causal over columns, AND the window over POSITION ids on
    local layers), so left padding and window edges cannot shift."""
    B, P = input_ids.shape
    nq, nkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    G = nq // nkv
    eps = c.rms_norm_eps
    scale = c.query_pre_attn_scalar ** -0.5
    L = c.num_hidden_layers
    cd, dev = compute_dtype, input_ids.device
    lora = _gemma_lora(lora_b, lora_impl)
    normalizer = torch.tensor(c.hidden_size ** 0.5, dtype=cd)
    col_pos = _col_positions(attention_mask, P, T)             # [B, T]
    prompt_ok = attention_mask.bool()                           # [B, P]
    kc = torch.zeros((L, B, nkv, T, D), dtype=cd, device=dev)
    vc = torch.zeros((L, B, nkv, T, D), dtype=cd, device=dev)

    x = None
    for w0 in range(0, P, W):
        pos_w = col_pos[:, w0:w0 + W]                           # [B, W]
        x = params["embed"][input_ids[:, w0:w0 + W]].to(cd) * normalizer
        ropes = {True: rope_cos_sin(pos_w, D, c.rope_theta),
                 False: rope_cos_sin(pos_w, D, c.rope_local_base_freq)}
        hi = w0 + W
        cols = torch.arange(hi, device=dev)
        causal = (cols[None, None, :]
                  <= (w0 + torch.arange(W, device=dev))[None, :, None])
        valid = prompt_ok[:, None, :hi] & causal                # [B, W, hi]
        win = (pos_w[:, :, None] - col_pos[:, None, :hi]) < c.sliding_window
        for i, bp in enumerate(blocks):
            glob = c.is_global_layer(i)
            a = bp["attn"]
            h = gemma3.rms_norm(x, bp["input_ln"], eps)
            q = lora(h @ a["q_w"], h, "q_proj", i).reshape(B, W, nq, D)
            k = lora(h @ a["k_w"], h, "k_proj", i).reshape(B, W, nkv, D)
            v = lora(h @ a["v_w"], h, "v_proj", i).reshape(B, W, nkv, D)
            q = gemma3.rms_norm(q, a["q_norm"], eps)
            k = gemma3.rms_norm(k, a["k_norm"], eps)
            q = apply_rope(q.transpose(1, 2), *ropes[glob])   # [B, nq, W, D]
            k = apply_rope(k.transpose(1, 2), *ropes[glob])
            kc[i, :, :, w0:hi] = k.to(cd)
            vc[i, :, :, w0:hi] = v.transpose(1, 2).to(cd)
            k_pre, v_pre = kc[i, :, :, :hi], vc[i, :, :, :hi]
            s = torch.einsum("bkgwd,bktd->bkgwt",
                             q.reshape(B, nkv, G, W, D).float(),
                             k_pre.float()) * scale
            ok = valid if glob else valid & win
            s = torch.where(ok[:, None, None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("bkgwt,bktd->bkgwd", p.to(v_pre.dtype).float(),
                               v_pre.float())
            ctx = ctx.reshape(B, nq, W, D).transpose(1, 2) \
                .reshape(B, W, nq * D).to(cd)
            attn_out = gemma3.rms_norm(lora(ctx @ a["o_w"], ctx, "o_proj", i),
                                       bp["post_attn_ln"], eps)
            x = x + attn_out
            x = x + _gemma_mlp(bp, x, lora, i, eps)
    x = gemma3.rms_norm(x, params["final_norm"].to(cd), eps)
    return x[:, -1], kc, vc


def _gemma_mlp(bp, x, lora, i: int, eps: float):
    """The sandwich-normed MLP branch of a Gemma block (before the
    residual add)."""
    m = bp["mlp"]
    h2 = gemma3.rms_norm(x, bp["pre_ffn_ln"], eps)
    act = gemma3.gelu_tanh(lora(h2 @ m["gate_w"], h2, "gate_proj", i)) \
        * lora(h2 @ m["up_w"], h2, "up_proj", i)
    down = lora(act @ m["down_w"], act, "down_proj", i)
    return gemma3.rms_norm(down, bp["post_ffn_ln"], eps)


def gemma3_decoder(config: Gemma3TextConfig, params, kc, vc,
                   attention_mask, lora=None, compute_dtype=torch.float32,
                   lora_impl: str = "auto", attn_impl: str = "auto"):
    """The decode step of gemma3_generate over caches kc/vc
    [L, B, Hkv, T, D] whose first P = attention_mask.shape[1] columns hold
    the prompt (as gpt2_decoder). Per layer: global layers attend every
    valid column, local ones the valid columns within the sliding window
    over position ids; RoPE uses the layer's theta; t a device scalar, as
    gpt2_decoder's."""
    validate_attn_impl(attn_impl)
    c = config
    L, B, nkv, T, D = kc.shape
    P = attention_mask.shape[1]
    nq = c.num_attention_heads
    G = nq // nkv
    eps = c.rms_norm_eps
    scale = c.query_pre_attn_scalar ** -0.5
    cd = compute_dtype
    lora_b = None if lora is None else lora.get("blocks")
    lora_site = _gemma_lora(lora_b, lora_impl)
    attend = xla_reference if attn_impl == "plain" else decode_attention
    n_real = attention_mask.sum(-1).long()
    col_pos = _col_positions(attention_mask, P, T)             # [B, T]
    normalizer = torch.tensor(c.hidden_size ** 0.5, dtype=cd)
    blocks = [gemma3.layer_params(params, i, cd) for i in range(L)]
    final_norm = params["final_norm"].to(cd)
    embed = params["embed"].to(cd)

    def step(tok, t):
        pos = n_real + t
        col = (P + t).reshape(1)
        x = params["embed"][tok].to(cd) * normalizer              # [B, H]
        ropes = {True: rope_cos_sin(pos[:, None], D, c.rope_theta),
                 False: rope_cos_sin(pos[:, None], D,
                                     c.rope_local_base_freq)}
        valid = _col_valid(attention_mask, P, T, t)
        # the window over POSITION ids, as the padded-batch forward
        local = valid & ((pos[:, None] - col_pos) < c.sliding_window)
        for i, bp in enumerate(blocks):
            glob = c.is_global_layer(i)
            a = bp["attn"]
            h = gemma3.rms_norm(x, bp["input_ln"], eps)
            q = lora_site(h @ a["q_w"], h, "q_proj", i).reshape(B, nq, D)
            k = lora_site(h @ a["k_w"], h, "k_proj", i).reshape(B, nkv, D)
            v = lora_site(h @ a["v_w"], h, "v_proj", i).reshape(B, nkv, D)
            q = gemma3.rms_norm(q, a["q_norm"], eps)
            k = gemma3.rms_norm(k, a["k_norm"], eps)
            q = apply_rope(q[:, :, None], *ropes[glob])[:, :, 0]
            k = apply_rope(k[:, :, None], *ropes[glob])[:, :, 0]
            # write before read, at the device column P + t
            kc[i].index_copy_(2, col, k.to(kc.dtype)[:, :, None])
            vc[i].index_copy_(2, col, v.to(vc.dtype)[:, :, None])
            ctx = attend(q.reshape(B, nkv, G, D).contiguous(), kc[i], vc[i],
                         valid if glob else local, scale)
            ctx = ctx.reshape(B, nq * D).to(cd)
            x = x + gemma3.rms_norm(lora_site(ctx @ a["o_w"], ctx, "o_proj",
                                              i), bp["post_attn_ln"], eps)
            x = x + _gemma_mlp(bp, x, lora_site, i, eps)
        x = gemma3.rms_norm(x, final_norm, eps)
        return _head_lora(x @ embed.T, x, lora_b, lora_impl)

    return step


def gemma3_generate(config: Gemma3TextConfig, params, input_ids,
                    attention_mask, cfg: SampleConfig,
                    generator: Optional[torch.Generator] = None,
                    compute_dtype=torch.float32, lora=None,
                    prefill_chunk: Optional[int] = None,
                    lora_impl: str = "auto", attn_impl: str = "auto",
                    events: Optional[List] = None, _eager: bool = False):
    """Gemma-3 generation (as gpt2_generate): GQA caches [L, B, Hkv, T, D],
    per-layer global/local RoPE and sliding-window validity over position
    ids. prefill_chunk: prompts longer than it are prefilled in W-sized
    windows against the growing cache (_gemma_chunked_prefill; the prompt
    is first left-padded to a multiple of W) instead of one whole-prompt
    forward."""
    c = config
    B, P = input_ids.shape
    N = cfg.max_new_tokens
    if N <= 0:
        return torch.zeros((B, 0), dtype=torch.int32,
                           device=input_ids.device)
    if prefill_chunk is not None and prefill_chunk < 1:
        raise ValueError(
            f"prefill_chunk must be >= 1, got {prefill_chunk}")
    validate_attn_impl(attn_impl)
    generator = _generator(generator, input_ids.device)
    lora_b = None if lora is None else lora.get("blocks")
    cd = compute_dtype
    chunked = prefill_chunk is not None and P > prefill_chunk
    if chunked:
        # pad on the LEFT to a window multiple (masked out; positions are
        # mask-derived, so phases do not move)
        W = int(prefill_chunk)
        pad_n = (-P) % W
        if pad_n:
            input_ids = torch.nn.functional.pad(input_ids, (pad_n, 0),
                                                value=cfg.pad_id)
            attention_mask = torch.nn.functional.pad(attention_mask,
                                                     (pad_n, 0))
            P += pad_n
    T = P + N
    _mark(events)
    with torch.no_grad():
        if chunked:
            blocks = [gemma3.layer_params(params, i, cd)
                      for i in range(c.num_hidden_layers)]
            last, kc, vc = _gemma_chunked_prefill(
                c, params, blocks, input_ids, attention_mask, lora_b, T, cd,
                W, lora_impl)
        else:
            x, (pk, pv) = gemma3.hidden_states(
                c, params, input_ids, attention_mask, lora=lora,
                compute_dtype=cd, attn_impl=attn_impl, lora_impl=lora_impl,
                collect_kv=True)
            last = x[:, -1]
            kc, vc = _caches(pk, pv, N)
        logits0 = _head_lora(last @ params["embed"].to(cd).T, last, lora_b,
                             lora_impl)
        _mark(events)
        step = gemma3_decoder(c, params, kc, vc, attention_mask, lora, cd,
                              lora_impl, attn_impl)
        return _decode_loop(step, logits0, generator, cfg, N, events,
                            graphed=not _eager)


# ------------------------------------------------- serving entry points -----


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


def gemma3_prefill(config: Gemma3TextConfig, params, input_ids,
                   attention_mask, compute_dtype=torch.float32, lora=None,
                   attn_impl: str = "auto"):
    """Gemma-3 serving prefill (as gpt2_prefill): (next-token logits
    [B, V] f32 at each row's last real position, (k, v) caches
    [L, B, Hkv, P, D]); the attention is the flash forward kernel on the
    card (ops/attention.py), windowed on the local layers."""
    x, (pk, pv) = gemma3.hidden_states(
        config, params, input_ids, attention_mask, lora=lora,
        compute_dtype=compute_dtype, collect_kv=True, attn_impl=attn_impl)
    n_real = attention_mask.sum(-1).long()
    last = x[torch.arange(x.shape[0], device=x.device), n_real - 1]
    logits = last @ params["embed"].to(compute_dtype).T
    lora_b = None if lora is None else lora.get("blocks")
    logits = _head_lora(logits, last, lora_b)
    return logits.float(), (pk, pv)


def _chunk_scalars(start, n_tok, device):
    """`start` and `n_tok` as 0-d int64 tensors on `device`: a chunk's
    shapes then depend on W alone, so one CUDA graph a bucket width serves
    every start and length. Tensors pass through as they are."""
    return tuple(v if isinstance(v, torch.Tensor)
                 else torch.full((), int(v), dtype=torch.int64,
                                 device=device)
                 for v in (start, n_tok))


def _chunk_rows(tbl, start, W: int, n_tok, bT: int):
    """(pos [W], real [W], page [W], offset [W]) of a chunk's rows, start
    and n_tok 0-d tensors: real rows land in their table page, padded ones
    in the trash page."""
    rows = torch.arange(W, device=tbl.device)
    pos = start + rows
    real = rows < n_tok
    page = tbl[0, torch.clamp(pos // bT, max=tbl.shape[1] - 1)].long()
    page = torch.where(real, page, torch.zeros_like(page))  # TRASH_BLOCK
    return pos, real, page, pos % bT


def _chunk_attention(q4, kq, vq, pool_k, pool_v, tbl, layer: int, ok_pre,
                     ok_in, scale):
    """One joint softmax over [the prefix pages | the chunk's own rows].

    q4 [W, KV, G, D]; kq / vq [W, KV, D] the chunk's K/V in the pool dtype;
    tbl [1, M]; ok_pre [W, M*bT] the attendable page columns, ok_in [W, W]
    the attendable chunk rows. f32 scores of the storage-dtype operands,
    probabilities cast to the value dtype, f32 P.V -> ctx [W, KV, G, D]
    f32."""
    kc = pool_k[tbl[0].long(), layer]                     # [M, KV, bT, D]
    vc = pool_v[tbl[0].long(), layer]
    W, KV, G, D = q4.shape
    M, _, bT, _ = kc.shape
    qf = q4.float()
    s1 = torch.einsum("wkgd,mktd->wkgmt", qf, kc.float()) * scale
    s1 = torch.where(ok_pre[:, None, None, :], s1.reshape(W, KV, G, M * bT),
                     NEG_INF)
    s2 = torch.einsum("wkgd,jkd->wkgj", qf, kq.float()) * scale
    s2 = torch.where(ok_in[:, None, None, :], s2, NEG_INF)
    p = torch.softmax(torch.cat([s1, s2], dim=-1), dim=-1)
    pre = p[..., :M * bT].reshape(W, KV, G, M, bT).to(vc.dtype).float()
    return (torch.einsum("wkgmt,mktd->wkgd", pre, vc.float())
            + torch.einsum("wkgj,jkd->wkgd",
                           p[..., M * bT:].to(vq.dtype).float(), vq.float()))


def _scatter_chunk(pool_k, pool_v, ks, vs, page, off):
    """Every layer's chunk K/V ([W, KV, D] each) into the pools at
    (page, offset) per row, in place."""
    pool_k[page, :, :, off, :] = torch.stack(ks, dim=1)    # [W, L, KV, D]
    pool_v[page, :, :, off, :] = torch.stack(vs, dim=1)


def gpt2_prefill_chunk(config: GPT2Config, params, pool_k, pool_v, ids,
                       start, n_tok, tbl, lora=None,
                       compute_dtype=torch.float32):
    """One fixed-width prefill CHUNK against the block pools: W prompt
    tokens from absolute position `start`, attending the pages earlier
    chunks (or the prefix cache) wrote and the chunk's own causal rows.

    ids [1, W] (pad past n_tok); start (a block_T multiple) and n_tok (the
    real tokens, 1..W) ints or 0-d int64 tensors on the pools' device (a
    graph's static inputs: every shape depends on W alone, and nothing is
    read back to the host); tbl [1, M] the request's block table. Returns
    (logits [1, V] f32 at the chunk's last real row, gathered at n_tok - 1,
    pool_k, pool_v), the chunk's K/V scattered into the pools in place
    after the layers (padded rows into the trash page)."""
    start, n_tok = _chunk_scalars(start, n_tok, ids.device)
    W = ids.shape[1]
    NB, L, H, bT, D = pool_k.shape
    E, eps = config.n_embd, config.layer_norm_epsilon
    cd = compute_dtype
    lora_b = None if lora is None else lora.get("blocks")
    pos, _, page, off = _chunk_rows(tbl, start, W, n_tok, bT)
    # padded rows clip their position (their K/V go to trash, their
    # logits are never read)
    x = params["wte"][ids[0]].to(cd) \
        + params["wpe"][torch.clamp(pos, max=config.n_positions - 1)].to(cd)
    ok_pre = (torch.arange(tbl.shape[1] * bT, device=ids.device)
              < start)[None].expand(W, -1)
    causal = pos[:, None] >= pos[None, :]
    ks, vs = [], []
    for i in range(L):
        bp = gpt2.layer_params(params, i, cd)
        h = gpt2.layer_norm(x, bp["ln_1"]["g"], bp["ln_1"]["b"], eps)
        q, k, v = gpt2.qkv_proj(config, bp, h, lora_b, i).split(E, dim=-1)
        kq = k.reshape(W, H, D).to(pool_k.dtype)   # the pool-dtype round
        vq = v.reshape(W, H, D).to(pool_v.dtype)   # trip
        ctx = _chunk_attention(q.reshape(W, H, 1, D), kq, vq, pool_k, pool_v,
                               tbl, i, ok_pre, causal, D ** -0.5)
        x = gpt2.mlp_and_proj(bp, x, ctx.reshape(W, E).to(cd), lora_b, i,
                              eps)
        ks.append(kq)
        vs.append(vq)
    _scatter_chunk(pool_k, pool_v, ks, vs, page, off)
    x = gpt2.layer_norm(x, params["ln_f"]["g"].to(cd),
                        params["ln_f"]["b"].to(cd), eps)
    last = x.index_select(0, (n_tok - 1).reshape(1))       # [1, E]
    logits = _head_lora(last @ params["wte"].to(cd).T, last, lora_b)
    return logits.float(), pool_k, pool_v


def gemma3_prefill_chunk(config: Gemma3TextConfig, params, pool_k, pool_v,
                         ids, start, n_tok, tbl, lora=None,
                         compute_dtype=torch.float32):
    """Gemma-3 prefill chunk (as gpt2_prefill_chunk): GQA pools, per-layer
    global / local RoPE at the chunk's absolute positions, and on local
    layers the sliding window over both the prefix pages and the chunk's
    own rows."""
    c = config
    start, n_tok = _chunk_scalars(start, n_tok, ids.device)
    W = ids.shape[1]
    NB, L, KV, bT, D = pool_k.shape
    nq = c.num_attention_heads
    G = nq // KV
    eps = c.rms_norm_eps
    scale = c.query_pre_attn_scalar ** -0.5
    cd = compute_dtype
    lora_b = None if lora is None else lora.get("blocks")
    lora_site = _gemma_lora(lora_b, "auto")
    pos, _, page, off = _chunk_rows(tbl, start, W, n_tok, bT)
    x = params["embed"][ids[0]].to(cd) \
        * torch.tensor(c.hidden_size ** 0.5, dtype=cd)
    ropes = {True: rope_cos_sin(pos[:, None], D, c.rope_theta),
             False: rope_cos_sin(pos[:, None], D, c.rope_local_base_freq)}
    cols = torch.arange(tbl.shape[1] * bT, device=ids.device)
    pre = (cols < start)[None].expand(W, -1)
    causal = pos[:, None] >= pos[None, :]
    masks = {True: (pre, causal),
             False: (pre & ((pos[:, None] - cols[None, :])
                            < c.sliding_window),
                     causal & ((pos[:, None] - pos[None, :])
                               < c.sliding_window))}
    ks, vs = [], []
    for i in range(L):
        glob = c.is_global_layer(i)
        bp = gemma3.layer_params(params, i, cd)
        a = bp["attn"]
        h = gemma3.rms_norm(x, bp["input_ln"], eps)
        q = lora_site(h @ a["q_w"], h, "q_proj", i).reshape(W, nq, D)
        k = lora_site(h @ a["k_w"], h, "k_proj", i).reshape(W, KV, D)
        v = lora_site(h @ a["v_w"], h, "v_proj", i).reshape(W, KV, D)
        q = gemma3.rms_norm(q, a["q_norm"], eps)
        k = gemma3.rms_norm(k, a["k_norm"], eps)
        q = apply_rope(q[:, :, None], *ropes[glob])[:, :, 0]
        k = apply_rope(k[:, :, None], *ropes[glob])[:, :, 0]
        kq, vq = k.to(pool_k.dtype), v.to(pool_v.dtype)
        ctx = _chunk_attention(q.reshape(W, KV, G, D), kq, vq, pool_k,
                               pool_v, tbl, i, *masks[glob], scale)
        ctx = ctx.reshape(W, nq * D).to(cd)
        x = x + gemma3.rms_norm(lora_site(ctx @ a["o_w"], ctx, "o_proj", i),
                                bp["post_attn_ln"], eps)
        x = x + _gemma_mlp(bp, x, lora_site, i, eps)
        ks.append(kq)
        vs.append(vq)
    _scatter_chunk(pool_k, pool_v, ks, vs, page, off)
    x = gemma3.rms_norm(x, params["final_norm"].to(cd), eps)
    last = x.index_select(0, (n_tok - 1).reshape(1))
    logits = _head_lora(last @ params["embed"].to(cd).T, last, lora_b)
    return logits.float(), pool_k, pool_v


def gemma3_decode_step_paged(config: Gemma3TextConfig, params, pool_k,
                             pool_v, tok, pos, tbl, lora=None,
                             compute_dtype=torch.float32,
                             attn_impl: str = "auto"):
    """One Gemma-3 continuous-batching decode step over the paged pools
    (as gpt2_decode_step_paged): GQA pools [NB, L, Hkv, bT, D], per-layer
    global / local RoPE, and the validity col <= pos, on local layers
    also pos - col < sliding_window (serve sequences are unpadded, so a
    column index is its position). attn_impl: "auto" =
    paged_decode_attention (row 12's kernel for CUDA pools), "plain" =
    paged_attention on any device."""
    validate_attn_impl(attn_impl)
    c = config
    S, M = tbl.shape
    NB, L, KV, bT, D = pool_k.shape
    nq = c.num_attention_heads
    G = nq // KV
    eps = c.rms_norm_eps
    scale = c.query_pre_attn_scalar ** -0.5
    cd = compute_dtype
    lora_b = None if lora is None else lora.get("blocks")
    lora_site = _gemma_lora(lora_b, "auto")
    attend = paged_attention if attn_impl == "plain" \
        else paged_decode_attention

    x = params["embed"][tok].to(cd) \
        * torch.tensor(c.hidden_size ** 0.5, dtype=cd)          # [S, H]
    ropes = {True: rope_cos_sin(pos[:, None], D, c.rope_theta),
             False: rope_cos_sin(pos[:, None], D, c.rope_local_base_freq)}
    cols = torch.arange(M * bT, device=pos.device)
    valid = cols[None, :] <= pos[:, None]                      # [S, M*bT]
    oks = {True: valid,
           False: valid & ((pos[:, None] - cols[None, :])
                           < c.sliding_window)}
    blk = tbl[torch.arange(S, device=tbl.device), pos // bT].long()
    off = pos % bT

    for i in range(L):
        glob = c.is_global_layer(i)
        bp = gemma3.layer_params(params, i, cd)
        a = bp["attn"]
        h = gemma3.rms_norm(x, bp["input_ln"], eps)
        q = lora_site(h @ a["q_w"], h, "q_proj", i).reshape(S, nq, D)
        k = lora_site(h @ a["k_w"], h, "k_proj", i).reshape(S, KV, D)
        v = lora_site(h @ a["v_w"], h, "v_proj", i).reshape(S, KV, D)
        q = gemma3.rms_norm(q, a["q_norm"], eps)
        k = gemma3.rms_norm(k, a["k_norm"], eps)
        q = apply_rope(q[:, :, None], *ropes[glob])[:, :, 0]
        k = apply_rope(k[:, :, None], *ropes[glob])[:, :, 0]
        # write before read: the fed token's K/V land in its current page
        pool_k[blk, i, :, off, :] = k.to(pool_k.dtype)
        pool_v[blk, i, :, off, :] = v.to(pool_v.dtype)
        ctx = attend(q.reshape(S, KV, G, D).to(pool_k.dtype).contiguous(),
                     pool_k, pool_v, tbl, i, oks[glob], scale)
        ctx = ctx.reshape(S, nq * D).to(cd)
        x = x + gemma3.rms_norm(lora_site(ctx @ a["o_w"], ctx, "o_proj", i),
                                bp["post_attn_ln"], eps)
        x = x + _gemma_mlp(bp, x, lora_site, i, eps)
    x = gemma3.rms_norm(x, params["final_norm"].to(cd), eps)
    logits = _head_lora(x @ params["embed"].to(cd).T, x, lora_b)
    return logits.float(), pool_k, pool_v
