"""Gemma-3 serving in the port against the JAX package (f32, CPU): the
serving model functions (`gemma3_prefill`, `gemma3_decode_step_paged`,
`gpt2_prefill_chunk`, `gemma3_prefill_chunk`) on the same weights, inputs
and pools (logits within 1e-4, pools within 1e-5; Gemma's window is
smaller than the sequence, so the local layers mask), and the port's
Gemma ServeEngine against the JAX Gemma engine: per-request greedy tokens
identical with and without a 2-tenant bank, with the prefix cache and
chunked admission on; plus the multi-adapter guards, memory admission at
Gemma-3-270M's width, and build_engine("tiny-gemma")."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.core.config import Gemma3TextConfig as JaxGemma
from mobilefinetuner_tpu.lora import lora as jlora
from mobilefinetuner_tpu.models import gemma3 as jgemma
from mobilefinetuner_tpu.models import generate as jgen
from mobilefinetuner_tpu.models import gpt2 as jgpt2
from mobilefinetuner_tpu.serve import AdapterBank as JaxAdapterBank
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.core.memory_guard import MemoryAdmissionError
from mobilefinetuner_tpu_torch.lora import lora as plora
from mobilefinetuner_tpu_torch.models import generate as gen
from mobilefinetuner_tpu_torch.serve import (AdapterBank, ServeConfig,
                                             ServeEngine)
from mobilefinetuner_tpu_torch.serve.bench import build_engine

# sliding_window (6) < prompt + generation, so local layers truncate
JAX_GEMMA = dataclasses.replace(
    JaxGemma.tiny(vocab_size=199), hidden_size=48, head_dim=12,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
    num_hidden_layers=4, sliding_window=6, sliding_window_pattern=3)
GEMMA = Gemma3TextConfig(**{f.name: getattr(JAX_GEMMA, f.name)
                            for f in dataclasses.fields(Gemma3TextConfig)})
JAX_GPT2 = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=96,
    n_layer=3)
GPT2 = GPT2Config(**{f.name: getattr(JAX_GPT2, f.name)
                     for f in dataclasses.fields(GPT2Config)})
SHAPE = dict(num_slots=2, block_T=8, num_blocks=64, max_prompt=16,
             max_new_tokens=10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def gemma_np():
    p = _np_tree(jgemma.init_params(JAX_GEMMA, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    # norm weights off zero so the (1 + w) convention is exercised
    for grp in ("input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln"):
        p["blocks"][grp] = (0.1 * rng.normal(
            size=p["blocks"][grp].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def gemma_pt(gemma_np):
    return convert.gemma3_params_from_numpy(gemma_np, device="cpu")


@pytest.fixture(scope="module")
def gpt2_np():
    return _np_tree(jgpt2.init_params(JAX_GPT2, jax.random.PRNGKey(0)))


def np_gemma_adapter(seed, config=JAX_GEMMA):
    """A rank-3 numpy adapter on every Gemma site, B off zero."""
    lora = _np_tree(jlora.init_lora_gemma3(
        config, jlora.LoRASpec(rank=3, alpha=6.0), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 50)
    for entry in lora["blocks"].values():
        for leaf in ("A", "B"):
            entry[leaf] = (0.05 * rng.standard_normal(
                entry[leaf].shape)).astype(np.float32)
    return lora


def np_gpt2_adapter(seed):
    lora = _np_tree(jlora.init_lora_gpt2(
        JAX_GPT2, jlora.LoRASpec(rank=3, alpha=6.0),
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 50)
    for entry in lora["blocks"].values():
        entry["B"] = (0.05 * rng.standard_normal(
            entry["B"].shape)).astype(np.float32)
    return lora


def routed(trees, ids):
    """(JAX, port) routed multi-adapter trees: the adapters stacked with a
    zero base slot, rows routed by `ids`."""
    zero = jax.tree.map(np.zeros_like, trees[0])
    stack = _np_tree(jlora.stack_adapters(list(trees) + [zero]))
    jt = jlora.assign_adapters(jax.tree.map(jnp.asarray, stack),
                               jnp.asarray(ids, jnp.int32))
    pt = plora.assign_adapters(convert.lora_from_numpy(stack, device="cpu"),
                               np.asarray(ids))
    return jt, pt


def rand_pools(NB, L, KV, bT, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(NB, L, KV, bT, D)).astype(np.float32)
            for _ in range(2)]


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


# ----------------------------------------------------- model functions ----

def test_gemma3_prefill_matches_jax(gemma_np, gemma_pt):
    """Right-padded prompts of 16 and 11 tokens (the window bites): logits
    at each row's last real position and every layer's K/V."""
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 199, (2, 16)).astype(np.int64)
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    ids[1, 11:] = 0
    want, (wk, wv) = jgen.gemma3_prefill(JAX_GEMMA, gemma_np,
                                         jnp.asarray(ids, jnp.int32),
                                         jnp.asarray(mask, jnp.int32))
    got, (gk, gv) = gen.gemma3_prefill(GEMMA, gemma_pt, t(ids), t(mask))
    close(got, want, 1e-4)
    close(gk, wk, 1e-5)
    close(gv, wv, 1e-5)


def _decode_inputs(seed):
    """Pools, a block table of 3 slots (the last idle), positions past the
    window and fed tokens."""
    NB, bT, M = 16, 4, 6
    pk, pv = rand_pools(NB, GEMMA.num_hidden_layers,
                        GEMMA.num_key_value_heads, bT, GEMMA.head_dim, seed)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, NB))
    tbl = np.zeros((3, M), np.int32)
    tbl[0] = pages[:M]
    tbl[1, :4] = pages[M:M + 4]
    pos = np.asarray([21, 13, 0], np.int64)
    tok = rng.integers(1, 199, 3).astype(np.int64)
    tok[2] = 0
    return pk, pv, tbl, pos, tok


@pytest.mark.parametrize("tenants", [False, True], ids=["base", "routed"])
def test_gemma3_decode_step_paged_matches_jax(gemma_np, gemma_pt, tenants):
    """One decode step over the paged pools: slot 0 at position 21 and
    slot 1 at 13 (local layers see the last 6 columns only), slot 2 idle;
    with tenants, rows routed to two adapters and the base."""
    pk, pv, tbl, pos, tok = _decode_inputs(3)
    jl = pl = None
    if tenants:
        jl, pl = routed([np_gemma_adapter(5), np_gemma_adapter(9)],
                        [0, 2, 1])
    want, wk, wv = jgen.gemma3_decode_step_paged(
        JAX_GEMMA, gemma_np, jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tok, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(tbl), lora=jl)
    gk, gv = t(pk.copy()), t(pv.copy())
    got, _, _ = gen.gemma3_decode_step_paged(GEMMA, gemma_pt, gk, gv, t(tok),
                                             t(pos), t(tbl), lora=pl)
    close(got, want, 1e-4)
    # page 0 takes the idle slot's write (which duplicate wins is free)
    close(gk[1:], np.asarray(wk)[1:], 1e-5)
    close(gv[1:], np.asarray(wv)[1:], 1e-5)


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
@pytest.mark.parametrize("tenant", [False, True], ids=["base", "routed"])
def test_prefill_chunk_matches_jax(gemma_np, gemma_pt, gpt2_np, family,
                                   tenant):
    """A chunk of 6 real tokens in an 8-wide bucket from position 16,
    attending 4 pages of earlier prompt (window 6 < 22 on Gemma's local
    layers): the last real row's logits, and the pools after the chunk's
    scatter (padded rows go to the trash page)."""
    if family == "gpt2":
        jcfg, pcfg, jp = JAX_GPT2, GPT2, gpt2_np
        pp = convert.gpt2_params_from_numpy(gpt2_np, device="cpu")
        L, KV, D = GPT2.n_layer, GPT2.n_head, GPT2.head_dim
        jfn, pfn = jgen.gpt2_prefill_chunk, gen.gpt2_prefill_chunk
        adapters = [np_gpt2_adapter(1), np_gpt2_adapter(2)]
    else:
        jcfg, pcfg, jp, pp = JAX_GEMMA, GEMMA, gemma_np, gemma_pt
        L, KV, D = (GEMMA.num_hidden_layers, GEMMA.num_key_value_heads,
                    GEMMA.head_dim)
        jfn, pfn = jgen.gemma3_prefill_chunk, gen.gemma3_prefill_chunk
        adapters = [np_gemma_adapter(5), np_gemma_adapter(9)]
    bT, NB, M, W, start, n_tok = 4, 16, 8, 8, 16, 6
    pk, pv = rand_pools(NB, L, KV, bT, D, 4)
    rng = np.random.default_rng(4)
    tbl = np.zeros((1, M), np.int32)
    tbl[0, :6] = rng.permutation(np.arange(1, NB))[:6]
    ids = np.zeros((1, W), np.int64)
    ids[0, :n_tok] = rng.integers(1, 199, n_tok)
    jl = pl = None
    if tenant:
        jl, pl = routed(adapters, [1] * W)
    want, wk, wv = jfn(jcfg, jp, jnp.asarray(pk), jnp.asarray(pv),
                       jnp.asarray(ids, jnp.int32), jnp.int32(start),
                       jnp.int32(n_tok), jnp.asarray(tbl), lora=jl)
    gk, gv = t(pk.copy()), t(pv.copy())
    got, _, _ = pfn(pcfg, pp, gk, gv, t(ids), start, n_tok, t(tbl), lora=pl)
    close(got, want, 1e-4)
    close(gk[1:], np.asarray(wk)[1:], 1e-5)
    close(gv[1:], np.asarray(wv)[1:], 1e-5)
    # the chunk's real rows landed in their table pages
    assert not torch.equal(gk[tbl[0, 4]], t(pk[tbl[0, 4]]))


def test_gemma3_chunked_prefill_equals_one_shot(gemma_pt):
    """The port against itself: a prompt of 22 tokens prefilled one-shot
    and as chunks of 8, 8 and 6 gives the same next-token logits and the
    same pool pages."""
    rng = np.random.default_rng(6)
    P, bT, L, KV, D = 22, 8, 4, 2, 12
    ids = torch.from_numpy(rng.integers(1, 199, (1, P)))
    logits, (k, v) = gen.gemma3_prefill(GEMMA, gemma_pt, ids,
                                        torch.ones_like(ids))
    pk, pv = (torch.zeros(8, L, KV, bT, D) for _ in range(2))
    tbl = torch.tensor([[3, 5, 2, 0]], dtype=torch.int32)
    for start in (0, 8, 16):
        n = min(8, P - start)
        chunk = torch.zeros(1, 8, dtype=torch.long)
        chunk[0, :n] = ids[0, start:start + n]
        got, _, _ = gen.gemma3_prefill_chunk(GEMMA, gemma_pt, pk, pv, chunk,
                                             start, n, tbl)
    close(got, logits, 1e-4)
    for j, page in enumerate((3, 5, 2)):
        cols = slice(8 * j, min(8 * j + 8, P))
        n = cols.stop - cols.start
        close(pk[page, :, :, :n], k[:, 0, :, cols], 1e-5)
        close(pv[page, :, :, :n], v[:, 0, :, cols], 1e-5)


# ------------------------------------------------------------ the engine --

def gemma_prompts(seed):
    """Every admission path: a shared 16-token prefix with a suffix (a
    chunked miss, then partial hits), the bare prefix (a full hit once it
    is cached), a long chunked prompt, and short one-shot prompts."""
    rng = np.random.default_rng(seed)
    common = [int(x) for x in rng.integers(3, 190, 16)]
    rand = lambda n: [int(x) for x in rng.integers(3, 190, n)]  # noqa: E731
    return [common + rand(5), rand(7), common + rand(3), list(common),
            rand(33), rand(12), list(common), common[:8] + rand(20)]


def serve_both(gemma_np, gemma_pt, prompts, routes, shape):
    """The same requests through the JAX and the port Gemma engine;
    returns (JAX engine, JAX requests, port engine, port requests)."""
    trees = [np_gemma_adapter(5), np_gemma_adapter(9)]
    banked = any(r is not None for r in routes)
    jeng = JaxServeEngine("gemma", JAX_GEMMA, gemma_np,
                          JaxServeConfig(**shape),
                          bank=JaxAdapterBank(trees[0], capacity=2)
                          if banked else None)
    peng = ServeEngine("gemma", GEMMA, gemma_pt, ServeConfig(**shape),
                       bank=AdapterBank(convert.lora_from_numpy(
                           trees[0], device="cpu"), capacity=2,
                           family="gemma") if banked else None,
                       device="cpu")
    for i, tree in enumerate(trees if banked else []):
        jeng.load_adapter(f"t{i}", tree)
        peng.load_adapter(f"t{i}", convert.lora_from_numpy(tree,
                                                           device="cpu"))
    out = []
    for eng in (jeng, peng):
        reqs = [eng.submit(p, max_new_tokens=8, adapter=a)
                for p, a in zip(prompts, routes)]
        done = eng.drain()
        assert sorted(r.id for r in done) == [r.id for r in reqs]
        out += [eng, reqs]
    jeng.close()
    return out


@pytest.mark.parametrize("routes", [
    [None] * 8, [None, "t0", "t1", None, "t0", None, "t1", None]],
    ids=["base", "two_tenants"])
def test_gemma_engine_matches_jax_engine(gemma_np, gemma_pt, routes):
    """8 requests through 2 slots with the prefix cache and chunked
    admission: greedy tokens identical to the JAX engine's, the same
    prefix hit rate and page copies, every page returned or parked."""
    shape = dict(SHAPE, prefix_cache=True, max_prompt_chunked=40)
    jeng, jreqs, peng, preqs = serve_both(gemma_np, gemma_pt,
                                          gemma_prompts(1), routes, shape)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    assert peng.prefix.hit_rate == jeng.prefix.hit_rate > 0
    assert peng.cow_copies == jeng.cow_copies >= 1
    assert peng.chunks > 0 and peng.prefills > 0 and peng.full_hits >= 1
    assert peng.alloc.in_use == 0 and peng.alloc.refcounts == {}
    assert sorted(peng.alloc.parked) == peng.prefix.blocks
    peng.prefix.check_consistent()


def test_gemma_engine_without_cache_matches_jax_engine(gemma_np, gemma_pt):
    """The plain engine (no cache, no chunking, one-shot prompts only)
    with two tenants: greedy tokens identical to the JAX engine's."""
    rng = np.random.default_rng(2)
    prompts = [[int(x) for x in rng.integers(3, 190, n)]
               for n in (7, 16, 11, 4, 9)]
    routes = ["t0", "t1", None, "t0", None]
    jeng, jreqs, peng, preqs = serve_both(gemma_np, gemma_pt, prompts,
                                          routes, SHAPE)
    assert [r.tokens for r in preqs] == [r.tokens for r in jreqs]
    assert peng.prefills == len(prompts) and peng.chunks == 0
    assert peng.alloc.free_blocks == SHAPE["num_blocks"] - 1


def test_gemma_hot_swap_and_tenancy_guards(gemma_np, gemma_pt):
    """Evict a tenant and load a new one in its slot: its requests get the
    new weights (the JAX engine's tokens), a queued request pins its
    adapter, and a reload makes the tenant's cached prefix pages
    unreachable (a fresh miss, not a hit)."""
    trees = [np_gemma_adapter(s) for s in (5, 9, 13)]
    shape = dict(SHAPE, num_slots=1, prefix_cache=True)
    jeng = JaxServeEngine("gemma", JAX_GEMMA, gemma_np,
                          JaxServeConfig(**shape),
                          bank=JaxAdapterBank(trees[0], capacity=2))
    peng = ServeEngine("gemma", GEMMA, gemma_pt, ServeConfig(**shape),
                       bank=AdapterBank(convert.lora_from_numpy(
                           trees[0], device="cpu"), capacity=2,
                           family="gemma"), device="cpu")
    pt = [convert.lora_from_numpy(x, device="cpu") for x in trees]
    prompt = [int(x) for x in np.random.default_rng(3).integers(3, 190, 16)]
    for eng, tr in ((jeng, trees), (peng, pt)):
        eng.load_adapter("a", tr[0])
        eng.load_adapter("b", tr[1])
    active = peng.submit(prompt, max_new_tokens=4, adapter="a")
    peng.step()
    queued = peng.submit(prompt, max_new_tokens=4, adapter="b")
    with pytest.raises(RuntimeError, match="in-flight"):
        peng.load_adapter("b", pt[2])
    with pytest.raises(RuntimeError, match="in-flight"):
        peng.evict_adapter("b")
    with pytest.raises(OverflowError, match="full"):
        peng.load_adapter("c", pt[2])
    peng.drain()
    assert active.state == queued.state == "finished"
    out = {}
    for eng, tr in ((jeng, trees), (peng, pt)):
        eng.evict_adapter("b")
        eng.load_adapter("c", tr[2])
        first = eng.submit(prompt, max_new_tokens=6, adapter="c")
        eng.drain()
        eng.load_adapter("c", tr[2])     # reload: generation bump
        again = eng.submit(prompt, max_new_tokens=6, adapter="c")
        eng.drain()
        out[eng is peng] = (first.tokens, again.tokens, eng.cow_copies)
    assert out[True] == out[False]
    assert out[True][0] == out[True][1]
    assert peng.cow_copies == 0          # the reload's pages never hit
    jeng.close()


def test_gemma_270m_memory_admission_counts_its_width():
    """Admission at Gemma-3-270M's width, on meta tensors (nothing is
    allocated): the 262,144 x 640 embedding and 18 layers of 5,570,560
    weights (511 MB in bf16), pools [NB, 18, 1, 16, 256] at 0.28 MB a bf16
    page, block tables over the true cap (608 + 64 - 1 columns: 42
    pages); a 400 MB cap refuses the config and names what fits."""
    config = Gemma3TextConfig.gemma3_270m()
    with torch.device("meta"):
        params = {"embed": torch.empty(262144, 640),
                  "blocks": {"w": torch.empty(18, 5570560)}}
    cfg = ServeConfig(num_slots=8, block_T=16, num_blocks=512,
                      max_prompt=128, max_prompt_chunked=608,
                      max_new_tokens=64, dtype="bfloat16", hbm_cap_mb=400)
    with pytest.raises(MemoryAdmissionError) as err:
        ServeEngine("gemma", config, params, cfg, device="cpu")
    msg = str(err.value)
    assert "(0.28 MB/page)" in msg and "KV pool 144 MB" in msg
    assert "requests of 42 pages each" in msg
    assert "params 511 MB" in msg


def test_build_engine_tiny_gemma_serves_on_the_cpu():
    """build_engine("tiny-gemma") with every feature on: sampled and
    greedy requests finish, pages all return or park, and the bank holds
    Gemma trees at its 7 sites."""
    eng, names = build_engine("tiny-gemma", num_slots=2, block_T=8,
                              num_blocks=64, max_prompt=32, max_new=6,
                              adapters=2, dtype="float32", prefix_cache=True,
                              max_prompt_chunked=64, sampling=True,
                              device="cpu")
    assert sorted(eng.bank.tree["blocks"]) == sorted(
        ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
         "down_proj"])
    rng = np.random.default_rng(0)
    reqs = [eng.submit([int(x) for x in rng.integers(1, 300, n)],
                       adapter=a, temperature=temp, top_k=20, top_p=0.9,
                       seed=i)
            for i, (n, a, temp) in enumerate(
                [(10, names[0], 0.0), (50, None, 0.8), (20, names[1], 0.8),
                 (40, None, 0.0)])]
    eng.drain()
    assert all(r.state == "finished" and len(r.tokens) == 6 for r in reqs)
    assert all(0 <= x < 300 for r in reqs for x in r.tokens)
    assert eng.alloc.in_use == 0
    eng.prefix.check_consistent()
    with pytest.raises(ValueError, match="unknown model"):
        build_engine("gemma9b", device="cpu")


def test_gemma_entry_points_refuse_to_run_without_a_card(monkeypatch,
                                                        gemma_np):
    """device=None means the CUDA card: without one the Gemma serving
    entry points raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine("tiny-gemma")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gemma3_params_from_numpy(gemma_np)
    params = convert.gemma3_params_from_numpy(gemma_np, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine("gemma", GEMMA, params, ServeConfig(**SHAPE))
