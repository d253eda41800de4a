"""The port's shared-prefix cache, chunked admission and per-slot sampling
(serve/prefix_cache.py, serve/paged_kv.py's parking verbs, serve/engine.py,
models/generate.sample_per_row) against the JAX package where both define
the result, f32 on the CPU:

* `chain_keys` byte-equal to the JAX ones; one sequence of allocator and
  prefix-cache verbs replayed on both packages gives identical refcounts,
  parked sets and evictions;
* the GPT-2 engine with the cache and chunking on gives the JAX engine's
  greedy tokens over three waves of every admission path (one-shot, full
  hit with its page copy, partial hit, chunked), the same hit rate and
  page copies, and leaves every page returned or parked;
* the port's own sampling contract (it is not threefry, so the tokens are
  not the JAX engine's): temperature 0 is the greedy oracle bit for bit,
  a seed gives the same tokens, across admission paths too, draws fall
  inside the top-k / top-p set, and a chi-square test of one row's
  frequencies against its filtered softmax."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.models import gpt2 as jgpt2
from mobilefinetuner_tpu.serve import BlockAllocator as JaxAllocator
from mobilefinetuner_tpu.serve import PrefixCache as JaxPrefixCache
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine
from mobilefinetuner_tpu.serve import chain_keys as jax_chain_keys
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.models import generate as gen
from mobilefinetuner_tpu_torch.ops.dropout import fold_in, fold_in_tensor
from mobilefinetuner_tpu_torch.serve import (BlockAllocator, PrefixCache,
                                             ServeConfig, ServeEngine,
                                             chain_keys)

JAX_CFG = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=96,
    n_layer=3)
CFG = GPT2Config(**{f.name: getattr(JAX_CFG, f.name)
                    for f in dataclasses.fields(GPT2Config)})
SHAPE = dict(num_slots=3, block_T=8, num_blocks=64, max_prompt=16,
             max_new_tokens=12)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jgpt2.init_params(JAX_CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(np_params):
    return convert.gpt2_params_from_numpy(np_params, device="cpu")


def engine(params, **kw):
    return ServeEngine("gpt2", CFG, params, ServeConfig(**{**SHAPE, **kw}),
                       device="cpu")


def ints(rng, n):
    return [int(x) for x in rng.integers(1, 200, n)]


def mix_prompts(rng, common):
    """Every admission path in one request set: partial hits, a full hit
    (page copy), a chunked long prompt, and a chunked prompt whose
    partial hit shortens the suffix."""
    return [common + ints(rng, 5), common + ints(rng, 3), list(common),
            ints(rng, 40), common[:8] + ints(rng, 30)]


# ------------------------------------------------------------ key hashing --

@pytest.mark.parametrize("block_T", [4, 8, 16])
def test_chain_keys_are_the_jax_keys(block_T):
    rng = np.random.default_rng(block_T)
    for n in (0, 3, 16, 37):
        prompt = ints(rng, n) + [262143, 0]      # wide ids hash too
        for ident in ("base", "t1:0", "tenant0:3"):
            assert chain_keys(prompt, block_T, ident) \
                == jax_chain_keys(prompt, block_T, ident)


def test_chain_keys_full_blocks_chained_and_identity_seeded():
    p = list(range(100, 120))                    # 20 tokens, block_T 8
    ks = chain_keys(p, 8, "base")
    assert len(ks) == 2                          # partial tail never keyed
    assert chain_keys(p[:16], 8, "base") == ks
    assert chain_keys(p[:8], 8, "base") == ks[:1]
    mut = [p[0] + 1] + p[1:]
    assert chain_keys(mut, 8, "base")[0] != ks[0]
    assert chain_keys(mut, 8, "base")[1] != ks[1]
    assert chain_keys(p, 8, "t1:0") != ks
    assert chain_keys(p, 8, "t1:1") != chain_keys(p, 8, "t1:0")
    assert chain_keys(p[:7], 8, "base") == []


# ---------------------------------------------------- allocator + cache ----

def _replay(alloc_cls, cache_cls):
    """One fixed sequence of allocator and cache verbs; the state after
    each verb (refcounts, parked pages in LRU order, free count, cache
    size) and every eviction the cache saw."""
    alloc = alloc_cls(9)
    cache = cache_cls(alloc, 4)
    evicted = []
    inner = alloc.on_evict
    alloc.on_evict = lambda b, k: (evicted.append(b), inner(b, k))
    keys = [bytes([i]) * 16 for i in range(12)]
    states = []

    def snap():
        states.append((alloc.refcounts, list(alloc._parked),
                       alloc.free_blocks, alloc.in_use, len(cache),
                       cache.lookup(keys[:3]), cache.lookup(keys[3:6])))

    a = alloc.alloc(3)
    for k, b in zip(keys[:3], a):
        cache.register(k, b)
    snap()
    for b in cache.lookup(keys[:3]):
        alloc.acquire(b)                 # a second request shares a
    snap()
    alloc.free(a, park=cache.park)       # the first finishes
    snap()
    alloc.free(a, park=cache.park)       # the second: the pages park
    snap()
    b = alloc.alloc(2)
    for k, x in zip(keys[3:5], b):
        cache.register(k, x)
    alloc.free(b, park=cache.park)
    snap()
    for x in cache.lookup(keys[:2]):
        alloc.acquire(x)                 # adopt parked pages
    snap()
    c = alloc.alloc(5)                   # reclaims parked pages, LRU first
    snap()
    alloc.free(c, park=cache.park)
    alloc.free(cache.lookup(keys[:2]), park=cache.park)
    snap()
    cache.flush()
    snap()
    return states, evicted


def test_allocator_and_cache_verbs_replay_the_jax_ones():
    got = _replay(BlockAllocator, PrefixCache)
    want = _replay(JaxAllocator, JaxPrefixCache)
    assert got == want
    assert got[1]                        # evictions happened


def test_allocator_parking_verbs():
    a = BlockAllocator(6)
    got = a.alloc(2)
    a.free(got, park=lambda b: b"k" if b == got[0] else None)
    assert a.parked == [got[0]] and a.in_use == 0 and a.free_blocks == 5
    a.adopt(got[0])
    assert a.refcounts == {got[0]: 1} and a.parked == []
    with pytest.raises(ValueError, match="adopt"):
        a.adopt(got[0])
    a.free([got[0]], park=lambda b: b"k")
    assert a.flush_parked() == 1 and a.parked == []
    assert a.free_blocks == 5


# ------------------------------------------------ cache-on engine parity ---

def test_prefix_engine_matches_jax_engine_over_three_waves(np_params,
                                                           params):
    rng = np.random.default_rng(0)
    common = ints(rng, 16)                       # two full blocks
    prompts = mix_prompts(rng, common)
    shape = dict(SHAPE, prefix_cache=True, max_prompt_chunked=48)
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params, JaxServeConfig(**shape))
    peng = engine(params, prefix_cache=True, max_prompt_chunked=48)
    assert peng.chunk_buckets == jeng.chunk_buckets == (8, 16)
    for wave in range(3):
        toks = []
        for eng in (jeng, peng):
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            eng.drain()
            toks.append([r.tokens for r in reqs])
        assert toks[0] == toks[1], f"wave {wave}"
        assert peng.alloc.in_use == 0 and peng.alloc.refcounts == {}
        assert sorted(peng.alloc.parked) == sorted(jeng.alloc._parked)
        peng.prefix.check_consistent()
    assert peng.cow_copies == jeng.cow_copies >= 1
    assert peng.prefix.hit_rate == jeng.prefix.hit_rate > 0.3
    h = peng.health()
    assert h["prefix_hit_rate"] == peng.prefix.hit_rate
    assert h["cow_copies"] == peng.cow_copies
    assert h["parked_blocks"] == peng.alloc.parked_blocks > 0
    jeng.close()


def test_cache_off_engine_gives_the_cache_on_tokens(params):
    rng = np.random.default_rng(0)
    prompts = mix_prompts(rng, ints(rng, 16))
    out = []
    for cache in (False, True):
        eng = engine(params, prefix_cache=cache, max_prompt_chunked=48)
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.drain()
        out.append([r.tokens for r in reqs])
    assert eng.prefix is not None and out[0] == out[1]


def test_shared_pages_refcounted_while_live(params):
    eng = engine(params, prefix_cache=True, max_prompt_chunked=48)
    rng = np.random.default_rng(7)
    common = ints(rng, 16)
    seed = eng.submit(common, max_new_tokens=2)   # registers the blocks
    eng.drain()
    ra = eng.submit(common + ints(rng, 4), max_new_tokens=4)
    rb = eng.submit(common + ints(rng, 6), max_new_tokens=4)
    eng.step()                                    # both admitted
    assert ra.blocks[:2] == rb.blocks[:2] != seed.blocks
    for b in ra.blocks[:2]:
        assert eng.alloc.refcounts[b] == 2
    eng.drain()
    assert eng.alloc.refcounts == {} and eng.alloc.in_use == 0
    assert eng.alloc.parked_blocks > 0
    eng.prefix.check_consistent()


def test_chunk_budget_and_cancel_mid_walk(np_params, params):
    """Chunk widths cap at max_prompt, so a 40-token prompt walks several
    chunks with decode steps between them; a cancel mid-walk releases
    everything; the survivor's tokens are the JAX engine's."""
    eng = engine(params, prefix_cache=True, max_prompt_chunked=48)
    rng = np.random.default_rng(11)
    victim = eng.submit(ints(rng, 40), max_new_tokens=4)
    eng.step()                                    # one 16-wide chunk
    assert victim.state == "active" and victim.prefilling
    assert victim.prefill_pos == 16 and eng.chunks == 1
    eng.cancel(victim)
    assert victim.state == "cancelled" and not victim.blocks
    assert eng.alloc.in_use == 0 and eng.alloc.refcounts == {}
    prompt = ints(rng, 40)
    survivor = eng.submit(prompt, max_new_tokens=4)
    eng.drain()
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params, JaxServeConfig(
        **SHAPE, prefix_cache=True, max_prompt_chunked=48))
    want = jeng.submit(prompt, max_new_tokens=4)
    jeng.drain()
    jeng.close()
    assert survivor.tokens == want.tokens


def test_true_cap_and_containment_flush_the_cache(params):
    eng = engine(params, prefix_cache=True, max_prompt_chunked=48)
    over = eng.submit(list(range(1, 50)))         # 49 > true cap 48
    assert over.state == "rejected" and over.reason == "prompt_too_long"
    rng = np.random.default_rng(2)
    eng.submit(ints(rng, 16), max_new_tokens=2)
    eng.drain()
    assert len(eng.prefix) == 2 and eng.alloc.parked_blocks == 2
    live = eng.submit(ints(rng, 10), max_new_tokens=8)

    def boom(step):
        raise RuntimeError("injected")

    eng.step_hook = boom
    eng.step()
    assert live.state == "error" and live.reason == "RuntimeError"
    assert len(eng.prefix) == 0 and eng.alloc.parked_blocks == 0
    assert eng.alloc.free_blocks == SHAPE["num_blocks"] - 1
    assert float(eng.pool_k.abs().sum()) == 0.0
    eng.step_hook = None


# ------------------------------------------------------------ sampling -----

def test_fold_in_tensor_is_fold_in():
    rng = np.random.default_rng(0)
    seeds = [int(x) for x in rng.integers(0, 2 ** 63, 200, dtype=np.uint64)]
    seeds += [0, 1, 2 ** 63 - 1]
    data = [int(x) for x in rng.integers(0, 2 ** 20, len(seeds))]
    got = fold_in_tensor(torch.tensor(seeds), torch.tensor(data)).tolist()
    assert got == [fold_in(s, d) for s, d in zip(seeds, data)]


def test_sample_per_row_mixes_greedy_and_sampled_rows():
    """Rows with temperature 0 take the argmax bit for bit; sampled rows
    land inside their own top-k and top-p set at every position."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 64, generator=g) * 3
    temp = torch.tensor([0.0, 0.8, 0.8, 1.3])
    top_k = torch.tensor([0, 5, 0, 0])
    top_p = torch.tensor([1.0, 1.0, 0.6, 1.0])
    seed = torch.tensor([7, 7, 8, 9])
    for pos in range(60):
        out = gen.sample_per_row(logits, temp, top_k, top_p, seed,
                                 torch.full((4,), pos))
        assert out[0] == logits[0].argmax()
        assert out[1] in torch.topk(logits[1], 5).indices
        cfg = gen.SampleConfig(temperature=0.8, top_p=0.6)
        kept = gen._filter_logits(logits[2:3] / 0.8, cfg)[0] > gen.NEG_INF
        assert kept[out[2]]


def test_sampling_frequencies_match_the_filtered_softmax():
    """Chi-square: 40,000 draws of one fixed row (one seed, positions
    0..39,999) against the softmax of its filtered, tempered logits
    (p-value floor 1e-3), nothing outside the filter."""
    from scipy import stats
    logits = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 50)).astype(np.float32))
    scfg = gen.SampleConfig(temperature=0.7, top_k=20, top_p=0.9)
    probs = torch.softmax(gen._filter_logits(logits / 0.7, scfg), -1)[0]
    n = 40_000
    draws = gen.sample_per_row(
        logits.expand(n, -1).contiguous(), torch.full((n,), 0.7),
        torch.full((n,), 20), torch.full((n,), 0.9),
        torch.full((n,), 1234, dtype=torch.long), torch.arange(n))
    counts = np.bincount(draws.numpy(), minlength=50)
    keep = probs.numpy() > 0
    assert counts[~keep].sum() == 0
    expected = probs.numpy()[keep] * n
    assert stats.chisquare(counts[keep], expected).pvalue > 1e-3


def test_sampling_engine_temperature_zero_is_greedy_and_seeds_repeat(
        np_params, params):
    """On a sampling engine, temperature-0 requests give the JAX greedy
    engine's tokens bit for bit beside sampled slots; the same seed gives
    the same tokens, another seed others."""
    eng = engine(params, num_slots=2, sampling=True)
    rng = np.random.default_rng(3)
    common = ints(rng, 16)
    greedy = eng.submit(common, max_new_tokens=8)
    kw = dict(max_new_tokens=8, temperature=0.9, top_k=40, top_p=0.95)
    s1 = eng.submit(common, seed=1234, **kw)
    eng.drain()
    s2 = eng.submit(common, seed=1234, **kw)
    s3 = eng.submit(common, seed=99, **kw)
    eng.drain()
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params,
                          JaxServeConfig(**dict(SHAPE, num_slots=2)))
    want = jeng.submit(common, max_new_tokens=8)
    jeng.drain()
    jeng.close()
    assert greedy.tokens == want.tokens
    assert s1.tokens == s2.tokens
    assert s2.tokens != s3.tokens
    assert s1.tokens != greedy.tokens


def test_sampling_seed_survives_admission_path_change(params):
    """The draw is keyed on (seed, position), not on how the prompt
    entered the pool: a chunked cold admission, a prefix hit of the same
    prompt, and a one-shot admission on a cache-off engine with a wider
    max_prompt all sample the same tokens."""
    rng = np.random.default_rng(5)
    long_p = ints(rng, 36)
    kw = dict(max_new_tokens=8, temperature=0.8, seed=7)
    eng = engine(params, num_slots=2, sampling=True, prefix_cache=True,
                 max_prompt_chunked=48)
    a = eng.submit(long_p, **kw)
    eng.drain()                                   # chunked, cold cache
    b = eng.submit(long_p, **kw)
    eng.drain()                                   # prefix hit
    assert eng.prefix.hit_rate > 0 and eng.chunks >= 4
    one = engine(params, num_slots=2, sampling=True, max_prompt=48)
    c = one.submit(long_p, **kw)
    one.drain()
    assert one.prefills == 1 and one.chunks == 0
    assert a.tokens == b.tokens == c.tokens


def test_sampling_submit_validation(params):
    eng = engine(params, sampling=True)
    with pytest.raises(ValueError, match="temperature"):
        eng.submit([1, 2], temperature=-1.0)
    with pytest.raises(ValueError, match="top_p"):
        eng.submit([1, 2], top_p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit([1, 2], top_k=-1)
    r = eng.submit([1, 2], max_new_tokens=3, temperature=0.5,
                   seed=2 ** 64 + 5)               # wide seeds wrap
    deadline = time.perf_counter() + 60
    while not eng.idle and time.perf_counter() < deadline:
        eng.step()
    assert r.state == "finished" and len(r.tokens) == 3
