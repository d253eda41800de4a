"""The port ServeEngine's compile-once contract against the JAX engine's,
on the CPU in f32 from the same numpy weights and traffic:

- `trace_counts` equal to the JAX engine's key by key (prefill,
  decode_step, write_prefill, prefill_chunk, cow_copy) after the same
  traffic, and the adapter bank's `trace_count` equal to the JAX bank's;
- `total_traces()` flat after warm-up across new prompt lengths,
  evictions, queued and mid-flight cancels, prefix hits and chunks, a
  contained step error and an adapter hot-swap, as the JAX engine's is
  (tests/test_serve.py, test_serve_prefix.py, test_serve_robustness.py,
  test_lora.py);
- the decode step's body over the static buffers (the body a CUDA graph
  replays on the card) gives the plain step's ids: greedy rows the JAX
  engine's, sampled rows the port's own (seed, position) rule on freshly
  made tensors (the JAX engine draws from threefry, which the port does
  not reproduce: ROADMAP.md, Differences);
- a bad adapter id raises on the host before the step runs.

On the CPU the decode step runs eagerly, so `decode_step` counts its
signature the first time it is seen; on the card it counts the graph's
captures (tests/test_torch_cuda_graphs.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2
from mobilefinetuner_tpu.serve import AdapterBank as JaxAdapterBank
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.lora.lora import assign_adapters
from mobilefinetuner_tpu_torch.models.generate import (gpt2_decode_step_paged,
                                                       sample_per_row)
from mobilefinetuner_tpu_torch.serve import (AdapterBank, ServeConfig,
                                             ServeEngine)

JAX_CFG = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=64,
    n_layer=3)
CFG = GPT2Config(**{f.name: getattr(JAX_CFG, f.name)
                     for f in dataclasses.fields(GPT2Config)})
SHAPE = dict(num_slots=3, block_T=8, num_blocks=32, max_prompt=16,
             max_new_tokens=12)
KEYS = ("prefill", "decode_step", "write_prefill", "prefill_chunk",
        "cow_copy")


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jax_gpt2.init_params(JAX_CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(np_params):
    return convert.gpt2_params_from_numpy(np_params, device="cpu")


def np_adapter(seed):
    """A rank-3 numpy adapter on the default targets, B off zero."""
    rng = np.random.default_rng(seed)
    E, L = CFG.n_embd, CFG.n_layer
    dims = {"attn_qkv": (E, 3 * E), "attn_proj": (E, E)}
    return {"blocks": {
        name: {"A": (0.1 * rng.standard_normal((L, i, 3))).astype(np.float32),
               "B": (0.1 * rng.standard_normal((L, 3, o))).astype(np.float32),
               "scale": np.float32(2.0)}
        for name, (i, o) in dims.items()}}


def both(np_params, params, bank_seed=None, **kw):
    """(JAX engine, port engine) of one config, each with a 2-slot bank
    over np_adapter(bank_seed) when a seed is given."""
    jbank = pbank = None
    if bank_seed is not None:
        t = np_adapter(bank_seed)
        jbank = JaxAdapterBank(t, capacity=2)
        pbank = AdapterBank(convert.lora_from_numpy(t, device="cpu"),
                            capacity=2)
    cfg = {**SHAPE, **kw}
    return (JaxServeEngine("gpt2", JAX_CFG, np_params,
                           JaxServeConfig(**cfg), bank=jbank),
            ServeEngine("gpt2", CFG, params, ServeConfig(**cfg), bank=pbank,
                        device="cpu"))


def load(engines, name, seed):
    jeng, peng = engines
    t = np_adapter(seed)
    jeng.load_adapter(name, t)
    peng.load_adapter(name, convert.lora_from_numpy(t, device="cpu"))


def counts(eng) -> dict:
    return {k: eng.trace_counts[k] for k in KEYS}


def assert_same_counts(jeng, peng):
    assert counts(peng) == counts(jeng), (dict(peng.trace_counts),
                                          dict(jeng.trace_counts))
    jb = jeng.bank.trace_count if jeng.bank else 0
    pb = peng.bank.trace_count if peng.bank else 0
    assert pb == jb
    assert peng.total_traces() == jeng.total_traces()


def prompts_of(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 200, int(n))] for n in lens]


@pytest.fixture(scope="module")
def warm(np_params, params):
    """Both engines after tests/test_serve.py:130-153's traffic: 6 ragged
    requests through 3 slots, 8 new tokens each."""
    engines = both(np_params, params)
    toks = []
    for eng in engines:
        reqs = [eng.submit(p, max_new_tokens=8)
                for p in prompts_of(0, (5, 9, 2, 13, 7, 3))]
        eng.drain()
        toks.append([r.tokens for r in reqs])
    yield engines, toks
    engines[0].close()
    engines[1].close()


def test_trace_counts_equal_the_jax_engines_key_by_key(warm):
    (jeng, peng), (want, got) = warm
    assert got == want
    assert_same_counts(jeng, peng)
    assert counts(peng) == {"prefill": 1, "decode_step": 1,
                            "write_prefill": 1, "prefill_chunk": 0,
                            "cow_copy": 0}
    assert peng.total_traces() == 3


def test_total_traces_flat_across_admissions_evictions_cancels(warm):
    """tests/test_serve.py:181-203's traffic after warm-up, on both
    engines: new prompt lengths and caps, a queued cancel, a mid-flight
    cancel, pool turnover; zero new traces on either, equal tokens."""
    (jeng, peng), _ = warm
    before = (jeng.total_traces(), peng.total_traces())
    toks = []
    for eng in (jeng, peng):
        rng = np.random.default_rng(7)
        reqs = [eng.submit(list(rng.integers(1, 200, int(n))),
                           max_new_tokens=int(m))
                for n, m in zip((1, 16, 4, 11, 8, 2, 6),
                                (12, 3, 7, 1, 5, 9, 2))]
        eng.step()
        eng.cancel(reqs[2])
        eng.step()
        if eng.active:
            eng.cancel(eng.active[0])
        eng.drain()
        assert eng.idle
        toks.append([(r.state, r.tokens) for r in reqs])
    assert toks[1] == toks[0]
    assert (jeng.total_traces(), peng.total_traces()) == before
    assert_same_counts(jeng, peng)


def test_total_traces_flat_across_prefix_hits_and_chunks(np_params, params):
    """tests/test_serve_prefix.py:139-150: three waves of every admission
    path (miss, partial hit, full hit through a page copy, chunked long
    prompts); wave 3 adds no trace, the counts equal the JAX engine's
    key by key after every wave, and the tokens are equal."""
    jeng, peng = both(np_params, params, num_blocks=64, prefix_cache=True,
                      max_prompt_chunked=48)
    rng = np.random.default_rng(0)
    common = [int(t) for t in rng.integers(1, 200, 16)]
    mix = [common + prompts_of(1, (5,))[0], common + prompts_of(2, (3,))[0],
           list(common), prompts_of(3, (40,))[0],
           common[:8] + prompts_of(4, (30,))[0]]
    for wave in range(3):
        warm = peng.total_traces()
        toks = []
        for eng in (jeng, peng):
            reqs = [eng.submit(p, max_new_tokens=8) for p in mix]
            eng.drain()
            toks.append([r.tokens for r in reqs])
        assert toks[1] == toks[0], f"wave {wave}"
        assert_same_counts(jeng, peng)
    assert peng.total_traces() == warm
    assert peng.trace_counts["cow_copy"] == 1
    assert peng.trace_counts["prefill_chunk"] >= 2
    jeng.close()
    peng.close()


def test_total_traces_flat_across_a_contained_step_error(np_params, params):
    """tests/test_serve_robustness.py:222-250: an exception out of the
    decode step fails the in-flight requests, the pools are zeroed in
    place and the queue survives; zero new traces on either engine, the
    survivors' tokens equal."""
    engines = both(np_params, params, num_slots=2, max_new_tokens=8)
    out, deltas = [], []
    for eng in engines:
        rng = np.random.default_rng(11)
        eng.submit(list(rng.integers(1, 200, 4)), max_new_tokens=2)
        eng.drain()
        t0 = eng.total_traces()
        pool = eng.pool_k
        reqs = [eng.submit(list(rng.integers(1, 200, int(n))),
                           max_new_tokens=6) for n in (5, 9, 3, 7)]
        eng.step()

        def boom(step, eng=eng):
            eng.step_hook = None
            raise RuntimeError("injected")
        eng.step_hook = boom
        eng.step()
        eng.drain()
        out.append([(r.state, r.reason, r.tokens) for r in reqs])
        deltas.append(eng.total_traces() - t0)
    assert out[1] == out[0]
    assert [s for s, _, _ in out[1]] == ["error", "error", "finished",
                                         "finished"]
    assert deltas == [0, 0]
    assert engines[1].pool_k is pool      # zeroed in place, not rebuilt
    assert_same_counts(*engines)
    for eng in engines:
        eng.close()


def test_total_traces_flat_across_an_adapter_hot_swap(np_params, params):
    """tests/test_lora.py:440-448 under lora_impl=fused: evict a tenant,
    load another, serve through it: zero new traces on either engine,
    the bank's trace_count equal to the JAX bank's, equal tokens."""
    jeng, peng = both(np_params, params, bank_seed=1, num_slots=2,
                      max_new_tokens=6, lora_impl="fused")
    load((jeng, peng), "t1", 2)
    toks, deltas = [], []
    for eng in (jeng, peng):
        rng = np.random.default_rng(0)
        a = eng.submit(list(rng.integers(1, 200, 5)), max_new_tokens=4,
                       adapter="t1")
        b = eng.submit(list(rng.integers(1, 200, 9)), max_new_tokens=4)
        eng.drain()
        toks.append([a.tokens, b.tokens])
    warm = (jeng.total_traces(), peng.total_traces())
    jeng.evict_adapter("t1")
    peng.evict_adapter("t1")
    load((jeng, peng), "t2", 3)
    for eng in (jeng, peng):
        rng = np.random.default_rng(1)
        a = eng.submit(list(rng.integers(1, 200, 7)), max_new_tokens=4,
                       adapter="t2")
        b = eng.submit(list(rng.integers(1, 200, 3)), max_new_tokens=4)
        eng.drain()
        toks.append([a.tokens, b.tokens])
    assert toks[0] == toks[1] and toks[2] == toks[3]
    assert (jeng.total_traces(), peng.total_traces()) == warm
    assert peng.bank.trace_count == jeng.bank.trace_count == 1
    assert_same_counts(jeng, peng)
    jeng.close()
    peng.close()


def sampling_engine(params):
    t = np_adapter(1)
    eng = ServeEngine("gpt2", CFG, params,
                      ServeConfig(**{**SHAPE, "sampling": True}),
                      bank=AdapterBank(convert.lora_from_numpy(t, "cpu"),
                                       capacity=2), device="cpu")
    eng.load_adapter("t0", convert.lora_from_numpy(t, "cpu"))
    eng.load_adapter("t1", convert.lora_from_numpy(np_adapter(2), "cpu"))
    return eng


def test_static_buffer_step_gives_the_plain_steps_ids(params):
    """Three slots (a greedy request on t0, a sampled one on t1, a
    sampled one on the base) after admission: the static buffers hold
    the slot arrays, and the step body's ids equal the paged step and
    sample_per_row on tensors made afresh from the same arrays."""
    eng = sampling_engine(params)
    rng = np.random.default_rng(3)
    eng.submit(list(rng.integers(1, 200, 6)), adapter="t0")
    eng.submit(list(rng.integers(1, 200, 11)), adapter="t1",
               temperature=0.9, top_k=30, top_p=0.8, seed=5)
    eng.submit(list(rng.integers(1, 200, 3)), temperature=1.3, seed=-2)
    eng.step()
    eng.step()
    assert len(eng.active) == 3
    for _ in range(3):
        pk, pv = eng.pool_k.clone(), eng.pool_v.clone()
        dev = lambda a: torch.from_numpy(a.copy())  # noqa: E731
        logits, _, _ = gpt2_decode_step_paged(
            CFG, eng.params, pk, pv, dev(eng._tok), dev(eng._pos),
            dev(eng._tbl), lora=assign_adapters(eng.bank.tree, eng._aid))
        want = sample_per_row(logits, dev(eng._temp), dev(eng._topk),
                              dev(eng._topp), dev(eng._seed),
                              dev(eng._pos + 1)).numpy()
        got = eng._decode()
        np.testing.assert_array_equal(got, want)
        b = eng._buf
        for name in ("tok", "pos", "aid", "topk", "seed", "temp", "topp"):
            np.testing.assert_array_equal(b[name].numpy(),
                                          getattr(eng, "_" + name))
        np.testing.assert_array_equal(b["tbl"].numpy(), eng._tbl)
        assert torch.equal(eng.pool_k, pk) and torch.equal(eng.pool_v, pv)
        for r in eng.active:           # feed the step's tokens back
            eng._tok[r.slot] = got[r.slot]
            eng._pos[r.slot] += 1
    assert eng.trace_counts["decode_step"] == 1


def test_greedy_rows_of_a_sampling_engine_equal_the_jax_engines(
        np_params, params):
    """Greedy requests beside sampled ones on both sampling engines: the
    greedy requests' tokens are the JAX engine's bit for bit; the counts
    are equal key by key."""
    t1, t2 = np_adapter(1), np_adapter(2)
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params,
                          JaxServeConfig(**{**SHAPE, "sampling": True}),
                          bank=JaxAdapterBank(t1, capacity=2))
    peng = sampling_engine(params)
    jeng.load_adapter("t0", t1)
    jeng.load_adapter("t1", t2)
    toks = []
    for eng in (jeng, peng):
        rng = np.random.default_rng(4)
        reqs = []
        for i, n in enumerate((5, 12, 7, 3, 9)):
            kw = dict(temperature=0.8, seed=i) if i % 2 else {}
            reqs.append(eng.submit(list(rng.integers(1, 200, n)),
                                   max_new_tokens=8,
                                   adapter=(None, "t0", "t1")[i % 3], **kw))
        eng.drain()
        toks.append([r.tokens for i, r in enumerate(reqs) if not i % 2])
    assert toks[1] == toks[0]
    assert_same_counts(jeng, peng)
    jeng.close()
    peng.close()


def test_a_bad_adapter_id_raises_before_the_step_runs(params, monkeypatch):
    eng = sampling_engine(params)
    eng.submit([5, 6, 7], adapter="t0")
    eng.step()
    eng._aid[0] = 7

    def never(*a, **k):
        raise AssertionError("the decode step ran")
    monkeypatch.setattr(eng, "_step_fn", never)
    with pytest.raises(ValueError, match="out of range"):
        eng._decode()
