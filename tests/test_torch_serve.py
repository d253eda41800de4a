"""Port ServeEngine (mobilefinetuner_tpu_torch/serve/) against the JAX
ServeEngine on the same weights and prompts (f32, CPU): per-request greedy
tokens identical through continuous batching with and without a 2-tenant
bank, every page returned; plus cancel, tiny-pool backpressure, deadline
expiry, step-error containment, admission, config validation, the eos
contract, and entry points that refuse to run without a card unless told
device="cpu"."""

import dataclasses
import time

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
from mobilefinetuner_tpu_torch.core.memory_guard import MemoryAdmissionError
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.serve import (AdapterBank, BlockAllocator,
                                             OutOfBlocks, ServeConfig,
                                             ServeEngine, TRASH_BLOCK,
                                             blocks_for)
from mobilefinetuner_tpu_torch.serve.bench import build_engine

JAX_CFG = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=64,
    n_layer=3)
CFG = GPT2Config(**{f.name: getattr(JAX_CFG, f.name)
                     for f in dataclasses.fields(GPT2Config)})
SHAPE = dict(num_slots=3, block_T=8, num_blocks=32, max_prompt=16,
             max_new_tokens=12)
PROMPT_LENS = (5, 9, 2, 13, 7, 3)


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


def port_engine(params, bank=None, **kw):
    return ServeEngine("gpt2", CFG, params,
                       ServeConfig(**{**SHAPE, **kw}), bank=bank,
                       device="cpu")


def serve_both(np_params, params, routes, prompts, n_new=8):
    """Run the same requests through the JAX and the port engine;
    returns (jax tokens, port tokens, port engine)."""
    trees = [np_adapter(1), np_adapter(2)]
    banked = any(r is not None for r in routes)
    jbank = JaxAdapterBank(trees[0], capacity=2) if banked else None
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params,
                          JaxServeConfig(**SHAPE), bank=jbank)
    pbank = None
    if banked:
        pbank = AdapterBank(convert.lora_from_numpy(trees[0], device="cpu"),
                            capacity=2)
    peng = port_engine(params, bank=pbank)
    for i, t in enumerate(trees if banked else []):
        jeng.load_adapter(f"t{i}", t)
        peng.load_adapter(f"t{i}", convert.lora_from_numpy(t, device="cpu"))
    out = []
    for eng in (jeng, peng):
        reqs = [eng.submit(p, max_new_tokens=n_new, adapter=a)
                for p, a in zip(prompts, routes)]
        done = eng.drain()
        assert sorted(r.id for r in done) == [r.id for r in reqs]
        out.append([r.tokens for r in reqs])
    jeng.close()
    return out[0], out[1], peng


def ragged_prompts(seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 200, n)] for n in PROMPT_LENS]


@pytest.mark.parametrize("routes", [
    [None] * 6, ["t0", "t1", None, "t0", None, "t1"]],
    ids=["base", "two_tenants"])
def test_engine_matches_jax_engine(np_params, params, routes):
    """6 ragged requests through 3 slots: greedy tokens identical to the
    JAX engine's, pages all returned, slots idle, one prefill per
    request."""
    want, got, eng = serve_both(np_params, params, routes,
                                ragged_prompts(0))
    assert got == want
    assert eng.alloc.in_use == 0
    assert eng.alloc.free_blocks == SHAPE["num_blocks"] - 1
    assert eng.idle and eng.prefills == len(PROMPT_LENS)
    assert eng.health()["counts"]["finished"] == len(PROMPT_LENS)


@pytest.fixture(scope="module")
def engine(params):
    return port_engine(params)


def test_block_allocator_lifecycle():
    a = BlockAllocator(8)
    got = a.alloc(3)
    assert len(set(got)) == 3 and TRASH_BLOCK not in got
    a.retain(got[0])
    a.free(got)
    assert a.in_use == 1 and a.refcounts == {got[0]: 1}
    a.free(got[:1])
    assert a.in_use == 0 and a.free_blocks == 7
    with pytest.raises(OutOfBlocks):
        a.alloc(8)
    with pytest.raises(ValueError):
        a.free(got[:1])                   # double free
    with pytest.raises(ValueError):
        a.free([TRASH_BLOCK])
    with pytest.raises(ValueError):
        BlockAllocator(1)
    assert blocks_for(0, 8) == 0 and blocks_for(9, 8) == 2


def test_cancel_frees_pages_and_slot(engine):
    free0 = engine.alloc.free_blocks
    r = engine.submit([1, 2, 3, 4, 5], max_new_tokens=10)
    q = engine.submit([6, 7], max_new_tokens=10)
    engine.step()
    assert r.state == "active" and engine.alloc.free_blocks < free0
    engine.cancel(r)
    engine.cancel(q)
    assert r.state == q.state == "cancelled"
    assert engine.alloc.free_blocks == free0 and engine.idle
    engine.cancel(r)                      # idempotent


def test_tiny_pool_backpressure_matches_jax(np_params, params):
    """A pool that fits ~one worst-case request at a time: admission waits
    for pages, and outputs stay equal to the JAX engine's."""
    shape = dict(num_slots=2, block_T=8, num_blocks=4, max_prompt=8,
                 max_new_tokens=8)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, 200, n)] for n in (6, 8, 3)]
    jeng = JaxServeEngine("gpt2", JAX_CFG, np_params,
                          JaxServeConfig(**shape))
    jreqs = [jeng.submit(p) for p in prompts]
    jeng.drain()
    jeng.close()
    eng = ServeEngine("gpt2", CFG, params, ServeConfig(**shape),
                      device="cpu")
    reqs = [eng.submit(p) for p in prompts]
    seen = False
    while not eng.idle:
        eng.step()
        seen |= bool(eng.queue and eng.active)
    assert seen
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert all(r.state == "finished" for r in reqs)


def test_eos_contract(engine):
    """A request stops at the first eos it emits, eos included; others run
    to their cap. The probe is picked so that eos first appears at index
    1 of its greedy output."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        probe = [int(t) for t in rng.integers(1, 200, 6)]
        r0 = engine.submit(probe, max_new_tokens=6)
        engine.drain()
        if r0.tokens[1] != r0.tokens[0]:
            break
    eos = r0.tokens[1]
    assert r0.tokens[0] != eos
    engine.eos_id = eos
    try:
        r1 = engine.submit(probe, max_new_tokens=6)
        other = engine.submit([5, 9, 11], max_new_tokens=6)
        engine.drain()
        assert r1.tokens == r0.tokens[:2] and r1.state == "finished"
        cut = (other.tokens.index(eos) + 1 if eos in other.tokens else 6)
        assert len(other.tokens) == cut
    finally:
        engine.eos_id = None


def test_deadlines_queue_cap_and_step_error_containment(params):
    eng = port_engine(params, num_slots=1, max_queue=2,
                      shed_policy="deadline")
    a = eng.submit([1, 2, 3], max_new_tokens=12)
    b = eng.submit([4, 5], deadline_ms=1.0)
    c = eng.submit([6, 7])                        # queue full: shed b
    assert b.state == "rejected" and b.reason == "shed"
    d = eng.submit([8], deadline_ms=1.0)          # queue full, no victim
    assert d.state == "rejected" and d.reason == "queue_full"
    eng.step()                                    # a active, c queued
    e = eng.submit([9, 9], deadline_ms=1.0)
    eng.cancel(c)
    time.sleep(0.01)
    done = eng.step()
    assert e in done and e.state == "timeout" and e.reason == "deadline"
    assert not e.tokens                           # never prefilled

    def boom(step):
        raise RuntimeError("injected")

    eng.step_hook = boom
    queued = eng.submit([3, 4])
    done = eng.step()
    assert a.state == "error" and a.reason == "RuntimeError" and a in done
    assert eng.alloc.in_use == 0
    assert float(eng.pool_k.abs().sum()) == 0.0   # pools zeroed
    eng.step_hook = None
    eng.drain()
    assert queued.state == "finished"             # the queue kept serving
    assert eng.alloc.in_use == 0


def test_submit_and_config_validation(engine, params):
    over = engine.submit(list(range(1, 18)))      # 17 > max_prompt 16
    assert over.state == "rejected" and over.reason == "prompt_too_long"
    with pytest.raises(ValueError, match="max_new_tokens"):
        engine.submit([1, 2], max_new_tokens=99)
    with pytest.raises(ValueError, match="empty"):
        engine.submit([])
    with pytest.raises(RuntimeError, match="bank"):
        engine.submit([1, 2], adapter="nope")
    with pytest.raises(ValueError, match="multiple"):
        ServeConfig(max_prompt=12, block_T=8).validate()
    with pytest.raises(ValueError, match="worst-case"):
        ServeConfig(num_blocks=4, block_T=16, max_prompt=64,
                    max_new_tokens=64).validate()
    with pytest.raises(ValueError, match="n_positions"):
        ServeEngine("gpt2", CFG, params,
                    ServeConfig(block_T=8, max_prompt=56, max_new_tokens=32),
                    device="cpu")
    with pytest.raises(ValueError, match="family"):
        ServeEngine("bert", CFG, params, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        ServeConfig(attn_impl="pallas").validate()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeConfig(mesh_tp=2).validate()
    # every lora_impl is taken; the multi-adapter path runs the gather
    ServeConfig(lora_impl="fused").validate()
    with pytest.raises(ValueError, match="lora_impl"):
        ServeConfig(lora_impl="pallas").validate()
    # serve telemetry is ported: its knobs validate, with the JAX rules
    ServeConfig(trace_spans=True, stats_every=4).validate()
    with pytest.raises(ValueError, match="stats_every"):
        ServeConfig(stats_every=-1).validate()
    # the prefix cache, chunked prefill and sampling are ported: their
    # knobs validate, with the JAX engine's rules
    ServeConfig(prefix_cache=True, sampling=True, max_prompt_chunked=128,
                chunk_buckets=(16, 32)).validate()
    with pytest.raises(ValueError, match="max_prompt_chunked"):
        ServeConfig(max_prompt=64, max_prompt_chunked=64).validate()
    with pytest.raises(ValueError, match="max_prompt_chunked"):
        ServeConfig(block_T=16, max_prompt_chunked=72).validate()
    with pytest.raises(ValueError, match="chunk_buckets"):
        ServeConfig(block_T=16, chunk_buckets=(24,)).validate()
    with pytest.raises(ValueError, match="sampling"):
        engine.submit([1, 2], temperature=0.5)
    # the telemetry stream and the drain are ported
    # (tests/test_torch_serve_telemetry.py); an engine with no stream
    # reports healthy
    assert engine.health()["status"] == "ok" and not engine.draining
    with pytest.raises(MemoryAdmissionError, match="num_blocks="):
        port_engine(params, hbm_cap_mb=1, num_blocks=4096)


def test_bank_tenancy_guards(params):
    eng, names = build_engine("tiny-gpt2", num_slots=1, block_T=8,
                              num_blocks=16, max_prompt=16, max_new=8,
                              adapters=2, dtype="float32", device="cpu")
    assert eng.bank.resident == {"tenant0": 0, "tenant1": 1}
    r = eng.submit([3, 4, 5], adapter="tenant0")
    q = eng.submit([3, 4], adapter="tenant1")     # queued: pins tenant1
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.evict_adapter("tenant1")
    with pytest.raises(RuntimeError, match="in-flight"):
        eng.load_adapter("tenant0", eng.bank.tree)
    with pytest.raises(OverflowError, match="full"):
        eng.bank.load("t9", {"blocks": {
            k: {leaf: x[0] for leaf, x in e.items()}
            for k, e in eng.bank.tree["blocks"].items()}})
    with pytest.raises(KeyError, match="not resident"):
        eng.submit([1], adapter="t9")
    eng.drain()
    assert r.state == q.state == "finished"
    eng.evict_adapter("tenant1")
    assert float(eng.bank.tree["blocks"]["attn_qkv"]["A"][1].abs().sum()) \
        == 0.0
    with pytest.raises(ValueError, match="shape|structure"):
        eng.load_adapter("t2", {"blocks": {}})


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, np_params):
    """device=None means the CUDA card: without one every entry point
    raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt2.init_params(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.gpt2_params_from_numpy(np_params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.lora_from_numpy(np_adapter(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine("tiny-gpt2")
    params = convert.gpt2_params_from_numpy(np_params, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine("gpt2", CFG, params, ServeConfig(**SHAPE))
