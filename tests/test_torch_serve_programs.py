"""The serve engine's programs over static buffers (serve/engine.py: the
one-shot prefill, the prompt-page write, the prefill chunks and the page
copy, the bodies a CUDA graph replays on the card), f32 on the CPU:

- the chunk functions with `start` and `n_tok` as 0-d int64 tensors (the
  form a graph replays): logits within 1e-4 and pools within 1e-5 of the
  JAX package's, and bit for bit the port's int path;
- each program's body over its staged buffers against the model
  functions on tensors made afresh: the prefill's first token (greedy and
  sampled at the mask's length) and K/V, the page write, a chunk's token
  at start + n_tok, the page copy;
- a sampling Gemma-3 and GPT-2 engine with two tenants over every
  admission path (one-shot, suffix hit, full hit, a long prompt chunked)
  and sampled rows: greedy requests' tokens identical to the JAX
  engine's, `trace_counts` equal key by key, and each sampled request's
  tokens the same with the prefix cache off and with every prompt
  chunked (the port's (seed, position) rule, not threefry);
- a hot-swap and a contained error drop no graph, reassigning the pools
  drops every one.

The graphs themselves are held on the card
(tests/test_torch_cuda_graphs.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve_gemma import (GEMMA, GPT2, JAX_GEMMA, JAX_GPT2, close,
                                    gemma_prompts, np_gemma_adapter,
                                    np_gpt2_adapter, rand_pools, routed, t)

from mobilefinetuner_tpu.models import gemma3 as jgemma
from mobilefinetuner_tpu.models import generate as jgen
from mobilefinetuner_tpu.models import gpt2 as jgpt2
from mobilefinetuner_tpu.serve import AdapterBank as JaxAdapterBank
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.models import generate as gen
from mobilefinetuner_tpu_torch.serve import (AdapterBank, ServeConfig,
                                             ServeEngine)
from mobilefinetuner_tpu_torch.serve.engine import _Staged
from mobilefinetuner_tpu_torch.serve.paged_kv import (TRASH_BLOCK,
                                                      write_prompt_blocks)

KEYS = ("prefill", "decode_step", "write_prefill", "prefill_chunk",
        "cow_copy")
SHAPE = dict(num_slots=2, block_T=8, num_blocks=64, max_prompt=16,
             max_new_tokens=8, prefix_cache=True, max_prompt_chunked=40,
             sampling=True)
SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.9)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """{family: (JAX config, port config, numpy params, port params,
    two numpy adapters)}."""
    gp = _np(jgemma.init_params(JAX_GEMMA, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    for grp in ("input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln"):
        gp["blocks"][grp] = (0.1 * rng.normal(
            size=gp["blocks"][grp].shape)).astype(np.float32)
    tp = _np(jgpt2.init_params(JAX_GPT2, jax.random.PRNGKey(0)))
    return {"gemma": (JAX_GEMMA, GEMMA, gp,
                      convert.gemma3_params_from_numpy(gp, device="cpu"),
                      [np_gemma_adapter(5), np_gemma_adapter(9)]),
            "gpt2": (JAX_GPT2, GPT2, tp,
                     convert.gpt2_params_from_numpy(tp, device="cpu"),
                     [np_gpt2_adapter(1), np_gpt2_adapter(2)])}


def dims(config):
    if isinstance(config, type(GPT2)):
        return config.n_layer, config.n_head, config.head_dim
    return (config.num_hidden_layers, config.num_key_value_heads,
            config.head_dim)


# ------------------------------------------- device-scalar chunk functions --

@pytest.mark.parametrize("family", ["gpt2", "gemma"])
@pytest.mark.parametrize("tenant", [False, True], ids=["base", "routed"])
@pytest.mark.parametrize("start,n_tok", [(16, 6), (8, 8)])
def test_device_scalar_chunk_matches_jax_and_the_int_path(models, family,
                                                          tenant, start,
                                                          n_tok):
    """One 8-wide chunk at two (start, n_tok) pairs, which share a
    graph's shapes: with 0-d tensors, the logits at row n_tok - 1 and the
    pools after the scatter equal the JAX chunk's (1e-4, 1e-5) and the
    int path's bit for bit."""
    jcfg, pcfg, jp, pp, adapters = models[family]
    jfn, pfn = ((jgen.gpt2_prefill_chunk, gen.gpt2_prefill_chunk)
                if family == "gpt2" else
                (jgen.gemma3_prefill_chunk, gen.gemma3_prefill_chunk))
    L, KV, D = dims(pcfg)
    bT, NB, M, W = 4, 16, 8, 8
    pk, pv = rand_pools(NB, L, KV, bT, D, 7)
    rng = np.random.default_rng(start + n_tok)
    tbl = np.zeros((1, M), np.int32)
    tbl[0, :6] = rng.permutation(np.arange(1, NB))[:6]
    ids = np.zeros((1, W), np.int64)
    ids[0, :n_tok] = rng.integers(1, 199, n_tok)
    jl = pl = None
    if tenant:
        jl, pl = routed(adapters, [0] * W)
    want, wk, wv = jfn(jcfg, jp, jnp.asarray(pk), jnp.asarray(pv),
                       jnp.asarray(ids, jnp.int32), jnp.int32(start),
                       jnp.int32(n_tok), jnp.asarray(tbl), lora=jl)
    runs = []
    for s, n in ((torch.tensor(start), torch.tensor(n_tok)),
                 (start, n_tok)):
        gk, gv = t(pk.copy()), t(pv.copy())
        got, _, _ = pfn(pcfg, pp, gk, gv, t(ids), s, n, t(tbl), lora=pl)
        runs.append((got, gk, gv))
    (got, gk, gv), (ref, rk, rv) = runs
    close(got, want, 1e-4)
    close(gk[1:], np.asarray(wk)[1:], 1e-5)
    close(gv[1:], np.asarray(wv)[1:], 1e-5)
    assert torch.equal(got, ref)
    assert torch.equal(gk, rk) and torch.equal(gv, rv)


def test_staged_buffers_group_by_dtype_and_copy_what_is_staged():
    st = _Staged(torch.device("cpu"), {
        "a": ((2, 3), torch.int64), "s": ((), torch.int64),
        "f": ((4,), torch.float32), "b": ((3,), torch.int32)})
    assert sorted(str(d) for d in st._pairs) == [
        "torch.float32", "torch.int32", "torch.int64"]
    # a 0-d input is a view into its group's one device tensor
    assert st.buf["s"].shape == () and st.buf["s"].untyped_storage() \
        .data_ptr() == st.buf["a"].untyped_storage().data_ptr()
    st.stage(a=np.arange(6).reshape(2, 3), s=7, f=np.full(4, 0.5),
             b=[1, 2, 3])
    assert st.buf["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert int(st.buf["s"]) == 7 and st.buf["b"].tolist() == [1, 2, 3]
    st.stage(s=9)                        # the rest keep their values
    assert int(st.buf["s"]) == 9 and st.buf["f"].tolist() == [0.5] * 4


# ------------------------------------------------- the programs' bodies ----

def engine_of(models, family, **kw):
    _, pcfg, _, pp, adapters = models[family]
    eng = ServeEngine(family, pcfg, pp, ServeConfig(**{**SHAPE, **kw}),
                      bank=AdapterBank(convert.lora_from_numpy(
                          adapters[0], device="cpu"), capacity=2,
                          family=family), device="cpu")
    for i, tree in enumerate(adapters):
        eng.load_adapter(f"t{i}", convert.lora_from_numpy(tree, "cpu"))
    return eng


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_program_bodies_over_staged_buffers_equal_fresh_calls(models,
                                                              family):
    """Each body run over what the engine staged, against the model
    functions on fresh tensors: the prefill (sampled, keyed on the mask's
    length) and its K/V, the page write, a chunk (greedy) at a device
    start, and the page copy."""
    eng = engine_of(models, family)
    prefill = gen.gpt2_prefill if family == "gpt2" else gen.gemma3_prefill
    rng = np.random.default_rng(3)
    P, Pm, bT = 11, eng.cfg.max_prompt, eng.cfg.block_T
    ids = np.zeros((1, Pm), np.int64)
    ids[0, :P] = rng.integers(3, 190, P)
    mask = (np.arange(Pm) < P)[None].astype(np.int64)
    blocks = np.asarray([5, 9], np.int32)
    eng._refresh()
    eng._prefill_in.stage(ids=ids, mask=mask, aid=1,
                          block_ids=blocks, temp=0.8, topk=0,
                          topp=0.9, seed=12)
    eng._prefill_body()
    lora = routed(models[family][4], [1])[1]
    logits, (k, v) = prefill(eng.config, eng.params, t(ids), t(mask),
                             lora=lora)
    want = gen.sample_per_row(logits, torch.tensor([0.8]), torch.tensor([0]),
                              torch.tensor([0.9]), torch.tensor([12]),
                              torch.tensor([P]))
    assert torch.equal(eng._tok0, want)
    assert torch.equal(eng._prompt_k, k[:, 0])
    assert torch.equal(eng._prompt_v, v[:, 0])
    pk, pv = eng.pool_k.clone(), eng.pool_v.clone()
    write_prompt_blocks(pk, pv, k[:, 0], v[:, 0], t(blocks))
    eng._write_body()
    assert torch.equal(eng.pool_k, pk) and torch.equal(eng.pool_v, pv)

    # a chunk of 5 tokens at position 16 (pages 5, 9 hold the prefix)
    chunk = [int(x) for x in rng.integers(3, 190, 5)]
    W, Wmax = 8, eng.chunk_buckets[-1]
    tbl = np.full((1, eng.M), TRASH_BLOCK, np.int32)
    tbl[0, :3] = [5, 9, 12]
    cids = np.zeros(Wmax, np.int64)
    cids[:5] = chunk
    eng._chunk_in.stage(ids=cids, aid=0, start_n=(16, 5), tbl=tbl, temp=0,
                        topk=0, topp=1.0, seed=0)
    eng._chunk_body(W)
    fn = gen.gpt2_prefill_chunk if family == "gpt2" \
        else gen.gemma3_prefill_chunk
    logits, _, _ = fn(eng.config, eng.params, pk, pv, t(cids[:W][None]), 16,
                      5, t(tbl), lora=routed(models[family][4], [0] * W)[1])
    assert torch.equal(eng._chunk_tok, logits.argmax(-1))
    assert torch.equal(eng.pool_k, pk) and torch.equal(eng.pool_v, pv)

    eng._cow_in.stage(src=9, dst=20)
    eng._cow_body()
    assert torch.equal(eng.pool_k[20], pk[9])
    assert torch.equal(eng.pool_v[20], pv[9])
    eng.close()


# ----------------------------------------------------------- the engines ---

def traffic(seed):
    """gemma_prompts' every admission path, routed to both tenants and
    the base, requests 1 and 5 sampled."""
    prompts = gemma_prompts(seed)
    routes = [None, "t0", "t1", None, "t0", None, None, "t1"]
    samp = [SAMPLED if i in (1, 5) else {} for i in range(len(prompts))]
    return [(p, a, dict(kw, seed=100 + i) if kw else {})
            for i, (p, a, kw) in enumerate(zip(prompts, routes, samp))]


def serve(eng, spec):
    reqs = [eng.submit(p, adapter=a, **kw) for p, a, kw in spec]
    eng.drain()
    return reqs


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_engine_gives_the_jax_engines_greedy_ids_and_counts(models,
                                                            family):
    """Two waves of every admission path through a sampling engine with
    two tenants: the greedy requests' tokens are the JAX engine's, the
    trace counts equal it key by key after each wave (the second adds
    none); the sampled requests' tokens are the same from an engine
    without the prefix cache and from one that chunks every prompt."""
    jcfg, _, jp, _, adapters = models[family]
    jeng = JaxServeEngine(family, jcfg, jp, JaxServeConfig(**SHAPE),
                          bank=JaxAdapterBank(adapters[0], capacity=2))
    for i, tree in enumerate(adapters):
        jeng.load_adapter(f"t{i}", tree)
    peng = engine_of(models, family)
    spec = traffic(1)
    greedy = [i for i, (_, _, kw) in enumerate(spec) if not kw]
    sampled = {}
    for wave in range(2):
        out = [serve(eng, spec) for eng in (jeng, peng)]
        assert [out[1][i].tokens for i in greedy] \
            == [out[0][i].tokens for i in greedy], wave
        assert {k: peng.trace_counts[k] for k in KEYS} \
            == {k: jeng.trace_counts[k] for k in KEYS}, wave
        assert peng.total_traces() == jeng.total_traces()
        sampled[wave] = [r.tokens for r in out[1] if r.temperature]
    assert sampled[0] == sampled[1]
    assert peng.full_hits >= 2 and peng.chunks > 0 and peng.prefills > 0
    assert peng.prefix.hit_rate == jeng.prefix.hit_rate > 0
    assert all(peng.trace_counts[k] >= 1 for k in KEYS)
    for kw in (dict(prefix_cache=False, max_prompt_chunked=40),
               dict(max_prompt=8)):
        other = engine_of(models, family, **kw)
        reqs = serve(other, spec)
        assert [r.tokens for r in reqs if r.temperature] == sampled[0], kw
        other.close()
    jeng.close()
    peng.close()


def test_reassigned_inputs_drop_every_graph_and_in_place_writes_do_not(
        models):
    """`_refresh` before each program: a hot-swap (the bank written in
    place) and a contained error (the pools zeroed in place) drop no
    graph; reassigning the pools drops every one, once."""
    eng = engine_of(models, "gpt2")
    spec = traffic(2)
    serve(eng, spec[:3])
    resets = []
    for key, g in eng.graphs().items():
        g.reset = lambda key=key: resets.append(key)
    eng.evict_adapter("t1")
    eng.load_adapter("t1", convert.lora_from_numpy(models["gpt2"][4][0],
                                                   "cpu"))

    def boom(step):
        eng.step_hook = None
        raise RuntimeError("injected")
    eng.step_hook = boom
    reqs = serve(eng, spec[3:6])
    assert any(r.state == "error" for r in reqs) and resets == []
    eng.pool_k = eng.pool_k.clone()
    eng.pool_v = eng.pool_v.clone()
    reqs = serve(eng, spec[:3])
    assert all(r.state == "finished" for r in reqs)
    assert sorted(resets) == sorted(eng.graphs())
    eng.close()
