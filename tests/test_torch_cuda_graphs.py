"""The serve engine's five programs (decode step, one-shot prefill,
prompt-page write, prefill chunks, page copy) and generate's decode step
as CUDA graphs on the card, against the same runs with every program
eager (the private `_eager` arguments): identical ids, greedy and
sampled, in f32 and bf16, for GPT-2 and Gemma-3, through an adapter
hot-swap and a contained step error; identical pools bit for bit;
exactly one capture for each (program, signature) called twice or more,
none on the hot-swap or the contained error, a new one after the pools
are reassigned; every kernel's launch count equal to the eager run's.
Marked `cuda`: without an NVIDIA card and nvcc every test here skips. On
a machine with a card: `python -m pytest tests/test_torch_cuda_graphs.py`."""

import dataclasses

import pytest
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.kernels import build
from mobilefinetuner_tpu_torch.models import gemma3, generate, gpt2
from mobilefinetuner_tpu_torch.ops import decode_attention as da
from mobilefinetuner_tpu_torch.ops import flash_attention as fa
from mobilefinetuner_tpu_torch.ops import lora_fused as lf
from mobilefinetuner_tpu_torch.serve import (AdapterBank, ServeConfig,
                                             ServeEngine)
from mobilefinetuner_tpu_torch.serve.bench import rand_adapters, tiny_gemma
from mobilefinetuner_tpu_torch.serve.engine import DTYPES

pytestmark = pytest.mark.cuda

KEYS = ("prefill", "decode_step", "write_prefill", "prefill_chunk",
        "cow_copy")
WRAPPERS = {"flash": fa.flash_attention_fwd,
            "paged": da.paged_decode_attention,
            "decode": da.decode_attention, "epilogue": lf.lora_epilogue}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    build.build_all()
    return torch.device("cuda", 0)


def _zero():
    for fn in WRAPPERS.values():
        fn.launches = 0
    lf.lora_epilogue.by_shape.clear()
    fa.flash_attention_fwd.by_shape.clear()


def _counts():
    return ({k: fn.launches for k, fn in WRAPPERS.items()},
            dict(lf.lora_epilogue.by_shape),
            dict(fa.flash_attention_fwd.by_shape))


def _model(family, dev, dtype):
    """A tiny model with head dim 64 (the kernels' smallest) and three
    rank-4 adapters."""
    if family == "gpt2":
        config = dataclasses.replace(GPT2Config.tiny(vocab_size=300),
                                     n_embd=128, n_head=2, n_layer=2,
                                     n_positions=128)
        params = gpt2.init_params(config, seed=0, dtype=DTYPES[dtype],
                                  device=dev)
    else:
        config = tiny_gemma()
        params = gemma3.init_params(config, seed=0, dtype=DTYPES[dtype],
                                    device=dev)
    return config, params, rand_adapters(family, config, 3, seed=0,
                                         device=dev, dtype=DTYPES[dtype])


def _serve(family, dev, dtype, sampled, eager):
    """Four waves through one engine (prefix cache, chunked admission,
    sampling on): a mixed wave; a hot-swap (t1 evicted, t2 loaded) and a
    wave with a step error injected after two steps; a wave that caches a
    32-token prefix; three full hits on it (three page copies). Returns
    (per-request (state, reason, tokens), launch counts, engine, the
    captures before the hot-swap)."""
    config, params, trees = _model(family, dev, dtype)
    eng = ServeEngine(
        family, config, params,
        ServeConfig(num_slots=3, block_T=16, num_blocks=64, max_prompt=32,
                    max_new_tokens=10, dtype=dtype, sampling=True,
                    prefix_cache=True, max_prompt_chunked=64),
        bank=AdapterBank(trees[0], capacity=2, family=family), device=dev,
        _eager=eager)
    eng.load_adapter("t0", trees[0])
    eng.load_adapter("t1", trees[1])
    g = torch.Generator().manual_seed(5)
    V = config.vocab_size

    def ints(n):
        return torch.randint(3, V, (n,), generator=g).tolist()

    def submit(prompts, routes):
        return [eng.submit(p, adapter=a, seed=i,
                           **({"temperature": 0.8, "top_k": 20,
                               "top_p": 0.9} if sampled and i % 2 else {}))
                for i, (p, a) in enumerate(zip(prompts, routes))]

    _zero()
    common = ints(32)
    reqs = submit([common + ints(5), ints(20), list(common), ints(50),
                   ints(7)], [None, "t0", None, "t1", "t0"])
    eng.drain()
    captured = {k: g.captures for k, g in eng.graphs().items()}
    eng.evict_adapter("t1")
    eng.load_adapter("t2", trees[2])
    wave = submit([ints(9), ints(12), ints(30), ints(4)],
                  ["t2", None, "t0", "t2"])
    eng.step()
    eng.step()

    def boom(step):
        eng.step_hook = None
        raise RuntimeError("injected")
    eng.step_hook = boom
    eng.step()
    eng.drain()
    last = submit([common + ints(3), ints(15), ints(40)],
                  [None, "t0", None])
    eng.drain()
    hits = submit([list(common)] * 3, [None] * 3)
    eng.drain()
    out = [(r.state, r.reason, r.tokens)
           for r in reqs + wave + last + hits]
    return out, _counts(), eng, captured


def _expected_counts(eng, graphed: bool) -> dict:
    """trace_counts from the programs' calls: on the card a graph
    captures at its second call; an eager program counts a signature at
    its first."""
    least = 2 if graphed else 1
    out = dict.fromkeys(KEYS, 0)
    for (program, _), g in eng.graphs().items():
        out[program] += g.calls >= least
    return out


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampled", [False, True])
def test_graphed_engine_matches_eager(dev, family, dtype, sampled):
    """The same traffic through a graphed and an eager engine: identical
    states and tokens, one capture in the graphed engine across the
    hot-swap and the contained error (eager: none), equal launch counts
    by kernel and by shape."""
    got, got_counts, eng, captured = _serve(family, dev, dtype, sampled,
                                            eager=False)
    want, want_counts, ref, _ = _serve(family, dev, dtype, sampled,
                                       eager=True)
    assert got == want
    assert any(s == "error" for s, _, _ in got)
    assert sum(s == "finished" for s, _, _ in got) >= 12
    assert eng.full_hits == ref.full_hits == 3
    # the trash page aside: which idle or padded row's write lands there
    # is unspecified
    assert torch.equal(eng.pool_k[1:], ref.pool_k[1:])
    assert torch.equal(eng.pool_v[1:], ref.pool_v[1:])
    # one capture for each (program, signature) called twice or more,
    # none added by the hot-swap or the contained error
    graphs = eng.graphs()
    for key, g in graphs.items():
        assert g.captures == (g.calls >= 2), (key, g.calls, g.captures)
        assert ref.graphs()[key].captures == 0
        if captured[key]:
            assert g.captures == captured[key], key
    assert all(eng.trace_counts[k] >= 1 for k in KEYS), eng.trace_counts
    assert {k: eng.trace_counts[k] for k in KEYS} == _expected_counts(
        eng, graphed=True)
    assert {k: ref.trace_counts[k] for k in KEYS} == _expected_counts(
        ref, graphed=False)
    assert got_counts == want_counts
    L = eng.config.n_layer if family == "gpt2" \
        else eng.config.num_hidden_layers
    assert got_counts[0]["paged"] == L * eng.decode_steps
    assert eng.decode_steps == ref.decode_steps


def test_reallocated_pools_drop_the_graph(dev):
    """Reassigning the pools (not zeroing them in place) drops every
    graph: the decode step captures again at its next step, the prefill
    and the page write at the next admission, and the tokens stay the
    eager engine's."""
    config, params, trees = _model("gpt2", dev, "float32")
    out = []
    for eager in (False, True):
        eng = ServeEngine("gpt2", config, params, ServeConfig(
            num_slots=2, block_T=16, num_blocks=32, max_prompt=32,
            max_new_tokens=12), device=dev, _eager=eager)
        reqs = [eng.submit(list(range(3, 12))), eng.submit([5, 6, 7])]
        for _ in range(4):
            eng.step()
        eng.pool_k = eng.pool_k.clone()
        eng.pool_v = eng.pool_v.clone()
        reqs += [eng.submit(list(range(20, 31))), eng.submit([8, 9])]
        eng.drain()
        out.append([r.tokens for r in reqs])
        if not eager:
            assert eng.trace_counts["decode_step"] == 2
            assert eng.trace_counts["prefill"] == 2
            assert eng.trace_counts["write_prefill"] == 2
            assert eng._prefill_graph.calls == 4
    assert out[0] == out[1]


def _generate(family, dev, dtype, sampled, eager):
    config, params, trees = _model(family, dev, dtype)
    ids, mask = (torch.as_tensor(a, device=dev) for a in generate.left_pad(
        [[5, 6, 7, 8, 9, 10, 11], [12, 13], [14, 15, 16, 17, 18]], 0))
    N = 12
    scfg = generate.SampleConfig(max_new_tokens=N, greedy=not sampled,
                                 temperature=0.8, top_k=20, top_p=0.9)
    gen = torch.Generator(device=dev).manual_seed(3)
    fn = generate.gpt2_generate if family == "gpt2" \
        else generate.gemma3_generate
    _zero()
    c0 = generate.graph_captures["decode_step"]
    out = fn(config, params, ids, mask, scfg, generator=gen,
             compute_dtype=DTYPES[dtype], lora=trees[0], _eager=eager)
    return (out.cpu(), _counts(), generate.graph_captures["decode_step"] - c0,
            N)


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sampled", [False, True])
def test_graphed_generate_matches_eager(dev, family, dtype, sampled):
    """gpt2_generate / gemma3_generate with a dynamic adapter: the decode
    steps replayed from one graph give the eager steps' ids, greedy and
    sampled from the same seed, with equal launch counts (row 13 L x
    (N - 1) times, the epilogue at every site of every step)."""
    got, got_counts, captures, N = _generate(family, dev, dtype, sampled,
                                             eager=False)
    want, want_counts, eager_captures, _ = _generate(family, dev, dtype,
                                                     sampled, eager=True)
    assert torch.equal(got, want)
    assert captures == 1 and eager_captures == 0
    assert got_counts == want_counts
    config = _model(family, dev, dtype)[0]
    L = config.n_layer if family == "gpt2" else config.num_hidden_layers
    assert got_counts[0]["decode"] == L * (N - 1)
