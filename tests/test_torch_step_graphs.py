"""kernels/graphs.py and the generate decode step it captures, on the CPU:

- the launch bookkeeping, driven with a fake kernel wrapper and a fake
  CUDA-graph API: a StepGraph's warm-up counts what it launched, its
  capture takes back out what the capture counted (nothing ran), every
  replay adds it once, so the counts equal an eager run's, tallies by
  shape included; a failed capture raises and leaves the counts as they
  were; reset() makes the next call capture again; the garbage collector
  is off inside a capture only;
- generate's decode step with the step index `t` as a device scalar (the
  form a CUDA graph replays): greedy ids equal to the JAX package's for
  GPT-2 and Gemma-3 with a dynamic adapter, the K/V written at column
  P + t, and the eager-only path (`_eager`) giving the same ids, greedy
  and sampled.

The real capture and replay are held on the card
(tests/test_torch_cuda_graphs.py)."""

import collections
import contextlib
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2
from mobilefinetuner_tpu.core.config import Gemma3TextConfig as JaxGemma
from mobilefinetuner_tpu.lora import lora as jlora
from mobilefinetuner_tpu.models import gemma3 as jgemma
from mobilefinetuner_tpu.models import generate as jgen
from mobilefinetuner_tpu.models import gpt2 as jgpt2
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.kernels import graphs
from mobilefinetuner_tpu_torch.models import generate as gen

# ------------------------------------------------- launch bookkeeping ------


def fake_kernel(x):
    """A stand-in wrapper: counts a launch of x's shape when called."""
    fake_kernel.launches += 1
    fake_kernel.by_shape[tuple(x.shape)] += 1
    return x + 1


class FakeGraph:
    """torch.cuda.CUDAGraph's surface: replay() runs the captured work
    without calling the wrapper, as a real replay does."""
    replays = 0

    def replay(self):
        FakeGraph.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(graphs, "_COUNTED", [])
    fake_kernel.launches = 0
    fake_kernel.by_shape = collections.Counter()
    graphs.counted(fake_kernel)
    FakeGraph.replays = 0

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(
        torch.cuda, "graph",
        lambda g, capture_error_mode=None: contextlib.nullcontext())
    return fake_kernel


def test_launch_counts_under_replay_equal_an_eager_runs(fake_cuda):
    x = torch.zeros(2, 3)
    steps = []
    graph = graphs.StepGraph(lambda: steps.append(fake_cuda(x)), "cuda",
                             on_capture=lambda: steps.append("capture"))
    assert graph.graphed
    graph()                              # warm-up: eager, counted
    assert (fake_cuda.launches, graph.captures, FakeGraph.replays) == (1, 0, 0)
    graph()                              # capture (taken back out) + replay
    assert (fake_cuda.launches, graph.captures, FakeGraph.replays) == (2, 1, 1)
    assert steps[1] == "capture"
    for _ in range(5):
        graph()
    assert (fake_cuda.launches, graph.captures, FakeGraph.replays) == (7, 1, 6)
    assert fake_cuda.by_shape == {(2, 3): 7}
    # a counter set to 0 between replays (chip_smoke.py's zero_counts)
    # counts only what runs after
    fake_cuda.launches = 0
    fake_cuda.by_shape.clear()
    graph()
    assert fake_cuda.launches == 1 and fake_cuda.by_shape == {(2, 3): 1}
    graph.reset()
    graph()
    assert graph.captures == 2 and fake_cuda.launches == 2
    eager = graphs.StepGraph(lambda: fake_cuda(x), "cuda", graphed=False)
    for _ in range(3):
        eager()
    assert fake_cuda.launches == 5 and eager.captures == 0


def test_a_failed_capture_raises_and_restores_the_counts(fake_cuda):
    x = torch.zeros(4)
    calls = []

    def body():
        calls.append(1)
        fake_cuda(x)
        if len(calls) == 2:              # the capture's call
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    graph = graphs.StepGraph(body, "cuda")
    graph()
    with pytest.raises(RuntimeError, match="capturing"):
        graph()
    assert fake_cuda.launches == 1 and fake_cuda.by_shape == {(4,): 1}
    assert graph.graph is None and FakeGraph.replays == 0
    graph()                              # captures again, then replays
    assert graph.captures == 2 and fake_cuda.launches == 2


def test_no_garbage_collection_inside_a_capture(fake_cuda):
    """A collection during a capture could free another graph, which CUDA
    forbids while a stream captures: the collector is off in the capture
    only, and on again after it, a failed one too."""
    seen = []

    def body():
        seen.append(gc.isenabled())
        if len(seen) == 3:               # the second graph's capture
            raise RuntimeError("capture failed")
    assert gc.isenabled()
    graph = graphs.StepGraph(body, "cuda")
    graph()                              # warm-up
    graph()                              # capture
    assert seen == [True, False] and gc.isenabled()
    graph.reset()
    with pytest.raises(RuntimeError, match="capture failed"):
        graph()
    assert seen == [True, False, False] and gc.isenabled()
    assert graph.calls == 3 and graph.captures == 2


def test_delta_helpers_drop_tallies_that_fall_to_zero(fake_cuda):
    before = graphs.launch_snapshot()
    fake_cuda(torch.zeros(1))
    fake_cuda(torch.zeros(2, 2))
    delta = graphs.launch_delta(before)
    assert delta == [(fake_cuda, 2, {"by_shape": {(1,): 1, (2, 2): 1}})]
    graphs.add_launches(delta, -1)
    assert fake_cuda.launches == 0 and fake_cuda.by_shape == {}
    assert graphs.launch_delta(graphs.launch_snapshot()) == []


def test_every_kernel_wrapper_is_registered():
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    from mobilefinetuner_tpu_torch.ops import flash_attention as fa
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc
    from mobilefinetuner_tpu_torch.ops import lora_fused as lf
    wrappers = [fa.flash_attention_fwd, fa.flash_attention_bwd_merged,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
                lf.lora_epilogue, da.paged_decode_attention,
                da.decode_attention, fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                fc.fused_ce_bwd_dw, fc.fused_ce_fwd_lora,
                fc.fused_ce_bwd_dh_lora, fc.fused_ce_bwd_dw_lora]
    assert all(fn in graphs._COUNTED for fn in wrappers)
    assert not graphs.StepGraph(lambda: None, "cpu").graphed


# ------------------------------------------ generate's device-t step -------

GPT2_KW = dict(n_embd=64, n_head=4, n_positions=64, n_layer=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _adapter(init, jcfg, targets, seed):
    """A JAX adapter with B off zero, as numpy."""
    tree = _np(init(jcfg, jlora.LoRASpec(rank=2, alpha=4.0, targets=targets),
                    jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for e in tree["blocks"].values():
        e["B"] = (rng.normal(size=e["B"].shape) * 0.1).astype(np.float32)
    return tree


def _family(family):
    if family == "gpt2":
        jcfg = dataclasses.replace(JaxGPT2.tiny(vocab_size=211), **GPT2_KW)
        cfg = dataclasses.replace(GPT2Config.tiny(vocab_size=211),
                                  **GPT2_KW)
        params = _np(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
        lora = _adapter(jlora.init_lora_gpt2, jcfg, ["attn_qkv", "attn_proj"],
                        3)
        return (jcfg, cfg, params, lora, jgen.gpt2_generate,
                gen.gpt2_generate, convert.gpt2_params_from_numpy)
    jcfg = dataclasses.replace(JaxGemma.tiny(vocab_size=199),
                               num_hidden_layers=4)
    cfg = dataclasses.replace(Gemma3TextConfig.tiny(vocab_size=199),
                              num_hidden_layers=4)
    params = _np(jgemma.init_params(jcfg, jax.random.PRNGKey(1)))
    lora = _adapter(jlora.init_lora_gemma3, jcfg, "full", 4)
    return (jcfg, cfg, params, lora, jgen.gemma3_generate,
            gen.gemma3_generate, convert.gemma3_params_from_numpy)


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return jgen.left_pad([list(rng.integers(3, vocab - 1, n))
                          for n in (6, 2, 11)], pad_id=0)


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_device_t_decoder_gives_the_jax_ids(family):
    """N = 10 greedy tokens (Gemma's 16-token window engages) with a
    dynamic adapter: the port's steps, t a device scalar, equal the JAX
    package's ids; the eager-only path gives the same ids."""
    jcfg, cfg, params, lora, jfn, pfn, conv = _family(family)
    ids, mask = _prompts(cfg.vocab_size)
    scfg = dict(max_new_tokens=10, greedy=True, eos_id=None)
    want = np.asarray(jfn(jcfg, jax.tree.map(jnp.asarray, params),
                          jnp.asarray(ids), jnp.asarray(mask),
                          jgen.SampleConfig(**scfg),
                          lora=jax.tree.map(jnp.asarray, lora)))
    tp = conv(params, device="cpu")
    pl = convert.lora_from_numpy(lora, device="cpu")
    tids, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    c0 = gen.graph_captures["decode_step"]
    for eager in (False, True):
        got = pfn(cfg, tp, tids, tmask, gen.SampleConfig(**scfg), lora=pl,
                  _eager=eager)
        np.testing.assert_array_equal(got.numpy(), want)
    assert gen.graph_captures["decode_step"] == c0   # the CPU captures none


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_sampled_ids_are_the_same_on_both_paths(family):
    """A sampled run (temperature, top-k, top-p) from one seed: the loop
    that leaves the draw outside the step's body gives the same ids as
    the eager-only path, and each drawn token lies in its row's
    vocabulary."""
    _, cfg, params, _, _, pfn, conv = _family(family)
    ids, mask = _prompts(cfg.vocab_size)
    tp = conv(params, device="cpu")
    scfg = gen.SampleConfig(max_new_tokens=8, temperature=0.9, top_k=15,
                            top_p=0.9)
    runs = [pfn(cfg, tp, torch.from_numpy(ids), torch.from_numpy(mask),
                scfg, generator=torch.Generator().manual_seed(5),
                _eager=eager) for eager in (False, True)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size


def test_step_writes_its_kv_at_the_device_column():
    """gpt2_decoder's step(tok, t) with t a 0-d tensor writes the fed
    token's K/V at column P + t of every layer and nowhere else."""
    _, cfg, params, _, _, _, conv = _family("gpt2")
    tp = conv(params, device="cpu")
    L, H, D = cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head
    B, P, T = 2, 5, 9
    kc = torch.zeros(L, B, H, T, D)
    vc = torch.zeros(L, B, H, T, D)
    mask = torch.ones(B, P, dtype=torch.int32)
    step = gen.gpt2_decoder(cfg, tp, kc, vc, mask)
    logits = step(torch.tensor([7, 9]), torch.tensor(2))
    assert logits.shape == (B, cfg.vocab_size)
    written = (kc.abs().sum(dim=(0, 1, 2, 4)) > 0).nonzero().flatten()
    assert written.tolist() == [P + 2]
    assert bool((vc[:, :, :, P + 2].abs() > 0).any())
