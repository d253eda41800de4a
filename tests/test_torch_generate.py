"""The port's contiguous generation (mobilefinetuner_tpu_torch/models/
generate.py, cli/generate.py) against the JAX package's, on the CPU in
f32 at tiny configs (GPT-2: 3 layers, 4 heads of 16; Gemma-3: 4 layers,
GQA 4:2, a 16-token window on local layers), from the same numpy weights:

- the sampling helpers: top-k / top-p filter masks identical to
  `_filter_logits`'s, `_advance`, `_col_positions`, `_col_valid` and
  `left_pad` identical;
- greedy ids identical to `gpt2_generate` / `gemma3_generate` for ragged
  left-padded prompts, with no adapter and with a merged, a dynamic, a
  split-QKV dynamic (GPT-2) and a routed multi-adapter LoRA, and equal to
  a no-cache naive rollout of the port's own forward; Gemma's window
  engages (P + N > 16); `prefill_chunk` ids equal the whole-prompt ids;
- eos then pad, max_new_tokens = 0, the overlong ValueError;
- seeded sampling: deterministic, inside the filtered set, and a
  chi-square test of its frequencies against the filtered softmax;
- `cli.generate.main --greedy --json --device cpu` prints the JAX CLI's
  records on the tiny fixture checkpoints.

Sampled tokens are not compared with JAX: jax.random's threefry stream
and torch.Generator differ (ROADMAP.md section 3)."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import write_tiny_gemma3_dir, write_tiny_gpt2_dir  # noqa

from mobilefinetuner_tpu.cli import generate as jax_cli  # noqa: E402
from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2  # noqa
from mobilefinetuner_tpu.core.config import \
    Gemma3TextConfig as JaxGemma  # noqa: E402
from mobilefinetuner_tpu.lora import lora as jlora  # noqa: E402
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu.models import gemma3 as jgemma  # noqa: E402
from mobilefinetuner_tpu.models import generate as jgen  # noqa: E402
from mobilefinetuner_tpu.models import gpt2 as jgpt2  # noqa: E402
from mobilefinetuner_tpu_torch import convert  # noqa: E402
from mobilefinetuner_tpu_torch.cli import generate as cli  # noqa: E402
from mobilefinetuner_tpu_torch.core.config import (  # noqa: E402
    GPT2Config, Gemma3TextConfig)
from mobilefinetuner_tpu_torch.lora import lora as plora  # noqa: E402
from mobilefinetuner_tpu_torch.models import gemma3, gpt2  # noqa: E402
from mobilefinetuner_tpu_torch.models import generate as gen  # noqa: E402

GPT2_KW = dict(n_embd=64, n_head=4, n_positions=64, n_layer=3)
GEMMA_KW = dict(num_hidden_layers=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """A JAX LoRA tree with B off zero, as numpy."""
    tree = _np_tree(tree)
    rng = np.random.default_rng(seed)
    for e in tree["blocks"].values():
        e["B"] = (rng.normal(size=e["B"].shape) * 0.1).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def gpt2_model():
    jcfg = dataclasses.replace(JaxGPT2.tiny(vocab_size=211), **GPT2_KW,
                               embd_pdrop=0.0, resid_pdrop=0.0,
                               attn_pdrop=0.0)
    cfg = dataclasses.replace(GPT2Config.tiny(vocab_size=211), **GPT2_KW,
                              embd_pdrop=0.0, resid_pdrop=0.0,
                              attn_pdrop=0.0)
    params = _np_tree(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


@pytest.fixture(scope="module")
def gemma_model():
    jcfg = dataclasses.replace(JaxGemma.tiny(vocab_size=199), **GEMMA_KW)
    cfg = dataclasses.replace(Gemma3TextConfig.tiny(vocab_size=199),
                              **GEMMA_KW)
    params = _np_tree(jgemma.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    for k in ("q_norm", "k_norm"):            # norms off zero
        params["blocks"]["attn"][k] = (rng.normal(
            size=params["blocks"]["attn"][k].shape) * 0.1).astype(np.float32)
    return jcfg, cfg, params


def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return jgen.left_pad([list(rng.integers(3, vocab - 1, n)) for n in lens],
                         pad_id=0)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _lora(family, model, kind, seed):
    """(JAX lora tree, port lora tree), both None for "none", for an
    adapter kind: none, merged, dynamic, split (GPT-2 split QKV) or multi
    (two adapters routed per row)."""
    jcfg = model[0]
    init = (jlora.init_lora_gpt2 if family == "gpt2"
            else jlora.init_lora_gemma3)
    targets = {"gpt2": ["attn_qkv", "attn_proj", "mlp_fc_in", "mlp_fc_out"],
               "gemma": "full"}[family]
    if kind == "split":
        targets = ["attn_q", "attn_v", "attn_proj"]

    def one(s):
        spec = jlora.LoRASpec(rank=2, alpha=4.0, targets=targets)
        return _perturb(init(jcfg, spec, jax.random.PRNGKey(s)), s)

    if kind == "none":
        return None, None
    if kind == "multi":
        trees = [one(seed), one(seed + 1)]
        ids = [1, 0, 1]
        jl = jlora.assign_adapters(jlora.stack_adapters(
            [jax.tree.map(jnp.asarray, t) for t in trees]), ids)
        pl = plora.assign_adapters(plora.stack_adapters(
            [convert.lora_from_numpy(t, device="cpu") for t in trees]), ids)
        return jl, pl
    tree = one(seed)
    return (jax.tree.map(jnp.asarray, tree),
            convert.lora_from_numpy(tree, device="cpu"))


def _naive_rollout(fwd, ids, mask, n_new):
    """No-cache oracle: the full forward again for every token, greedy."""
    ids, mask = torch.as_tensor(ids).long(), torch.as_tensor(mask).long()
    out = []
    for _ in range(n_new):
        nxt = fwd(ids, mask)[:, -1].argmax(-1)
        out.append(nxt)
        ids = torch.cat([ids, nxt[:, None]], dim=1)
        mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
    return torch.stack(out, dim=1).numpy()


# ------------------------------------------------------------ helpers ------

@pytest.mark.parametrize("top_k,top_p", [(7, 1.0), (0, 0.8), (12, 0.6)])
def test_filter_masks_match_jax(top_k, top_p):
    logits = np.random.default_rng(top_k).normal(size=(5, 101)).astype(
        np.float32) * 3
    cfg_j = jgen.SampleConfig(top_k=top_k, top_p=top_p)
    cfg_t = gen.SampleConfig(top_k=top_k, top_p=top_p)
    want = np.asarray(jgen._filter_logits(jnp.asarray(logits), cfg_j))
    got = gen._filter_logits(torch.from_numpy(logits), cfg_t).numpy()
    np.testing.assert_array_equal(got == gen.NEG_INF, want == jgen.NEG_INF)
    np.testing.assert_array_equal(got, want)


def test_bookkeeping_matches_jax():
    ids, mask = jgen.left_pad([[5, 6, 7], [8], [], [1, 2, 3, 4, 5]], 9)
    pids, pmask = gen.left_pad([[5, 6, 7], [8], [], [1, 2, 3, 4, 5]], 9)
    np.testing.assert_array_equal(pids, ids)
    np.testing.assert_array_equal(pmask, mask)
    P, T = ids.shape[1], ids.shape[1] + 6
    np.testing.assert_array_equal(
        gen._col_positions(torch.from_numpy(mask), P, T).numpy(),
        np.asarray(jgen._col_positions(jnp.asarray(mask), P, T)))
    for t in (0, 3, 5):
        np.testing.assert_array_equal(
            gen._col_valid(torch.from_numpy(mask), P, T, t).numpy(),
            np.asarray(jgen._col_valid(jnp.asarray(mask), P, T, t)))
    raw = np.array([4, 2, 9, 2], np.int32)
    done = np.array([False, True, False, False])
    for eos in (None, 2):
        jc = jgen.SampleConfig(eos_id=eos, pad_id=7)
        tc = gen.SampleConfig(eos_id=eos, pad_id=7)
        want = jgen._advance(jnp.asarray(raw), jnp.asarray(done), jc)
        got = gen._advance(torch.from_numpy(raw), torch.from_numpy(done), tc)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# ------------------------------------------------------- greedy parity ----

@pytest.mark.parametrize("kind", ["none", "merged", "dynamic", "split",
                                  "multi"])
def test_gpt2_greedy_matches_jax(gpt2_model, kind):
    jcfg, cfg, params = gpt2_model
    ids, mask = _prompts(0, (5, 11, 2), jcfg.vocab_size)
    N = 9
    jl, pl = _lora("gpt2", gpt2_model, kind, 7)
    jp, tp = jax.tree.map(jnp.asarray, params), convert.gpt2_params_from_numpy(
        params, device="cpu")
    if kind in ("merged",):
        jp, tp = jlora.merge_gpt2(jp, jl), plora.merge_gpt2(tp, pl)
        jl = pl = None
    scfg = dict(max_new_tokens=N, greedy=True, eos_id=None)
    want = np.asarray(jgen.gpt2_generate(
        jcfg, jp, jnp.asarray(ids), jnp.asarray(mask),
        jgen.SampleConfig(**scfg), lora=jl))
    tids, tmask = _t(ids, mask)
    got = gen.gpt2_generate(cfg, tp, tids, tmask, gen.SampleConfig(**scfg),
                            lora=pl)
    assert got.dtype == torch.int32 and got.shape == (3, N)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("none", "dynamic"):
        naive = _naive_rollout(
            lambda i, m: gpt2.forward(cfg, tp, i, attention_mask=m,
                                      lora=pl), ids, mask, N)
        np.testing.assert_array_equal(got.numpy(), naive)
    plain = gen.gpt2_generate(cfg, tp, tids, tmask, gen.SampleConfig(**scfg),
                              lora=pl, attn_impl="plain")
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("kind", ["none", "merged", "dynamic", "multi"])
def test_gemma3_greedy_matches_jax(gemma_model, kind):
    jcfg, cfg, params = gemma_model
    ids, mask = _prompts(1, (12, 5, 9), jcfg.vocab_size)
    N = 10                                 # P + N = 22 > the 16 window
    jl, pl = _lora("gemma", gemma_model, kind, 11)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.gemma3_params_from_numpy(params, device="cpu")
    if kind == "merged":
        jp, tp = jlora.merge_gemma3(jp, jl), plora.merge_gemma3(tp, pl)
        jl = pl = None
    scfg = dict(max_new_tokens=N, greedy=True, eos_id=None)
    want = np.asarray(jgen.gemma3_generate(
        jcfg, jp, jnp.asarray(ids), jnp.asarray(mask),
        jgen.SampleConfig(**scfg), lora=jl))
    tids, tmask = _t(ids, mask)
    got = gen.gemma3_generate(cfg, tp, tids, tmask, gen.SampleConfig(**scfg),
                              lora=pl)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("none", "dynamic"):
        naive = _naive_rollout(
            lambda i, m: gemma3.forward(cfg, tp, i, attention_mask=m,
                                        lora=pl), ids, mask, N)
        np.testing.assert_array_equal(got.numpy(), naive)


@pytest.mark.parametrize("kind", ["none", "multi"])
def test_gemma3_prefill_chunk_matches_whole(gemma_model, kind):
    """Windowed prefill = whole-prompt prefill, at window sizes that do
    not divide the prompt (an internal left re-pad), as in JAX; the JAX
    CLI's chunked ids are held in test_cli_matches_jax."""
    jcfg, cfg, params = gemma_model
    ids, mask = _prompts(2, (19, 11, 23), jcfg.vocab_size)   # P = 23
    pl = _lora("gemma", gemma_model, kind, 13)[1]
    tp = convert.gemma3_params_from_numpy(params, device="cpu")
    scfg = gen.SampleConfig(max_new_tokens=6, greedy=True, eos_id=None)
    tids, tmask = _t(ids, mask)
    whole = gen.gemma3_generate(cfg, tp, tids, tmask, scfg, lora=pl)
    for W in (8, 5):
        got = gen.gemma3_generate(cfg, tp, tids, tmask, scfg, lora=pl,
                                  prefill_chunk=W)
        np.testing.assert_array_equal(got.numpy(), whole.numpy(),
                                      err_msg=f"W={W}")
    with pytest.raises(ValueError, match="prefill_chunk"):
        gen.gemma3_generate(cfg, tp, tids, tmask, scfg, prefill_chunk=0)


# ----------------------------------------------------------- contract -----

def test_eos_then_pad_zero_tokens_and_overlong(gpt2_model, gemma_model):
    _, cfg, params = gpt2_model
    tp = convert.gpt2_params_from_numpy(params, device="cpu")
    tids, tmask = _t(*gen.left_pad([[1, 2, 3], [4, 5, 6, 7]], 0))
    free = gen.gpt2_generate(cfg, tp, tids, tmask, gen.SampleConfig(
        max_new_tokens=5, greedy=True))
    eos = int(free[0, 1])                  # the row's second token
    pad = (eos + 1) % cfg.vocab_size
    out = gen.gpt2_generate(cfg, tp, tids, tmask, gen.SampleConfig(
        max_new_tokens=5, greedy=True, eos_id=eos, pad_id=pad))
    first = int(np.flatnonzero(free[0].numpy() == eos)[0])
    assert out[0, :first + 1].tolist() == free[0, :first + 1].tolist()
    assert (out[0, first + 1:] == pad).all()

    zero = gen.SampleConfig(max_new_tokens=0, greedy=True)
    assert gen.gpt2_generate(cfg, tp, tids, tmask, zero).shape == (2, 0)
    gcfg, gparams = gemma_model[1], convert.gemma3_params_from_numpy(
        gemma_model[2], device="cpu")
    assert gen.gemma3_generate(gcfg, gparams, tids, tmask,
                               zero).shape == (2, 0)
    long_ids, long_mask = _t(*gen.left_pad([list(range(1, 61))], 0))
    for n in (10, 0):                      # checked before the N <= 0 return
        with pytest.raises(ValueError, match="n_positions"):
            gen.gpt2_generate(cfg, tp, torch.cat([long_ids] * 2, 1)
                              if n == 0 else long_ids,
                              torch.cat([long_mask] * 2, 1)
                              if n == 0 else long_mask,
                              gen.SampleConfig(max_new_tokens=n))


def test_sampling_seeded_and_inside_the_filtered_set(gpt2_model):
    _, cfg, params = gpt2_model
    tp = convert.gpt2_params_from_numpy(params, device="cpu")
    tids, tmask = _t(*gen.left_pad([[1, 2, 3, 4], [9, 8]], 0))
    scfg = gen.SampleConfig(max_new_tokens=8, temperature=0.9, top_k=5,
                            top_p=0.9)

    def run(seed):
        return gen.gpt2_generate(cfg, tp, tids, tmask, scfg,
                                 generator=torch.Generator().manual_seed(
                                     seed)).numpy()

    a, b, c = run(3), run(3), run(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # each sampled token lies in the filter of its own step's logits:
    # replay the steps with the sampled tokens fed back (teacher forcing)
    ids = torch.cat([tids.long(), torch.from_numpy(a).long()], dim=1)
    mask = torch.cat([tmask.long(), torch.ones_like(ids[:, 4:])], dim=1)
    logits = gpt2.forward(cfg, tp, ids, attention_mask=mask)
    P = tids.shape[1]
    for j in range(a.shape[1]):
        kept = gen._filter_logits(logits[:, P - 1 + j] / 0.9, scfg) \
            > gen.NEG_INF
        assert kept[torch.arange(2), torch.from_numpy(a[:, j]).long()].all()


def test_sampling_frequencies_match_the_filtered_softmax():
    """Chi-square at a fixed seed: 40,000 draws of one row against the
    softmax of its filtered, tempered logits (p-value floor 1e-3)."""
    from scipy import stats
    logits = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 50)).astype(np.float32))
    scfg = gen.SampleConfig(temperature=0.7, top_k=20, top_p=0.9)
    probs = torch.softmax(gen._filter_logits(logits / 0.7, scfg), -1)[0]
    n = 40_000
    draws = gen._sample(logits.expand(n, -1).contiguous(),
                        torch.Generator().manual_seed(0), scfg)
    counts = np.bincount(draws.numpy(), minlength=50)
    keep = probs.numpy() > 0
    assert counts[~keep].sum() == 0
    expected = probs.numpy()[keep] * n
    assert stats.chisquare(counts[keep], expected).pvalue > 1e-3


# ---------------------------------------------------------------- CLI -----

@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("generate")
    g2, gm = str(root / "gpt2"), str(root / "gemma")
    write_tiny_gpt2_dir(g2)
    write_tiny_gemma3_dir(gm)
    spec = jlora.LoRASpec(rank=2, alpha=4.0, targets=["attn_qkv"])
    cfg = JaxGPT2.from_pretrained(g2)
    paths = []
    for s in (0, 1):
        p = str(root / f"a{s}.safetensors")
        jax_peft_io.save_adapter(p, _perturb(jlora.init_lora_gpt2(
            cfg, spec, jax.random.PRNGKey(s)), s), spec)
        paths.append(p)
    return {"gpt2": g2, "gemma": gm, "adapters": ",".join(paths)}


def _records(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


@pytest.mark.parametrize("fam,extra", [
    ("gpt2", []),
    ("gpt2", ["--lora_path", "ADAPTERS", "--adapter_ids", "1,0"]),
    ("gemma", ["--prefill_chunk", "4"]),
])
def test_cli_matches_jax(fixture_dirs, capsys, fam, extra):
    extra = [fixture_dirs["adapters"] if a == "ADAPTERS" else a
             for a in extra]
    argv = ["--pretrained_dir", fixture_dirs[fam], "--prompt",
            "The quick brown fox", "--prompt", "Prices rose",
            "--max_new_tokens", "6", "--greedy", "--json", *extra]
    want = _records(jax_cli.main, argv, capsys)
    stats = {}
    got = _records(lambda a: cli.main(a, stats=stats),
                   argv + ["--device", "cpu"], capsys)
    assert got == want and len(got) == 2
    assert stats["tokens"] == 12 and stats["tokens_per_s"] > 0


def test_cli_refusals(fixture_dirs):
    d = fixture_dirs["gpt2"]
    base = ["--pretrained_dir", d, "--device", "cpu"]
    with pytest.raises(SystemExit, match="no prompts"):
        cli.main(base)
    with pytest.raises(SystemExit, match="Gemma-only"):
        cli.main(base + ["--prompt", "a", "--prefill_chunk", "4"])
    with pytest.raises(SystemExit, match="at least two"):
        cli.main(base + ["--prompt", "a", "--adapter_ids", "0"])
    with pytest.raises(SystemExit, match="out of range"):
        cli.main(base + ["--prompt", "a", "--lora_path",
                         fixture_dirs["adapters"], "--adapter_ids", "2"])
