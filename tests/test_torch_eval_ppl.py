"""The port's eval_ppl (mobilefinetuner_tpu_torch/cli/eval_ppl.py) and its
family dispatch (cli/family.py) against the JAX package's, on the tiny
fixture checkpoints and corpus, on the CPU in f32: the final record's
nll agrees to 1e-5 relative and its token count is identical for GPT-2
with no adapter, a dynamic and a merged one, and for Gemma-3 with no
adapter and with an lm_head adapter (rows 9-11's forward on the chunked
loss); the family is detected alike; unported flags refuse."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import (write_tiny_gemma3_dir, write_tiny_gpt2_dir,  # noqa
                      write_wikitext_dir)

from mobilefinetuner_tpu.cli import eval_ppl as jax_eval  # noqa: E402
from mobilefinetuner_tpu.cli import family as jax_family  # noqa: E402
from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2  # noqa
from mobilefinetuner_tpu.core.config import \
    Gemma3TextConfig as JaxGemma  # noqa: E402
from mobilefinetuner_tpu.lora import lora as jlora  # noqa: E402
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu_torch.cli import eval_ppl  # noqa: E402
from mobilefinetuner_tpu_torch.cli import family  # noqa: E402


def _adapter(path, spec, tree_fn, seed):
    tree = jax.tree.map(np.asarray, tree_fn(spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for e in tree["blocks"].values():       # B off zero
        e["B"] = (rng.normal(size=e["B"].shape) * 0.05).astype(np.float32)
    jax_peft_io.save_adapter(path, tree, spec)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_ppl")
    g2, gm, wiki = (str(root / n) for n in ("gpt2", "gemma", "wiki"))
    write_tiny_gpt2_dir(g2)
    write_tiny_gemma3_dir(gm)
    write_wikitext_dir(wiki)
    g2cfg = JaxGPT2.tiny(vocab_size=json.load(
        open(os.path.join(g2, "config.json")))["vocab_size"])
    gmcfg = JaxGemma.from_pretrained(gm)
    adapters = {
        "gpt2": _adapter(str(root / "gpt2_lora.safetensors"),
                         jlora.LoRASpec(rank=4, alpha=8.0,
                                        targets=["attn_qkv", "attn_proj"]),
                         lambda s, k: jlora.init_lora_gpt2(g2cfg, s, k), 1),
        "gemma": _adapter(str(root / "gemma_head.safetensors"),
                          jlora.LoRASpec(rank=4, alpha=8.0, init="peft",
                                         targets=["q_proj", "lm_head"]),
                          lambda s, k: jlora.init_lora_gemma3(gmcfg, s, k),
                          2)}
    return {"gpt2": g2, "gemma": gm, "wiki": wiki, "adapters": adapters}


def _final(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("fam,adapter", [("gpt2", "none"),
                                         ("gpt2", "dynamic"),
                                         ("gpt2", "merged"),
                                         ("gemma", "none"),
                                         ("gemma", "dynamic")])
def test_eval_ppl_matches_jax(dirs, capsys, fam, adapter):
    argv = ["--pretrained_dir", dirs[fam], "--data_root", dirs["wiki"],
            "--seq_len", "32", "--batch_size", "2", "--max_batches", "4",
            "--log_every", "2"]
    if adapter != "none":
        argv += ["--lora_path", dirs["adapters"][fam]]
    if adapter == "merged":
        argv.append("--lora_merge")
    theirs = _final(jax_eval.main, argv + ["--prefetch", "0"], capsys)
    ours = _final(eval_ppl.main, argv + ["--device", "cpu"], capsys)
    assert ours["family"] == theirs["family"] == fam
    assert ours["tokens"] == theirs["tokens"] > 0
    np.testing.assert_allclose(ours["nll"], theirs["nll"], rtol=1e-5)
    for k in ("split", "seq_len", "lora", "merged"):
        assert ours[k] == theirs[k]
    assert set(ours) == set(theirs)


def test_eval_ppl_prefetch_and_out_file(dirs, tmp_path, capsys):
    """--prefetch 0 (synchronous) and 3 give the same record; --out gets
    the progress records and the final one."""
    argv = ["--pretrained_dir", dirs["gemma"], "--data_root", dirs["wiki"],
            "--seq_len", "32", "--batch_size", "2", "--max_batches", "4",
            "--log_every", "1", "--device", "cpu",
            "--lora_path", dirs["adapters"]["gemma"]]
    out = str(tmp_path / "e.jsonl")
    a = _final(eval_ppl.main, argv + ["--prefetch", "0"], capsys)
    b = _final(eval_ppl.main, argv + ["--prefetch", "3", "--out", out],
               capsys)
    assert a["nll"] == b["nll"] and a["tokens"] == b["tokens"]
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    n = len(recs) - 1                  # one progress record a batch
    assert n >= 2 and [r["type"] for r in recs] == ["progress"] * n + [
        "final"]
    assert recs[-1]["nll"] == b["nll"]


def test_family_detection_matches_jax(dirs):
    for fam in ("gpt2", "gemma"):
        assert family.detect_family(dirs[fam]) == \
            jax_family.detect_family(dirs[fam]) == fam
        b = family.load_family(dirs[fam], device="cpu")
        assert (b.family, b.head_key, b.max_len) == (
            fam, "wte" if fam == "gpt2" else "embed",
            jax_family.load_family(dirs[fam]).max_len)
    b = family.load_family(dirs["gemma"], device="cpu")
    with pytest.raises(ValueError, match="tied"):   # merge refuses lm_head
        family.apply_adapter(b, dirs["adapters"]["gemma"], lora_merge=True)


def test_eval_ppl_refuses_what_is_not_ported(dirs):
    base = ["--pretrained_dir", dirs["gpt2"], "--data_root", dirs["wiki"],
            "--seq_len", "32"]
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_ppl.main(base)
    # the telemetry stream, the memory preflight and the run registry are
    # ported: a run that asks for them is admitted and writes its stream
    stream = os.path.join(os.path.dirname(dirs["wiki"]), "ported.jsonl")
    registry = os.path.join(os.path.dirname(dirs["wiki"]), "ppl_reg.jsonl")
    assert eval_ppl.main(base + ["--device", "cpu", "--max_batches", "1",
                                 "--telemetry_out", stream,
                                 "--run_registry", registry,
                                 "--on_oom_risk", "fail",
                                 "--hbm_cap_mb", "100000"]) == 0
    events = [json.loads(line)["event"] for line in open(stream)]
    assert events[:3] == ["run_start", "run", "mem_check"]
    assert events[-2:] == ["run", "run_end"]
    recs = [json.loads(line) for line in open(registry)]
    assert [(r["phase"], r["status"], r["kind"], r["tool"])
            for r in recs] == [("start", "running", "eval", "eval_ppl"),
                               ("end", "ok", "eval", "eval_ppl")]
