"""The port's Gemma CLIs (mobilefinetuner_tpu_torch/cli/train_lora_gemma.py
and gemma_full_finetune.py) against the JAX package's, on the tiny
fixture checkpoint and corpus, on the CPU in f32: three train steps of
each CLI take the same losses (<= 1e-4); the files either package writes
(native and PEFT `gemma` adapters, `.opt` sidecars, the HF-keyed full
model) load in the other and are written back byte for byte; the same
for an adapter with the lm_head target (rows 9-11 on the chunked loss),
whose PEFT export both packages refuse; the port's GemmaTokenizer gives
the JAX tokenizer's ids; unported flags refuse."""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import (WIKI_LINES, write_tiny_gemma3_dir,  # noqa: E402
                      write_wikitext_dir)

from mobilefinetuner_tpu.cli import gemma_full_finetune as jax_full  # noqa
from mobilefinetuner_tpu.cli import train_lora_gemma as jax_lora  # noqa
from mobilefinetuner_tpu.core.config import \
    Gemma3TextConfig as JaxConfig  # noqa: E402
from mobilefinetuner_tpu.data.tokenizer_gemma import \
    GemmaTokenizer as JaxTokenizer  # noqa: E402
from mobilefinetuner_tpu.io import checkpoints as jckpt  # noqa: E402
from mobilefinetuner_tpu.io.safetensors_io import \
    SafeTensorsReader as JaxReader  # noqa: E402
from mobilefinetuner_tpu.lora import lora as jlora  # noqa: E402
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu.optim import adam as jadam  # noqa: E402
from mobilefinetuner_tpu_torch import convert  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gemma_full_finetune as full  # noqa
from mobilefinetuner_tpu_torch.cli import train_lora_gemma as lora_cli  # noqa
from mobilefinetuner_tpu_torch.data.synthetic import (  # noqa: E402
    CORPUS_WORDS, synthetic_gemma_tokenizer)
from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
    GemmaTokenizer  # noqa: E402
from mobilefinetuner_tpu_torch.io import checkpoints as ckpt  # noqa: E402
from mobilefinetuner_tpu_torch.lora import peft_io  # noqa: E402
from mobilefinetuner_tpu_torch.lora.lora import (  # noqa: E402
    GEMMA_PRESETS, trainable_mask)
from mobilefinetuner_tpu_torch.optim import adam  # noqa: E402

JAX_ONLY = ["--prefetch", "0", "--async_save", "0"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gemma_cli")
    write_tiny_gemma3_dir(str(root / "gemma"))
    write_wikitext_dir(str(root / "wiki"))
    return str(root / "gemma"), str(root / "wiki"), root


def _argv(gdir, wiki, *extra):
    return ["--model_dir", gdir, "--data_dir", wiki, "--steps", "3",
            "--batch_size", "2", "--seq_len", "40", "--dtype", "float32",
            "--eval_interval", "3", "--eval_batches", "2", *extra]


def _losses(path):
    with open(path, newline="") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.fixture(scope="module")
def lora_runs(dirs):
    """Both LoRA CLIs resumed from one adapter the JAX package saved (B
    off zero, no .opt: step 0, a fresh optimizer), 3 steps each."""
    gdir, wiki, root = dirs
    cfg = JaxConfig.from_pretrained(gdir)
    tree = jax.tree.map(np.asarray, jlora.init_lora_gemma3(
        cfg, jlora.LoRASpec(rank=4, alpha=8.0, init="peft"),
        jax.random.PRNGKey(7)))
    rng = np.random.default_rng(7)
    for e in tree["blocks"].values():
        e["B"] = (rng.normal(size=e["B"].shape) * 0.05).astype(np.float32)
    src = str(root / "src.safetensors")
    jax_peft_io.save_adapter(src, tree, jlora.LoRASpec(
        rank=4, alpha=8.0, init="peft", targets=sorted(tree["blocks"])))
    outs = {}
    for name, main, extra in (("jax", jax_lora.main, JAX_ONLY),
                              ("port", lora_cli.main, ["--device", "cpu"])):
        out = str(root / f"lora_{name}")
        assert main(_argv(gdir, wiki, "--resume_from", src,
                          "--output_dir", out,
                          "--metrics_csv", os.path.join(out, "m.csv"),
                          "--peft_export_dir", os.path.join(out, "peft"),
                          *extra)) == 0
        outs[name] = out
    return outs


def test_lora_cli_losses_match_jax(lora_runs):
    jl = _losses(os.path.join(lora_runs["jax"], "m.csv"))
    pl = _losses(os.path.join(lora_runs["port"], "m.csv"))
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    assert pl[-1] < pl[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lora_files_load_across_packages(lora_runs, tmp_path, writer):
    """The native adapter, its .opt and the PEFT export of one package's
    run load in the other with the same values, and the other package
    writes them back byte for byte."""
    out = lora_runs[writer]
    path = os.path.join(out, "gemma_lora.safetensors")
    pl, pspec = peft_io.load_adapter(path, device="cpu")
    jl, jspec = jax_peft_io.load_adapter(path)
    assert pspec.targets == jspec.targets and pspec.init == "peft"
    for n, e in pl["blocks"].items():
        for k in ("A", "B"):
            assert np.array_equal(e[k].numpy(), np.asarray(jl["blocks"][n][k]))
    p_again, j_again = str(tmp_path / "p.st"), str(tmp_path / "j.st")
    peft_io.save_adapter(p_again, pl, pspec)
    jax_peft_io.save_adapter(j_again, jl, jspec)
    assert _same_bytes(p_again, path) and _same_bytes(j_again, path)
    # the .opt sidecar
    jst, jcfg = jadam.load_state(path + ".opt", jadam.init_state(
        jl, jadam.AdamConfig(), jlora.trainable_mask(jl)))
    pst, _ = adam.load_state(path + ".opt", adam.init_state(
        pl, adam.AdamConfig(), trainable_mask(pl)), verify=True)
    assert int(pst["step"]) == int(jst["step"]) == 3
    for (a_path, a), (b_path, b) in zip(
            adam.flatten(pst).items(),
            adam.flatten(convert.adam_state_from_numpy(
                jax.tree.map(np.asarray, jst), device="cpu")).items()):
        assert a_path == b_path and torch.equal(a, b)
    md = JaxReader(path + ".opt").metadata
    adam.save_state(str(tmp_path / "p.opt"), pst, jcfg,
                    extra_metadata={"loop_step": md["loop_step"]})
    jadam.save_state(str(tmp_path / "j.opt"), jst, jcfg,
                     extra_metadata={"loop_step": md["loop_step"]})
    assert _same_bytes(str(tmp_path / "p.opt"), path + ".opt")
    assert _same_bytes(str(tmp_path / "j.opt"), path + ".opt")
    # the PEFT export (family "gemma")
    pdir = os.path.join(out, "peft")
    pp, _ = peft_io.import_peft(pdir, "gemma", device="cpu")
    jp, _ = jax_peft_io.import_peft(pdir, "gemma")
    for n, e in pp["blocks"].items():
        for k in ("A", "B"):
            assert np.array_equal(e[k].numpy(), np.asarray(jp["blocks"][n][k]))
            assert np.array_equal(e[k].numpy(), pl["blocks"][n][k].numpy())
    peft_io.export_peft(str(tmp_path / "pp"), pp, pspec, "gemma",
                        base_model_name=os.path.dirname(out) + "/gemma")
    jax_peft_io.export_peft(str(tmp_path / "jp"), jp, jspec, "gemma",
                            base_model_name=os.path.dirname(out) + "/gemma")
    for f in ("adapter_model.safetensors", "adapter_config.json"):
        assert _same_bytes(str(tmp_path / "pp" / f), str(tmp_path / "jp" / f))


@pytest.fixture(scope="module")
def full_runs(dirs):
    gdir, wiki, root = dirs
    outs = {}
    for name, main, extra in (("jax", jax_full.main, JAX_ONLY),
                              ("port", full.main, ["--device", "cpu"])):
        out = str(root / f"full_{name}")
        assert main(_argv(gdir, wiki, "--output_path",
                          os.path.join(out, "full.safetensors"),
                          "--metrics_csv", os.path.join(out, "m.csv"),
                          "--lr", "1e-3", *extra)) == 0
        outs[name] = out
    return outs


def test_full_finetune_cli_losses_match_jax(full_runs):
    jl = _losses(os.path.join(full_runs["jax"], "m.csv"))
    pl = _losses(os.path.join(full_runs["port"], "m.csv"))
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    assert pl[-1] < pl[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_full_model_and_opt_files_load_across_packages(dirs, full_runs,
                                                       tmp_path, writer):
    gdir = dirs[0]
    path = os.path.join(full_runs[writer], "full.safetensors")
    cfg, _ = ckpt.load_gemma3(gdir)
    jcfg = JaxConfig.from_pretrained(gdir)
    p_np = ckpt.gemma3_params_from_hf(JaxReader(path).load_all(), cfg)
    j_np = jckpt.gemma3_params_from_hf(JaxReader(path).load_all(), jcfg)
    params = convert.gemma3_params_from_numpy(p_np, device="cpu")
    ckpt.save_gemma3(str(tmp_path / "p.st"), params)
    jckpt.save_gemma3(str(tmp_path / "j.st"), j_np)
    assert _same_bytes(str(tmp_path / "p.st"), path)
    assert _same_bytes(str(tmp_path / "j.st"), path)
    jst, jc = jadam.load_state(path + ".opt", jadam.init_state(
        jax.tree.map(jnp.asarray, j_np), jadam.AdamConfig()))
    pst, _ = adam.load_state(path + ".opt",
                             adam.init_state(params, adam.AdamConfig()),
                             verify=True)
    assert int(pst["step"]) == int(jst["step"]) == 3
    md = {"loop_step": JaxReader(path + ".opt").metadata["loop_step"]}
    adam.save_state(str(tmp_path / "p.opt"), pst, jc, extra_metadata=md)
    jadam.save_state(str(tmp_path / "j.opt"), jst, jc, extra_metadata=md)
    assert _same_bytes(str(tmp_path / "p.opt"), path + ".opt")
    assert _same_bytes(str(tmp_path / "j.opt"), path + ".opt")


def test_full_finetune_resumes_from_its_files(dirs, full_runs, tmp_path):
    """A port run resumed from the JAX run's model + .opt continues at
    step 3 with the JAX run's step-4 loss (<= 1e-4)."""
    gdir, wiki, _ = dirs
    src = os.path.join(full_runs["jax"], "full.safetensors")
    outs = {}
    for name, main, extra in (("jax", jax_full.main, JAX_ONLY),
                              ("port", full.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        argv = _argv(gdir, wiki, "--output_path",
                     os.path.join(out, "full.safetensors"),
                     "--metrics_csv", os.path.join(out, "m.csv"),
                     "--lr", "1e-3", "--resume_from", src, *extra)
        argv[argv.index("--steps") + 1] = "4"
        assert main(argv) == 0
        outs[name] = _losses(os.path.join(out, "m.csv"))
    assert len(outs["port"]) == len(outs["jax"]) == 1
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-4, rtol=0)


def test_tokenizer_ids_match_jax(dirs, tmp_path):
    texts = WIKI_LINES[:6] + [" w001 w399 w123 ", "<bos>user ünï ☃ 12",
                              "", "  double  spaces "]
    path = os.path.join(dirs[0], "tokenizer.json")
    spec_path = str(tmp_path / "tokenizer.json")
    with open(spec_path, "w", encoding="utf-8") as f:
        json.dump(synthetic_gemma_tokenizer(2048), f, ensure_ascii=False)
    for p in (path, spec_path):
        ours, theirs = GemmaTokenizer(p), JaxTokenizer(p)
        assert (ours.pad_id, ours.eos_id, ours.bos_id, ours.unk_id) == \
            (theirs.pad_id, theirs.eos_id, theirs.bos_id, theirs.unk_id)
        for t in texts:
            for bos in (True, False):
                ids = ours.encode(t, add_bos=bos)
                assert ids == theirs.encode(t, add_bos=bos)
                assert ours.decode(ids) == theirs.decode(ids)
    # every corpus word is one token of the synthetic vocabulary
    tok = GemmaTokenizer(spec_path)
    assert len(tok.encode(" " + " ".join(CORPUS_WORDS), add_bos=False)) \
        == len(CORPUS_WORDS)


def test_gemma_clis_refuse_what_is_not_ported(dirs):
    gdir, wiki, root = dirs
    out = ["--output_dir", str(root / "refuse")]
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lora_cli.main(_argv(gdir, wiki, *out))
    for flag in (["--straggler_cadence", "4"], ["--mesh_fsdp", "2"],
                 ["--align_dump_dir", "d"], ["--shard_enable"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            lora_cli.main(_argv(gdir, wiki, *out, "--device", "cpu", *flag))
    full_out = ["--output_path", str(root / "refuse" / "f.safetensors")]
    for flag in (["--opt_offload"], ["--opt_offload_state_dtype",
                                     "bfloat16"], ["--multihost"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            full.main(_argv(gdir, wiki, *full_out, "--device", "cpu", *flag))


@pytest.fixture(scope="module")
def head_runs(dirs):
    """Both LoRA CLIs resumed from one JAX-saved adapter on q_proj and the
    lm_head (B off zero), 3 steps each: the head adapter rides the
    chunked loss (the port's rows 9-11 through their plain versions)."""
    gdir, wiki, root = dirs
    cfg = JaxConfig.from_pretrained(gdir)
    spec = jlora.LoRASpec(rank=4, alpha=8.0, init="peft",
                          targets=["q_proj", "lm_head"])
    tree = jax.tree.map(np.asarray, jlora.init_lora_gemma3(
        cfg, spec, jax.random.PRNGKey(9)))
    rng = np.random.default_rng(9)
    for e in tree["blocks"].values():
        e["B"] = (rng.normal(size=e["B"].shape) * 0.05).astype(np.float32)
    src = str(root / "head_src.safetensors")
    jax_peft_io.save_adapter(src, tree, spec)
    outs = {}
    for name, main, extra in (("jax", jax_lora.main, JAX_ONLY),
                              ("port", lora_cli.main, ["--device", "cpu"])):
        out = str(root / f"head_{name}")
        assert main(_argv(gdir, wiki, "--resume_from", src,
                          "--lora_targets", "q_proj,lm_head",
                          "--output_dir", out,
                          "--metrics_csv", os.path.join(out, "m.csv"),
                          *extra)) == 0
        outs[name] = out
    return outs


def test_head_target_cli_losses_match_jax(head_runs):
    jl = _losses(os.path.join(head_runs["jax"], "m.csv"))
    pl = _losses(os.path.join(head_runs["port"], "m.csv"))
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    assert pl[-1] < pl[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_head_adapter_files_load_across_packages(head_runs, tmp_path,
                                                 writer):
    """The trained adapter (its unstacked lm_head A [H, r] / B [r, V]) and
    its .opt sidecar load in the other package and are written back byte
    for byte; PEFT export of the lm_head is refused by both."""
    path = os.path.join(head_runs[writer], "gemma_lora.safetensors")
    pl, pspec = peft_io.load_adapter(path, device="cpu")
    jl, jspec = jax_peft_io.load_adapter(path)
    assert sorted(pl["blocks"]) == ["lm_head", "q_proj"]
    assert pspec.targets == jspec.targets
    assert pl["blocks"]["lm_head"]["A"].ndim == 2
    for n, e in pl["blocks"].items():
        for k in ("A", "B"):
            assert np.array_equal(e[k].numpy(), np.asarray(jl["blocks"][n][k]))
    p_again, j_again = str(tmp_path / "p.st"), str(tmp_path / "j.st")
    peft_io.save_adapter(p_again, pl, pspec)
    jax_peft_io.save_adapter(j_again, jl, jspec)
    assert _same_bytes(p_again, path) and _same_bytes(j_again, path)
    jst, jcfg = jadam.load_state(path + ".opt", jadam.init_state(
        jl, jadam.AdamConfig(), jlora.trainable_mask(jl)))
    pst, _ = adam.load_state(path + ".opt", adam.init_state(
        pl, adam.AdamConfig(), trainable_mask(pl)), verify=True)
    assert int(pst["step"]) == int(jst["step"]) == 3
    md = {"loop_step": JaxReader(path + ".opt").metadata["loop_step"]}
    adam.save_state(str(tmp_path / "p.opt"), pst, jcfg, extra_metadata=md)
    jadam.save_state(str(tmp_path / "j.opt"), jst, jcfg, extra_metadata=md)
    assert _same_bytes(str(tmp_path / "p.opt"), path + ".opt")
    assert _same_bytes(str(tmp_path / "j.opt"), path + ".opt")
    with pytest.raises(ValueError, match="lm_head"):
        peft_io.export_peft(str(tmp_path / "pp"), pl, pspec, "gemma")
    with pytest.raises(ValueError, match="lm_head"):
        jax_peft_io.export_peft(str(tmp_path / "jp"), jl, jspec, "gemma")


def test_lora_targets_expand_a_preset(dirs):
    """--lora_targets full,lm_head: the preset's seven targets and the
    head, one step on the CPU."""
    gdir, wiki, root = dirs
    out = str(root / "expand")
    argv = _argv(gdir, wiki, "--lora_targets", "full,lm_head",
                 "--output_dir", out, "--device", "cpu")
    argv[argv.index("--steps") + 1] = "1"
    assert lora_cli.main(argv) == 0
    lora, spec = peft_io.load_adapter(
        os.path.join(out, "gemma_lora.safetensors"), device="cpu")
    assert sorted(lora["blocks"]) == sorted(
        GEMMA_PRESETS["full"] + ["lm_head"])
    assert float(lora["blocks"]["lm_head"]["B"].abs().max()) > 0
