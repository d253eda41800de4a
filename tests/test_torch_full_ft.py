"""The port's GPT-2 full fine-tuning CLI (mobilefinetuner_tpu_torch/cli/
gpt2_full_finetune.py) against the JAX package's, on the tiny fixture
checkpoint and corpus, on the CPU in f32: three steps under
--no_model_dropout take the same losses (<= 1e-4); `save_gpt2` writes the
JAX package's bytes (and manifest) from the same parameters; either
package's model file loads in the other and is written back byte for
byte, and so are the `.opt` sidecars; a run resumed from either
package's `_step<N>` file repeats that package's uninterrupted losses;
with the model's dropout on, the loop runs, repeats itself and its
files reload; unported flags refuse."""

import csv
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.cli import gpt2_full_finetune as jax_full  # noqa
from mobilefinetuner_tpu.core.config import GPT2Config as JaxConfig  # noqa
from mobilefinetuner_tpu.io import checkpoints as jckpt  # noqa: E402
from mobilefinetuner_tpu.io.safetensors_io import \
    SafeTensorsReader as JaxReader  # noqa: E402
from mobilefinetuner_tpu.optim import adam as jadam  # noqa: E402
from mobilefinetuner_tpu_torch import convert  # noqa: E402
from mobilefinetuner_tpu_torch.cli import common  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_full_finetune as full  # noqa
from mobilefinetuner_tpu_torch.io import checkpoints as ckpt  # noqa: E402
from mobilefinetuner_tpu_torch.io.safetensors_io import \
    SafeTensorsReader  # noqa: E402
from mobilefinetuner_tpu_torch.optim import adam  # noqa: E402

JAX_ONLY = ["--prefetch", "0", "--async_save", "0"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt2_full")
    write_tiny_gpt2_dir(str(root / "gpt2"))
    write_wikitext_dir(str(root / "wiki"))
    return str(root / "gpt2"), str(root / "wiki"), root


def _argv(gdir, wiki, out, steps=3, *extra):
    return ["--pretrained_dir", gdir, "--data_dir", wiki,
            "--steps", str(steps), "--batch_size", "2",
            "--grad_accum_steps", "2", "--seq_len", "32",
            "--dtype", "float32", "--lr", "1e-3",
            "--output_path", os.path.join(out, "full.safetensors"),
            "--metrics_csv", os.path.join(out, "m.csv"), *extra]


def _losses(out):
    with open(os.path.join(out, "m.csv"), newline="") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


@pytest.fixture(scope="module")
def full_runs(dirs):
    """Both CLIs, 3 steps, no model dropout, a step file at step 2."""
    gdir, wiki, root = dirs
    outs = {}
    for name, main, extra in (("jax", jax_full.main, JAX_ONLY),
                              ("port", full.main, ["--device", "cpu"])):
        out = str(root / f"full_{name}")
        assert main(_argv(gdir, wiki, out, 3, "--no_model_dropout",
                          "--save_every", "2", "--eval_interval", "3",
                          "--eval_batches", "2", *extra)) == 0
        outs[name] = out
    return outs


def test_full_finetune_cli_losses_match_jax(full_runs):
    jl, pl = _losses(full_runs["jax"]), _losses(full_runs["port"])
    assert len(jl) == len(pl) == 3
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=0)
    assert pl[-1] < pl[0]


def test_save_gpt2_writes_the_jax_bytes(dirs, tmp_path):
    """The same parameters (the fixture checkpoint) through both
    `save_gpt2`s: byte-equal files and manifests."""
    gdir = dirs[0]
    cfg, p_np = ckpt.load_gpt2(gdir)
    _, j_np = jckpt.load_gpt2(gdir)
    ckpt.save_gpt2(str(tmp_path / "p.st"),
                   convert.gpt2_params_from_numpy(p_np, device="cpu"))
    jckpt.save_gpt2(str(tmp_path / "j.st"),
                    jax.tree.map(jnp.asarray, j_np))
    assert _same_bytes(str(tmp_path / "p.st"), str(tmp_path / "j.st"))
    manifests = [json.load(open(str(tmp_path / f"{w}.st.manifest.json")))
                 for w in "pj"]     # the same but for the file's name
    assert manifests[0]["tensors"] == manifests[1]["tensors"]
    assert [m["file"] for m in manifests] == ["p.st", "j.st"]
    # and the numpy tree the JAX loader gives saves the same bytes
    ckpt.save_gpt2(str(tmp_path / "n.st"), j_np)
    assert _same_bytes(str(tmp_path / "n.st"), str(tmp_path / "j.st"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_full_model_and_opt_files_load_across_packages(dirs, full_runs,
                                                       tmp_path, writer):
    gdir = dirs[0]
    path = os.path.join(full_runs[writer], "full.safetensors")
    cfg, _ = ckpt.load_gpt2(gdir)
    jcfg = JaxConfig.from_pretrained(gdir)
    p_np = ckpt.gpt2_params_from_hf(
        common.load_full_resume(path), cfg)
    j_np = jckpt.gpt2_params_from_hf(JaxReader(path).load_all(), jcfg)
    params = convert.gpt2_params_from_numpy(p_np, device="cpu")
    ckpt.save_gpt2(str(tmp_path / "p.st"), params)
    jckpt.save_gpt2(str(tmp_path / "j.st"), j_np)
    assert _same_bytes(str(tmp_path / "p.st"), path)
    assert _same_bytes(str(tmp_path / "j.st"), path)
    jst, jc = jadam.load_state(path + ".opt", jadam.init_state(
        jax.tree.map(jnp.asarray, j_np), jadam.AdamConfig()))
    pst, _ = adam.load_state(path + ".opt",
                             adam.init_state(params, adam.AdamConfig()),
                             verify=True)
    assert int(pst["step"]) == int(jst["step"]) == 3
    md = {"loop_step": JaxReader(path + ".opt").metadata["loop_step"]}
    assert md["loop_step"] == "3"
    adam.save_state(str(tmp_path / "p.opt"), pst, jc, extra_metadata=md)
    jadam.save_state(str(tmp_path / "j.opt"), jst, jc, extra_metadata=md)
    assert _same_bytes(str(tmp_path / "p.opt"), path + ".opt")
    assert _same_bytes(str(tmp_path / "j.opt"), path + ".opt")


@pytest.fixture(scope="module")
def whole_runs(dirs):
    """Both CLIs, 4 uninterrupted steps, a step file at step 2."""
    gdir, wiki, root = dirs
    outs = {}
    for name, main, extra in (("jax", jax_full.main, JAX_ONLY),
                              ("port", full.main, ["--device", "cpu"])):
        out = str(root / f"whole_{name}")
        assert main(_argv(gdir, wiki, out, 4, "--no_model_dropout",
                          "--save_every", "2", *extra)) == 0
        outs[name] = out
    return outs


@pytest.mark.parametrize("source", ["port", "jax"])
def test_resume_from_a_step_file_repeats_the_uninterrupted_losses(
        dirs, whole_runs, tmp_path, source):
    """The port resumed from either package's `_step2` file (model +
    .opt, loop_step 2) for steps 3-4 takes that package's uninterrupted
    losses at steps 3 and 4: the port's to 1e-6, the JAX CLI's to
    1e-4."""
    gdir, wiki, _ = dirs
    src = os.path.join(whole_runs[source], "full_step2.safetensors")
    assert SafeTensorsReader(src + ".opt").metadata["loop_step"] == "2"
    out = str(tmp_path / "resumed")
    assert full.main(_argv(gdir, wiki, out, 4, "--no_model_dropout",
                           "--resume_from", src, "--device", "cpu")) == 0
    resumed = _losses(out)
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, _losses(whole_runs[source])[2:],
                               atol=1e-6 if source == "port" else 1e-4,
                               rtol=0)


def _dropout_dir(gdir, d):
    """The fixture checkpoint with GPT-2's published dropout rates
    (embd / resid / attn pdrop 0.1) in its config.json."""
    os.makedirs(d, exist_ok=True)
    for name in os.listdir(gdir):
        if name != "config.json":
            shutil.copy(os.path.join(gdir, name), d)
    with open(os.path.join(gdir, "config.json")) as f:
        raw = json.load(f)
    raw.update(embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(raw, f)
    return d


def test_model_dropout_trains_and_saves(dirs, tmp_path):
    """With the checkpoint's dropout on (the attention probs through the
    flash path's hash mask under --attention_impl flash): finite losses
    that differ from the --no_model_dropout run's, the same losses again
    from a second run (the masks depend on the seed and the step only),
    and a model file and .opt that reload."""
    gdir, wiki, _ = dirs
    ddir = _dropout_dir(gdir, str(tmp_path / "gpt2_drop"))
    cfg, _ = ckpt.load_gpt2(ddir)
    assert cfg.attn_pdrop == cfg.resid_pdrop == cfg.embd_pdrop == 0.1
    runs = {}
    for name, extra in (("drop", []), ("again", []),
                        ("nodrop", ["--no_model_dropout"])):
        out = str(tmp_path / name)
        assert full.main(_argv(ddir, wiki, out, 2, "--device", "cpu",
                               "--attention_impl", "flash", *extra)) == 0
        runs[name] = _losses(out)
    assert all(np.isfinite(runs["drop"]))
    assert runs["drop"] == runs["again"]
    assert runs["drop"][0] != runs["nodrop"][0]
    path = os.path.join(str(tmp_path / "drop"), "full.safetensors")
    p = ckpt.gpt2_params_from_hf(common.load_full_resume(path), cfg)
    assert p["blocks"]["attn"]["qkv_w"].shape[0] == cfg.n_layer
    assert SafeTensorsReader(path + ".opt").metadata["loop_step"] == "2"


def test_full_finetune_refuses_what_is_not_ported(dirs):
    gdir, wiki, root = dirs
    out = str(root / "refuse")
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            full.main(_argv(gdir, wiki, out))
    for flag, item in ((["--mesh_fsdp", "2"], "P9"),
                       (["--straggler_cadence", "2"], "P9"),
                       (["--multihost"], "P9"),
                       (["--sequence_parallel"], "P9")):
        with pytest.raises(NotImplementedError, match=item):
            full.main(_argv(gdir, wiki, out, 3, "--device", "cpu", *flag))
