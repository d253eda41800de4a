"""The port's GPT-2 LoRA CLI (mobilefinetuner_tpu_torch/cli/
gpt2_lora_finetune.py) on the tiny fixture checkpoint and corpus, on the
CPU in f32: what a run writes, that both CLIs resumed from one adapter
the JAX package saved take the same first step (loss within 1e-4), that
unported flags refuse, and that an adapter file the JAX package saved
serves the same greedy tokens in the port's engine (AdapterBank.load_file)
as in the JAX engine."""

import csv
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.cli import gpt2_lora_finetune as jax_cli  # noqa
from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config  # noqa
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu.lora.lora import LoRASpec as JaxLoRASpec  # noqa
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2  # noqa: E402
from mobilefinetuner_tpu.serve import AdapterBank as JaxAdapterBank  # noqa
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig  # noqa
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine  # noqa
from mobilefinetuner_tpu_torch import convert  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.core.config import GPT2Config  # noqa: E402
from mobilefinetuner_tpu_torch.io.safetensors_io import (  # noqa: E402
    CheckpointIntegrityError, SafeTensorsReader)
from mobilefinetuner_tpu_torch.lora import peft_io  # noqa: E402
from mobilefinetuner_tpu_torch.serve import (AdapterBank,  # noqa: E402
                                             ServeConfig, ServeEngine)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_tiny_gpt2_dir(str(root / "gpt2"))
    write_wikitext_dir(str(root / "wiki"))
    return str(root / "gpt2"), str(root / "wiki"), root


def _argv(gpt2_dir, wiki, out, *extra):
    return ["--pretrained_dir", gpt2_dir, "--data_dir", wiki,
            "--batch_size", "2", "--grad_accum_steps", "2",
            "--seq_len", "32", "--dtype", "float32",
            "--lora_out", os.path.join(out, "adapter.safetensors"),
            "--metrics_csv", os.path.join(out, "metrics.csv"), *extra]


def _rows(out):
    with open(os.path.join(out, "metrics.csv"), newline="") as f:
        return list(csv.DictReader(f))


def test_cli_writes_adapter_opt_csv_and_evals(dirs):
    gpt2_dir, wiki, root = dirs
    out = str(root / "port")
    assert cli.main(_argv(gpt2_dir, wiki, out, "--steps", "3",
                          "--device", "cpu", "--eval_interval", "2",
                          "--eval_batches", "2", "--save_every", "2",
                          "--eval_out", os.path.join(out, "eval.jsonl"),
                          "--peft_export_dir",
                          os.path.join(out, "peft"))) == 0
    rows = _rows(out)
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    with open(os.path.join(out, "eval.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    assert [e["type"] for e in evals] == ["eval", "final_eval"]
    adapter = os.path.join(out, "adapter.safetensors")
    for p in (adapter, adapter + ".opt",
              os.path.join(out, "adapter_step2.safetensors.opt")):
        assert os.path.exists(p) and os.path.exists(p + ".manifest.json")
    assert SafeTensorsReader(adapter + ".opt").metadata["loop_step"] == "3"
    lora, spec = peft_io.load_adapter(adapter, device="cpu")
    assert spec.rank == 8 and sorted(lora["blocks"]) == ["attn_proj",
                                                         "attn_qkv"]
    # the JAX package reads the adapter and the PEFT export
    jlora, _ = jax_peft_io.load_adapter(adapter)
    jpeft, _ = jax_peft_io.import_peft(os.path.join(out, "peft"), "gpt2")
    for name, entry in lora["blocks"].items():
        for leaf in ("A", "B"):
            assert np.array_equal(np.asarray(jlora["blocks"][name][leaf]),
                                  entry[leaf].numpy())
            assert np.array_equal(np.asarray(jpeft["blocks"][name][leaf]),
                                  entry[leaf].numpy())


def test_resume_from_a_jax_adapter_matches_the_jax_cli(dirs):
    """The JAX CLI trains 2 steps and saves adapter + .opt; both CLIs
    resume from those files for steps 3-4 over the same batches: step 3's
    loss within 1e-4, and the two final adapters within 1e-4."""
    gpt2_dir, wiki, root = dirs
    base = str(root / "jax0")
    assert jax_cli.main(_argv(gpt2_dir, wiki, base, "--steps", "2",
                              "--prefetch", "0", "--async_save", "0")) == 0
    src = os.path.join(base, "adapter.safetensors")
    outs = {}
    for name, main, extra in (
            ("jax", jax_cli.main, ["--prefetch", "0", "--async_save", "0"]),
            ("port", cli.main, ["--device", "cpu"])):
        out = str(root / f"resume_{name}")
        assert main(_argv(gpt2_dir, wiki, out, "--steps", "4",
                          "--resume_from", src, *extra)) == 0
        outs[name] = out
    jrows, prows = _rows(outs["jax"]), _rows(outs["port"])
    assert [r["step"] for r in prows] == [r["step"] for r in jrows] \
        == ["3", "4"]
    for jr, pr in zip(jrows, prows):
        assert abs(float(jr["loss"]) - float(pr["loss"])) <= 1e-4
        assert abs(float(jr["lr"]) - float(pr["lr"])) <= 1e-9
    jl, _ = jax_peft_io.load_adapter(os.path.join(
        outs["jax"], "adapter.safetensors"))
    pl, _ = peft_io.load_adapter(os.path.join(
        outs["port"], "adapter.safetensors"), device="cpu")
    for name, entry in pl["blocks"].items():
        for leaf in ("A", "B"):
            assert float(np.abs(np.asarray(jl["blocks"][name][leaf])
                                - entry[leaf].numpy()).max()) <= 1e-4


def test_cli_refuses_unported_flags_and_a_corrupt_resume(dirs):
    gpt2_dir, wiki, root = dirs
    out = str(root / "refuse")
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(_argv(gpt2_dir, wiki, out))
    # the observability flags are ported (tests/test_torch_observability
    # .py); the mesh, offload and cross-host straggler flags are not
    for flag in (["--mesh_fsdp", "2"], ["--shard_enable"],
                 ["--straggler_cadence", "4"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(_argv(gpt2_dir, wiki, out, "--device", "cpu", *flag))
    # a resume source whose bytes no longer match its manifest
    lora = {"blocks": {"attn_qkv": {"A": torch.ones(2, 32, 8),
                                    "B": torch.zeros(2, 8, 96),
                                    "scale": torch.tensor(2.0)}}}
    bad = os.path.join(out, "bad.safetensors")
    os.makedirs(out, exist_ok=True)
    peft_io.save_adapter(bad, lora, peft_io.LoRASpec(targets=["attn_qkv"]))
    with open(bad, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x01")
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        cli.main(_argv(gpt2_dir, wiki, out, "--device", "cpu",
                       "--resume_from", bad))


def test_adapter_file_saved_by_jax_serves_the_same_tokens(tmp_path):
    """AdapterBank.load_file: an adapter the JAX package wrote, hot-loaded
    from its file into the port's engine and into the JAX engine, serves
    identical greedy tokens (f32, CPU); a PEFT directory loads too."""
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(vocab_size=211),
                               n_embd=64, n_head=4, n_layer=2)
    pcfg = GPT2Config(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(GPT2Config)})
    np_params = jax.tree.map(np.asarray,
                             jax_gpt2.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    E, L = pcfg.n_embd, pcfg.n_layer
    tree = {"blocks": {n: {
        "A": (0.2 * rng.standard_normal((L, E, 4))).astype(np.float32),
        "B": (0.2 * rng.standard_normal((L, 4, o))).astype(np.float32),
        "scale": np.float32(2.0)} for n, o in (("attn_qkv", 3 * E),
                                                ("attn_proj", E))}}
    path = str(tmp_path / "tenant.safetensors")
    jax_peft_io.save_adapter(path, tree, JaxLoRASpec(
        rank=4, alpha=8.0, targets=["attn_proj", "attn_qkv"]))
    shape = dict(num_slots=2, block_T=8, num_blocks=16, max_prompt=16,
                 max_new_tokens=8)
    jeng = JaxServeEngine("gpt2", jcfg, np_params, JaxServeConfig(**shape),
                          bank=JaxAdapterBank(tree, capacity=1))
    jeng.load_adapter("t", path)
    template = convert.lora_from_numpy(tree, device="cpu")
    peng = ServeEngine("gpt2", pcfg,
                       convert.gpt2_params_from_numpy(np_params,
                                                      device="cpu"),
                       ServeConfig(**shape),
                       bank=AdapterBank(template, capacity=1), device="cpu")
    assert peng.load_adapter("t", path) == 0
    prompts = [[5, 9, 2, 13], [7, 3, 100, 42, 8, 1]]
    toks = []
    for eng in (jeng, peng):
        reqs = [eng.submit(p, adapter="t") for p in prompts]
        eng.drain()
        toks.append([r.tokens for r in reqs])
    jeng.close()
    assert toks[0] == toks[1]
    # a PEFT directory takes the same route; a corrupt file is refused
    peft_dir = str(tmp_path / "peft")
    jax_peft_io.export_peft(peft_dir, tree, JaxLoRASpec(rank=4, alpha=8.0),
                            "gpt2")
    peng.load_adapter("t", peft_dir)
    got = peng.bank.tree["blocks"]["attn_qkv"]["A"][0]
    assert torch.equal(got, torch.from_numpy(tree["blocks"]["attn_qkv"]["A"]))
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)[0]
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last ^ 0xFF]))
    with pytest.raises(CheckpointIntegrityError):
        peng.load_adapter("t", path)
