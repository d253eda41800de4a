"""Port file I/O and weights (mobilefinetuner_tpu_torch/io/, lora/lora.py
merge, convert.py) against the JAX package: safetensors files and their
checksum manifests byte-identical to the JAX package's Python writer and
readable both ways, bf16 encode/decode, integrity verdicts, load_gpt2 and
the HF key maps, merge/unmerge (split-QKV included), and the Adam-state
conversion."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import write_tiny_gpt2_dir  # noqa: E402

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config  # noqa
from mobilefinetuner_tpu.io import checkpoints as jax_ckpt  # noqa: E402
from mobilefinetuner_tpu.io import safetensors_io as jax_st  # noqa: E402
from mobilefinetuner_tpu.lora import lora as jax_lora  # noqa: E402
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2  # noqa: E402
from mobilefinetuner_tpu.optim import adam as jax_adam  # noqa: E402
from mobilefinetuner_tpu_torch import convert  # noqa: E402
from mobilefinetuner_tpu_torch.io import checkpoints, safetensors_io  # noqa
from mobilefinetuner_tpu_torch.lora import lora  # noqa: E402


def _tensors():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "i": np.arange(7, dtype=np.int32),
            "h": rng.standard_normal(4).astype(np.float16),
            "b": rng.standard_normal((2, 2)).astype(np.float32),
            "empty": np.zeros((0,), np.float32),
            "scalar": np.asarray(3, np.int32)}


def test_safetensors_bytes_and_manifest_equal_jax_writer(tmp_path,
                                                         monkeypatch):
    """The same tensors and metadata give the same file and manifest bytes
    as the JAX package's Python writer (bf16 keys too), and each package
    reads the other's file to identical arrays."""
    monkeypatch.setattr(jax_st, "_native_mod", lambda: None)
    md = {"format": "pt", "k": "v"}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = str(tmp_path / "port" / "w.safetensors")
    theirs = str(tmp_path / "jax" / "w.safetensors")
    safetensors_io.save_safetensors(ours, _tensors(), md, bf16_keys={"b"})
    jax_st.save_safetensors(theirs, _tensors(), md, bf16_keys={"b"})
    for suffix in ("", ".manifest.json"):
        with open(ours + suffix, "rb") as f, open(theirs + suffix, "rb") as g:
            assert f.read() == g.read()
    for path in (ours, theirs):
        a = safetensors_io.SafeTensorsReader(path)
        b = jax_st.SafeTensorsReader(path)
        assert a.metadata == b.metadata == md
        assert a.shape_dtype("b") == ((2, 2), "BF16")
        for k in _tensors():
            x, y = a.load(k), b.load(k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        assert safetensors_io.verify_report(path) == ("ok", None)


def test_bf16_round_trip_and_integrity_verdicts(tmp_path):
    x = np.asarray([1.0, 1.00390625, 1.01171875, -3.14159, 65504.0,
                    1e-30], np.float32)
    u = safetensors_io.f32_to_bf16_u16(x)
    assert np.array_equal(u, jax_st._f32_to_bf16_u16(x))
    assert np.array_equal(safetensors_io.bf16_to_f32(u),
                          torch.from_numpy(x).bfloat16().float().numpy())
    path = str(tmp_path / "a.st")
    safetensors_io.save_safetensors(path, {"x": x})
    assert safetensors_io.verify_report(path)[0] == "ok"
    with open(path, "r+b") as f:
        f.seek(-2, os.SEEK_END)
        f.write(b"\x00\x7f")
    assert safetensors_io.verify_report(path) == \
        jax_st.verify_report(path) == ("corrupt", "checksum_mismatch:x")
    with pytest.raises(safetensors_io.CheckpointIntegrityError):
        safetensors_io.verify_file(path)
    os.unlink(path + ".manifest.json")
    assert safetensors_io.verify_report(path)[0] == "unverified"
    with open(str(tmp_path / "bad.st"), "wb") as f:
        f.write(b"\xff" * 16)
    with pytest.raises(ValueError, match="malformed"):
        safetensors_io.SafeTensorsReader(str(tmp_path / "bad.st"))


def test_load_gpt2_and_key_maps_match_jax(tmp_path):
    d = str(tmp_path / "gpt2")
    write_tiny_gpt2_dir(d)
    cfg, params = checkpoints.load_gpt2(d)
    jcfg, jparams = jax_ckpt.load_gpt2(d)
    assert dataclasses.asdict(cfg).items() <= dataclasses.asdict(
        jcfg).items()
    assert cfg.attn_pdrop == cfg.embd_pdrop == cfg.resid_pdrop == 0.0
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    ours = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat] == [p for p, _ in ours]
    for (_, a), (_, b) in zip(ours, flat):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    hf = checkpoints.gpt2_params_to_hf(
        convert.gpt2_params_from_numpy(params, device="cpu"), "transformer.")
    jhf = jax_ckpt.gpt2_params_to_hf(jparams, "transformer.")
    assert list(hf) == list(jhf)
    assert all(np.array_equal(hf[k], jhf[k]) for k in hf)


def test_merge_unmerge_match_jax():
    """merge_gpt2 folds dW = scale * A @ B into the base weights as the
    JAX package does (fused and split-QKV targets); unmerge undoes it;
    a tied lm_head adapter refuses."""
    jcfg = JaxGPT2Config.tiny()
    params = jax.tree.map(np.asarray, jax_gpt2.init_params(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    E, L = jcfg.n_embd, jcfg.n_layer
    tree = {"blocks": {n: {
        "A": rng.standard_normal((L, E, 4)).astype(np.float32) * 0.1,
        "B": rng.standard_normal((L, 4, o)).astype(np.float32) * 0.1,
        "scale": np.float32(2.0)} for n, o in (("attn_q", E),
                                                ("attn_proj", E),
                                                ("mlp_fc_in", 4 * E))}}
    want = jax.tree.map(np.asarray, jax_lora.merge_gpt2(params, tree))
    tp = convert.gpt2_params_from_numpy(params, device="cpu")
    tl = convert.lora_from_numpy(tree, device="cpu")
    got = lora.merge_gpt2(tp, tl)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves_with_path(
                convert.to_numpy(got))):
        assert float(np.abs(a - b).max()) <= 1e-6, path
    back = lora.unmerge_gpt2(got, tl)
    for k in ("qkv_w", "proj_w"):
        assert float((back["blocks"]["attn"][k]
                      - tp["blocks"]["attn"][k]).abs().max()) <= 1e-6
    assert lora.num_trainable(tl) == jax_lora.num_trainable(tree)
    with pytest.raises(ValueError, match="lm_head"):
        lora.merge_gpt2(tp, {"blocks": {"lm_head": tl["blocks"]["attn_q"]}})


def test_adam_state_conversion_round_trip():
    tree = {"blocks": {"attn_qkv": {
        "A": np.ones((2, 8, 4), np.float32), "B": np.zeros((2, 4, 24),
                                                           np.float32),
        "scale": np.float32(2.0)}}}
    state = jax.tree.map(np.asarray, jax_adam.init_state(
        tree, jax_adam.AdamConfig(amsgrad=True), jax_lora.trainable_mask(tree)))
    port = convert.adam_state_from_numpy(state, device="cpu")
    assert port["step"].dtype == torch.int32
    assert port["m"]["blocks"]["attn_qkv"]["scale"].shape == (0,)
    back = convert.to_numpy(port)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(state),
                              jax.tree_util.tree_leaves_with_path(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b), p
