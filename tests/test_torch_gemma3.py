"""The port's Gemma-3 model (mobilefinetuner_tpu_torch/models/gemma3.py)
against the JAX package's, on the CPU in f32, at Gemma3TextConfig.tiny
(GQA 4:2, head_dim 8, a 16-token window on local layers) and S = 40, so
the window bites, with right padding: hidden states and the chunked loss
with and without the `full` LoRA preset (<= 1e-4), the logits and the
chunked loss with an lm_head adapter (<= 1e-4) and its branch dropout,
the LoRA and the full-fine-tuning gradients (<= 1e-5), and the pieces
around them (the config parser, RoPE, the LoRA init with and without the
head target, merge, checkpoints)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import Gemma3TextConfig as JaxConfig
from mobilefinetuner_tpu.io import checkpoints as jckpt
from mobilefinetuner_tpu.lora import lora as jlora
from mobilefinetuner_tpu.models import gemma3 as jgemma
from mobilefinetuner_tpu.ops import loss as jloss
from mobilefinetuner_tpu.ops import rope as jrope
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import Gemma3TextConfig
from mobilefinetuner_tpu_torch.io import checkpoints as ckpt
from mobilefinetuner_tpu_torch.lora import lora as plora
from mobilefinetuner_tpu_torch.models import gemma3
from mobilefinetuner_tpu_torch.ops import fused_ce as fc
from mobilefinetuner_tpu_torch.ops import loss
from mobilefinetuner_tpu_torch.ops import rope

B, S = 2, 40


@pytest.fixture(scope="module")
def model():
    jcfg = JaxConfig.tiny(vocab_size=96)
    cfg = Gemma3TextConfig.tiny(vocab_size=96)
    params_np = jax.tree.map(np.asarray,
                             jgemma.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    # norm weights off zero so the (1 + w) convention is exercised
    for grp in ("input_ln", "post_attn_ln", "pre_ffn_ln", "post_ffn_ln"):
        params_np["blocks"][grp] = rng.normal(
            size=params_np["blocks"][grp].shape).astype(np.float32) * 0.1
    for k in ("q_norm", "k_norm"):
        params_np["blocks"]["attn"][k] = rng.normal(
            size=params_np["blocks"]["attn"][k].shape).astype(
                np.float32) * 0.1
    spec = jlora.LoRASpec(rank=4, alpha=8.0, init="peft")
    lora_np = jax.tree.map(np.asarray, jlora.init_lora_gemma3(
        jcfg, spec, jax.random.PRNGKey(1)))
    for entry in lora_np["blocks"].values():      # B off zero
        entry["B"] = (rng.normal(size=entry["B"].shape) * 0.1).astype(
            np.float32)
    ids = rng.integers(0, 96, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 31:] = 0.0                             # right padding
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    return jcfg, cfg, params_np, lora_np, ids, mask, labels


def close(a, b, tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def test_config_matches_jax(tmp_path):
    for name in ("gemma3_270m", "gemma3_1b"):
        ours = dataclasses.asdict(getattr(Gemma3TextConfig, name)())
        theirs = dataclasses.asdict(getattr(JaxConfig, name)())
        theirs.pop("attention_impl")
        assert ours == theirs
    cfg = Gemma3TextConfig.gemma3_270m()
    assert [cfg.is_global_layer(i) for i in range(18)] == \
        [(i + 1) % 6 == 0 for i in range(18)]
    (tmp_path / "config.json").write_text(json.dumps({"text_config": {
        "hidden_size": 64, "num_hidden_layers": 3, "vocab_size": 50,
        "sliding_window_pattern": 3, "unknown": 1}}))
    loaded = Gemma3TextConfig.from_pretrained(str(tmp_path))
    assert dataclasses.asdict(loaded) == dataclasses.asdict(
        Gemma3TextConfig(hidden_size=64, num_hidden_layers=3, vocab_size=50,
                         sliding_window_pattern=3))
    assert loaded.layer_types == ["sliding_attention"] * 2 + \
        ["full_attention"]


def test_rope_matches_jax():
    pos = np.array([[0, 1, 2, 7], [0, 0, 1, 2]], np.int32)
    x = np.random.default_rng(1).normal(size=(2, 3, 4, 8)).astype(np.float32)
    for theta in (1e4, 1e6):
        jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 8, theta)
        c, s = rope.rope_cos_sin(torch.from_numpy(pos), 8, theta)
        close(c, jc, 1e-6)
        close(s, js, 1e-6)
        close(rope.apply_rope(torch.from_numpy(x), c, s),
              jrope.apply_rope(jnp.asarray(x), jc, js), 1e-6)


@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_hidden_states_and_chunked_loss_match_jax(model, with_lora,
                                                  attn_impl):
    jcfg, cfg, params_np, lora_np, ids, mask, labels = model
    jl = jax.tree.map(jnp.asarray, lora_np) if with_lora else None
    jh = jgemma.hidden_states(jcfg, params_np, jnp.asarray(ids),
                              jnp.asarray(mask), lora=jl)
    jv = jloss.chunked_lm_cross_entropy(jh, jnp.asarray(params_np["embed"]),
                                        jnp.asarray(labels), num_chunks=4)
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    pl = (convert.lora_from_numpy(lora_np, device="cpu") if with_lora
          else None)
    h = gemma3.hidden_states(cfg, params, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask), lora=pl,
                             attn_impl=attn_impl)
    close(h, jh, 1e-4)
    v = loss.chunked_lm_cross_entropy(h, params["embed"],
                                      torch.from_numpy(labels).long(),
                                      num_chunks=4)
    close(v, jv, 1e-4)
    logits = gemma3.forward(cfg, params, torch.from_numpy(ids).long(),
                            torch.from_numpy(mask), lora=pl)
    close(logits, jgemma.forward(jcfg, params_np, jnp.asarray(ids),
                                 jnp.asarray(mask), lora=jl), 1e-4)


def _with_head(lora_np, seed=4):
    """lora_np plus an unstacked lm_head entry, B off zero."""
    H, V = lora_np["blocks"]["q_proj"]["A"].shape[1], 96
    rng = np.random.default_rng(seed)
    out = {"blocks": dict(lora_np["blocks"])}
    out["blocks"]["lm_head"] = {
        "A": (rng.normal(size=(H, 4)) * 0.2).astype(np.float32),
        "B": (rng.normal(size=(4, V)) * 0.2).astype(np.float32),
        "scale": np.float32(2.0)}
    return out


@pytest.mark.parametrize("lora_impl", ["auto", "fused"])
def test_forward_with_head_adapter_matches_jax(model, lora_impl):
    """An lm_head adapter on the tied head: gemma3.forward's logits (the
    delta through maybe_lora at d_out = V; "fused" is the epilogue
    kernel's route, its plain version on the CPU) and the chunked loss
    with lora_head, against the JAX package (<= 1e-4)."""
    jcfg, cfg, params_np, lora_np, ids, mask, labels = model
    head_np = _with_head(lora_np)
    jl = jax.tree.map(jnp.asarray, head_np)
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    pl = convert.lora_from_numpy(head_np, device="cpu")
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    logits = gemma3.forward(cfg, params, tids, tmask, lora=pl,
                            lora_impl=lora_impl)
    jlogits = jgemma.forward(jcfg, params_np, jnp.asarray(ids),
                             jnp.asarray(mask), lora=jl)
    close(logits, jlogits, 1e-4)
    # the delta is there: without the head entry the logits differ
    base = dict(pl["blocks"])
    base.pop("lm_head")
    assert float((gemma3.forward(cfg, params, tids, tmask,
                                 lora={"blocks": base}) - logits).abs()
                 .max()) > 1e-2
    jh = jgemma.hidden_states(jcfg, params_np, jnp.asarray(ids),
                              jnp.asarray(mask), lora=jl)
    jv = jloss.chunked_lm_cross_entropy(
        jh, jnp.asarray(params_np["embed"]), jnp.asarray(labels),
        num_chunks=4, lora_head=jl["blocks"]["lm_head"])
    h = gemma3.hidden_states(cfg, params, tids, tmask, lora=pl)
    v = loss.chunked_lm_cross_entropy(
        h, params["embed"], torch.from_numpy(labels).long(), num_chunks=4,
        lora_head=pl["blocks"]["lm_head"])
    close(v, jv, 1e-4)


@pytest.mark.parametrize("impl", ["plain", "kernels"])
def test_head_adapter_branch_dropout_matches_unchunked(model, impl):
    """lora_dropout on the head adapter's branch (the port's own dropout
    bits, so held against the port's unchunked path, as the JAX package's
    tests hold theirs): the chunked loss with dropout_seed equals the mean
    NLL of gemma3.forward's logits with the same seed, which drops the
    branch input with the same fold_in(seed, 2000) mask; the dropout is
    live (the loss moves), and with B = 0 it changes nothing (only the
    branch is dropped, never the base logits). "kernels": the route a
    CUDA tensor takes, through rows 9-11's plain versions."""
    _, cfg, params_np, lora_np, ids, mask, labels = model
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    pl = convert.lora_from_numpy(_with_head(lora_np), device="cpu")
    head = pl["blocks"]["lm_head"]
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    lab = torch.from_numpy(labels).long()
    p, seed = 0.3, 1234
    h = gemma3.hidden_states(cfg, params, tids, tmask,
                             lora={"blocks": {"lm_head": head}})

    def chunked(entry, rate):
        if impl == "plain":
            return loss.chunked_lm_cross_entropy(
                h, params["embed"], lab, num_chunks=4, impl="plain",
                lora_head=entry, lora_dropout=rate, dropout_seed=seed)
        # the auto route's chunk body on a CUDA tensor, run on the CPU
        from mobilefinetuner_tpu_torch.ops.dropout import (fold_in,
                                                           inverted_dropout)
        hb = inverted_dropout(h, rate, fold_in(seed, 2000))
        hs, ls = loss._shift_and_chunk(h, lab, -100, 4)
        hbs, _ = loss._shift_and_chunk(hb, lab, -100, 4)
        parts = [fc.fused_ce_nll_sum(a, params["embed"], c, -100,
                                     lora_head=entry, branch_hidden=b)
                 for a, b, c in zip(hs, hbs, ls)]
        return sum(x[0] for x in parts) / sum(x[1] for x in parts)

    full = loss.lm_cross_entropy(
        gemma3.forward(cfg, params, tids, tmask,
                       lora={"blocks": {"lm_head": head}}, lora_dropout=p,
                       dropout_seed=seed), lab)
    close(chunked(head, p), full, 1e-5)
    assert abs(float(chunked(head, p)) - float(chunked(head, 0.0))) > 1e-4
    zero_b = dict(head, B=torch.zeros_like(head["B"]))
    close(chunked(zero_b, p), chunked(zero_b, 0.0), 1e-6)


def test_head_target_init_mask_and_merge_refusal(model):
    """The lm_head target end to end in lora/lora.py: init (unstacked
    A [H, r], B = 0 [r, V], the JAX package's shapes), the trainable mask
    (A and B train, the scale does not) and merge_gemma3's refusal of a
    tied head, as the JAX package refuses it."""
    jcfg, cfg, params_np, *_ = model
    targets = plora.GEMMA_PRESETS["full"] + ["lm_head"]
    pl = plora.init_lora_gemma3(cfg, plora.LoRASpec(
        rank=4, alpha=8.0, init="peft", targets=targets), seed=0,
        device="cpu")
    jl = jlora.init_lora_gemma3(jcfg, jlora.LoRASpec(
        rank=4, alpha=8.0, init="peft", targets=targets),
        jax.random.PRNGKey(0))
    for name in targets:
        for k in ("A", "B"):
            assert tuple(pl["blocks"][name][k].shape) == \
                jl["blocks"][name][k].shape
    head = pl["blocks"]["lm_head"]
    assert tuple(head["A"].shape) == (cfg.hidden_size, 4)
    assert tuple(head["B"].shape) == (4, cfg.vocab_size)
    assert not head["B"].any()
    mask = plora.trainable_mask(pl)
    assert mask["blocks"]["lm_head"] == {"A": True, "B": True,
                                         "scale": False}
    assert jlora.trainable_mask(jl)["blocks"]["lm_head"] == \
        mask["blocks"]["lm_head"]
    assert plora.num_trainable(pl) == sum(
        int(np.prod(e[k].shape)) for e in jl["blocks"].values()
        for k in ("A", "B"))
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    with pytest.raises(ValueError, match="tied"):
        plora.merge_gemma3(params, pl)
    with pytest.raises(ValueError, match="TIED"):
        jlora.merge_gemma3(params_np, jl)


def test_lora_gradients_match_jax(model):
    jcfg, cfg, params_np, lora_np, ids, mask, labels = model

    def jf(lt):
        h = jgemma.hidden_states(jcfg, params_np, jnp.asarray(ids),
                                 jnp.asarray(mask), lora=lt)
        return jloss.chunked_lm_cross_entropy(
            h, jnp.asarray(params_np["embed"]), jnp.asarray(labels),
            num_chunks=4)
    jg = jax.grad(jf)(jax.tree.map(jnp.asarray, lora_np))
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    pl = convert.lora_from_numpy(lora_np, device="cpu")
    leaves = [e[k].requires_grad_(True) for e in pl["blocks"].values()
              for k in ("A", "B")]
    h = gemma3.hidden_states(cfg, params, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask), lora=pl,
                             remat=True)          # remat changes nothing
    v = loss.chunked_lm_cross_entropy(h, params["embed"],
                                      torch.from_numpy(labels).long(),
                                      num_chunks=4)
    grads = torch.autograd.grad(v, leaves)
    want = [jg["blocks"][n][k] for n in pl["blocks"] for k in ("A", "B")]
    for g, w in zip(grads, want):
        close(g, w, 1e-5)


@pytest.mark.parametrize("impl", ["plain", "kernels"])
def test_full_finetune_gradients_match_jax(model, impl):
    """Every parameter trainable, the tied embedding's gradient summing the
    gather and the head ("kernels": the route a CUDA tensor takes,
    fused_ce_nll_sum over the chunks, through the kernels' plain
    versions)."""
    jcfg, cfg, params_np, _, ids, mask, labels = model

    def jf(p):
        h = jgemma.hidden_states(jcfg, p, jnp.asarray(ids),
                                 jnp.asarray(mask))
        return jloss.chunked_lm_cross_entropy(
            h, p["embed"], jnp.asarray(labels), num_chunks=4)
    jg = jax.tree.map(np.asarray,
                      jax.grad(jf)(jax.tree.map(jnp.asarray, params_np)))
    params = convert.gemma3_params_from_numpy(params_np, device="cpu")
    flat = plora.tree_leaves(params)
    for _, t in flat:
        t.requires_grad_(True)
    h = gemma3.hidden_states(cfg, params, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask))
    lab = torch.from_numpy(labels).long()
    if impl == "plain":
        v = loss.chunked_lm_cross_entropy(h, params["embed"], lab,
                                          num_chunks=4, impl="plain")
    else:
        parts = [fc.fused_ce_nll_sum(a, params["embed"], b, -100)
                 for a, b in zip(*loss._shift_and_chunk(h, lab, -100, 4))]
        v = sum(p[0] for p in parts) / sum(p[1] for p in parts)
    grads = torch.autograd.grad(v, [t for _, t in flat])
    want = dict(plora.tree_leaves(convert.gemma3_params_from_numpy(
        jg, device="cpu")))
    for (path, _), g in zip(flat, grads):
        close(g, want[path], 1e-5)


def test_lora_init_and_merge_match_jax(model):
    jcfg, cfg, params_np, lora_np, ids, mask, _ = model
    spec = plora.LoRASpec(rank=4, alpha=8.0, init="peft")
    pl = plora.init_lora_gemma3(cfg, spec, seed=3, device="cpu")
    assert sorted(pl["blocks"]) == sorted(lora_np["blocks"]) == sorted(
        plora.GEMMA_PRESETS["full"])
    for name, entry in pl["blocks"].items():
        assert entry["A"].shape == lora_np["blocks"][name]["A"].shape
        bound = 1.0 / np.sqrt(entry["A"].shape[1])
        assert float(entry["A"].abs().max()) <= bound
        assert float(entry["A"].abs().max()) > 0.5 * bound
        assert not entry["B"].any()
    assert plora.GEMMA_PRESETS == jlora.GEMMA_PRESETS
    merged = plora.merge_gemma3(
        convert.gemma3_params_from_numpy(params_np, device="cpu"),
        convert.lora_from_numpy(lora_np, device="cpu"))
    jmerged = jlora.merge_gemma3(params_np,
                                 jax.tree.map(jnp.asarray, lora_np))
    for path, t in plora.tree_leaves(merged):
        close(t, dict(plora.tree_leaves(convert.gemma3_params_from_numpy(
            jax.tree.map(np.asarray, jmerged), device="cpu")))[path], 1e-6)


def test_checkpoint_key_maps_match_jax(model, tmp_path):
    jcfg, cfg, params_np, *_ = model
    hf = ckpt.gemma3_params_to_hf(params_np)
    jhf = jckpt.gemma3_params_to_hf(params_np)
    assert list(hf) == list(jhf)
    for k in hf:
        assert np.array_equal(hf[k], jhf[k])
    back = ckpt.gemma3_params_from_hf(hf, cfg)
    for (pa, a), (pb, b) in zip(plora.tree_leaves(back),
                                plora.tree_leaves(params_np)):
        assert pa == pb and np.array_equal(a, b)
    # the port's save is the JAX package's, byte for byte
    ckpt.save_gemma3(str(tmp_path / "p.st"),
                     convert.gemma3_params_from_numpy(params_np,
                                                      device="cpu"))
    jckpt.save_gemma3(str(tmp_path / "j.st"), params_np)
    assert (tmp_path / "p.st").read_bytes() == (tmp_path / "j.st").read_bytes()
