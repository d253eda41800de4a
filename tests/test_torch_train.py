"""Port training stack against the JAX package on the CPU, f32: the loss
(ops/loss.py), Adam and its clipping (optim/adam.py), the LR schedule
(optim/schedule.py), the `.opt` and adapter files both ways, and three
optimizer steps of make_train_step (train/trainer.py) on a tiny GPT-2
with a LoRA and gradient accumulation. Every comparison feeds both
packages the same numpy inputs; tolerances are stated per test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io
from mobilefinetuner_tpu.lora.lora import LoRASpec as JaxLoRASpec
from mobilefinetuner_tpu.lora.lora import init_lora_gpt2 as jax_init_lora
from mobilefinetuner_tpu.lora.lora import trainable_mask as jax_mask
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2
from mobilefinetuner_tpu.ops import loss as jax_loss
from mobilefinetuner_tpu.optim import adam as jax_adam
from mobilefinetuner_tpu.optim.schedule import lr_schedule as jax_schedule
from mobilefinetuner_tpu.train import trainer as jax_trainer
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.lora import peft_io
from mobilefinetuner_tpu_torch.lora.lora import trainable_mask
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.ops import loss
from mobilefinetuner_tpu_torch.optim import adam
from mobilefinetuner_tpu_torch.optim.schedule import lr_schedule
from mobilefinetuner_tpu_torch.train import trainer


def _err(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0


def _rel(a, b):
    """_err over max(1, max |b|): f32 values of ~10 differ in ulps."""
    b = np.asarray(b)
    return _err(a, b) / max([1.0, *np.abs(b).reshape(-1).tolist()])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """{path: numpy} of a nested dict of torch tensors or arrays."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (v.detach().numpy() if torch.is_tensor(v)
                                    else np.asarray(v))
    return out


# ------------------------------------------------------------------ loss --

def test_loss_values_and_grads_match_jax():
    """Every reduction of the causal-LM CE, ignore_index rows included, and
    the mean loss's gradient to the logits: f32, <= 1e-5 (the shift
    happens inside, once, in both)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (3, 9)).astype(np.int32)
    labels[1, 4:] = -100
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    lj, yj = jnp.asarray(logits), jnp.asarray(labels)
    for red in ("mean", "sum", "none"):
        assert _err(loss.lm_cross_entropy(lt, yt, reduction=red),
                    jax_loss.lm_cross_entropy(lj, yj, reduction=red)) <= 1e-5
    for name in ("lm_cross_entropy_sum", "lm_cross_entropy_rows",
                 "lm_cross_entropy_with_count"):
        for a, b in zip(getattr(loss, name)(lt, yt),
                        getattr(jax_loss, name)(lj, yj)):
            assert _err(a, b) <= 1e-5, name
    assert loss.lm_cross_entropy_sum(lt, yt)[1] == 3 * 8 - 5
    lg = lt.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss.lm_cross_entropy(lg, yt), lg)
    want = jax.grad(lambda x: jax_loss.lm_cross_entropy(x, yj))(lj)
    assert _err(g, want) <= 1e-6
    assert abs(loss.perplexity_from_loss(torch.tensor(2.0))
               - jax_loss.perplexity_from_loss(2.0)) < 1e-9


# ------------------------------------------------------- optimizer, LR --

def _adam_tree(rng):
    return {"blocks": {"attn_qkv": {
        "A": rng.standard_normal((2, 8, 4)).astype(np.float32),
        "B": rng.standard_normal((2, 4, 24)).astype(np.float32),
        "scale": np.float32(4.0)}}}


@pytest.mark.parametrize("opts", [
    dict(), dict(weight_decay=0.1), dict(weight_decay=0.1,
                                         coupled_weight_decay=True),
    dict(amsgrad=True)])
def test_adam_update_matches_jax_over_five_steps(opts):
    """Five steps on identical gradients, masked scale leaf included:
    params, m, v (and v_hat) and the update/param norms within 1e-6 of
    max(1, |value|)."""
    rng = np.random.default_rng(1)
    params = _adam_tree(rng)
    jcfg = jax_adam.AdamConfig(lr=1e-2, **opts)
    pcfg = adam.AdamConfig(lr=1e-2, **opts)
    jmask = jax_mask(params)
    pmask = trainable_mask(params)
    jp, js = params, jax_adam.init_state(params, jcfg, jmask)
    pp = convert.lora_from_numpy(params, device="cpu")
    ps = adam.init_state(pp, pcfg, pmask)
    for step in range(5):
        g = _adam_tree(rng)
        jp, js, jn = jax_adam.adam_update(g, js, jp, jcfg,
                                          jnp.float32(1e-2 / (step + 1)),
                                          jmask, with_norms=True)
        pp, ps, pn = adam.adam_update(
            convert.lora_from_numpy(g, device="cpu"), ps, pp, pcfg,
            torch.tensor(1e-2 / (step + 1)), pmask, with_norms=True)
        for a, b in zip(pn, jn):
            assert _rel(a, b) <= 1e-6
    for tree_p, tree_j in ((pp, jp), (ps, js)):
        want = _leaves(_np(tree_j))
        got = _leaves(tree_p)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert _rel(got[k], want[k]) <= 1e-6, k


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((5, 3)).astype(np.float32) * 4,
         "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 1e3):
        jc, jn = jax_adam.clip_by_global_norm(g, max_norm)
        pc, pn = adam.clip_by_global_norm(
            convert.lora_from_numpy(g, device="cpu"), max_norm)
        assert _err(pn, jn) <= 1e-5
        for k, v in _leaves(_np(jc)).items():
            assert _err(_leaves(pc)[k], v) <= 1e-6


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax_at_every_step(kind):
    for step in range(20):
        got = lr_schedule(step, 20, 3e-4, 0.15, kind, 0.1)
        want = jax_schedule(step, 20, 3e-4, 0.15, kind, 0.1)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-10, (kind, step)


# ------------------------------------------------------------------ files --

def test_opt_and_adapter_files_load_bit_equal_across_packages(tmp_path):
    """A .opt sidecar and a native adapter written by either package load
    in the other with every value bit-equal; the PEFT export round-trips
    too."""
    rng = np.random.default_rng(3)
    lora = _adam_tree(rng)
    cfg = jax_adam.AdamConfig(lr=3e-4, amsgrad=True)
    state = jax_adam.init_state(lora, cfg, jax_mask(lora))
    _, state = jax_adam.adam_update(_adam_tree(rng), state, lora, cfg,
                                    jnp.float32(1e-3), jax_mask(lora))
    state = _np(state)
    spec_j = JaxLoRASpec(rank=4, alpha=16.0, dropout=0.05,
                         targets=["attn_qkv"])
    # JAX -> port
    jax_adam.save_state(str(tmp_path / "j.opt"), state, cfg,
                        extra_metadata={"loop_step": "1"})
    jax_peft_io.save_adapter(str(tmp_path / "j.st"), lora, spec_j)
    plora = convert.lora_from_numpy(lora, device="cpu")
    template = adam.init_state(plora, adam.AdamConfig(amsgrad=True),
                               trainable_mask(plora))
    got, pcfg = adam.load_state(str(tmp_path / "j.opt"), template,
                                verify=True)
    assert pcfg == adam.AdamConfig(lr=3e-4, amsgrad=True)
    want = _leaves(state)
    for k, v in _leaves(got).items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k
    ad, spec = peft_io.load_adapter(str(tmp_path / "j.st"), device="cpu")
    assert (spec.rank, spec.alpha, spec.dropout) == (4, 16.0, 0.05)
    for k, v in _leaves(lora).items():
        assert np.array_equal(_leaves(ad)[k], v), k
    # port -> JAX
    adam.save_state(str(tmp_path / "p.opt"), got, pcfg,
                    extra_metadata={"loop_step": "1"})
    peft_io.save_adapter(str(tmp_path / "p.st"), ad, spec)
    back, jcfg = jax_adam.load_state(
        str(tmp_path / "p.opt"),
        jax.eval_shape(lambda t: jax_adam.init_state(t, cfg, jax_mask(t)),
                       lora), verify=True)
    assert jcfg == cfg
    for k, v in _leaves(_np(back)).items():
        assert np.array_equal(v, want[k]), k
    jad, jspec = jax_peft_io.load_adapter(str(tmp_path / "p.st"))
    assert jspec.rank == 4 and jspec.dropout == 0.05
    for k, v in _leaves(_np(jad)).items():
        assert np.array_equal(v, _leaves(lora)[k]), k
    # PEFT: port export -> JAX import, JAX export -> port import
    peft_io.export_peft(str(tmp_path / "pp"), ad, spec, "gpt2")
    jp, _ = jax_peft_io.import_peft(str(tmp_path / "pp"), "gpt2")
    jax_peft_io.export_peft(str(tmp_path / "jp"), lora, spec_j, "gpt2")
    pj, pspec = peft_io.import_peft(str(tmp_path / "jp"), "gpt2",
                                    device="cpu")
    assert pspec.rank == 4
    for k, v in _leaves(lora).items():
        assert np.array_equal(_leaves(_np(jp))[k], v)
        assert np.array_equal(_leaves(pj)[k], v)


# ------------------------------------------------------------ train step --

def _tiny_models(seed=0):
    jcfg = JaxGPT2Config.tiny()
    pcfg = GPT2Config.tiny()
    assert dataclasses.asdict(pcfg).items() <= dataclasses.asdict(
        jcfg).items()
    params = _np(jax_gpt2.init_params(jcfg, jax.random.PRNGKey(seed)))
    lora = _np(jax_init_lora(jcfg, JaxLoRASpec(rank=4, alpha=8.0),
                             jax.random.PRNGKey(seed + 1)))
    rng = np.random.default_rng(seed)
    for entry in lora["blocks"].values():    # B off zero: A trains too
        entry["B"] = (0.05 * rng.standard_normal(entry["B"].shape)).astype(
            np.float32)
    return jcfg, pcfg, params, lora


def test_train_step_matches_jax_over_three_steps():
    """make_train_step, both packages: tiny GPT-2 + LoRA (attn_qkv,
    attn_proj), micro-batch 2 x accumulation 2, a padded row, clipping and
    a warmup-cosine schedule, dropout off: the per-step losses, grad norms
    and LRs, and the final LoRA leaves, within 1e-5."""
    jcfg, pcfg, params, lora = _tiny_models()
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        ids = rng.integers(0, pcfg.vocab_size, (4, 16)).astype(np.int32)
        mask = np.ones((4, 16), np.float32)
        mask[2, 11:] = 0
        labels = np.where(mask > 0, ids, -100).astype(np.int32)
        batches.append({"input_ids": ids, "attention_mask": mask,
                        "labels": labels})
    kw = dict(total_steps=3, lr=5e-3, warmup_ratio=0.34,
              clip_grad_norm=0.5, grad_accum_steps=2, weight_decay=0.01)

    def jax_loss_fn(t, frozen, mb):
        logits = jax_gpt2.forward(jcfg, frozen, mb["input_ids"],
                                  attention_mask=mb["attention_mask"],
                                  lora=t)
        return jax_loss.lm_cross_entropy_sum(logits, mb["labels"])

    jtc = jax_trainer.TrainConfig(**kw)
    jstep = jax_trainer.make_train_step(jax_loss_fn, jtc, jax_mask(lora),
                                        donate=False)
    jt, jo = lora, jax_trainer.init_optimizer(lora, jtc, jax_mask(lora))
    jm = []
    for s, b in enumerate(batches):
        jt, jo, m = jstep(jt, params, jo, b, s)
        jm.append(_np(m))

    def port_loss_fn(t, frozen, mb):
        logits = gpt2.forward(pcfg, frozen, mb["input_ids"],
                              attention_mask=mb["attention_mask"], lora=t)
        return loss.lm_cross_entropy_sum(logits, mb["labels"])

    pt = convert.lora_from_numpy(lora, device="cpu")
    frozen = convert.gpt2_params_from_numpy(params, device="cpu")
    mask = trainable_mask(pt)
    ptc = trainer.TrainConfig(**kw)
    pstep = trainer.make_train_step(port_loss_fn, ptc, mask)
    po = trainer.init_optimizer(pt, ptc, mask)
    for s, b in enumerate(batches):
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in b.items()}
        pt, po, m = pstep(pt, frozen, po, tb, s)
        for key in ("loss", "grad_norm", "lr", "param_norm",
                    "update_ratio"):
            assert _err(m[key], jm[s][key]) <= 1e-5, (s, key)
        assert int(m["nonfinite_count"]) == 0 and int(m["skipped"]) == 0
    for k, v in _leaves(_np(jt)).items():
        assert _err(_leaves(pt)[k], v) <= 1e-5, k
    assert int(po["step"]) == 3


def test_skip_nonfinite_guard_and_accum_split():
    """A NaN gradient under skip_nonfinite leaves params and optimizer
    state (its step counter too) untouched and reports skipped = 1;
    reshape_for_accum refuses a batch that does not split."""
    _, pcfg, params, lora = _tiny_models(1)
    pt = convert.lora_from_numpy(lora, device="cpu")
    frozen = convert.gpt2_params_from_numpy(params, device="cpu")
    mask = trainable_mask(pt)
    tc = trainer.TrainConfig(total_steps=2, grad_accum_steps=1,
                             skip_nonfinite=True)

    def nan_loss(t, frozen, mb):
        a = t["blocks"]["attn_qkv"]["A"]
        return (a.sum() * float("nan"), torch.tensor(1.0))

    step = trainer.make_train_step(nan_loss, tc, mask)
    opt = trainer.init_optimizer(pt, tc, mask)
    batch = {"input_ids": torch.zeros(2, 4, dtype=torch.long)}
    new_t, new_o, m = step(pt, frozen, opt, batch, 0)
    assert int(m["skipped"]) == 1 and int(m["nonfinite_count"]) > 0
    assert int(new_o["step"]) == 0
    for k, v in _leaves(pt).items():
        assert np.array_equal(_leaves(new_t)[k], v)
    with pytest.raises(ValueError, match="micro-batches"):
        trainer.reshape_for_accum({"x": torch.zeros(3, 2)}, 2)


def test_remat_and_dropout_seeds():
    """Train-mode dropout (embd/resid/attn probs, LoRA branch) is a pure
    function of the seed: the same seed gives the same loss, another seed
    another; remat (torch.utils.checkpoint per block) recomputes with the
    same masks, so its loss and grads equal the plain forward's; no seed
    is eval mode."""
    _, pcfg, params, lora_np = _tiny_models(2)
    cfg = dataclasses.replace(pcfg, embd_pdrop=0.1, resid_pdrop=0.1,
                              attn_pdrop=0.1)
    frozen = convert.gpt2_params_from_numpy(params, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))

    def run(seed, remat, config=cfg):
        t = convert.lora_from_numpy(lora_np, device="cpu")
        leaves = [e[k].requires_grad_(True) for e in t["blocks"].values()
                  for k in ("A", "B")]
        logits = gpt2.forward(config, frozen, ids, lora=t, remat=remat,
                              lora_dropout=0.2, dropout_seed=seed)
        s, w = loss.lm_cross_entropy_sum(logits, ids)
        return float((s / w).detach()), torch.autograd.grad(s / w, leaves)

    a, ga = run(11, False)
    b, gb = run(11, True)
    c, _ = run(12, False)
    assert a == b and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert abs(a - c) > 1e-4
    assert run(None, False)[0] == run(None, False, pcfg)[0]
