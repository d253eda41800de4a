"""The port's multi-tenant LoRA training (mobilefinetuner_tpu_torch/
multitenant/, cli/train_multi_lora.py and the pieces under them) against
the JAX package on the CPU, at the JAX tests' sizes (GPT-2 2 layers x 32,
Gemma 2 layers x 48, S 32, B 2), f32.

Inputs come from seeded numpy; where an initial adapter must match, the
port engine's initialiser is swapped (monkeypatch) for the JAX package's
initial adapter carried across by convert.py. Tolerances are stated per
test: the jobs file and the saved bytes exactly, the multi-slot optimizer
and schedule to 1e-6, the ids-routed LoRA to 1e-5, the engine against
its own solo step to 1e-5, against the JAX engine to 1e-5 (GPT-2) and
1e-4 (Gemma) in the losses and ten times that in the weights, relative
to what training changed."""

import dataclasses
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.core.config import \
    Gemma3TextConfig as JaxGemmaConfig
from mobilefinetuner_tpu.lora import lora as jax_lora
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io
from mobilefinetuner_tpu.models import gemma3 as jax_gemma3
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2
from mobilefinetuner_tpu.models import lora_apply as jax_lora_apply
from mobilefinetuner_tpu.multitenant import engine as jax_engine
from mobilefinetuner_tpu.multitenant import jobspec as jax_jobspec
from mobilefinetuner_tpu.optim import adam as jax_adam
from mobilefinetuner_tpu.optim import schedule as jax_schedule
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry, validate_event
from mobilefinetuner_tpu_torch.io.safetensors_io import \
    CheckpointIntegrityError
from mobilefinetuner_tpu_torch.lora import lora, peft_io
from mobilefinetuner_tpu_torch.models import gemma3, gpt2, lora_apply
from mobilefinetuner_tpu_torch.models.generate import (SampleConfig,
                                                       gpt2_generate)
from mobilefinetuner_tpu_torch.multitenant import engine as mt_engine
from mobilefinetuner_tpu_torch.multitenant import jobspec
from mobilefinetuner_tpu_torch.multitenant import (EngineConfig, JobSpec,
                                                   MultiTenantEngine,
                                                   TenantMux)
from mobilefinetuner_tpu_torch.ops.dropout import row_dropout
from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
from mobilefinetuner_tpu_torch.optim import adam, schedule
from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine
from mobilefinetuner_tpu_torch.serve.adapters import AdapterBank
from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                     init_optimizer,
                                                     make_train_step)

GPT2_KW = dict(n_embd=32, n_head=2, n_positions=64, n_layer=2,
               embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
GEMMA_KW = dict(hidden_size=48, head_dim=12, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=96,
                num_hidden_layers=2, sliding_window=6,
                sliding_window_pattern=3)
CFG = {"gpt2": (dataclasses.replace(GPT2Config.tiny(vocab_size=211),
                                    **GPT2_KW),
                dataclasses.replace(JaxGPT2Config.tiny(vocab_size=211),
                                    **GPT2_KW)),
       "gemma": (dataclasses.replace(Gemma3TextConfig.tiny(vocab_size=199),
                                     **GEMMA_KW),
                 dataclasses.replace(JaxGemmaConfig.tiny(vocab_size=199),
                                     **GEMMA_KW))}
S = 32
B = 2
CPU = "cpu"


@pytest.fixture(scope="module")
def params():
    """{family: (port params, JAX params)}: one JAX init, both packages."""
    out = {}
    for fam, mod, seed in (("gpt2", jax_gpt2, 0), ("gemma", jax_gemma3, 1)):
        pj = mod.init_params(CFG[fam][1], jax.random.PRNGKey(seed))
        tree = jax.tree.map(np.asarray, pj)
        out[fam] = (convert.gpt2_params_from_numpy(tree, device=CPU)
                    if fam == "gpt2"
                    else convert.gemma3_params_from_numpy(tree, device=CPU),
                    pj)
    return out


def stream_batches(seed, n, vocab=199, b=B, s=S):
    """n deterministic [b, s] step batches (the JAX test's streams): the
    same list feeds the solo runs and both engines."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
        out.append({"input_ids": ids,
                    "attention_mask": np.ones((b, s), np.float32),
                    "labels": ids.copy()})
    return out


def make_stream(spec):
    return iter(stream_batches(spec.data_seed, 64))


def port_engine(family, p, jobs, tmp_path, slots=2, flush_every=1,
                telemetry=None, **kw):
    cfg = EngineConfig(slots=slots, rows_per_tenant=B, seq_len=S,
                       flush_every=flush_every, prefetch=0,
                       out_dir=str(tmp_path), **kw)
    return MultiTenantEngine(family, CFG[family][0], p, jobs, make_stream,
                             cfg, telemetry=telemetry, device=CPU)


def jax_init_swap(monkeypatch, family):
    """The port engine draws its adapters from the JAX initialiser (the
    same PRNGKey(seed)), carried across by convert.py."""
    jcfg = CFG[family][1]
    jfn = (jax_lora.init_lora_gpt2 if family == "gpt2"
           else jax_lora.init_lora_gemma3)

    def init(config, spec, seed=0, dtype=torch.float32, device=None):
        js = jax_lora.LoRASpec(rank=spec.rank, alpha=spec.alpha,
                               dropout=spec.dropout, targets=spec.targets,
                               init=spec.init)
        tree = jax.tree.map(np.asarray,
                            jfn(jcfg, js, jax.random.PRNGKey(seed)))
        return convert.lora_from_numpy(tree, device=device)

    name = "init_lora_gpt2" if family == "gpt2" else "init_lora_gemma3"
    monkeypatch.setattr(mt_engine, name, init)


def _err(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0


def _synced(step_fn):
    """The JAX engine's jitted step, returning only once its outputs are
    computed. JAX's CPU client may alias the host numpy arrays the engine
    hands the step (the per-slot step counters, LRs), and the engine
    mutates them right after the dispatch: on a loaded host the
    asynchronous step can read the next step's values."""
    def step(*args):
        return jax.block_until_ready(step_fn(*args))
    return step


def _steps(eng, n, names):
    hist = {name: [] for name in names}
    for _ in range(n):
        eng.step()
        for name in names:
            hist[name].append(eng.tenants[name].last_loss)
    return hist


# --------------------------------------------------- the queue-3 repair --

def test_unmerge_gemma3_round_trip_matches_jax(params):
    """merge -> unmerge on the same Gemma tree and adapter: each step
    equals the JAX package's within 1e-6, and the round trip returns the
    base weights."""
    p_port, p_jax = params["gemma"]
    rng = np.random.default_rng(3)
    spec = jax_lora.LoRASpec(rank=4, alpha=8.0)
    ad = jax.tree.map(np.asarray, jax_lora.init_lora_gemma3(
        CFG["gemma"][1], spec, jax.random.PRNGKey(2)))
    for e in ad["blocks"].values():
        e["B"] = rng.standard_normal(e["B"].shape).astype(np.float32) * 0.1
    ad_t = convert.lora_from_numpy(ad, device=CPU)
    merged = lora.merge_gemma3(p_port, ad_t)
    back = lora.unmerge_gemma3(merged, ad_t)
    j_merged = jax_lora.merge_gemma3(p_jax, ad)
    j_back = jax_lora.unmerge_gemma3(j_merged, ad)
    for grp, leaf in (("attn", "q_w"), ("attn", "o_w"), ("mlp", "down_w")):
        assert _err(merged["blocks"][grp][leaf],
                    j_merged["blocks"][grp][leaf]) <= 1e-6
        assert _err(back["blocks"][grp][leaf],
                    j_back["blocks"][grp][leaf]) <= 1e-6
        assert _err(back["blocks"][grp][leaf],
                    p_port["blocks"][grp][leaf]) <= 1e-6


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_param_count_matches_jax(family, params):
    p_port, p_jax = params[family]
    assert gpt2.param_count(p_port) == jax_gpt2.param_count(p_jax)


# ------------------------------------------------------------- (a) jobs --

JOB_DOCS = [
    {"family": "gpt2", "defaults": {"rank": 4, "steps": 10},
     "jobs": [{"name": "a", "lr": 1e-4, "seed": 1},
              {"name": "b", "lr": 3e-4, "alpha": 32.0}]},
    {"family": "gemma",
     "jobs": [{"name": "x", "targets": ["q_proj", "v_proj"],
               "save_every": 2, "keep_ckpts": 1, "peft_export_dir": "p"}]},
]
BAD_DOCS = [
    ("rank", {"jobs": [{"name": "a", "rank": 4}, {"name": "b", "rank": 8}]}),
    ("duplicate", {"jobs": [{"name": "a"}, {"name": "a"}]}),
    ("unknown field", {"jobs": [{"name": "a", "learning_rate": 1e-4}]}),
    ("family", {"family": "bert", "jobs": [{"name": "a"}]}),
    ("non-empty", {"jobs": []}),
    ("missing a name", {"jobs": [{"lr": 1e-3}]}),
    ("rank and steps", {"jobs": [{"name": "a", "steps": 0}]}),
    ("dropout", {"jobs": [{"name": "a", "dropout": 1.0}]}),
    ("dropout=", {"jobs": [{"name": "a", "dropout": 0.1},
                           {"name": "b", "dropout": 0.2}]}),
    ("defaults", {"defaults": [1], "jobs": [{"name": "a"}]}),
]


def test_jobspec_parse_and_validation_match_jax(tmp_path):
    """Every doc of the JAX test parses to the same JobSpecs field by
    field (JSON and TOML files too), and every invalid doc raises the
    same ValueError message in both packages."""
    for doc in JOB_DOCS:
        fam, jobs = jobspec.parse_jobs(doc)
        jfam, jjobs = jax_jobspec.parse_jobs(doc)
        assert fam == jfam
        assert [dataclasses.asdict(j) for j in jobs] == \
            [dataclasses.asdict(j) for j in jjobs]
    p = tmp_path / "jobs.json"
    p.write_text(json.dumps(JOB_DOCS[0]))
    t = tmp_path / "jobs.toml"
    t.write_text('family = "gpt2"\n[defaults]\nrank = 4\n'
                 '[[jobs]]\nname = "a"\n[[jobs]]\nname = "b"\n')
    for path in (str(p), str(t)):
        fam, jobs = jobspec.load_jobs_file(path)
        jfam, jjobs = jax_jobspec.load_jobs_file(path)
        assert fam == jfam and [dataclasses.asdict(j) for j in jobs] == \
            [dataclasses.asdict(j) for j in jjobs]
    for word, doc in BAD_DOCS:
        with pytest.raises(ValueError, match=word) as got:
            jobspec.parse_jobs(doc)
        with pytest.raises(ValueError) as want:
            jax_jobspec.parse_jobs(doc)
        assert str(got.value) == str(want.value)
    assert JobSpec(name="a").resolved_save_path("/out") == \
        "/out/a.safetensors"
    assert JobSpec(name="x", save_path="/tmp/c.st").resolved_save_path(
        "/out") == "/tmp/c.st"


# ------------------------------------------------- (b) optimizer, sched --

@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_multi_lr_schedule_matches_jax(kind):
    """multi_lr_schedule against the JAX function and against the port's
    solo lr_schedule per slot: 1e-6 relative."""
    totals = np.array([10, 50, 1, 7], np.float32)
    lrs = np.array([1e-3, 3e-4, 5e-2, 2e-3], np.float32)
    warm = np.array([0.2, 0.0, 0.5, 0.3], np.float32)
    for step in (0, 1, 2, 5, 49):
        st = np.full(4, step, np.float32)
        got = schedule.multi_lr_schedule(
            torch.from_numpy(st), torch.from_numpy(totals),
            torch.from_numpy(lrs), torch.from_numpy(warm), kind).numpy()
        want = np.asarray(jax_schedule.multi_lr_schedule(
            st.astype(np.int32), totals, lrs, warm, kind))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
        solo = [float(schedule.lr_schedule(step, int(t), float(l), float(w),
                                           kind))
                for t, l, w in zip(totals, lrs, warm)]
        np.testing.assert_allclose(got, solo, rtol=1e-6, atol=1e-12)


def _stacked(rng, k=3):
    return {"blocks": {
        "attn_qkv": {"A": rng.standard_normal((k, 2, 8, 4)).astype(
                         np.float32),
                     "B": rng.standard_normal((k, 2, 4, 24)).astype(
                         np.float32),
                     "scale": np.full(k, 2.0, np.float32)},
        "attn_proj": {"A": rng.standard_normal((k, 2, 8, 4)).astype(
                          np.float32),
                      "B": rng.standard_normal((k, 2, 4, 8)).astype(
                          np.float32),
                      "scale": np.full(k, 2.0, np.float32)}}}


@pytest.mark.parametrize("amsgrad,wd,coupled", [
    (False, 0.0, False), (True, 0.0, False), (False, 0.05, False),
    (True, 0.05, True)])
def test_multi_adam_update_matches_jax(amsgrad, wd, coupled):
    """Three stacked Adam steps with a per-slot apply mask and per-slot
    LRs (amsgrad, decoupled and coupled weight decay): params, m, v,
    v_hat, the per-slot step counters and the per-slot norms equal JAX's
    to 1e-6; a masked slot passes through bit for bit; every result is
    written into the tensor it replaces."""
    rng = np.random.default_rng(7)
    k = 3
    p_np = _stacked(rng, k)
    mask_j = jax_lora.trainable_mask(p_np)
    cfg_j = jax_adam.AdamConfig(weight_decay=wd, amsgrad=amsgrad,
                                coupled_weight_decay=coupled)
    cfg_t = adam.AdamConfig(weight_decay=wd, amsgrad=amsgrad,
                            coupled_weight_decay=coupled)
    st_j = jax_adam.init_multi_state(p_np, cfg_j, k, mask_j)
    p_t = convert.lora_from_numpy(p_np, device=CPU)
    mask_t = lora.trainable_mask(p_t)
    st_t = adam.init_multi_state(p_t, cfg_t, k, mask_t)
    p_j = p_np
    for it, app in enumerate(([1, 1, 0], [1, 0, 1], [1, 1, 1])):
        g_np = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p_np)
        lr = np.array([1e-2, 3e-3, 5e-2], np.float32) * (it + 1)
        app_np = np.array(app, bool)
        p_j, st_j, (u_j, w_j) = jax_adam.multi_adam_update(
            g_np, st_j, p_j, cfg_j, lr, app_np, mask_j, with_norms=True)
        before = adam.tree_map(torch.clone, p_t)
        ptrs = {k: t.data_ptr()
                for k, t in adam.flatten({"p": p_t, "s": st_t}).items()}
        with torch.no_grad():
            p_t, st_t, (u_t, w_t) = adam.multi_adam_update(
                convert.lora_from_numpy(g_np, device=CPU), st_t, p_t,
                cfg_t, torch.from_numpy(lr), torch.from_numpy(app_np),
                mask_t, with_norms=True)
        # written in place: every tensor stays where it was
        assert {k: t.data_ptr() for k, t in adam.flatten(
            {"p": p_t, "s": st_t}).items()} == ptrs
        assert _err(u_t, u_j) <= 1e-6 * max(1.0, float(np.max(u_j)))
        assert _err(w_t, w_j) <= 1e-6 * max(1.0, float(np.max(w_j)))
        for j in np.flatnonzero(~app_np):
            for e0, e1 in zip(before["blocks"].values(),
                              p_t["blocks"].values()):
                assert torch.equal(e0["A"][j], e1["A"][j])
    assert np.array_equal(st_t["step"].numpy(), np.asarray(st_j["step"]))
    for key in ("m", "v") + (("v_hat",) if amsgrad else ()):
        for name in p_np["blocks"]:
            for leaf in ("A", "B"):
                assert _err(st_t[key]["blocks"][name][leaf],
                            st_j[key]["blocks"][name][leaf]) <= 1e-6
    for name in p_np["blocks"]:
        for leaf in ("A", "B"):
            assert _err(p_t["blocks"][name][leaf],
                        p_j["blocks"][name][leaf]) <= 1e-6


def test_slot_norms_and_clip_match_jax():
    """slot_norms and clip_by_slot_norm on a stacked grad tree (the [k]
    scale leaf included): 1e-6 against JAX, and slot j's norm is the
    solo global_norm of its own tree."""
    rng = np.random.default_rng(11)
    g_np = _stacked(rng)
    g_t = convert.lora_from_numpy(g_np, device=CPU)
    n_t = adam.slot_norms(g_t)
    assert _err(n_t, jax_adam.slot_norms(g_np)) <= 1e-6 * float(n_t.max())
    c_t, cn_t = adam.clip_by_slot_norm(g_t, 5.0)
    c_j, cn_j = jax_adam.clip_by_slot_norm(g_np, 5.0)
    assert _err(cn_t, cn_j) <= 1e-6 * float(cn_t.max())
    for name in g_np["blocks"]:
        for leaf in ("A", "B", "scale"):
            assert _err(c_t["blocks"][name][leaf],
                        c_j["blocks"][name][leaf]) <= 1e-6
    for j in range(3):
        solo = lora.unstack_adapter(g_t, j)
        assert abs(float(adam.global_norm(solo)) - float(n_t[j])) \
            <= 1e-5 * float(n_t[j])


# ------------------------------------------------- (c) the routed LoRA --

def _routed_inputs(seed, n_rows=8, S_=1, d_in=32, d_out=16, r=8, k=3):
    """A decode-like routed site (one token per row): the JAX package's
    cost model picks its dense order here under `fused`."""
    rng = np.random.default_rng(seed)
    entry = {"A": rng.standard_normal((k, 2, d_in, r)).astype(np.float32),
             "B": rng.standard_normal((k, 2, r, d_out)).astype(np.float32)
             * 0.05,
             "scale": rng.uniform(0.5, 2.0, k).astype(np.float32),
             "ids": rng.integers(0, k, n_rows).astype(np.int32)}
    x = rng.standard_normal((n_rows, S_, d_in)).astype(np.float32)
    y = rng.standard_normal((n_rows, S_, d_out)).astype(np.float32)
    g = rng.standard_normal((n_rows, S_, d_out)).astype(np.float32)
    return entry, x, y, g


@pytest.mark.parametrize("impl,order", [("naive", "gather"),
                                        ("fused", "dense")])
def test_multi_lora_orders_match_jax(impl, order):
    """The port's ids-routed site (the gather under every impl), forward
    and the gradients of x, A and B, against the JAX _multi_lora under
    the same impl, which takes `order` here: 1e-5. Under `fused` the JAX
    side runs its dense order, so the gather is held against both of the
    JAX package's orders."""
    entry, x, y, g = _routed_inputs(0)
    k, _, d_in, r = entry["A"].shape
    d_out = entry["B"].shape[-1]
    n_tok = x.shape[0] * x.shape[1]
    want_order = "gather" if impl == "naive" else \
        jax_lora_apply.resolve_multi_order(x.shape[0], n_tok, d_in, d_out,
                                           r, k, 4)
    assert want_order == order

    def jfn(xx, A, Bm):
        e = dict(entry, A=A, B=Bm)
        return jnp.sum(jax_lora_apply.maybe_lora(
            jnp.asarray(y), xx, e, 1, impl=impl) * g)

    j_out = jax_lora_apply.maybe_lora(jnp.asarray(y), jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, entry), 1,
                                      impl=impl)
    j_grads = jax.grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(entry["A"]), jnp.asarray(entry["B"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    At = torch.from_numpy(entry["A"]).requires_grad_(True)
    Bt = torch.from_numpy(entry["B"]).requires_grad_(True)
    et = {"A": At, "B": Bt, "scale": torch.from_numpy(entry["scale"]),
          "ids": torch.from_numpy(entry["ids"]).long()}
    out = lora_apply.maybe_lora(torch.from_numpy(y), xt, et, 1, impl=impl)
    assert _err(out, j_out) <= 1e-5
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                [xt, At, Bt])
    for a, b in zip(grads, j_grads):
        assert _err(a, b) <= 1e-5 * max(1.0, float(np.abs(b).max()))


def test_routed_dropout_per_row_and_rate():
    """Routed-site dropout: one mask per row from (site seed, row), the
    same for the same seed, different for another seed or row; the kept
    share is 1 - rate and kept elements are scaled by 1 / (1 - rate);
    every impl sees the same mask and gives the same output."""
    rate = 0.25
    x = torch.ones(6, 64, 128)
    a = row_dropout(x, rate, 77)
    assert torch.equal(a, row_dropout(x, rate, 77))
    assert not torch.equal(a, row_dropout(x, rate, 78))
    assert not torch.equal(a[0], a[1])
    assert torch.equal(row_dropout(x[:3], rate, 77), a[:3])
    kept = float((a != 0).float().mean())
    assert abs(kept - (1 - rate)) < 0.01
    assert torch.allclose(a[a != 0], torch.tensor(1 / (1 - rate)))
    assert row_dropout(x, 0.0, 77) is x and row_dropout(x, rate, None) is x
    entry, xn, y, _ = _routed_inputs(1)
    et = convert.lora_from_numpy(entry, device=CPU)
    outs = [lora_apply.maybe_lora(torch.from_numpy(y), torch.from_numpy(xn),
                                  et, 0, rate, 5, impl=impl)
            for impl in ("naive", "fused", "auto")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    clean = lora_apply.maybe_lora(torch.from_numpy(y), torch.from_numpy(xn),
                                  et, 0, impl="naive")
    assert not torch.allclose(outs[0], clean)


def test_order_rule_and_impl_summary():
    """The order rule: an ids-routed site takes the gather under every
    impl, on the CPU and on the card; a single-adapter site resolves as
    resolve_lora_impl does. impl_summary logs that per target and refuses
    an unknown impl."""
    dims = {"attn_qkv": (768, 2304), "attn_proj": (768, 768)}
    for impl in lora_apply.LORA_IMPLS:
        for device in ("cpu", "cuda"):
            assert lora_apply.impl_summary(dims, impl, device,
                                           routed=True) == \
                "attn_proj=gather,attn_qkv=gather"
    assert lora_apply.impl_summary(dims, "auto", "cpu") == \
        "attn_proj=naive,attn_qkv=naive"
    assert lora_apply.impl_summary(dims, "auto", "cuda") == \
        "attn_proj=fused,attn_qkv=fused"
    assert lora_apply.impl_summary(dims, "naive", "cuda") == \
        "attn_proj=naive,attn_qkv=naive"
    with pytest.raises(ValueError, match="lora_impl"):
        lora_apply.impl_summary(dims, "pallas")


# ------------------------------------------------- (d) k vs solo, port --

def solo_train(family, config, p, job):
    """The port's solo single-adapter run (full-logits CE), same init
    seed, data and hyperparameters: (per-step losses, final adapter)."""
    fwd = gpt2.forward if family == "gpt2" else gemma3.forward
    spec = lora.LoRASpec(rank=job.rank, alpha=job.alpha,
                         init="gpt2" if family == "gpt2" else "peft")
    init = lora.init_lora_gpt2 if family == "gpt2" else lora.init_lora_gemma3
    ad = init(config, spec, job.seed, device=CPU)
    mask = lora.trainable_mask(ad)
    tc = TrainConfig(total_steps=job.steps, lr=job.lr,
                     warmup_ratio=job.warmup_ratio, clip_grad_norm=1.0)

    def loss_fn(lt, pp, mb):
        logits = fwd(config, pp, mb["input_ids"],
                     attention_mask=mb["attention_mask"], lora=lt)
        return lm_cross_entropy_sum(logits, mb["labels"])

    step = make_train_step(loss_fn, tc, mask)
    opt = init_optimizer(ad, tc, mask)
    losses = []
    for s, b in enumerate(stream_batches(job.data_seed, job.steps)):
        mb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in b.items()}
        ad, opt, m = step(ad, p, opt, mb, s)
        losses.append(float(m["loss"]))
    return losses, ad


def _two_jobs(family):
    lr_a, lr_b = (1e-3, 3e-3) if family == "gpt2" else (3e-4, 1e-3)
    return [JobSpec(name="a", lr=lr_a, alpha=16.0, steps=5, seed=1,
                    data_seed=101, warmup_ratio=0.2),
            JobSpec(name="b", lr=lr_b, alpha=32.0, steps=5, seed=2,
                    data_seed=102)]


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_k_adapter_matches_solo_run(family, params, tmp_path):
    """Two tenants with different LR, alpha, warmup and seeds trained in
    one step match the port's solo runs on the same data and init: the
    per-step losses and the saved adapters' weights within 1e-5."""
    jobs = _two_jobs(family)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # one reduction order, however loaded
    try:
        eng = port_engine(family, params[family][0], jobs, tmp_path)
        eng.admit_pending()
        hist = _steps(eng, 5, ["a", "b"])
        eng.close()
        solo = {job.name: solo_train(family, CFG[family][0],
                                     params[family][0], job)
                for job in jobs}
    finally:
        torch.set_num_threads(threads)
    for job in jobs:
        solo_losses, solo_tree = solo[job.name]
        for s, (a, b) in enumerate(zip(solo_losses, hist[job.name])):
            assert abs(a - b) <= 1e-5, (job.name, s, a, b)
        saved, sspec = peft_io.load_adapter(
            str(tmp_path / f"{job.name}.safetensors"), device=CPU)
        assert sspec.rank == job.rank and sspec.alpha == job.alpha
        for tgt, entry in saved["blocks"].items():
            for leaf in ("A", "B"):
                assert _err(entry[leaf],
                            solo_tree["blocks"][tgt][leaf].numpy()) <= 1e-5


# ------------------------------------------------- (e) port vs JAX engine --

def _tenant_events(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return recs, [(r["name"], r["phase"], r["slot"], r["step"])
                  for r in recs if r["event"] == "tenant"]


@pytest.mark.parametrize("family,tol", [("gpt2", 1e-5), ("gemma", 1e-4)])
def test_engine_matches_jax_engine(family, tol, params, tmp_path,
                                   monkeypatch):
    """Three jobs over two slots (one refill, one cancel) through the port
    engine and the JAX engine, same init, data and hyperparameters (the
    JAX engine test's LRs): the per-step tenant losses agree within `tol`;
    each saved adapter's weights agree, by the L2 of the difference over
    the L2 of what training changed, within 10 x `tol`; the `tenant`
    events come in the same sequence, and every port event
    (step_stats.tenants too) is schema-valid. The JAX engine's step is
    synced (_synced: on a loaded host it otherwise reads the next step's
    counters) and the port runs on one thread."""
    jax_init_swap(monkeypatch, family)
    jobs = [JobSpec(name="a", lr=2e-3, alpha=16.0, steps=3, seed=1,
                    data_seed=31, warmup_ratio=0.3),
            JobSpec(name="b", lr=1e-3, alpha=8.0, steps=2, seed=2,
                    data_seed=32, save_every=1),
            JobSpec(name="c", lr=3e-3, steps=6, seed=3, data_seed=33)]
    p_port, p_jax = params[family]
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for side in ("port", "jax"):
            d = tmp_path / side
            stream = str(d / "mt.jsonl")
            if side == "port":
                eng = port_engine(family, p_port, jobs, d,
                                  telemetry=Telemetry(stream))
            else:
                from mobilefinetuner_tpu.core.telemetry import \
                    Telemetry as JaxTelemetry
                eng = jax_engine.MultiTenantEngine(
                    family, CFG[family][1], p_jax,
                    [jax_jobspec.JobSpec(**dataclasses.asdict(j))
                     for j in jobs],
                    make_stream,
                    jax_engine.EngineConfig(slots=2, rows_per_tenant=B,
                                            seq_len=S, flush_every=1,
                                            prefetch=0, out_dir=str(d)),
                    telemetry=JaxTelemetry(stream))
                eng._step_fn = _synced(eng._step_fn)
            eng.admit_pending()
            hist = _steps(eng, 4, ["a", "b", "c"])
            eng.cancel("c")
            eng.close()
            runs[side] = (hist, *_tenant_events(stream))
    finally:
        torch.set_num_threads(threads)
    for name in ("a", "b", "c"):
        for s, (a, b) in enumerate(zip(runs["port"][0][name],
                                       runs["jax"][0][name])):
            assert (a is None) == (b is None), (name, s)
            if a is not None:
                assert abs(a - b) <= tol, (name, s, a, b)
    assert runs["port"][2] == runs["jax"][2]
    jinit = (jax_lora.init_lora_gpt2 if family == "gpt2"
             else jax_lora.init_lora_gemma3)
    for job in jobs[:2]:                # c was cancelled: no file
        spec = jax_lora.LoRASpec(rank=job.rank, alpha=job.alpha,
                                 init="gpt2" if family == "gpt2" else "peft")
        init = jinit(CFG[family][1], spec, jax.random.PRNGKey(job.seed))
        trees = [peft_io.load_adapter(
            str(tmp_path / side / f"{job.name}.safetensors"),
            device=CPU)[0]["blocks"] for side in ("port", "jax")]
        diff_sq = change_sq = 0.0
        for tgt, entry in trees[1].items():
            for leaf in ("A", "B"):
                want = entry[leaf].double().numpy()
                diff_sq += float(np.sum(
                    (trees[0][tgt][leaf].double().numpy() - want) ** 2))
                change_sq += float(np.sum(
                    (want - np.asarray(init["blocks"][tgt][leaf],
                                       np.float64)) ** 2))
        assert change_sq > 0.0
        assert (diff_sq / change_sq) ** 0.5 <= 10 * tol, \
            (job.name, (diff_sq / change_sq) ** 0.5)
    recs = runs["port"][1]
    for rec in recs:
        assert validate_event(rec) is None, (rec, validate_event(rec))
    stats = [r for r in recs if r["event"] == "step_stats"]
    assert stats and all(set(t) >= {"slot", "step", "loss", "tokens",
                                     "wait_ms"}
                         for r in stats for t in r["tenants"].values())


# ------------------------------------------ (f) stable storage, no retrace --

def test_storage_stable_across_join_leave_refill_cancel(params, tmp_path):
    """After warm-up (the first step and the first slot write), job
    completion, refill of the freed slot and an early cancel add no build
    (`total_traces()` flat) and move no bank or optimizer tensor (every
    data_ptr() unchanged); a cancelled job saves no file."""
    jobs = [JobSpec(name="a", lr=1e-3, steps=6, seed=1, data_seed=11),
            JobSpec(name="b", lr=2e-3, steps=2, seed=2, data_seed=12),
            JobSpec(name="c", lr=3e-3, steps=3, seed=3, data_seed=13),
            JobSpec(name="d", lr=1e-3, steps=9, seed=4, data_seed=14)]
    eng = port_engine("gpt2", params["gpt2"][0], jobs, tmp_path,
                      flush_every=4)
    ptrs = eng.storage_ptrs()
    eng.admit_pending()
    eng.step()
    warm = eng.total_traces()
    assert warm == 2, dict(eng.trace_counts)
    eng.step()                       # b finishes -> c refills slot 1
    assert eng.tenants["b"].status == "finished"
    assert eng.tenants["c"].status == "active"
    for _ in range(3):
        eng.step()                   # c finishes -> d refills
    assert eng.tenants["c"].status == "finished"
    eng.cancel("d")
    assert eng.tenants["d"].status == "cancelled"
    assert eng.slot_tenant[1] is None
    assert float(eng.bank["blocks"]["attn_qkv"]["scale"][1]) == 0.0
    assert int(eng.opt["step"][1]) == 0
    while eng._has_work():
        eng.step()
    assert eng.tenants["a"].status == "finished"
    assert eng.total_traces() == warm, dict(eng.trace_counts)
    assert eng.storage_ptrs() == ptrs
    eng.close()
    for name in ("a", "b", "c"):
        assert (tmp_path / f"{name}.safetensors").exists()
    assert not (tmp_path / "d.safetensors").exists()


# --------------------------------------------- (g) bank-sliced file bytes --

def test_unstack_adapter_saves_bytes_identical_to_jax(tmp_path):
    """An adapter sliced out of a stacked bank by the port's
    unstack_adapter and saved by the port's peft_io has the same bytes as
    the JAX package's unstack_adapter + save of the same tree: the native
    file and the PEFT export. An out-of-range slot names the bank size."""
    spec_j = jax_lora.LoRASpec(rank=4, alpha=8.0)
    spec_t = lora.LoRASpec(rank=4, alpha=8.0)
    ads = [jax_lora.init_lora_gpt2(CFG["gpt2"][1], spec_j,
                                   jax.random.PRNGKey(i)) for i in range(3)]
    bank_j = jax.device_get(jax_lora.stack_adapters(ads))
    bank_t = convert.lora_from_numpy(jax.tree.map(np.asarray, bank_j),
                                     device=CPU)
    for i in range(3):
        pj, pt = str(tmp_path / f"j{i}.safetensors"), \
            str(tmp_path / f"t{i}.safetensors")
        jax_peft_io.save_adapter(pj, jax_lora.unstack_adapter(bank_j, i),
                                 spec_j, extra_metadata={"tenant": "x"})
        peft_io.save_adapter(pt, lora.unstack_adapter(bank_t, i), spec_t,
                             extra_metadata={"tenant": "x"})
        assert open(pj, "rb").read() == open(pt, "rb").read()
        dj, dt = str(tmp_path / f"pj{i}"), str(tmp_path / f"pt{i}")
        jax_peft_io.export_peft(dj, jax_lora.unstack_adapter(bank_j, i),
                                spec_j, "gpt2")
        peft_io.export_peft(dt, lora.unstack_adapter(bank_t, i), spec_t,
                            "gpt2")
        for f in ("adapter_model.safetensors", "adapter_config.json"):
            assert open(os.path.join(dj, f), "rb").read() == \
                open(os.path.join(dt, f), "rb").read()
    with pytest.raises(ValueError, match="out of range.*3 adapter"):
        lora.unstack_adapter(bank_t, 3)


# -------------------------------------------------- (h) train -> serve --

def test_train_serve_handoff_token_identical(params, tmp_path):
    """Two adapters trained in the port engine, hot-loaded through
    AdapterBank.load_file (manifest-verified) into a serve engine with
    lora_impl="fused": the greedy tokens equal generate() with the
    solo-trained weights, and run_start records the routed gather per
    target; a corrupted file is refused before any slot changes."""
    p = params["gpt2"][0]
    config = CFG["gpt2"][0]
    jobs = [JobSpec(name="t1", lr=5e-3, steps=4, seed=1, data_seed=21),
            JobSpec(name="t2", lr=8e-3, steps=4, seed=2, data_seed=22)]
    eng = port_engine("gpt2", p, jobs, tmp_path)
    eng.run()
    eng.close()
    template = lora.init_lora_gpt2(config, lora.LoRASpec(rank=8, alpha=16.0),
                                   0, device=CPU)
    bank = AdapterBank(template, capacity=2)
    serve = ServeEngine("gpt2", config, p, ServeConfig(
        num_slots=2, block_T=8, num_blocks=32, max_prompt=16,
        max_new_tokens=8, lora_impl="fused"), bank=bank, device=CPU,
        telemetry=Telemetry(str(tmp_path / "serve.jsonl")))
    bank.load_file("t1", str(tmp_path / "t1.safetensors"))
    bank.load_file("t2", str(tmp_path / "t2.safetensors"))
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 200, n)] for n in (5, 9)]
    reqs = [serve.submit(pr, max_new_tokens=6, adapter=a)
            for pr, a in zip(prompts, ("t1", "t2"))]
    done = {r.id: r for r in serve.drain()}
    serve.close()
    recs, _ = _tenant_events(str(tmp_path / "serve.jsonl"))
    start = [r for r in recs if r["event"] == "run_start"]
    assert start[0]["config"]["lora_impl_resolved"] == \
        "attn_proj=gather,attn_qkv=gather"
    for req, job in zip(reqs, jobs):
        _, solo_tree = solo_train("gpt2", config, p, job)
        ids = torch.tensor([req.prompt])
        want = gpt2_generate(config, p, ids, torch.ones_like(ids),
                             SampleConfig(max_new_tokens=6, greedy=True),
                             lora=solo_tree)[0].tolist()
        assert done[req.id].tokens == want, job.name
    victim = str(tmp_path / "t1.safetensors")
    blob = bytearray(open(victim, "rb").read())
    blob[-1] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    bank2 = AdapterBank(template, capacity=1)
    before = {k: v.clone() for k, v in lora.tree_leaves(bank2.tree)}
    with pytest.raises(CheckpointIntegrityError):
        bank2.load_file("t1", victim)
    assert bank2.resident == {}
    assert all(torch.equal(before[k], v)
               for k, v in lora.tree_leaves(bank2.tree))


# ------------------------------------------------------------ (i) the mux --

def test_mux_slow_tenant_does_not_starve_others():
    """A stalled tenant stream does not starve the others (their bounded
    queues fill), and the wait is charged to the slow tenant."""
    stall = threading.Event()

    def slow_gen():
        n = 0
        while True:
            if n > 0:
                stall.wait(10.0)
            n += 1
            yield {"x": n}

    def fast_gen():
        n = 0
        while True:
            n += 1
            yield {"x": n}

    mux = TenantMux(depth=2)
    mux.add("slow", slow_gen())
    mux.add("f1", fast_gen())
    mux.add("f2", fast_gen())
    try:
        for n in ("slow", "f1", "f2"):
            mux.pull(n)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and (
                mux.queue_depth("f1") < 2 or mux.queue_depth("f2") < 2):
            time.sleep(0.01)
        assert mux.queue_depth("f1") == 2 and mux.queue_depth("f2") == 2
        t0 = time.perf_counter()
        threading.Timer(0.25, stall.set).start()
        mux.pull("slow")
        blocked_ms = (time.perf_counter() - t0) * 1000
        mux.pull("f1")
        mux.pull("f2")
        waits = mux.take_waits()
        assert waits["slow"] >= 0.8 * blocked_ms > 50
        assert waits["f1"] < waits["slow"] / 10
        assert waits["f2"] < waits["slow"] / 10
        assert mux.take_waits() == {"slow": 0.0, "f1": 0.0, "f2": 0.0}
        with pytest.raises(ValueError, match="already"):
            mux.add("f1", fast_gen())
    finally:
        stall.set()
        mux.close()


def test_mux_exhausted_stream_names_the_tenant():
    mux = TenantMux(depth=0)
    mux.add("tiny", iter([{"x": 1}]))
    mux.pull("tiny")
    with pytest.raises(RuntimeError, match="tiny"):
        mux.pull("tiny")
    mux.close()


# -------------------------------------------------------------- (j) CLI --

def _parser_surface(p):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
            for a in p._actions if a.dest != "help"}


def test_cli_parser_matches_jax():
    """The port's parser has the JAX CLI's flags, option strings, types,
    choices and defaults, plus --device (default: the card)."""
    from mobilefinetuner_tpu.cli import train_multi_lora as jax_cli
    from mobilefinetuner_tpu_torch.cli import train_multi_lora as cli
    port = _parser_surface(cli.build_parser())
    want = _parser_surface(jax_cli.build_parser())
    assert port.pop("device") == (("--device",), None, None, None)
    assert port == want


def test_cli_end_to_end_on_fixture_dirs(tmp_path):
    """The CLI trains three jobs over two slots on the tiny fixture dirs
    with --device cpu: every adapter lands with manifest and lineage and
    loads in the JAX package's peft_io, the PEFT export too; the stream
    validates; with no --device and no card it raises."""
    from fixtures import write_tiny_gpt2_dir, write_wikitext_dir
    from mobilefinetuner_tpu_torch.cli import train_multi_lora as cli
    model_dir = str(tmp_path / "model")
    data_dir = write_wikitext_dir(str(tmp_path / "wt2"))
    write_tiny_gpt2_dir(model_dir)
    jobs_file = str(tmp_path / "jobs.json")
    with open(jobs_file, "w") as f:
        json.dump({"family": "gpt2",
                   "defaults": {"rank": 4, "steps": 3, "alpha": 8.0},
                   "jobs": [{"name": "alice", "lr": 1e-3, "seed": 1},
                            {"name": "bob", "lr": 3e-3, "seed": 2,
                             "data_seed": 9, "peft_export_dir":
                             str(tmp_path / "peft_bob")},
                            {"name": "carol", "steps": 2, "seed": 3}]}, f)
    out_dir = str(tmp_path / "out")
    stream = str(tmp_path / "mt.jsonl")
    argv = ["--jobs", jobs_file, "--pretrained_dir", model_dir,
            "--data_dir", data_dir, "--out_dir", out_dir, "--slots", "2",
            "--batch_size", "2", "--seq_len", "32", "--log_interval", "2",
            "--telemetry_out", stream]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    for name in ("alice", "bob", "carol"):
        path = os.path.join(out_dir, f"{name}.safetensors")
        assert os.path.exists(path + ".manifest.json")
        assert os.path.exists(path + ".lineage.json")
        tree, spec = jax_peft_io.load_adapter(path)
        assert spec.rank == 4 and float(np.abs(
            np.asarray(tree["blocks"]["attn_qkv"]["B"])).max()) > 0
    tree, _ = jax_peft_io.import_peft(str(tmp_path / "peft_bob"), "gpt2")
    assert set(tree["blocks"]) == {"attn_qkv", "attn_proj"}
    with open(stream) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for rec in recs:
        assert validate_event(rec) is None, (rec, validate_event(rec))
    assert {r["name"] for r in recs if r["event"] == "tenant"
            and r["phase"] == "finish"} == {"alice", "bob", "carol"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            cli.main(argv)
