"""Port GPT-2 (mobilefinetuner_tpu_torch/models/) against the JAX package
on the tiny serving config of tests/test_serve.py, with the JAX weights
carried over by `convert.py`: prefill logits and K/V, one paged decode
step (logits and the scattered pools) and the full forward, each within
1e-4 in f32, with and without a 2-tenant adapter bank that carries fused
and split-QKV, MLP and lm_head entries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.lora import lora as jax_lora
from mobilefinetuner_tpu.models import generate as jax_generate
from mobilefinetuner_tpu.models import gpt2 as jax_gpt2
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.lora import lora as port_lora
from mobilefinetuner_tpu_torch.models import generate, gpt2

TOL = 1e-4
JAX_CFG = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=64,
    n_layer=3)
CFG = GPT2Config(**{f.name: getattr(JAX_CFG, f.name)
                     for f in dataclasses.fields(GPT2Config)})
TARGETS = ["attn_qkv", "attn_q", "attn_v", "attn_proj", "mlp_fc_in",
           "mlp_fc_out", "lm_head"]


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray,
                          jax_gpt2.init_params(JAX_CFG, jax.random.PRNGKey(0)))
    return params, convert.gpt2_params_from_numpy(params, device="cpu")


def rand_adapter(seed, rank=3):
    """A numpy adapter tree on every GPT-2 target, B off zero."""
    rng = np.random.default_rng(seed)
    blocks = {}
    for name in TARGETS:
        d_in, d_out = port_lora.GPT2_TARGETS[name](CFG)
        lead = () if name in port_lora.UNSTACKED_TARGETS else (CFG.n_layer,)
        blocks[name] = {
            "A": (0.1 * rng.standard_normal(lead + (d_in, rank))
                  ).astype(np.float32),
            "B": (0.1 * rng.standard_normal(lead + (rank, d_out))
                  ).astype(np.float32),
            "scale": np.float32(2.0 + seed % 3)}
    return {"blocks": blocks}


def banks(ids):
    """(jax routed tree, port routed tree) over two tenants + a zero base
    slot, rows routed by `ids`."""
    trees = [rand_adapter(1), rand_adapter(2)]
    zero = jax.tree.map(np.zeros_like, trees[0])
    jstack = jax_lora.stack_adapters([jax.tree.map(jnp.asarray, t)
                                      for t in trees + [zero]])
    pstack = port_lora.stack_adapters(
        [convert.lora_from_numpy(t, device="cpu") for t in trees + [zero]])
    return (jax_lora.assign_adapters(jstack, np.asarray(ids, np.int32)),
            port_lora.assign_adapters(pstack, ids))


def err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("with_bank", [False, True])
def test_prefill_logits_and_kv_match_jax(weights, with_bank):
    jparams, pparams = weights
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 200, (2, 16))
    mask = np.zeros((2, 16), np.int32)
    mask[0, :16], mask[1, :9] = 1, 1                  # right padding
    ids[1, 9:] = 0
    jl, pl = banks([1, 2]) if with_bank else (None, None)
    j_logits, (jk, jv) = jax_generate.gpt2_prefill(
        JAX_CFG, jparams, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        lora=jl)
    p_logits, (pk, pv) = generate.gpt2_prefill(
        CFG, pparams, torch.from_numpy(ids), torch.from_numpy(mask),
        lora=pl)
    assert p_logits.shape == (2, CFG.vocab_size)
    assert pk.shape == (CFG.n_layer, 2, CFG.n_head, 16, CFG.head_dim)
    assert err(p_logits, j_logits) <= TOL
    assert err(pk, jk) <= TOL and err(pv, jv) <= TOL


@pytest.mark.parametrize("with_bank", [False, True])
def test_paged_decode_step_matches_jax(weights, with_bank):
    jparams, pparams = weights
    rng = np.random.default_rng(5)
    NB, bT, M, S = 12, 8, 4, 3
    shape = (NB, CFG.n_layer, CFG.n_head, bT, CFG.head_dim)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    pool_k[0] = pool_v[0] = 0.0
    tbl = np.zeros((S, M), np.int32)
    tbl[0, :3], tbl[1, :1] = [3, 7, 5], [9]   # slot 2 idle (all trash)
    pos = np.asarray([19, 4, 0], np.int32)
    tok = np.asarray([17, 101, 0], np.int32)
    jl, pl = banks([0, 2, 1]) if with_bank else (None, None)
    j_logits, jpk, jpv = jax_generate.gpt2_decode_step_paged(
        JAX_CFG, jparams, jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(tbl), lora=jl,
        attn_impl="xla")
    tpk, tpv = torch.from_numpy(pool_k.copy()), torch.from_numpy(
        pool_v.copy())
    p_logits, ppk, ppv = generate.gpt2_decode_step_paged(
        CFG, pparams, tpk, tpv, torch.from_numpy(tok).long(),
        torch.from_numpy(pos).long(), torch.from_numpy(tbl), lora=pl)
    assert ppk is tpk                                   # updated in place
    assert err(p_logits, j_logits) <= TOL
    live = [3, 7, 5, 9]                       # the trash page's winner
    assert err(ppk[live], np.asarray(jpk)[live]) <= TOL  # is unspecified
    assert err(ppv[live], np.asarray(jpv)[live]) <= TOL


def test_forward_with_single_adapter_matches_jax(weights):
    jparams, pparams = weights
    tree = rand_adapter(3)
    rng = np.random.default_rng(6)
    ids = rng.integers(1, 200, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[0, 8:] = 0
    want = jax_gpt2.forward(JAX_CFG, jparams, jnp.asarray(ids, jnp.int32),
                            jnp.asarray(mask),
                            lora=jax.tree.map(jnp.asarray, tree),
                            lora_impl="naive")
    got = gpt2.forward(CFG, pparams, torch.from_numpy(ids),
                       torch.from_numpy(mask),
                       lora=convert.lora_from_numpy(tree, device="cpu"))
    assert got.shape == (2, 12, CFG.vocab_size)
    assert err(got, want) <= TOL


def test_init_and_lora_helpers():
    p = gpt2.init_params(CFG, seed=3, device="cpu")
    q = gpt2.init_params(CFG, seed=3, device="cpu")
    assert torch.equal(p["wte"], q["wte"])             # seeded
    assert p["blocks"]["attn"]["qkv_w"].shape == (3, 64, 192)
    lo = port_lora.init_lora_gpt2(CFG, port_lora.LoRASpec(rank=4), seed=1,
                                  device="cpu")
    assert sorted(lo["blocks"]) == sorted(port_lora.GPT2_DEFAULT_TARGETS)
    assert float(lo["blocks"]["attn_qkv"]["B"].abs().sum()) == 0.0
    stacked = port_lora.stack_adapters([lo, lo])
    with pytest.raises(ValueError, match="out of range"):
        port_lora.assign_adapters(stacked, [0, 2])
    with pytest.raises(ValueError, match="out of range"):
        port_lora.assign_adapters(stacked, torch.tensor([-1]))
    other = port_lora.init_lora_gpt2(CFG, port_lora.LoRASpec(rank=2),
                                     device="cpu")
    with pytest.raises(ValueError, match="shape"):
        port_lora.stack_adapters([lo, other])
