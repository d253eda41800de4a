"""Port flash-attention backward and train-mode dropout
(mobilefinetuner_tpu_torch/ops/flash_attention.py) against the JAX
package's Pallas kernels run in interpret mode on the CPU: the same numpy
inputs through jax.vjp of `flash_attention` and through the port's
autograd function, with the backward implementation forced to merged and
to split on both sides. f32, max abs error <= 1e-5.

On the CPU the port's wrappers run their plain versions (the kernels'
blocked algorithms in torch); the CUDA kernels are held against those on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import flash_attention as jax_fa
from mobilefinetuner_tpu_torch.ops import flash_attention as port_fa

TOL = 1e-5


def _inputs(seed, B, Hq, Hkv, S, D, n_real):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    pad = np.zeros((B, S), np.float32)
    for b, n in enumerate(n_real):
        pad[b, :n] = 1.0
    return q, k, v, do, pad


def _jax_grads(q, k, v, do, pad, bwd_impl, **kw):
    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, padding_mask=jnp.asarray(pad),
                                      block_q=64, block_k=64,
                                      bwd_impl=bwd_impl, **kw)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (out, *vjp(jnp.asarray(do)))]


def _port_grads(q, k, v, do, pad, bwd_impl, **kw):
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = port_fa.flash_attention(*leaves, padding_mask=torch.from_numpy(pad),
                                  bwd_impl=bwd_impl, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return [t.detach().numpy() for t in (out, *grads)]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


# (S, Hkv, n_pad, window): causal always; GQA where Hkv < Hq = 4; right
# padding of the last batch row; a 24-key window (which, past the padding,
# leaves fully masked rows: out 0 and no gradient, in both packages)
CASES = [(64, 4, 0, None), (128, 2, 40, None), (128, 2, 30, 24),
         (64, 1, 10, 24)]


@pytest.mark.parametrize("bwd_impl", ["merged", "split"])
@pytest.mark.parametrize("S,Hkv,n_pad,window", CASES)
def test_flash_backward_matches_jax(bwd_impl, S, Hkv, n_pad, window):
    q, k, v, do, pad = _inputs(S + Hkv + n_pad, 2, 4, Hkv, S, 64,
                               n_real=(S, S - n_pad))
    kw = dict(is_causal=True, sliding_window=window)
    want = _jax_grads(q, k, v, do, pad, bwd_impl, **kw)
    got = _port_grads(q, k, v, do, pad, bwd_impl, **kw)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        assert _max_err(a, b) <= TOL, name


def test_keep_mask_bit_equal_to_jax():
    """The port's keep bits are `_keep_mask`'s on the same (seed, b, h,
    rows, cols), negative int32 seeds included."""
    for seed, b, h, row0, col0 in ((0, 0, 0, 0, 0), (-1234567, 3, 5, 64, 0),
                                   (2 ** 31 - 1, 7, 11, 128, 192)):
        want = np.asarray(jax_fa._keep_mask(jnp.int32(seed), b, h, row0,
                                            col0, 64, 64, 0.1))
        rows = torch.arange(row0, row0 + 64)[:, None]
        cols = torch.arange(col0, col0 + 64)[None, :]
        got = port_fa.keep_mask(seed, b, h, rows, cols, 0.1).numpy()
        assert np.array_equal(got, want)
        assert 0.85 < got.mean() < 0.95


@pytest.mark.parametrize("bwd_impl", ["merged", "split"])
def test_flash_dropout_matches_jax_under_the_same_seed(bwd_impl):
    """Forward and grads with p_drop = 0.2: the JAX wrapper derives an
    int32 seed from its key; the port, given that seed, drops exactly the
    same probabilities (GQA, padding, two key blocks)."""
    q, k, v, do, pad = _inputs(11, 2, 4, 2, 128, 64, n_real=(128, 100))
    rng = jax.random.PRNGKey(7)
    seed = int(np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(rng, (1,), jnp.uint32), jnp.int32))[0])
    want = _jax_grads(q, k, v, do, pad, bwd_impl, attn_dropout=0.2,
                      attn_dropout_rng=rng)
    got = _port_grads(q, k, v, do, pad, bwd_impl, attn_dropout=0.2,
                      dropout_seed=seed)
    no_drop = _port_grads(q, k, v, do, pad, bwd_impl)
    assert _max_err(got[0], no_drop[0]) > 1e-2      # dropout did act
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _max_err(a, b) <= TOL, name


def test_merged_and_split_plain_versions_agree_and_check_inputs():
    """The two plain backward versions compute one function; the
    wrappers refuse mismatched shapes; bwd_impl is checked."""
    q, k, v, do, pad = (torch.from_numpy(t) for t in _inputs(
        5, 1, 4, 2, 96, 64, n_real=(80,)))
    out, lse = port_fa.flash_attention_fwd(q, k, v, pad)
    delta = (do * out).sum(-1, keepdim=True)
    kw = dict(scale=0.125, sliding_window=16, p_drop=0.3, seed=99)
    m = port_fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, do,
                                           **kw)
    s = port_fa.flash_attention_bwd_split(q, k, v, pad, lse, delta, do,
                                          **kw)
    for a, b in zip(m, s):
        assert float((a - b).abs().max()) <= TOL
    with pytest.raises(ValueError, match="flash_attention"):
        port_fa.flash_attention_bwd_merged(q, k[:, :, :50], v, pad, lse,
                                           delta, do, scale=0.125)
    with pytest.raises(ValueError, match="bwd_impl"):
        port_fa.flash_attention(q, k, v, bwd_impl="fast")
    assert port_fa.resolve_bwd_impl(128, 64, torch.bfloat16) in ("merged",
                                                                  "split")
