"""The f32 flash kernels' 3xTF32 arithmetic on the CPU
(csrc/flash_attention_fwd_tf32.cu, csrc/flash_attention_bwd_merged_tf32.cu,
split and product helpers in csrc/tensor_core_tf32.cuh), against the JAX
package's flash attention with its Pallas kernels in interpret mode.

The card's TF32 rounding (cvt.rna.tf32.f32: to nearest, ties away from
zero, at bit 13 of the f32 pattern) is emulated by integer arithmetic on
the f32 bits; every product of the kernels' blocked forward and merged
backward (S = Q K^T, P V; S^T, dP^T, dV, dK, dQ), at the kernels' own
tiles (`fwd_plan`, `bwd_plan`), splits both operands into hi + lo TF32
halves and sums hi.hi + hi.lo + lo.hi in f32, dropping lo.lo, as the
kernels' mma_3xtf32 does. At the f32 shapes chip_smoke.py checks (GQA, a
window, ragged S, dropout 0.1, D 64 and 256) the emulated forward's out
and lse stay within 1e-4 and its backward within 1e-5 of max(1, |ref|)
of the JAX kernels, the f32 tolerances the kernels are held to on the
card; one TF32 product (each operand rounded once) misses the backward's
1e-5, which is why the kernels split. The CUDA kernels themselves are
held against the port's plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import flash_attention as jax_fa
from mobilefinetuner_tpu_torch.ops import flash_attention as port_fa


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 rounds it, on its
    bits: + 0x1000 carries a half ulp of the 10-bit mantissa into the
    magnitude, then the low 13 bits are cleared."""
    b = x.detach().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(
        ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: the two small products first, then hi . hi."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def emul_fwd(q, k, v, pad, mm, *, scale, causal, window, p_drop, seed):
    """The forward kernel's blocked online softmax at its f32 tiles, every
    product through `mm`: (out, lse [B, Hq, S, 1])."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    plan = port_fa.fwd_plan(B, Hq, S, D, torch.float32)
    bq, bk = plan["block_q"], plan["block_k"]
    qf = q.reshape(B, Hkv, G, S, D)
    kf, vf = k[:, :, None], v[:, :, None]
    bi, hi_ = port_fa._head_index(B, Hkv, G, "cpu")
    out = torch.zeros(B, Hkv, G, S, D)
    lse = torch.zeros(B, Hkv, G, S)
    for row0 in range(0, S, bq):
        row1 = min(S, row0 + bq)
        rows = torch.arange(row0, row1)[:, None]
        m = torch.full((B, Hkv, G, row1 - row0, 1), port_fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, G, row1 - row0, D)
        lo, hi = port_fa._kv_block_bounds(row0, -(-S // bk), causal, window,
                                          bq, bk)
        for kb in range(lo, hi):
            col0, col1 = kb * bk, min(S, (kb + 1) * bk)
            cols = torch.arange(col0, col1)[None, :]
            s = mm(qf[..., row0:row1, :],
                   kf[..., col0:col1, :].transpose(-1, -2)) * scale
            mask = port_fa._tile_mask(pad, rows, cols, causal, window)
            s = torch.where(mask, s, port_fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if p_drop:
                keep = port_fa.keep_mask(seed, bi, hi_, rows, cols, p_drop)
                p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - p_drop))
            acc = acc * alpha + mm(p, vf[..., col0:col1, :])
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[..., row0:row1, :] = acc / l_safe
        lse[..., row0:row1] = (m + torch.log(l_safe))[..., 0]
    return out.reshape(B, Hq, S, D), lse.reshape(B, Hq, S, 1)


def emul_bwd(q, k, v, pad, lse, delta, do, mm, *, scale, causal, window,
             p_drop, seed):
    """The merged backward kernel's loop at its f32 tiles (per key block,
    the q-blocks that see it), every product through `mm`: (dq, dk, dv)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    plan = port_fa.bwd_plan(B, Hq, Hkv, S, D, torch.float32)
    bq, bk = plan["block_q"], plan["block_k"]
    f = lambda t: t.reshape(B, Hkv, G, S, -1)  # noqa: E731
    qf, dof, lsef, dlf = f(q), f(do), f(lse), f(delta)
    kf, vf = k[:, :, None], v[:, :, None]
    bi, hi_ = port_fa._head_index(B, Hkv, G, "cpu")
    dq = torch.zeros(B, Hkv, G, S, D)
    dk = torch.zeros(B, Hkv, G, S, D)
    dv = torch.zeros(B, Hkv, G, S, D)
    T = lambda t: t.transpose(-1, -2)  # noqa: E731
    for col0 in range(0, S, bk):
        col1 = min(S, col0 + bk)
        cols = torch.arange(col0, col1)[None, :]
        kb, vb = kf[..., col0:col1, :], vf[..., col0:col1, :]
        qlo, qhi = port_fa._q_block_bounds(col0, -(-S // bq), causal, window,
                                           bq, bk)
        for qi in range(qlo, qhi):
            r = slice(qi * bq, min(S, (qi + 1) * bq))
            rows = torch.arange(r.start, r.stop)[:, None]
            s = mm(qf[..., r, :], T(kb)) * scale
            mask = port_fa._tile_mask(pad, rows, cols, causal, window)
            p = torch.where(mask, torch.exp(s - lsef[..., r, :]), 0.0)
            dp = mm(dof[..., r, :], T(vb))
            pv = p
            if p_drop:
                keep = port_fa.keep_mask(seed, bi, hi_, rows, cols, p_drop)
                inv = 1.0 / (1.0 - p_drop)
                pv = torch.where(keep, p, 0.0) * inv
                dp = torch.where(keep, dp, 0.0) * inv
            ds = p * (dp - dlf[..., r, :]) * scale
            dv[..., col0:col1, :] += mm(T(pv), dof[..., r, :])
            dk[..., col0:col1, :] += mm(T(ds), qf[..., r, :])
            dq[..., r, :] += mm(ds, kb)
    return dq.reshape(B, Hq, S, D), dk.sum(2), dv.sum(2)


# chip_smoke.py's f32 check_flash / check_flash_bwd shapes and the card
# test's D 256 case: (B, Hq, Hkv, S, D, n_real, window, p_drop); causal
CASES = [
    (2, 4, 2, 200, 64, (200, 150), 24, 0.0),      # GQA, window, ragged
    (2, 4, 4, 128, 64, (128, 100), None, 0.1),    # dropout 0.1
    (2, 8, 2, 200, 256, (200, 150), 40, 0.1),     # D 256, GQA 4:1, all
]


def _inputs(B, Hq, Hkv, S, D, n_real):
    rng = np.random.default_rng(S + D + Hkv)
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D)))
    pad = np.zeros((B, S), np.float32)
    for b, n in enumerate(n_real):
        pad[b, :n] = 1.0
    return q, k, v, do, pad


def _jax_ref(q, k, v, do, pad, window, p_drop):
    """JAX's (out, lse, dq, dk, dv) through its Pallas kernels in interpret
    mode, and the int seed its dropout used."""
    rng = jax.random.PRNGKey(3) if p_drop else None
    seed = (int(np.asarray(jax.lax.bitcast_convert_type(
        jax.random.bits(rng, (1,), jnp.uint32), jnp.int32))[0])
        if p_drop else None)

    def f(q_, k_, v_):
        return jax_fa.flash_attention(
            q_, k_, v_, padding_mask=jnp.asarray(pad), is_causal=True,
            sliding_window=window, attn_dropout=p_drop,
            attn_dropout_rng=rng, block_q=64, block_k=64, bwd_impl="merged")
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    # lse does not depend on dropout (l sums the undropped probabilities)
    _, lse = jax_fa.flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        is_causal=True, sliding_window=window, block_q=64, block_k=64)
    return ([np.asarray(t, np.float64) for t in (out, lse, *grads)], seed)


def _emulated(q, k, v, do, pad, window, p_drop, seed, mm):
    t = [torch.from_numpy(a) for a in (q, k, v, do, pad)]
    kw = dict(scale=q.shape[-1] ** -0.5, causal=True, window=window,
              p_drop=p_drop, seed=seed)
    out, lse = emul_fwd(t[0], t[1], t[2], t[4], mm, **kw)
    delta = (t[3] * out).sum(-1, keepdim=True)   # as the autograd backward
    grads = emul_bwd(t[0], t[1], t[2], t[4], lse, delta, t[3], mm, **kw)
    return [x.numpy().astype(np.float64) for x in (out, lse, *grads)]


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def test_tf32_rounding_and_split():
    """Ties round away from zero, as cvt.rna does; hi carries 11
    significant bits and hi + lo restores x to within 2^-22 |x|."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      3 * 2 ** -11, 0.0], dtype=torch.float32)
    want = [1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3 * 2 ** -11, 0.0]
    assert tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(y)
    for h in (hi, lo):
        assert not (h.numpy().view(np.uint32) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2 ** -22
    assert float(((hi - y).abs() / y.abs()).max()) > 2 ** -13


@pytest.mark.parametrize("B,Hq,Hkv,S,D,n_real,window,p_drop", CASES)
def test_3xtf32_flash_matches_jax_kernels(B, Hq, Hkv, S, D, n_real, window,
                                          p_drop):
    """Forward out and lse within 1e-4, backward within 1e-5 of max(1,
    |ref|) of the JAX Pallas kernels; with dropout the keep bits are the
    JAX kernels' (the same seed) and dropout acts."""
    q, k, v, do, pad = _inputs(B, Hq, Hkv, S, D, n_real)
    want, seed = _jax_ref(q, k, v, do, pad, window, p_drop)
    got = _emulated(q, k, v, do, pad, window, p_drop, seed, mm3)
    assert np.max(np.abs(got[0] - want[0])) <= 1e-4
    assert np.max(np.abs(got[1].reshape(want[1].shape) - want[1])) <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-5, name
    if p_drop:
        undropped = _emulated(q, k, v, do, pad, window, 0.0, None, mm3)
        assert np.max(np.abs(got[0] - undropped[0])) > 1e-2


@pytest.mark.parametrize("B,Hq,Hkv,S,D,n_real,window,p_drop", CASES[:2])
def test_one_tf32_product_misses_the_backward_tolerance(
        B, Hq, Hkv, S, D, n_real, window, p_drop):
    """Each operand rounded to TF32 once (2^-11): the backward lands
    beyond 1e-5 of max(1, |ref|), where 3xTF32 stays within it."""
    q, k, v, do, pad = _inputs(B, Hq, Hkv, S, D, n_real)
    want, seed = _jax_ref(q, k, v, do, pad, window, p_drop)
    got = _emulated(q, k, v, do, pad, window, p_drop, seed, mm1)
    assert max(_rel(a, b) for a, b in zip(got[2:], want[2:])) > 1e-5
