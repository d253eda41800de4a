"""The f32 fused CE dW kernel's 3xTF32 arithmetic on the CPU
(csrc/fused_ce_dw_tf32.cu, row 8; split and product helpers in
csrc/tensor_core_tf32.cuh), against the JAX package's `_bwd_dw` with its
Pallas kernel in interpret mode.

The kernel splits each operand as `split_tf32_raw_lo` does: hi rounded to
TF32 (round to nearest, ties away from zero, at bit 13 of the f32
pattern), lo = x - hi left raw, of which the tensor cores read the top 19
bits (emulated here by clearing the low 13). Its loop, at its own plan
(`dw_tf32_plan`: H cut into the parts of a thread-block cluster, h's rows
held whole or in 64-row chunks, 64-row vocab tiles), is emulated product
by product: each part's partial logits of a vocab tile over its own
columns (lo.hi + hi.lo, then hi.hi), the parts' partials added in part
order (the exchange through distributed shared memory), coef from them,
then each part's dW columns += coef^T h over the chunk's rows, the row
chunks in order. At small shapes with a ragged R, H 64 and 128, a cluster
of two and of four parts and three row chunks, dW stays within 1e-4 of
max(1, |ref|) of the JAX kernel and its softmax part (dgold = 0) within
1e-4 of max |ref|: the f32 tolerances the CUDA kernel is held to on the
card. One TF32 product (each operand rounded once) misses both, which is
why the kernel splits. A V that is not a multiple of a tile, which the
JAX kernel does not take, is held against the port's plain version. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import fused_ce as jfc
from mobilefinetuner_tpu_torch.ops import fused_ce as fc

N_SM = 132                              # an H100 SXM's multiprocessors

MASK = np.uint32(0xFFFFE000)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().contiguous().numpy().view(np.uint32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 on its bits: + 0x1000 carries a half ulp
    of the 10-bit mantissa, then the low 13 bits are cleared."""
    return torch.from_numpy(((_bits(x) + np.uint32(0x1000)) & MASK)
                            .view(np.float32))


def top19(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of x: what a TF32 mma.sync reads of a raw f32."""
    return torch.from_numpy((_bits(x) & MASK).view(np.float32))


def split(x):
    """split_tf32_raw_lo as the tensor cores see it: (hi, lo's top 19
    bits)."""
    hi = tf32(x)
    return hi, top19(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: lo.hi + hi.lo into one sum, hi.hi into another,
    added last."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def emul_dw(h, w, labels, lse, dlse, dgold, mm=mm3):
    """dW: the kernel's loop at its own plan, every product through `mm`.
    Vocab tiles are independent (a cluster owns whole dW rows), so the
    order the clusters walk them in changes no bit and is not emulated."""
    R, H = h.shape
    V = w.shape[0]
    plan = fc.dw_tf32_plan(R, V, H, N_SM)
    hp, rc = plan["hp"], plan["row_chunk"]
    vt = 16 * plan["vocab_groups"]
    parts = [(c0, min(H, c0 + hp)) for c0 in range(0, H, hp)]
    assert len(parts) == plan["n_parts"]
    lab = labels.long()
    dw = torch.full((V, H), float("nan"))
    for v0 in range(0, V, vt):
        v1 = min(V, v0 + vt)
        cols = torch.arange(v0, v1)
        acc = torch.zeros(v1 - v0, H)
        for r0 in range(0, R, rc):
            rows = slice(r0, min(R, r0 + rc))
            logits = torch.zeros(rows.stop - r0, v1 - v0)
            for c0, c1 in parts:            # the exchange, in part order
                logits = logits + mm(h[rows, c0:c1], w[v0:v1, c0:c1].T)
            coef = dlse[rows, None] * torch.exp(logits - lse[rows, None]) \
                + torch.where(cols[None, :] == lab[rows, None],
                              dgold[rows, None], 0.0)
            for c0, c1 in parts:
                acc[:, c0:c1] += mm(coef.T, h[rows, c0:c1])
        dw[v0:v1] = acc
    return dw


def _inputs(R, V, H, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, R).astype(np.int32)
    dlse = rng.normal(size=R).astype(np.float32)
    dgold = rng.normal(size=R).astype(np.float32)
    return h, w, lab, dlse, dgold


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _scaled(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _t(x):
    return torch.from_numpy(x)


# (R, V, H): V a multiple of 128 (the JAX kernel's tile); 2,176 is 34
# 64-row vocab tiles; H 384 a cluster of two 192-column parts, H 648 of
# four (the last 120 columns), R 150 three 64-row chunks
CASES = [(37, 2176, 64), (19, 1280, 128), (37, 1280, 384), (21, 1280, 648),
         (150, 1280, 128)]


def _errors(R, V, H, mm):
    h, w, lab, dlse, dgold = _inputs(R, V, H, R + V + H)
    j = [jnp.asarray(x) for x in (h, w)]
    lab2 = jnp.asarray(lab).reshape(-1, 1)
    lse = jfc._fwd(*j, lab2)[0]
    out = []
    for dg in (dgold, np.zeros_like(dgold)):
        rows = [jnp.asarray(x).reshape(-1, 1) for x in (dlse, dg)]
        want = np.asarray(jfc._bwd_dw(*j, lab2, lse.reshape(-1, 1), *rows),
                          np.float64)
        got = emul_dw(_t(h), _t(w), _t(lab),
                      torch.from_numpy(np.array(lse, np.float32)),
                      _t(dlse), _t(dg), mm).numpy()
        assert got.shape == want.shape == (V, H)
        out.append((got, want))
    return _rel(*out[0]), _scaled(*out[1])


def test_emulation_takes_the_kernels_layouts():
    """The CASES hit one part and a cluster of two and four, a last part
    narrower than the rest, h held whole (a ragged 64-row chunk) and in
    three chunks, and a V that is no multiple of the 64-row vocab tile's
    128-row JAX block; the Gemma chunk is a cluster of two halves."""
    plans = {c: fc.dw_tf32_plan(*c, N_SM) for c in CASES}
    assert [p["n_parts"] for p in plans.values()] == [1, 1, 2, 4, 1]
    assert [p["n_chunks"] for p in plans.values()] == [1, 1, 1, 1, 3]
    assert plans[(21, 1280, 648)]["hp"] * 3 < 648
    gemma = fc.dw_tf32_plan(128, 262144, 640, N_SM)
    assert (gemma["n_parts"], gemma["hp"], gemma["row_chunk"],
            gemma["n_chunks"]) == (2, 320, 128, 1)


@pytest.mark.parametrize("R,V,H", CASES)
def test_3xtf32_dw_matches_jax_kernel(R, V, H):
    """dW within 1e-4 of max(1, |ref|) of the JAX Pallas kernel; the
    softmax part (dgold = 0) within 1e-4 of max |ref|."""
    rel, sm = _errors(R, V, H, mm3)
    assert rel <= 1e-4
    assert sm <= 1e-4


@pytest.mark.parametrize("R,V,H", CASES[:3])
def test_one_tf32_product_misses_the_f32_tolerances(R, V, H):
    """Each operand rounded to TF32 once (2^-11): dW over max(1, |ref|)
    and its softmax part over max |ref| land beyond 1e-4, where 3xTF32
    stays near 1e-6."""
    rel, sm = _errors(R, V, H, mm1)
    assert rel > 1e-4
    assert sm > 1e-4


@pytest.mark.parametrize("R,V,H", [(37, 1001, 64), (21, 999, 400)])
def test_3xtf32_dw_matches_the_plain_version_at_a_ragged_v(R, V, H):
    """A V that is no multiple of the 64-row tile (coef 0 past V): the
    emulated kernel against the port's plain version (the card's oracle),
    at the same tolerances."""
    h, w, lab, dlse, dgold = (_t(x) for x in _inputs(R, V, H, R + V))
    lse = fc.fused_ce_fwd_reference(h, w, lab)[0]
    for dg, err in ((dgold, _rel), (torch.zeros_like(dgold), _scaled)):
        want = fc.fused_ce_dw_reference(h, w, lab, lse, dlse, dg)
        got = emul_dw(h, w, lab, lse, dlse, dg)
        assert err(got.numpy(), want.numpy()) <= 1e-4
