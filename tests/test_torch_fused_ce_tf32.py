"""The f32 fused CE dh kernels' 3xTF32 arithmetic on the CPU
(csrc/fused_ce_dh_tf32.cu, row 7, and csrc/fused_ce_dh_lora_tf32.cu, row
10; split and product helpers in csrc/tensor_core_tf32.cuh), against the
JAX package's `_bwd_dh` and `_bwd_dh_lora` with their Pallas kernels in
interpret mode.

The card's TF32 rounding (round to nearest, ties away from zero, at bit
13 of the f32 pattern: cvt.rna.tf32.f32, and the kernels'
tf32_round_bits) is emulated by integer arithmetic on the f32 bits.
Every product of the kernels' loop, at their own tiles and slabs (from
`dh_tf32_plan` / `dh_lora_tf32_plan`), splits both operands into hi + lo
TF32 halves and sums hi.hi + hi.lo + lo.hi in f32, dropping lo.lo: the
logits of each 16-row vocab tile over the widened row [h | xa] against
[W | bt], as the WG warps' k-slices summed in warp order; coef from
them; [dh | dxa] += coef @ [W | bt]_tile within a slab; the slabs'
partials added in slab order. At small shapes with a ragged R, a last
slab shorter than the rest, H 64 and 128 and r 4 and 8, dh and dxa stay
within 1e-4 of max(1, |ref|) of the JAX kernels and their softmax part
(dgold = 0) within 1e-4 of max |ref|: the f32 tolerances the CUDA
kernels are held to on the card. One TF32 product (each operand rounded
once) misses both, which is why the kernels split. A V that is not a
multiple of a tile, which the JAX kernels do not take, is held against
the port's plain version. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import fused_ce as jfc
from mobilefinetuner_tpu_torch.ops import fused_ce as fc

N_SM = 132                              # an H100 SXM's multiprocessors


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32 on its bits: + 0x1000 carries a half ulp
    of the 10-bit mantissa, then the low 13 bits are cleared."""
    b = x.detach().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(
        ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b in 3xTF32: lo.hi + hi.lo into one sum, hi.hi into another,
    added last (the kernels' two accumulators)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def emul_dh(h, w, labels, lse, dlse, dgold, xa=None, bt=None, mm=mm3):
    """(dh, dxa or None): the kernels' loop at their own plan, every
    product through `mm`."""
    R, H = h.shape
    V = w.shape[0]
    r = 0 if xa is None else xa.shape[1]
    plan = (fc.dh_lora_tf32_plan(R, V, H, r, N_SM) if r
            else fc.dh_tf32_plan(R, V, H, N_SM))
    hx, vt, wg = plan["hx"], fc.TF32_VOCAB_TILE, fc.TF32_WARPS
    hw = torch.zeros(R, hx)
    ww = torch.zeros(V, hx)
    hw[:, :H], ww[:, :H] = h, w
    if r:
        hw[:, H:H + r], ww[:, H:H + r] = xa, bt
    ks = hx // 8
    slices = [(8 * (k * ks // wg), 8 * ((k + 1) * ks // wg))
              for k in range(wg)]
    lab = labels.long()
    total = torch.zeros(R, hx)
    span = plan["tiles_per_slab"] * vt
    for s0 in range(0, V, span):
        acc = torch.zeros(R, hx)
        for v0 in range(s0, min(V, s0 + span), vt):
            v1 = min(V, v0 + vt)
            logits = torch.zeros(R, v1 - v0)
            for a, b in slices:
                logits = logits + mm(hw[:, a:b], ww[v0:v1, a:b].T)
            cols = torch.arange(v0, v1)
            coef = dlse[:, None] * torch.exp(logits - lse[:, None]) \
                + torch.where(cols[None, :] == lab[:, None],
                              dgold[:, None], 0.0)
            acc = acc + mm(coef, ww[v0:v1])
        total = total + acc
    return total[:, :H], (total[:, H:H + r] if r else None)


def _inputs(R, V, H, r, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, R).astype(np.int32)
    dlse = rng.normal(size=R).astype(np.float32)
    dgold = rng.normal(size=R).astype(np.float32)
    xa = rng.normal(size=(R, r)).astype(np.float32) if r else None
    bt = (rng.normal(size=(V, r)) * 0.3).astype(np.float32) if r else None
    return h, w, lab, dlse, dgold, xa, bt


def _jax_dh(h, w, lab, dlse, dgold, xa, bt):
    """lse from the JAX forward, then (dh, dxa or None) from `_bwd_dh` or
    `_bwd_dh_lora`, twice: with dgold and with dgold = 0."""
    j = [jnp.asarray(x) for x in (h, w)]
    lab2 = jnp.asarray(lab).reshape(-1, 1)
    if xa is None:
        lse = jfc._fwd(*j, lab2)[0]
    else:
        lse = jfc._fwd_lora(*j, jnp.asarray(xa), jnp.asarray(bt), lab2)[0]
    out = []
    for dg in (dgold, np.zeros_like(dgold)):
        rows = [jnp.asarray(x).reshape(-1, 1) for x in (dlse, dg)]
        lse2 = lse.reshape(-1, 1)
        if xa is None:
            got = (jfc._bwd_dh(*j, lab2, lse2, *rows), None)
        else:
            got = jfc._bwd_dh_lora(*j, jnp.asarray(xa), jnp.asarray(bt),
                                   lab2, lse2, *rows)
        out.append([None if x is None else np.asarray(x, np.float64)
                    for x in got])
    return np.array(lse, np.float32), out


def _emulated(h, w, lab, lse, dlse, dgold, xa, bt, mm):
    out = []
    for dg in (dgold, np.zeros_like(dgold)):
        got = emul_dh(*(None if x is None else torch.from_numpy(x)
                        for x in (h, w, lab, lse, dlse, dg, xa, bt)),
                      mm=mm)
        out.append([None if x is None else x.numpy().astype(np.float64)
                    for x in got])
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _scaled(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


# (R, V, H, r): V a multiple of 128 (the JAX kernels' tile); 2,176 is
# 136 16-row tiles over 46 slabs of 3, the last of 1
CASES = [
    (37, 2176, 64, 0),
    (19, 1280, 128, 0),
    (37, 2176, 64, 4),
    (19, 1280, 128, 8),
]


def _errors(R, V, H, r, mm):
    h, w, lab, dlse, dgold, xa, bt = _inputs(R, V, H, r, R + V + H + r)
    lse, want = _jax_dh(h, w, lab, dlse, dgold, xa, bt)
    got = _emulated(h, w, lab, lse, dlse, dgold, xa, bt, mm)
    rel = max(_rel(a, b) for a, b in zip(got[0], want[0]) if b is not None)
    sm = max(_scaled(a, b) for a, b in zip(got[1], want[1])
             if b is not None)
    for a, b in zip(got[0], want[0]):
        assert (a is None) == (b is None) and (a is None
                                               or a.shape == b.shape)
    return rel, sm


def test_tf32_round_bits_match_cvt_rna():
    """Ties round away from zero at bit 13, as cvt.rna does; hi carries
    11 significant bits and hi + lo restores x to within 2^-22 |x|."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23,
                      3 * 2 ** -11, 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                                3 * 2 ** -11, 0.0]
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(y)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2 ** -22


def test_emulation_takes_the_kernels_tiles():
    """The CASES hit a ragged R, a last slab shorter than the rest and,
    for row 10, the widened row's zero columns (r 4 of 8)."""
    plan = fc.dh_tf32_plan(37, 2176, 64, N_SM)
    n_vt = 2176 // fc.TF32_VOCAB_TILE
    assert 37 % (16 * plan["row_groups"]) != 0
    assert n_vt % plan["tiles_per_slab"] != 0
    assert plan["n_slabs"] > 1
    assert fc.dh_lora_tf32_plan(37, 2176, 64, 4, N_SM)["hx"] == 72


@pytest.mark.parametrize("R,V,H,r", CASES)
def test_3xtf32_dh_matches_jax_kernels(R, V, H, r):
    """dh (and dxa) within 1e-4 of max(1, |ref|) of the JAX Pallas
    kernels; the softmax part (dgold = 0) within 1e-4 of max |ref|."""
    rel, sm = _errors(R, V, H, r, mm3)
    assert rel <= 1e-4
    assert sm <= 1e-4


@pytest.mark.parametrize("R,V,H,r", CASES)
def test_one_tf32_product_misses_the_f32_tolerances(R, V, H, r):
    """Each operand rounded to TF32 once (2^-11): dh over max(1, |ref|)
    and its softmax part over max |ref| both land beyond 1e-4 (about 5e-4
    to 3e-3 here), where 3xTF32 stays near 1e-6."""
    rel, sm = _errors(R, V, H, r, mm1)
    assert rel > 1e-4
    assert sm > 1e-4


@pytest.mark.parametrize("R,V,H,r", [(37, 1001, 64, 0), (21, 999, 64, 3)])
def test_3xtf32_dh_matches_the_plain_version_at_a_ragged_v(R, V, H, r):
    """A V that is no multiple of the 16-row tile (coef 0 past V), an odd
    rank: the emulated kernels against the port's plain versions (the
    card's oracle), at the same tolerances."""
    h, w, lab, dlse, dgold, xa, bt = (None if x is None else
                                      torch.from_numpy(x) for x in
                                      _inputs(R, V, H, r, R + V))
    lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
    for dg, err in ((dgold, _rel), (torch.zeros_like(dgold), _scaled)):
        want = fc.fused_ce_dh_lora_reference(h, w, xa, bt, lab, lse, dlse,
                                             dg)
        got = emul_dh(h, w, lab, lse, dlse, dg, xa, bt)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert err(a.numpy(), b.numpy()) <= 1e-4
