"""The f32 fused CE forward, head-adapter forward and dbt-only kernels'
3xTF32 arithmetic on the CPU (csrc/fused_ce_fwd_tf32.cu, row 6,
csrc/fused_ce_fwd_lora_tf32.cu, row 9, and csrc/fused_ce_dbt_tf32.cu, row
11 in its dbt-only mode; split and product helpers in
csrc/tensor_core_tf32.cuh), against the JAX package's `_fwd`, `_fwd_lora`
and `_bwd_dw_lora` with their Pallas kernels in interpret mode.

The kernels split each operand as `split_tf32_raw_lo` does: hi rounded to
TF32 (round to nearest, ties away from zero, at bit 13 of the f32
pattern), lo = x - hi left raw, of which the tensor cores read the top 19
bits (emulated here by clearing the low 13). Every product of the
kernels' loop, at their own tiles and slabs (from `fwd_tf32_plan` /
`fwd_lora_tf32_plan` / `dbt_tf32_plan`, at 8 multiprocessors so that the
small vocabularies here take several slabs, the last shorter), sums
lo.hi + hi.lo and then hi.hi in f32: row 6's logits of each 128-row
vocab tile folded into an online logsumexp and gold, the slabs' partials
merged in slab order; row 9 the same over the widened row [h | xa]
against [W | bt] (the rank's columns zero past r); row 11's logits over
that widened row, coef from them, coef^T @ xa a row tile, the row tiles'
partials added in order. At small shapes with a ragged R, H 64 and 128
and r 1, 4 and 8, lse and gold (rows 6 and 9) stay within 1e-4 of the
JAX kernels, dbt within 1e-4 of max(1, |ref|) and
its softmax part (dgold = 0) within 1e-4 of max |ref|: the f32 tolerances
the CUDA kernels are held to on the card. One TF32 product (each operand
rounded once) misses them. A V that is not a multiple of a tile, which
the JAX kernels do not take, is held against the port's plain versions.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import fused_ce as jfc
from mobilefinetuner_tpu_torch.ops import fused_ce as fc

N_SM = 8                                # multiprocessors the plans fill

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
    added last (the kernels' two accumulators)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm1(a, b):
    """a @ b with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def _slabs(V, plan):
    vt = fc.LOGITS_VOCAB_TILE
    span = plan["tiles_per_slab"] * vt
    for s0 in range(0, V, span):
        yield [(v0, min(V, v0 + vt))
               for v0 in range(s0, min(V, s0 + span), vt)]


def emul_fwd(h, w, labels, mm=mm3, plan=None):
    """(lse, gold): row 6's loop at its own plan (or `plan`), every
    product through `mm`; the slabs' (max, sum of exp, gold) merged in
    slab order."""
    R, H = h.shape
    V = w.shape[0]
    plan = plan or fc.fwd_tf32_plan(R, V, H, N_SM)
    lab = labels.long()
    parts = []
    for tiles in _slabs(V, plan):
        m = torch.full((R,), -1e30)
        s = torch.zeros(R)
        gold = torch.zeros(R)
        for v0, v1 in tiles:
            logits = mm(h, w[v0:v1].T)
            cols = torch.arange(v0, v1)
            gold = gold + torch.where(cols[None, :] == lab[:, None], logits,
                                      0.0).sum(-1)
            mx = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - mx) + torch.exp(logits - mx[:, None]).sum(-1)
            m = mx
        parts.append((m, s, gold))
    M = torch.stack([p[0] for p in parts]).amax(0)
    total = sum(p[1] * torch.exp(p[0] - M) for p in parts)
    return M + torch.log(total), sum(p[2] for p in parts)


def widened(h, w, xa, bt, hx):
    """[h | xa | 0] [R, hx] and [W | bt | 0] [V, hx]: the rows rows 9 and
    11 contract, the rank's columns zero past r."""
    R, H = h.shape
    V, r = bt.shape
    hw = torch.zeros(R, hx)
    ww = torch.zeros(V, hx)
    hw[:, :H], ww[:, :H] = h, w
    hw[:, H:H + r], ww[:, H:H + r] = xa, bt
    return hw, ww


def emul_fwd_lora(h, w, xa, bt, labels, mm=mm3):
    """(lse, gold): row 9's loop, which is row 6's (emul_fwd) at row 9's
    own plan over the widened row."""
    R, H = h.shape
    V, r = bt.shape
    plan = fc.fwd_lora_tf32_plan(R, V, H, r, N_SM)
    return emul_fwd(*widened(h, w, xa, bt, plan["hx"]), labels, mm, plan)


def emul_dbt(h, w, xa, bt, labels, lse, dlse, dgold, mm=mm3):
    """dbt: row 11's dbt-only loop at its own plan over the widened row
    [h | xa | 0] against [W | bt | 0], every product through `mm`; a row
    tile's partial coef^T @ xa, the partials added in row-tile order."""
    R, H = h.shape
    V, r = bt.shape
    plan = fc.dbt_tf32_plan(R, V, H, r, N_SM)
    hx, rt = plan["hx"], plan["row_tile"]
    hw, ww = widened(h, w, xa, bt, hx)
    lab = labels.long()
    dbt = torch.zeros(V, r)
    for r0 in range(0, R, rt):
        rows = slice(r0, min(R, r0 + rt))
        part = torch.zeros(V, r)
        for tiles in _slabs(V, plan):
            for v0, v1 in tiles:
                logits = mm(hw[rows], ww[v0:v1].T)
                cols = torch.arange(v0, v1)
                coef = dlse[rows, None] * torch.exp(logits - lse[rows, None]) \
                    + torch.where(cols[None, :] == lab[rows, None],
                                  dgold[rows, None], 0.0)
                part[v0:v1] = mm(coef.T, xa[rows])
        dbt = dbt + part
    return dbt


def _inputs(R, V, H, r, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, R).astype(np.int32)
    dlse = rng.normal(size=R).astype(np.float32)
    dgold = rng.normal(size=R).astype(np.float32)
    xa = rng.normal(size=(R, r)).astype(np.float32)
    bt = (rng.normal(size=(V, r)) * 0.3).astype(np.float32)
    return h, w, lab, dlse, dgold, xa, bt


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _scaled(a, b):
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _t(x):
    return torch.from_numpy(x)


# (R, V, H): V a multiple of 128 (the JAX kernels' tile); at 8
# multiprocessors 2,176 is 17 128-row tiles over 6 slabs of 3, the last of
# 2, and 1,280 with two row tiles 10 over 4 slabs of 3, the last of 1
FWD_CASES = [(37, 2176, 64), (70, 1280, 128)]
# (R, V, H, r): r 1, 4 and 8; R 70 takes two row tiles of 64
DBT_CASES = [(37, 2176, 64, 1), (70, 1280, 128, 4), (19, 2176, 64, 8)]


def _fwd_errors(R, V, H, mm):
    h, w, lab, *_ = _inputs(R, V, H, 1, R + V + H)
    want = [np.asarray(x, np.float64) for x in jfc._fwd(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab).reshape(-1, 1))]
    got = emul_fwd(_t(h), _t(w), _t(lab), mm)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    return max(float(np.max(np.abs(a.numpy() - b)))
               for a, b in zip(got, want))


def _fwd_lora_errors(R, V, H, r, mm):
    h, w, lab, _, _, xa, bt = _inputs(R, V, H, r, R + V + H + r)
    want = [np.asarray(x, np.float64) for x in jfc._fwd_lora(
        *(jnp.asarray(x) for x in (h, w, xa, bt)),
        jnp.asarray(lab).reshape(-1, 1))]
    got = emul_fwd_lora(_t(h), _t(w), _t(xa), _t(bt), _t(lab), mm)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (R,)
    return max(float(np.max(np.abs(a.numpy() - b)))
               for a, b in zip(got, want))


def _dbt_errors(R, V, H, r, mm):
    h, w, lab, dlse, dgold, xa, bt = _inputs(R, V, H, r, R + V + H + r)
    j = [jnp.asarray(x) for x in (h, w, xa, bt)]
    lab2 = jnp.asarray(lab).reshape(-1, 1)
    lse = jfc._fwd_lora(*j, lab2)[0]
    out = []
    for dg in (dgold, np.zeros_like(dgold)):
        rows = [jnp.asarray(x).reshape(-1, 1) for x in (dlse, dg)]
        want = np.asarray(jfc._bwd_dw_lora(*j, lab2, lse.reshape(-1, 1),
                                           *rows)[1], np.float64)
        got = emul_dbt(_t(h), _t(w), _t(xa), _t(bt), _t(lab),
                       torch.from_numpy(np.array(lse, np.float32)),
                       _t(dlse), _t(dg), mm).numpy()
        assert got.shape == want.shape == (V, r)
        out.append((got, want))
    return _rel(*out[0]), _scaled(*out[1])


def test_split_with_a_raw_lo_keeps_f32_accuracy():
    """hi carries 11 significant bits and lo as the tensor cores read it
    restores x to within 2^-21 |x|; hi alone misses by up to 2^-12."""
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32))
    hi, lo = split(y)
    for part in (hi, lo):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) > 2 ** -14


def test_emulation_takes_the_kernels_tiles():
    """The cases hit a ragged R, several slabs with a last one shorter
    than the rest, two row tiles for row 11 and the widened row's zero
    columns (r 4 of 8)."""
    p = fc.fwd_tf32_plan(37, 2176, 64, N_SM)
    n_vt = 2176 // fc.LOGITS_VOCAB_TILE
    assert 37 % p["row_tile"] != 0
    assert p["n_slabs"] > 1 and n_vt % p["tiles_per_slab"] != 0
    q = fc.dbt_tf32_plan(70, 1280, 128, 4, N_SM)
    assert q["row_tiles"] == 2 and q["hx"] == 136
    assert q["n_slabs"] > 1 and 10 % q["tiles_per_slab"] != 0
    for R, V, H, r in DBT_CASES:     # row 9's: the same tiles as row 11's
        p = fc.fwd_lora_tf32_plan(R, V, H, r, N_SM)
        assert p == fc.dbt_tf32_plan(R, V, H, r, N_SM)
        assert p["hx"] > H + r or r % 8 == 0
        assert R % p["row_tile"] != 0 and p["n_slabs"] > 1
        assert (V // fc.LOGITS_VOCAB_TILE) % p["tiles_per_slab"] != 0


@pytest.mark.parametrize("R,V,H", FWD_CASES)
def test_3xtf32_fwd_matches_jax_kernel(R, V, H):
    """lse and gold within 1e-4 of the JAX Pallas kernel."""
    assert _fwd_errors(R, V, H, mm3) <= 1e-4


@pytest.mark.parametrize("R,V,H,r", DBT_CASES)
def test_3xtf32_fwd_lora_matches_jax_kernel(R, V, H, r):
    """Row 9: lse and gold of h W^T + xa bt^T within 1e-4 of the JAX
    Pallas kernel at a ragged R, a short last slab, H 64 and 128, r 1, 4
    and 8."""
    assert _fwd_lora_errors(R, V, H, r, mm3) <= 1e-4


@pytest.mark.parametrize("R,V,H,r", DBT_CASES)
def test_3xtf32_dbt_matches_jax_kernel(R, V, H, r):
    """dbt within 1e-4 of max(1, |ref|) of the JAX Pallas kernel; the
    softmax part (dgold = 0) within 1e-4 of max |ref|."""
    rel, sm = _dbt_errors(R, V, H, r, mm3)
    assert rel <= 1e-4
    assert sm <= 1e-4


@pytest.mark.parametrize("R,V,H,r", [(*c, 0) for c in FWD_CASES]
                         + DBT_CASES)
def test_one_tf32_product_misses_the_f32_tolerances(R, V, H, r):
    """Each operand rounded to TF32 once (2^-11): lse / gold (rows 6 and
    9), dbt over max(1, |ref|) and its softmax part over max |ref| land
    beyond 1e-4, where 3xTF32 stays near 1e-6."""
    if not r:
        assert _fwd_errors(R, V, H, mm1) > 1e-4
        return
    assert _fwd_lora_errors(R, V, H, r, mm1) > 1e-4
    rel, sm = _dbt_errors(R, V, H, r, mm1)
    assert rel > 1e-4
    assert sm > 1e-4


@pytest.mark.parametrize("R,V,H,r", [(37, 1001, 64, 3), (70, 999, 72, 8)])
def test_3xtf32_matches_the_plain_version_at_a_ragged_v(R, V, H, r):
    """A V that is no multiple of the 128-row tile (vocab rows past V
    left out), an odd rank: the emulated kernels (rows 6, 9 and 11)
    against the port's plain versions (the card's oracle), at the same
    tolerances."""
    h, w, lab, dlse, dgold, xa, bt = (_t(x) for x in
                                      _inputs(R, V, H, r, R + V))
    lse, gold = emul_fwd(h, w, lab)
    rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
    assert float((lse - rl).abs().max()) <= 1e-4
    assert float((gold - rg).abs().max()) <= 1e-4
    lse, gold = emul_fwd_lora(h, w, xa, bt, lab)
    rl, rg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    assert float((lse - rl).abs().max()) <= 1e-4
    assert float((gold - rg).abs().max()) <= 1e-4
    lse = rl
    for dg, err in ((dgold, _rel), (torch.zeros_like(dgold), _scaled)):
        want = fc.fused_ce_dw_lora_reference(h, w, xa, bt, lab, lse, dlse,
                                             dg, want_dw=False)[1]
        got = emul_dbt(h, w, xa, bt, lab, lse, dlse, dg)
        assert err(got.numpy(), want.numpy()) <= 1e-4
