"""The f32 flash-decoding splits of rows 12 and 13
(csrc/paged_decode_attention_vec_f32.cu, csrc/decode_attention_split_f32.cu
and their csrc/decode_split_f32.cuh), replayed in f32 on the CPU against
the JAX package's kernels (Pallas in interpret mode, as the JAX tests run
them) and the port's plain versions.

The replay follows the kernels: the columns cut into the plan's chunks
(`paged_f32_plan`, `decode_f32_plan`, or other chunk lengths), query heads
in the kernels' groups of up to 4, each chunk's rows in rounds of
SPLIT_F32_ROW_SLOTS x 256 / D rows dealt to the warps as the lanes hold
them, an online softmax a warp (masked rows never read: selected out, not
multiplied), the warps' partials merged in warp order and the chunks' in
chunk order, with those of l = 0 selected out. Cases: a reduced Gemma
serve pool (S 3, KV 1, G 4, D 256, bT 16, a window), a GPT-2 generate
cache (KV 12, G 1, D 64), chunks that end inside a page, whole chunks
masked, the idle slot on the trash page, T not a multiple of the first
version's 32-row tile, chunks longer than one round. Each is held within
1e-5 of the JAX kernel and 1e-6 of the port's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    paged_decode_attention as jax_paged_decode_attention,
    xla_reference as jax_xla_reference)
from mobilefinetuner_tpu_torch.ops import decode_attention as port
from test_torch_decode_attention import _case, _windowed_case

N_SM = 132                              # an H100 SXM's multiprocessors


def _replay(q, k_rows, v_rows, ok, scale, cpc):
    """The f32 split kernel and its merge in f32: q [S, KV, G, D], the
    logical K/V rows [S, KV, cols, D] (the paged pool's pages gathered),
    ok [S, cols], `cpc` columns a chunk -> ctx [S, KV, G, D]."""
    S, KV, G, D = q.shape
    cols = ok.shape[1]
    qg = 1 if G == 1 else 2 if G == 2 else port.SPLIT_F32_MAX_QG
    warps = 8 if qg == port.SPLIT_F32_MAX_QG else 16
    rpp = 256 // D                          # rows a warp a pass
    per_pass = warps * rpp
    rnd = port.SPLIT_F32_ROW_SLOTS // warps * per_pass
    neg = torch.tensor(port.NEG_INF)
    out = torch.zeros(S, KV, G, D)
    for g0 in range(0, G, qg):
        qs = q[:, :, g0:g0 + qg]
        shape = (S, KV, qs.shape[2])
        parts = []
        for c0 in range(0, cols, cpc):
            rows = min(cpc, cols - c0)
            m = [torch.full(shape, port.NEG_INF) for _ in range(warps)]
            l = [torch.zeros(shape) for _ in range(warps)]
            acc = [torch.zeros(*shape, D) for _ in range(warps)]
            for base in range(0, rows, rnd):
                r = torch.arange(base, min(base + rnd, rows))
                warp = (r - base) % per_pass // rpp
                col = c0 + r
                live = ok[:, col]
                kk = torch.where(live[:, None, :, None], k_rows[:, :, col], 0)
                vv = torch.where(live[:, None, :, None], v_rows[:, :, col], 0)
                sc = torch.einsum("skgd,sktd->skgt", qs, kk) * scale
                sc = torch.where(live[:, None, None, :], sc, neg)
                for w in range(warps):
                    sel = warp == w
                    if not sel.any():
                        continue
                    m_new = torch.maximum(m[w], sc[..., sel].amax(-1))
                    alpha = torch.exp(m[w] - m_new)
                    p = torch.where(live[:, None, None, sel],
                                    torch.exp(sc[..., sel] - m_new[..., None]),
                                    0.0)
                    l[w] = alpha * l[w] + p.sum(-1)
                    acc[w] = alpha[..., None] * acc[w] + torch.einsum(
                        "skgt,sktd->skgd", p, vv[:, :, sel])
                    m[w] = m_new
            mg = torch.full(shape, port.NEG_INF)
            for w in range(warps):
                mg = torch.where(l[w] > 0, torch.maximum(mg, m[w]), mg)
            num, den = torch.zeros(*shape, D), torch.zeros(shape)
            for w in range(warps):
                f = torch.where(l[w] > 0, torch.exp(m[w] - mg), 0.0)
                num = num + f[..., None] * acc[w]
                den = den + f * l[w]
            parts.append((mg, den, num))
        if len(parts) > 1:                   # the merge kernel
            mmax = torch.full(shape, port.NEG_INF)
            for mc, lc, _ in parts:
                mmax = torch.where(lc > 0, torch.maximum(mmax, mc), mmax)
            num, den = torch.zeros(*shape, D), torch.zeros(shape)
            for mc, lc, ac in parts:
                f = torch.where(lc > 0, torch.exp(mc - mmax), 0.0)
                num = num + f[..., None] * ac
                den = den + f * lc
        out[:, :, g0:g0 + qg] = torch.where(
            den[..., None] > 0, num / den.clamp_min(1e-30)[..., None], 0.0)
    return out


def _paged_rows(pool, tbl, layer):
    """The pool's rows of each slot's logical columns, table entries
    clamped to [0, NB) as the kernel clamps them: [S, KV, M * bT, D]."""
    S, M = tbl.shape
    NB, _, KV, bT, D = pool.shape
    pages = pool[tbl.long().clamp(0, NB - 1), layer]   # [S, M, KV, bT, D]
    return pages.permute(0, 2, 1, 3, 4).reshape(S, KV, M * bT, D)


PAGED_CASES = [
    # (S, KV, G, D, bT, M, window, n_sm for the plan, JAX kernel too)
    (3, 1, 4, 256, 16, 12, 60, N_SM, True),    # reduced Gemma serve pool
    (3, 1, 4, 256, 16, 12, 60, 1, False),      # one chunk of four rounds
    (2, 2, 2, 256, 64, 3, 30, N_SM, True),     # chunks end inside a page
    (4, 2, 6, 64, 8, 7, None, N_SM, False),    # two groups of query heads
    (3, 3, 1, 64, 16, 20, 20, N_SM, False),    # G 1, masked chunks
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_f32_split_matches_jax_and_plain(case):
    """Row 12's split at paged_f32_plan's chunking (and at 7 columns a
    chunk and one page a chunk) within 1e-6 of paged_attention and 1e-5
    of the JAX kernel; the idle slot reads the trash page; a window masks
    whole chunks."""
    S, KV, G, D, bT, M, window, n_sm, with_jax = case
    q, pk, pv, tbl, ok = _case(S * D + M, S=S, KV=KV, G=G, D=D, bT=bT, M=M,
                               NB=S * M + 1, L=2, window=window)
    tq, tk, tv, tt, tok = (torch.from_numpy(a) for a in (q, pk, pv, tbl, ok))
    layer, scale = 1, D ** -0.5
    plain = port.paged_attention(tq, tk, tv, tt, layer, tok, scale)
    plan = port.paged_f32_plan(S, KV, G, M, bT, D, torch.float32, n_sm)
    krows, vrows = _paged_rows(tk, tt, layer), _paged_rows(tv, tt, layer)
    cols = M * bT
    got = _replay(tq, krows, vrows, tok, scale, plan["cpc"])
    assert float((got - plain).abs().max()) <= 1e-6
    if with_jax:
        want = np.asarray(jax_paged_decode_attention(
            *(jnp.asarray(a) for a in (q, pk, pv, tbl)), layer,
            jnp.asarray(ok), scale))
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5
    for cpc in sorted({7, bT} - {plan["cpc"]}):
        other = _replay(tq, krows, vrows, tok, scale, cpc)
        assert float((other - plain).abs().max()) <= 1e-6, cpc
    assert not ok[S - 1, 1:].any() and tbl[S - 1].max() == 0   # idle slot
    if window is not None and plan["n_chunks"] > 1:   # a chunk all masked
        c = plan["cpc"]
        assert any(not ok[s, c0:c0 + c].any()
                   for s in range(S) for c0 in range(0, cols, c))
    if n_sm == 1:            # a chunk longer than a round loops
        assert plan["cpc"] > plan["round_rows"]
    if case[:6] == (2, 2, 2, 256, 64, 3):
        assert plan["cpc"] % bT and plan["n_chunks"] > 1


DECODE_CASES = [
    # (B, KV, G, T, D, pads, window, n_sm for the plan)
    (8, 12, 1, 144, 64, (0, 17, 40, 64, 90, 100, 120, 3), None, N_SM),
    (8, 12, 1, 400, 64, (0, 17, 40, 64, 90, 100, 220, 3), None, 300),
    (4, 1, 4, 200, 256, (0, 40, 100, 7), 96, N_SM),     # Gemma, window
    (2, 1, 4, 200, 256, (0, 60), 96, 1),                # rounds loop
    (3, 2, 3, 77, 32, (5, 0, 33), None, N_SM),          # ragged T
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_f32_split_matches_jax_and_plain(case):
    """Row 13's split at decode_f32_plan's chunking (and at 7 and 33
    columns a chunk) within 1e-6 of xla_reference and 1e-5 of the JAX
    kernel (its oracle where T % 8 != 0, which the TPU kernel refuses),
    at GPT-2's generate cache in one chunk and in several, Gemma's with
    padding and the window masking whole chunks, a chunk longer than a
    round, and T not a multiple of 32."""
    B, KV, G, T, D, pads, window, n_sm = case
    q, kc, vc, ok = _windowed_case(B, KV, G, T, D, pads, window, seed=T)
    tq, tk, tv, tok = (torch.from_numpy(a) for a in (q, kc, vc, ok))
    scale = D ** -0.5
    plain = port.xla_reference(tq, tk, tv, tok, scale)
    jax_fn = jax_decode_attention if T % 8 == 0 else jax_xla_reference
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in (q, kc, vc, ok)),
                             scale))
    plan = port.decode_f32_plan(B, KV, G, T, D, torch.float32, n_sm)
    got = _replay(tq, tk, tv, tok, scale, plan["cpc"])
    assert float((got - plain).abs().max()) <= 1e-6
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5
    for cpc in sorted({7, 33} - {plan["cpc"]}):
        other = _replay(tq, tk, tv, tok, scale, cpc)
        assert float((other - plain).abs().max()) <= 1e-6, cpc
    if window is not None and plan["n_chunks"] > 1:   # a chunk all masked
        c = plan["cpc"]
        assert any(not ok[b, c0:c0 + c].any()
                   for b in range(B) for c0 in range(0, T, c))
    if n_sm == 1:
        assert plan["cpc"] > plan["round_rows"]


def test_masked_rows_holding_inf_and_nan_change_nothing():
    """Rows the mask leaves out are never read by the split: poisoned
    with Inf in K and NaN in V (the trash page, masked columns of live
    pages, padding) the replay's bits stay as they were."""
    q, pk, pv, tbl, ok = _case(9, S=3, KV=1, G=4, D=256, bT=16, M=6, NB=19,
                               L=1, window=40)
    tq, tk, tv, tt, tok = (torch.from_numpy(a) for a in (q, pk, pv, tbl, ok))
    krows, vrows = _paged_rows(tk, tt, 0), _paged_rows(tv, tt, 0)
    cpc = port.paged_f32_plan(3, 1, 4, 6, 16, 256, torch.float32)["cpc"]
    base = _replay(tq, krows, vrows, tok, 0.0625, cpc)
    dead = ~tok[:, None, :, None]
    poisoned = _replay(tq, krows.masked_fill(dead, float("inf")),
                       vrows.masked_fill(dead, float("nan")), tok, 0.0625,
                       cpc)
    assert torch.equal(base, poisoned)
