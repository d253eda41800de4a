"""Port decode attention (mobilefinetuner_tpu_torch/ops/
decode_attention.py) against the JAX package's, on the CPU.

Paged (row 12): `paged_attention` and the Pallas `paged_decode_attention`
(interpret mode) on the same numpy pools, tables and masks; covers
trash-padded table rows, idle slots (pos 0 on the trash page), a
sliding-window mask, G = 2 query groups and Gemma-3-270M's serve shape
in f32 (KV 1, G 4, bT 16, D 256). The 16-bit kernel's chunked split
(chunks of logical columns, partials merged in chunk order), in plain
torch, equals paged_attention within 1e-6 in f32 for paged_plan's
split and others, whole chunks masked by a window. Contiguous (row 13):
`xla_reference` and the Pallas `decode_attention` (interpret mode) at the
JAX test's four shapes, and `xla_reference` alone at ragged T (the TPU
kernel takes T % 8 == 0 only; the port's kernel any T); masked columns
poisoned with +-1e6 change nothing. f32 max abs error <= 1e-5; bf16 <=
2e-2 (the probabilities round to bf16 at different places). The
tensor-core kernel's flash-decoding split (chunks of 32-key tiles, partials
merged in chunk order), in plain torch, equals xla_reference within 1e-6
in f32 for decode_mma_plan's split and others, whole chunks masked, and
the JAX decode_attention on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops.decode_attention import (
    decode_attention as jax_decode_attention,
    paged_attention as jax_paged_attention,
    paged_decode_attention as jax_paged_decode_attention,
    xla_reference as jax_xla_reference)
from mobilefinetuner_tpu_torch.ops import decode_attention as port

TOLS = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(seed, S=4, KV=2, G=2, D=64, bT=8, M=3, NB=10, L=2,
          window=None):
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((NB, L, KV, bT, D)).astype(np.float32)
    pool_v = rng.standard_normal((NB, L, KV, bT, D)).astype(np.float32)
    pool_k[0] = pool_v[0] = 0.0             # the trash page holds zeros
    q = rng.standard_normal((S, KV, G, D)).astype(np.float32)
    tbl = np.zeros((S, M), np.int32)        # unused rows -> trash block 0
    pos = np.zeros(S, np.int64)             # slot S-1 stays idle
    free = list(rng.permutation(np.arange(1, NB)))
    for s, p in enumerate([M * bT - 1, bT + 3, 2][:S - 1]):
        pos[s] = p
        for m in range(p // bT + 1):
            tbl[s, m] = free.pop()
    cols = np.arange(M * bT)
    ok = cols[None, :] <= pos[:, None]
    if window is not None:
        ok &= cols[None, :] > pos[:, None] - window
    return q, pool_k, pool_v, tbl, ok


def _to(dtype, *arrays):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("G", [1, 2])
def test_paged_matches_jax(dtype, window, G):
    q, pk, pv, tbl, ok = _case(3 + G, G=G, window=window)
    (jq, jk, jv), (tq, tk, tv) = _to(dtype, q, pk, pv)
    layer, scale = 1, 64 ** -0.5
    want_x = np.asarray(jax_paged_attention(
        jq, jk, jv, jnp.asarray(tbl), layer, jnp.asarray(ok), scale))
    want_k = np.asarray(jax_paged_decode_attention(
        jq, jk, jv, jnp.asarray(tbl), layer, jnp.asarray(ok), scale))
    args = (torch.from_numpy(tbl), layer, torch.from_numpy(ok), scale)
    got_plain = port.paged_attention(tq, tk, tv, *args)
    port.paged_decode_attention.launches = 0
    got_wrap = port.paged_decode_attention(tq, tk, tv, *args)
    assert port.paged_decode_attention.launches == 0   # CPU: plain version
    assert got_plain.dtype == torch.float32
    assert got_plain.shape == q.shape
    tol = TOLS[dtype]
    for got in (got_plain, got_wrap):
        for want in (want_x, want_k):
            assert np.max(np.abs(got.numpy() - want)) <= tol


def test_trash_page_contents_never_leak():
    """Poisoning the trash page (finite garbage) must not move any live
    slot's context: masked columns contribute exactly 0."""
    q, pk, pv, tbl, ok = _case(11)
    base = port.paged_attention(*(torch.from_numpy(a) for a in (q, pk, pv)),
                                torch.from_numpy(tbl), 0,
                                torch.from_numpy(ok), 0.125)
    pk[0] = 1e3
    pv[0] = -1e3
    poisoned = port.paged_attention(
        *(torch.from_numpy(a) for a in (q, pk, pv)), torch.from_numpy(tbl),
        0, torch.from_numpy(ok), 0.125)
    live = slice(0, q.shape[0] - 1)          # the idle slot reads trash
    assert torch.equal(base[live], poisoned[live])


def test_paged_validation_and_eligibility():
    q, pk, pv, tbl, ok = _case(5)
    with pytest.raises(ValueError, match="dtype"):
        port.paged_decode_attention(
            torch.from_numpy(q).bfloat16(), torch.from_numpy(pk),
            torch.from_numpy(pv), torch.from_numpy(tbl), 0,
            torch.from_numpy(ok), 0.125)
    assert port.paged_eligible(12, 1, 16, 64, 2)     # GPT-2 small, bf16
    assert port.paged_eligible(1, 4, 16, 256, 2)     # Gemma-shaped GQA
    assert port.paged_eligible(1, 4, 16, 256, 4)     # the same in f32
    assert not port.paged_eligible(4, 1, 16, 16, 4)   # tiny test head dim
    assert not port.paged_eligible(4, 1, 4096, 64, 2)


@pytest.mark.parametrize("window", [None, 40])
def test_paged_matches_jax_at_gemma_f32_d256(window):
    """Gemma-3-270M's serve shape in f32 (KV 1, G 4, bT 16, D 256), which
    the JAX kernel takes and the port's f32 kernel now takes too: the
    plain version against the Pallas kernel (interpret mode) and the JAX
    plain version within 1e-5."""
    q, pk, pv, tbl, ok = _case(21, S=4, KV=1, G=4, D=256, bT=16, M=4,
                               NB=14, L=2, window=window)
    (jq, jk, jv), (tq, tk, tv) = _to("float32", q, pk, pv)
    layer, scale = 1, 256 ** -0.5
    want_x = np.asarray(jax_paged_attention(
        jq, jk, jv, jnp.asarray(tbl), layer, jnp.asarray(ok), scale))
    want_k = np.asarray(jax_paged_decode_attention(
        jq, jk, jv, jnp.asarray(tbl), layer, jnp.asarray(ok), scale))
    got = port.paged_decode_attention(tq, tk, tv, torch.from_numpy(tbl),
                                      layer, torch.from_numpy(ok), scale)
    assert port.paged_eligible(1, 4, 16, 256, 4)
    for want in (want_x, want_k):
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5


# ------------- row 12's chunked split (the 16-bit kernel, plain torch) ----

def _paged_chunked_reference(q, pool_k, pool_v, tbl, layer, ok, scale, cpc,
                             p_dtype=None):
    """The 16-bit kernel's algorithm in plain torch (f64): the M * bT
    logical columns cut into chunks of `cpc` (a chunk may end inside a
    page), each chunk's scores over its attendable columns, its max m,
    p = exp(s - m) (rounded to `p_dtype` before P.V where given, l from
    the unrounded p) giving partials (m, l, acc), merged in chunk order
    with chunks of l = 0 selected out."""
    S, KV, G, D = q.shape
    bT = pool_k.shape[3]
    kc = pool_k[tbl.long(), layer].double()       # [S, M, KV, bT, D]
    vc = pool_v[tbl.long(), layer].double()
    cols = tbl.shape[1] * bT
    kc = kc.permute(0, 2, 1, 3, 4).reshape(S, KV, cols, D)
    vc = vc.permute(0, 2, 1, 3, 4).reshape(S, KV, cols, D)
    qd = q.double()
    parts = []
    for c0 in range(0, cols, cpc):
        sl = slice(c0, min(c0 + cpc, cols))
        okc = ok[:, None, None, sl]
        s = torch.einsum("skgd,sktd->skgt", qd, kc[:, :, sl]) * scale
        s = torch.where(okc, s, port.NEG_INF)
        m = s.max(-1).values
        p = torch.where(okc, torch.exp(s - m[..., None]), 0.0)
        pr = p if p_dtype is None else p.to(p_dtype).double()
        parts.append((m, p.sum(-1),
                      torch.einsum("skgt,sktd->skgd", pr, vc[:, :, sl])))
    mmax = torch.full((S, KV, G), port.NEG_INF, dtype=torch.float64)
    for m, l, _ in parts:
        mmax = torch.where(l > 0, torch.maximum(mmax, m), mmax)
    num = torch.zeros(S, KV, G, D, dtype=torch.float64)
    den = torch.zeros(S, KV, G, dtype=torch.float64)
    for m, l, acc in parts:
        f = torch.where(l > 0, torch.exp(m - mmax), 0.0)
        num = num + f[..., None] * acc
        den = den + f * l
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-300)[..., None], 0.0)


@pytest.mark.parametrize("case", [
    # (S, KV, G, D, bT, M, window, plan shapes (S, KV) for the split)
    (8, 12, 1, 64, 16, 12, None, None),        # GPT-2's serve step: 1 chunk
    (3, 1, 4, 256, 16, 12, 60, None),          # Gemma: 3-page chunks
    (3, 1, 4, 256, 16, 12, 60, (1, 1)),        # more chunks, masked ones
    (2, 2, 2, 128, 64, 3, 30, (1, 1)),         # chunks end inside a page
    (4, 2, 6, 64, 8, 7, None, (2, 1)),         # two groups of query heads
])
def test_paged_chunked_split_matches_plain(case):
    """Per-chunk partials merged in chunk order, for paged_plan's own
    split and for others (one chunk, one page a chunk, 7 columns a chunk),
    equal paged_attention within 1e-6 in f32, with whole chunks masked by
    the window and the idle slot on the trash page."""
    S, KV, G, D, bT, M, window, plan_shape = case
    q, pk, pv, tbl, ok = _case(S + D, S=S, KV=KV, G=G, D=D, bT=bT, M=M,
                               NB=S * M + 1, L=2, window=window)
    tq, tk, tv, tt, tok = (torch.from_numpy(a) for a in (q, pk, pv, tbl, ok))
    scale = D ** -0.5
    want = port.paged_attention(tq, tk, tv, tt, 1, tok, scale).double()
    ps, pkv = plan_shape or (S, KV)
    plan = port.paged_plan(ps, pkv, G, M, bT, D, torch.bfloat16)
    cols = M * bT
    for cpc in sorted({plan["cpc"], cols, bT, 7}):
        got = _paged_chunked_reference(tq, tk, tv, tt, 1, tok, scale, cpc)
        assert float((got - want).abs().max()) <= 1e-6, cpc
    if window is not None:   # a whole chunk with no attendable column
        c = plan["cpc"]
        assert any(not ok[s, c0:c0 + c].any()
                   for s in range(S) for c0 in range(0, cols, c))


def test_paged_chunked_split_rounds_p_within_bf16():
    """With p rounded to bf16 before P.V, the chunked split stays within
    the bf16 tolerance of paged_attention on bf16 pools."""
    q, pk, pv, tbl, ok = _case(7, S=3, KV=1, G=4, D=256, bT=16, M=8, NB=25,
                               L=1, window=70)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, pk, pv))
    tt, tok = torch.from_numpy(tbl), torch.from_numpy(ok)
    want = port.paged_attention(tq, tk, tv, tt, 0, tok, 0.0625).double()
    for cpc in (16, 48, 128):
        got = _paged_chunked_reference(tq, tk, tv, tt, 0, tok, 0.0625, cpc,
                                       p_dtype=torch.bfloat16)
        assert float((got - want).abs().max()) <= TOLS["bfloat16"]


# ------------------------------------------------ contiguous cache (row 13)

def _decode_case(B, KV, G, T, D, seed=0):
    """q, caches and a left-padding-style mask with scattered holes, the
    last column (the fed token) always attendable, as the JAX test makes
    them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    ok = rng.random((B, T)) < 0.7
    ok[:, -1] = True
    return q, kc, vc, ok


@pytest.mark.parametrize("shape,dtype", [
    ((2, 12, 1, 64, 64), "float32"),     # GPT-2 head layout
    ((2, 12, 1, 64, 64), "bfloat16"),
    ((2, 1, 4, 48, 256), "float32"),     # Gemma GQA layout
    ((3, 2, 2, 40, 32), "bfloat16"),     # multi-kv-head GQA
    ((2, 3, 2, 37, 64), "float32"),      # ragged T
    ((2, 1, 4, 21, 256), "bfloat16"),    # ragged T, Gemma layout
])
def test_decode_matches_jax(shape, dtype):
    B, KV, G, T, D = shape
    q, kc, vc, ok = _decode_case(B, KV, G, T, D, seed=T + D)
    (jq, jk, jv), (tq, tk, tv) = _to(dtype, q, kc, vc)
    scale = D ** -0.5
    wants = [np.asarray(jax_xla_reference(jq, jk, jv, jnp.asarray(ok),
                                          scale))]
    if T % 8 == 0:                       # the TPU kernel's shape rule
        wants.append(np.asarray(jax_decode_attention(
            jq, jk, jv, jnp.asarray(ok), scale)))
    port.decode_attention.launches = 0
    got_plain = port.xla_reference(tq, tk, tv, torch.from_numpy(ok), scale)
    got_wrap = port.decode_attention(tq, tk, tv, torch.from_numpy(ok), scale)
    assert port.decode_attention.launches == 0     # CPU: plain version
    assert got_wrap.dtype == torch.float32 and got_wrap.shape == q.shape
    assert port.decode_eligible(KV, T, D, tq.element_size(), G)
    for got in (got_plain, got_wrap):
        for want in wants:
            assert np.max(np.abs(got.numpy() - want)) <= TOLS[dtype]


def test_decode_masked_columns_contribute_nothing():
    """Left-pad columns poisoned with +-1e6 (and not-yet-written zero
    columns) must not move the output."""
    B, KV, G, T, D = 2, 4, 1, 37, 64
    q, kc, vc, _ = _decode_case(B, KV, G, T, D, seed=5)
    ok = np.arange(T)[None, :] >= np.array([[8], [3]])
    ok[:, 30:] = False                   # unwritten tail columns
    kc[:, :, 30:] = vc[:, :, 30:] = 0.0
    args = [torch.from_numpy(a) for a in (q, kc, vc)]
    base = port.decode_attention(*args, torch.from_numpy(ok), D ** -0.5)
    kc[0, :, :8], vc[0, :, :8] = 1e6, -1e6
    kc[1, :, :3], vc[1, :, :3] = -1e6, 1e6
    got = port.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                                torch.from_numpy(ok), D ** -0.5)
    assert np.max(np.abs(got.numpy() - base.numpy())) <= 1e-6


def test_decode_validation_and_eligibility():
    q, kc, vc, ok = _decode_case(2, 2, 2, 16, 32)
    with pytest.raises(ValueError, match="dtype"):
        port.decode_attention(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(kc), torch.from_numpy(vc),
                              torch.from_numpy(ok), 1.0)
    assert port.decode_eligible(12, 192, 64, 2)            # GPT-2 small
    assert port.decode_eligible(1, 190, 64, 2)             # ragged T
    assert port.decode_eligible(1, 32768, 256, 4, G=4)     # Gemma context
    assert port.decode_eligible(3, 1, 32, 2, G=2)
    assert not port.decode_eligible(12, 192, 16, 4)        # D outside
    assert not port.decode_eligible(12, 192, 96, 2)
    assert not port.decode_eligible(1, 0, 64, 2)
    assert not port.decode_eligible(1, 64, 64, 8)          # f64


# ------------------- row 13's flash-decoding split (the tensor-core kernel)

def _chunked_reference(q, kc, vc, ok, scale, tpc, p_dtype=None):
    """The tensor-core kernel's algorithm in plain torch (f64): T cut into
    chunks of `tpc` 32-key tiles, each chunk an online softmax over its
    tiles (p rounded to `p_dtype` before P.V where given, l from the
    unrounded p) giving partials (m, l, acc), merged in chunk order with
    chunks of l = 0 selected out."""
    q, kc, vc = (t.double() for t in (q, kc, vc))
    B, KV, G, D = q.shape
    T = kc.shape[2]
    n_tiles = -(-T // 32)
    parts = []
    for c0 in range(0, n_tiles, tpc):
        m = torch.full((B, KV, G), port.NEG_INF, dtype=torch.float64)
        l = torch.zeros(B, KV, G, dtype=torch.float64)
        acc = torch.zeros(B, KV, G, D, dtype=torch.float64)
        for tile in range(c0, min(c0 + tpc, n_tiles)):
            sl = slice(32 * tile, min(32 * tile + 32, T))
            okt = ok[:, None, None, sl]
            s = torch.einsum("bkgd,bktd->bkgt", q, kc[:, :, sl]) * scale
            s = torch.where(okt, s, port.NEG_INF)
            m_new = torch.maximum(m, s.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.where(okt, torch.exp(s - m_new[..., None]), 0.0)
            pr = p if p_dtype is None else p.to(p_dtype).double()
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bkgt,bktd->bkgd", pr, vc[:, :, sl])
            m = m_new
        parts.append((m, l, acc))
    mmax = torch.full((B, KV, G), port.NEG_INF, dtype=torch.float64)
    for m, l, _ in parts:
        mmax = torch.where(l > 0, torch.maximum(mmax, m), mmax)
    num = torch.zeros(B, KV, G, D, dtype=torch.float64)
    den = torch.zeros(B, KV, G, dtype=torch.float64)
    for m, l, acc in parts:
        f = torch.where(l > 0, torch.exp(m - mmax), 0.0)
        num = num + f[..., None] * torch.where(l[..., None] > 0, acc, 0.0)
        den = den + f * l
    return torch.where(den[..., None] > 0, num / den.clamp_min(1e-300)
                       [..., None], 0.0)


def _windowed_case(B, KV, G, T, D, pads, window, seed):
    """Left padding of pads[b] columns and the generate path's window over
    the last query position: the last column always attendable."""
    q, kc, vc, _ = _decode_case(B, KV, G, T, D, seed=seed)
    cols = np.arange(T)
    ok = cols[None, :] >= np.asarray(pads)[:, None]
    if window is not None:
        ok &= cols[None, :] > T - 1 - window
    return q, kc, vc, ok


@pytest.mark.parametrize("case", [
    # (B, KV, G, T, D, pads, window, plan shapes (B, KV, G) for the split)
    (2, 12, 1, 192, 64, (0, 70), None, None),          # GPT-2: 2 chunks
    (4, 1, 4, 160, 256, (0, 40, 100, 7), 48, None),     # Gemma: 5 chunks
    (2, 2, 2, 96, 32, (70, 0), None, (1, 1, 1)),        # 3 chunks, pads
    (1, 1, 4, 256, 64, (0,), 40, (1, 1, 1)),            # masked chunks
    (3, 1, 2, 40, 64, (5, 0, 33), None, (64, 4, 16)),   # one chunk
])
def test_chunked_split_matches_xla_reference_and_jax(case):
    """Per-chunk partials merged in chunk order, for decode_mma_plan's own
    split and for others (one chunk a tile, whole T), equal xla_reference
    within 1e-6 in f32, with whole chunks masked by padding or Gemma's
    window; and the JAX decode_attention on the same numpy inputs."""
    B, KV, G, T, D, pads, window, plan_shape = case
    q, kc, vc, ok = _windowed_case(B, KV, G, T, D, pads, window, seed=T)
    tq, tk, tv, tok = (torch.from_numpy(a) for a in (q, kc, vc, ok))
    scale = D ** -0.5
    want = port.xla_reference(tq, tk, tv, tok, scale)
    jax_want = np.asarray(jax_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, ok)), scale))
    pb, pk, pg = plan_shape or (B, KV, G)
    plan = port.decode_mma_plan(pb, pk, pg, T, D, torch.bfloat16)
    n_tiles = -(-T // 32)
    for tpc in sorted({plan["tiles_per_chunk"], 1, n_tiles}):
        got = _chunked_reference(tq, tk, tv, tok, scale, tpc)
        assert float((got - want.double()).abs().max()) <= 1e-6, tpc
        assert np.max(np.abs(got.numpy() - jax_want)) <= 1e-5, tpc
    # a whole chunk with no attendable column exists in the masked cases
    if window is not None or max(pads) >= 32 * plan["tiles_per_chunk"]:
        chunk_keys = 32 * plan["tiles_per_chunk"]
        assert any(not ok[b, c:c + chunk_keys].any()
                   for b in range(B) for c in range(0, T, chunk_keys))


def test_chunked_split_rounds_p_like_one_pass_within_bf16():
    """With p rounded to bf16 before P.V, the chunked split stays within
    the bf16 tolerance of xla_reference on bf16 operands."""
    q, kc, vc, ok = _windowed_case(4, 1, 4, 200, 256, (0, 9, 60, 3), 96,
                                   seed=3)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, kc, vc))
    tok = torch.from_numpy(ok)
    want = port.xla_reference(tq, tk, tv, tok, 0.0625)
    for tpc in (1, 2, 7):
        got = _chunked_reference(tq, tk, tv, tok, 0.0625, tpc,
                                 p_dtype=torch.bfloat16)
        assert float((got - want.double()).abs().max()) <= TOLS["bfloat16"]
