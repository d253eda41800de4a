"""The launch plans of the tensor-core kernels (row 1, the flash-attention
forward; rows 7, 8 and 10, the fused CE dh, dW and head-adapter dh + dxa),
on the CPU: the pure-Python plans the wrappers pass to the card
(`ops/flash_attention.fwd_plan` with the key-tile bounds
`_kv_block_bounds`; `ops/fused_ce.dh_mma_plan`, with a rank for row 10,
and `dw_mma_plan`) cover every (query block, head, batch), every (row
tile, vocab slab, H part) and every (vocab tile, H part) exactly once,
visit every attendable key, fit the card's shared memory, and agree with
the constants of the CUDA sources; row 8's stores write each dW element
once, from the fragment that holds it; and the dtype picks the library:
bf16 / f16 the `_mma` sources, f32 the FMA ones. No card needed."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from mobilefinetuner_tpu_torch.ops import flash_attention as fa
from mobilefinetuner_tpu_torch.ops import fused_ce as fc

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mobilefinetuner_tpu_torch", "csrc")
N_SM = 132                              # an H100 SXM's multiprocessors


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constexpr(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# ----------------------------------------------------------- dtype route ---

MMA_LIBS = {  # the tensor-core kernels' (source, symbol) for bf16 / f16
    "fwd": ("flash_attention_fwd_mma", "mft_flash_attention_fwd_mma"),
    "dh": ("fused_ce_dh_mma", "mft_fused_ce_dh_mma"),
    "dw": ("fused_ce_dw_mma", "mft_fused_ce_dw_mma"),
    "dh_lora": ("fused_ce_dh_lora_mma", "mft_fused_ce_dh_lora_mma")}
FMA_LIBS = {  # the FMA kernels' for f32
    "fwd": ("flash_attention_fwd", "mft_flash_attention_fwd"),
    "dh": ("fused_ce", "mft_fused_ce_dh"),
    "dw": ("fused_ce", "mft_fused_ce_dw"),
    "dh_lora": ("fused_ce", "mft_fused_ce_dh_lora")}
ROUTES = {"fwd": fa.fwd_library, "dh": fc.dh_library, "dw": fc.dw_library,
          "dh_lora": fc.dh_lora_library}


@pytest.mark.parametrize("dtype,fwd,dh", [
    (torch.bfloat16, MMA_LIBS["fwd"], MMA_LIBS["dh"]),
    (torch.float16, MMA_LIBS["fwd"], MMA_LIBS["dh"]),
    (torch.float32, FMA_LIBS["fwd"], FMA_LIBS["dh"]),
])
def test_dtype_picks_the_library(dtype, fwd, dh):
    libs = FMA_LIBS if dtype == torch.float32 else MMA_LIBS
    assert (libs["fwd"], libs["dh"]) == (fwd, dh)
    for key, route in ROUTES.items():
        assert route(dtype) == libs[key]
    # each symbol is exported by its source, with a C interface
    for lib, sym in libs.values():
        assert f'extern "C" int {sym}(' in _source(f"{lib}.cu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_dtype_without_a_kernel_raises(dtype):
    for route in ROUTES.values():
        with pytest.raises(ValueError, match="dtype"):
            route(dtype)


@pytest.mark.parametrize("key", ["dw", "dh_lora"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int8,
                                   torch.complex64])
def test_new_routes_raise_for_other_dtypes(key, dtype):
    with pytest.raises(ValueError, match="dtype"):
        ROUTES[key](dtype)


def _entry(text, sym):
    """The body of the C entry `sym` up to the next entry (or the end)."""
    start = text.index(f'extern "C" int {sym}(')
    end = text.find('extern "C"', start + 1)
    return text[start:] if end < 0 else text[start:end]


def test_fma_sources_keep_only_their_f32_instantiation():
    """The 16-bit cases left flash_attention_fwd.cu and the base dh, dW
    and head-adapter dh entries of fused_ce.cu; row 11's dW kernel keeps
    its 16-bit instantiations there, its template untouched."""
    fwd = _source("flash_attention_fwd.cu")
    entry = fwd[fwd.index('extern "C" int mft_flash_attention_fwd('):]
    assert "dispatch_d<float>" in entry
    assert "__nv_bfloat16" not in entry and "__half" not in entry
    ce = _source("fused_ce.cu")
    for sym, launch in (("mft_fused_ce_dh", "launch_dh<float, false>"),
                        ("mft_fused_ce_dw", "launch_dw<float>"),
                        ("mft_fused_ce_dh_lora", "launch_dh<float, true>")):
        entry = _entry(ce, sym)
        assert launch in entry and "dtype != 0" in entry
        assert "by_dtype" not in entry
    assert "by_dtype" in _entry(ce, "mft_fused_ce_dw_lora")


def test_tensor_core_sources_use_mma_sync():
    for name in ("flash_attention_fwd_mma.cu", "fused_ce_dh_mma.cu",
                 "fused_ce_dw_mma.cu", "fused_ce_dh_lora_mma.cu"):
        text = _source(name)
        assert "mma_16816<T>" in text and "ldmatrix_x4" in text
        assert "ldmatrix_x4_trans" in text or name.startswith("flash")
        assert "cp_async_16" in text
        assert '#include "tensor_core.cuh"' in text
    assert "mma.sync.aligned.m16n8k16" in _source("tensor_core.cuh")


def test_new_sources_are_built_and_call_no_library():
    from mobilefinetuner_tpu_torch.kernels import build
    for name in ("fused_ce_dw_mma", "fused_ce_dh_lora_mma"):
        assert name in build.SOURCES
        text = _source(f"{name}.cu")
        for lib in ("cublas", "cutlass", "torch/", "<aten"):
            assert lib not in text.lower()


# ------------------------------------------------------------- row 1 -------

FLASH_SHAPES = [  # (B, Hq, S, D, dtype)
    (4, 4, 256, 256, torch.bfloat16),   # Gemma-3 training step
    (8, 4, 256, 256, torch.bfloat16),   # batch 8
    (8, 12, 128, 64, torch.bfloat16),   # GPT-2 training step
    (1, 12, 100, 64, torch.bfloat16),   # a ragged serving prefill
    (2, 8, 200, 256, torch.float16),    # ragged S at D 256
    (2, 8, 96, 128, torch.bfloat16),
    (2, 4, 200, 64, torch.float32),     # the FMA kernel
]


def test_flash_plan_constants_match_the_source():
    text = _source("flash_attention_fwd_mma.cu")
    warps = _constexpr(text, "WARPS")
    assert "constexpr int BQ = 16 * WARPS;" in text
    assert "D == 256 ? 32 : 64" in text
    assert "min(nK, (row0 + BQ - 1) / BK + 1)" in text
    assert "floor_div(row0 - window + 1, BK)" in text
    for D, bk in ((64, 64), (128, 64), (256, 32)):
        plan = fa.fwd_plan(1, 1, 64, D, torch.bfloat16)
        assert (plan["block_q"], plan["block_k"]) == (16 * warps, bk)
    old = _source("flash_attention_fwd.cu")
    assert _constexpr(old, "BQ") == fa.fwd_plan(1, 1, 64, 64, torch.float32)[
        "block_q"] == _constexpr(old, "BK")


@pytest.mark.parametrize("B,Hq,S,D,dtype", FLASH_SHAPES)
def test_flash_plan_covers_each_query_block_once(B, Hq, S, D, dtype):
    plan = fa.fwd_plan(B, Hq, S, D, dtype)
    nx, ny, nz = plan["grid"]
    assert (ny, nz) == (Hq, B)
    seen = np.zeros((B, Hq, S), dtype=np.int64)
    for b in range(nz):
        for h in range(ny):
            for x in range(nx):
                r0 = x * plan["block_q"]
                assert r0 < S                  # no CTA without a row
                seen[b, h, r0:r0 + plan["block_q"]] += 1
    assert (seen == 1).all()


def test_flash_plan_fills_the_card_at_gemma_shape():
    """32-row blocks give 128 CTAs at Gemma's B 4 x Hq 4 x S 256, twice the
    64-row blocks' 64 (132 SMs)."""
    nx, ny, nz = fa.fwd_plan(4, 4, 256, 256, torch.bfloat16)["grid"]
    assert nx * ny * nz == 128
    nx, ny, nz = fa.fwd_plan(4, 4, 256, 256, torch.float32)["grid"]
    assert nx * ny * nz == 64


@pytest.mark.parametrize("S,D,causal,window", [
    (256, 256, True, 512), (256, 256, True, 40), (200, 256, True, 24),
    (128, 64, True, None), (100, 64, False, None), (200, 64, False, 24),
    (1000, 128, True, 512), (33, 64, True, 1),
])
def test_flash_key_tiles_reach_every_attendable_key(S, D, causal, window):
    """[lo, hi) of each query block holds every key some row of the block
    attends to, and no tile beyond the last key of the block's last row
    (causal) or before the first window key of its first row."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.fwd_plan(1, 1, S, D, dtype)
        bq, bk = plan["block_q"], plan["block_k"]
        rows = np.arange(S)[:, None]
        cols = np.arange(S)[None, :]
        ok = np.ones((S, S), dtype=bool)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= cols > rows - window
        for x in range(plan["grid"][0]):
            r0 = x * bq
            lo, hi = fa._kv_block_bounds(r0, -(-S // bk), causal, window,
                                         bq, bk)
            hit = np.nonzero(ok[r0:r0 + bq].any(0))[0]
            assert hit.min() >= lo * bk and hit.max() < hi * bk
            assert hit.max() >= (hi - 1) * bk     # the last tile is needed
            assert hit.min() < (lo + 1) * bk      # the first one too


# ------------------------------------------------------------- row 7 -------

DH_SHAPES = [  # (R, V, H)
    (128, 262144, 640),     # the Gemma-3 chunk, batch 4 x 32 rows
    (256, 262144, 640),     # batch 8
    (120, 50257, 1152),     # ragged
    (37, 50257, 1152),      # R 37
    (37, 1001, 200),
    (64, 5000, 640),
    (8, 100, 8),
    (40, 3001, 1520),       # the widest H a multiple of 8 within MAX_HIDDEN
]


def _dh_blocks(plan, R, V, H):
    """The (rows, vocab, columns) ranges of each CTA of `plan`'s grid, as
    csrc/fused_ce_dh_mma.cu derives them from its block index."""
    rt = 16 * plan["row_groups"]
    hp, n_parts = plan["hp"], plan["n_parts"]
    span = plan["tiles_per_slab"] * fc.MMA_VOCAB_TILE
    gx, gy = plan["grid"]
    for slab in range(gy):
        for x in range(gx):
            r0, c0, v0 = (x // n_parts) * rt, (x % n_parts) * hp, slab * span
            yield ((r0, min(R, r0 + rt)), (v0, min(V, v0 + span)),
                   (c0, min(H, c0 + hp)))


def test_dh_plan_constants_match_the_source():
    text = _source("fused_ce_dh_mma.cu")
    assert _constexpr(text, "VT") == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "HP_MAX") == fc.MMA_HP_MAX
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert _constexpr(text, "VG") * 16 == fc.MMA_VOCAB_TILE
    assert "(16 * RG + stages * VT) * ld * elem" in text
    assert "(size_t)16 * RG * hp * sizeof(float)" in text
    assert "const int row0 = (blockIdx.x / n_parts) * RT;" in text
    assert "const int c0 = (blockIdx.x % n_parts) * hp;" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert re.search(r"case 4:\s+return launch<T, 4>", text)
    assert re.search(r"case 2:\s+return launch<T, 2>", text)


@pytest.mark.parametrize("R,V,H", DH_SHAPES)
def test_dh_plan_covers_each_tile_once(R, V, H):
    """Every (row, vocab, column) of dh's work lies in exactly one CTA:
    the CTAs' ranges are the product of a partition of [0, R), one of
    [0, V) in whole 32-column tiles and one of [0, H), each combination
    once."""
    plan = fc.dh_mma_plan(R, V, H, N_SM)
    blocks = list(_dh_blocks(plan, R, V, H))
    gx, gy = plan["grid"]
    assert len(blocks) == gx * gy
    parts = [sorted({b[i] for b in blocks}) for i in range(3)]
    for (lo_hi), n in zip(parts, (R, V, H)):
        edges = [e for rng in lo_hi for e in rng]
        assert edges[0] == 0 and edges[-1] == n
        assert all(a[1] == b[0] for a, b in zip(lo_hi, lo_hi[1:]))
        assert all(a < b for a, b in lo_hi)     # no empty range
    assert len(set(blocks)) == len(blocks)
    assert len(blocks) == len(parts[0]) * len(parts[1]) * len(parts[2])
    for _, (v0, v1), _ in blocks:
        assert v0 % fc.MMA_VOCAB_TILE == 0
    for _, _, (c0, c1) in blocks:
        assert c1 - c0 <= plan["hp"]


@pytest.mark.parametrize("R,V,H", DH_SHAPES)
def test_dh_plan_fits_the_card(R, V, H):
    """hp a multiple of 16 within the accumulators, the parts just enough
    for H, the shared memory within a block's 227 KB, and the grid one
    wave of CTAs (one CTA an SM: the plan's shared memory allows no
    more) where there are slabs to spare."""
    plan = fc.dh_mma_plan(R, V, H, N_SM)
    hp, n_parts = plan["hp"], plan["n_parts"]
    assert hp % 16 == 0 and hp <= fc.MMA_HP_MAX
    assert hp * n_parts >= H > hp * (n_parts - 1)
    assert n_parts == -(-H // fc.MMA_HP_MAX)
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    assert plan["stages"] in (1, 2, 3) and plan["row_groups"] in (2, 4)
    gx, gy = plan["grid"]
    n_vt = -(-V // fc.MMA_VOCAB_TILE)
    assert (gy - 1) * plan["tiles_per_slab"] < n_vt \
        <= gy * plan["tiles_per_slab"]
    if n_vt >= N_SM:
        assert gx * gy <= N_SM


def test_dh_plan_at_the_gemma_chunk():
    """R 128, V 262,144, H 640: 64-row tiles, two parts of 320 columns,
    three W buffers, 33 slabs: 132 CTAs, four of them a slab."""
    plan = fc.dh_mma_plan(128, 262144, 640, N_SM)
    assert (plan["row_groups"], plan["stages"], plan["hp"],
            plan["n_parts"], plan["n_slabs"]) == (4, 3, 320, 2, 33)
    assert plan["grid"] == (4, 33)


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_dh_plan_refuses_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.dh_mma_plan(16, 100, H, N_SM)


# ------------------------------------------------------------- row 8 -------

DW_SHAPES = [  # (R, V, H)
    (128, 262144, 640),     # the Gemma-3 chunk: h resident, one part
    (256, 262144, 640),     # batch 8: two row chunks
    (120, 50257, 1152),     # ragged: two row chunks, two parts
    (37, 50257, 1152),      # R 37
    (37, 1001, 200),
    (64, 5000, 640),
    (8, 100, 8),
    (40, 3001, 1520),       # the widest H a multiple of 8 within MAX_HIDDEN
]


def test_dw_plan_constants_match_the_source():
    text = _source("fused_ce_dw_mma.cu")
    assert _constexpr(text, "VT") == fc.DW_VOCAB_TILE
    assert _constexpr(text, "HP_MAX") == fc.DW_HP_MAX
    assert _constexpr(text, "WC_MAX") * 8 == fc.DW_HP_MAX
    assert _constexpr(text, "WARPS") == 8
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert "((RC + VT) * ld + (size_t)VT * (RC + 8)) * elem + " \
           "(size_t)RC * 16" in text
    assert "const int tile = item / n_parts;" in text
    assert "(item % n_parts) * hp + warp * wc" in text
    assert "const int wc = hp / 8;" in text
    assert "item < n_items; item += gridDim.x" in text
    assert "hp % 128 != 0" in text
    for rc in fc.DW_ROW_CHUNKS:
        assert re.search(rf"case {rc}:\s+return launch<T, {rc}>", text)


@pytest.mark.parametrize("R,V,H", DW_SHAPES)
def test_dw_plan_covers_each_item_once(R, V, H):
    """The persistent CTAs' grid-stride walk visits every (32-row vocab
    tile, H part) once; the parts partition [0, H) and the row chunks
    [0, R)."""
    plan = fc.dw_mma_plan(R, V, H, N_SM)
    n_vt = -(-V // fc.DW_VOCAB_TILE)
    assert plan["n_items"] == n_vt * plan["n_parts"]
    seen = np.zeros(plan["n_items"], dtype=np.int64)
    for cta in range(plan["n_ctas"]):
        seen[cta::plan["n_ctas"]] += 1
    assert (seen == 1).all()
    hp, n_parts = plan["hp"], plan["n_parts"]
    cols = np.zeros(H, dtype=np.int64)
    for p in range(n_parts):
        assert p * hp < H                   # no empty part
        cols[p * hp:(p + 1) * hp] += 1
    assert (cols == 1).all()
    rc = plan["row_chunk"]
    assert plan["n_chunks"] == -(-R // rc)
    assert (plan["n_chunks"] - 1) * rc < R <= plan["n_chunks"] * rc


@pytest.mark.parametrize("R,V,H", DW_SHAPES)
def test_dw_plan_fits_the_card(R, V, H):
    """hp a multiple of 128 (eight warps of 16-column multiples) within
    the accumulators, just enough parts, shared memory within a block's
    227 KB, one CTA an SM at most, and the smallest row chunk that holds
    every row when it fits."""
    plan = fc.dw_mma_plan(R, V, H, N_SM)
    hp, n_parts = plan["hp"], plan["n_parts"]
    assert hp % 128 == 0 and hp <= fc.DW_HP_MAX
    assert hp * n_parts >= H > hp * (n_parts - 1)
    assert n_parts == -(-H // fc.DW_HP_MAX)
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    assert plan["row_chunk"] in fc.DW_ROW_CHUNKS
    assert plan["n_ctas"] == min(N_SM, plan["n_items"])
    ld = -(-H // 16) * 16 + 8
    smem = ((plan["row_chunk"] + 32) * ld + 32 * (plan["row_chunk"] + 8)) \
        * 2 + plan["row_chunk"] * 16
    assert plan["smem_bytes"] == smem
    smaller = [rc for rc in fc.DW_ROW_CHUNKS if R <= rc < plan["row_chunk"]]
    assert not smaller


def test_dw_plan_at_the_gemma_chunk():
    """R 128, V 262,144, H 640: all of h resident (128 rows), one part of
    640 columns, 132 persistent CTAs over 8,192 vocab tiles."""
    plan = fc.dw_mma_plan(128, 262144, 640, N_SM)
    assert (plan["row_chunk"], plan["n_chunks"], plan["hp"],
            plan["n_parts"], plan["n_ctas"], plan["n_items"]) == \
        (128, 1, 640, 1, 132, 8192)
    assert plan["smem_bytes"] == 218112


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_dw_plan_refuses_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.dw_mma_plan(16, 100, H, N_SM)


@pytest.mark.parametrize("R,V,H", [(128, 300, 640), (37, 1001, 200),
                                   (120, 2000, 1152), (8, 70, 8)])
def test_dw_stores_write_each_element_once_from_its_fragment(R, V, H):
    """csrc/fused_ce_dw_mma.cu's store loop, replayed: each lane of a
    quad trades half of its C fragments with its neighbour and writes 4
    columns; over every item, warp, m-tile, n-tile pair, half and lane
    each dW element is written exactly once, with the value of the C
    fragment element that holds its (vocab row, column)."""
    plan = fc.dw_mma_plan(R, V, H, N_SM)
    hp, n_parts = plan["hp"], plan["n_parts"]
    wc, nw = hp // 8, fc.DW_HP_MAX // 8 // 8
    hits = np.zeros((V, H), dtype=np.int64)
    for item, m in itertools.product(range(plan["n_items"]), range(2)):
        tile, part = divmod(item, n_parts)
        for warp in range(8):
            cw = part * hp + warp * wc
            ncols = min(wc, H - cw)

            def frag(n, e, g, t):   # (row in the tile, column) it holds
                return (m * 16 + g + 8 * (e >> 1), cw + n * 8 + 2 * t
                        + (e & 1))
            for n in range(0, nw, 2):
                for hi in range(2):
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        odd, pt = t & 1, t ^ 1
                        if odd:   # partner's a (n-tile n) is not taken
                            vals = [frag(n + 1, 2 * hi, g, pt),
                                    frag(n + 1, 2 * hi + 1, g, pt),
                                    frag(n + 1, 2 * hi, g, t),
                                    frag(n + 1, 2 * hi + 1, g, t)]
                            col = (n + 1) * 8 + 2 * t - 2
                        else:
                            vals = [frag(n, 2 * hi, g, t),
                                    frag(n, 2 * hi + 1, g, t),
                                    frag(n, 2 * hi, g, pt),
                                    frag(n, 2 * hi + 1, g, pt)]
                            col = n * 8 + 2 * t
                        v = tile * 32 + m * 16 + g + 8 * hi
                        if v < V and col < ncols:
                            assert col % 4 == 0   # 16-byte aligned
                            for k, (row, c) in enumerate(vals):
                                assert (tile * 32 + row, c) == \
                                    (v, cw + col + k)
                                hits[v, cw + col + k] += 1
    assert (hits == 1).all()


# ------------------------------------------------------------ row 10 -------

DH_LORA_SHAPES = [  # (R, V, H, r)
    (128, 262144, 640, 8),      # the Gemma-3 chunk with the head adapter
    (128, 262144, 640, 1),
    (128, 262144, 640, 4),
    (128, 50257, 640, 128),     # the largest rank
    (256, 262144, 640, 8),      # batch 8
    (120, 50257, 1000, 4),      # ragged
    (37, 50257, 1152, 8),       # R 37, H 1,152
    (37, 50257, 1152, 128),
    (40, 3001, 1392, 128),      # H + r at MAX_HIDDEN's edge
    (8, 100, 8, 5),
]


def test_dh_lora_plan_constants_match_the_source():
    text = _source("fused_ce_dh_lora_mma.cu")
    assert _constexpr(text, "VT") == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "HP_MAX") == fc.DH_LORA_HP_MAX
    assert _constexpr(text, "HW_MAX") * 2 == fc.DH_LORA_HP_MAX
    assert _constexpr(text, "MAX_RANK") == fc.MAX_RANK
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert _constexpr(text, "VG") * 16 == fc.MMA_VOCAB_TILE
    assert "return (size_t)RG * VG * h16_of(r) * 64;" in text
    assert "((16 * RG + stages * VT) * (ld + ldr) + 16 * RG * (VT + 8)) " \
           "* elem" in text
    assert "const int cw = c0 + vg * (hp / 2);" in text
    assert "hp % 32 != 0" in text
    assert "const int row0 = (blockIdx.x / n_parts) * RT;" in text
    assert "const int c0 = (blockIdx.x % n_parts) * hp;" in text
    assert "const bool with_dxa = c0 == 0;" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert re.search(r"case 4:\s+return launch<T, 4>", text)
    assert re.search(r"case 2:\s+return launch<T, 2>", text)


@pytest.mark.parametrize("R,V,H,r", DH_LORA_SHAPES)
def test_dh_lora_plan_covers_each_tile_once(R, V, H, r):
    """Row 10's CTAs partition (rows, vocab, dh columns) as row 7's do,
    and exactly one CTA of each (row tile, slab), the H-part-0 one, forms
    dxa: every (row, vocab) pair feeds dxa once."""
    plan = fc.dh_lora_mma_plan(R, V, H, r, N_SM)
    blocks = list(_dh_blocks(plan, R, V, H))
    gx, gy = plan["grid"]
    assert len(blocks) == gx * gy == len(set(blocks))
    parts = [sorted({b[i] for b in blocks}) for i in range(3)]
    for lo_hi, n in zip(parts, (R, V, H)):
        edges = [e for rng in lo_hi for e in rng]
        assert edges[0] == 0 and edges[-1] == n
        assert all(a[1] == b[0] for a, b in zip(lo_hi, lo_hi[1:]))
    dxa = np.zeros((R, -(-V // fc.MMA_VOCAB_TILE)), dtype=np.int64)
    for (r0, r1), (v0, v1), (c0, _) in blocks:
        if c0 == 0:
            dxa[r0:r1, v0 // 32:-(-v1 // 32)] += 1
    assert (dxa == 1).all()


@pytest.mark.parametrize("R,V,H,r", DH_LORA_SHAPES)
def test_dh_lora_plan_fits_the_card(R, V, H, r):
    """Parts of up to 640 columns, a multiple of 32, at every rank (the
    dxa accumulators live in shared memory, not registers), the shared
    memory with xa, the bt tiles, the coef tile and the dxa accumulators
    within a block's 227 KB, and one wave of CTAs."""
    plan = fc.dh_lora_mma_plan(R, V, H, r, N_SM)
    hp, n_parts = plan["hp"], plan["n_parts"]
    assert hp % 32 == 0 and hp <= fc.DH_LORA_HP_MAX
    assert n_parts == -(-H // fc.DH_LORA_HP_MAX)
    assert hp * n_parts >= H > hp * (n_parts - 1)
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    rg, st = plan["row_groups"], plan["stages"]
    r16 = -(-r // 16) * 16
    ld = -(-H // 16) * 16 + 8
    assert plan["smem_bytes"] == 2 * rg * r16 * 64 + (
        (16 * rg + st * 32) * (ld + r16 + 8) + 16 * rg * 40) * 2
    assert st in (1, 2, 3) and rg in (2, 4)
    gx, gy = plan["grid"]
    n_vt = -(-V // fc.MMA_VOCAB_TILE)
    assert (gy - 1) * plan["tiles_per_slab"] < n_vt \
        <= gy * plan["tiles_per_slab"]
    if n_vt >= N_SM:
        assert gx * gy <= N_SM


def test_dh_lora_plan_at_the_gemma_chunk():
    """R 128, V 262,144, H 640, r 8: 64-row tiles, one part of 640 (each
    logits tile formed once, where row 7 forms it for each of two
    parts), three buffers, 66 slabs: 132 CTAs; rank 128 takes 32-row
    tiles and two buffers."""
    plan = fc.dh_lora_mma_plan(128, 262144, 640, 8, N_SM)
    assert (plan["row_groups"], plan["stages"], plan["hp"],
            plan["n_parts"], plan["n_slabs"]) == (4, 3, 640, 1, 66)
    assert plan["grid"] == (2, 66) and plan["smem_bytes"] == 228352
    big = fc.dh_lora_mma_plan(128, 262144, 640, 128, N_SM)
    assert (big["row_groups"], big["stages"], big["hp"]) == (2, 2, 640)


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_dh_lora_plan_refuses_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.dh_lora_mma_plan(16, 100, H, 8, N_SM)


@pytest.mark.parametrize("r", [0, -1, 129])
def test_dh_lora_plan_refuses_a_rank_out_of_range(r):
    with pytest.raises(ValueError, match="rank"):
        fc.dh_lora_mma_plan(16, 100, 64, r, N_SM)
