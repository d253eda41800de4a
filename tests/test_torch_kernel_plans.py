"""The launch plans of the tensor-core kernels (row 1, the flash-attention
forward, and row 7, the fused CE dh), on the CPU: the pure-Python plans
the wrappers pass to the card (`ops/flash_attention.fwd_plan` with the
key-tile bounds `_kv_block_bounds`; `ops/fused_ce.dh_mma_plan`) cover
every (query block, head, batch) and every (row tile, vocab slab, H
part) exactly once, visit every attendable key, fit the card's shared memory,
and agree with the constants of the CUDA sources; and the dtype picks the
library: bf16 / f16 the `_mma` sources, f32 the FMA ones. No card
needed."""

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

@pytest.mark.parametrize("dtype,fwd,dh", [
    (torch.bfloat16, ("flash_attention_fwd_mma",
                      "mft_flash_attention_fwd_mma"),
     ("fused_ce_dh_mma", "mft_fused_ce_dh_mma")),
    (torch.float16, ("flash_attention_fwd_mma",
                     "mft_flash_attention_fwd_mma"),
     ("fused_ce_dh_mma", "mft_fused_ce_dh_mma")),
    (torch.float32, ("flash_attention_fwd", "mft_flash_attention_fwd"),
     ("fused_ce", "mft_fused_ce_dh")),
])
def test_dtype_picks_the_library(dtype, fwd, dh):
    assert fa.fwd_library(dtype) == fwd
    assert fc.dh_library(dtype) == dh
    # each symbol is exported by its source, with a C interface
    for lib, sym in (fwd, dh):
        assert f'extern "C" int {sym}(' in _source(f"{lib}.cu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_dtype_without_a_kernel_raises(dtype):
    with pytest.raises(ValueError, match="dtype"):
        fa.fwd_library(dtype)
    with pytest.raises(ValueError, match="dtype"):
        fc.dh_library(dtype)


def test_fma_sources_keep_only_their_f32_instantiation():
    """The 16-bit cases left flash_attention_fwd.cu and the base dh entry
    of fused_ce.cu (row 10 keeps its 16-bit kernels there)."""
    fwd = _source("flash_attention_fwd.cu")
    entry = fwd[fwd.index('extern "C" int mft_flash_attention_fwd('):]
    assert "dispatch_d<float>" in entry
    assert "__nv_bfloat16" not in entry and "__half" not in entry
    ce = _source("fused_ce.cu")
    entry = ce[ce.index('extern "C" int mft_fused_ce_dh('):
               ce.index('extern "C" int mft_fused_ce_dw(')]
    assert "launch_dh<float, false>" in entry and "dtype != 0" in entry
    assert "by_dtype" not in entry


def test_tensor_core_sources_use_mma_sync():
    for name in ("flash_attention_fwd_mma.cu", "fused_ce_dh_mma.cu"):
        text = _source(name)
        assert "mma_16816<T>" in text and "ldmatrix_x4" in text
        assert "cp_async_16" in text
    assert "mma.sync.aligned.m16n8k16" in _source("tensor_core.cuh")


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
