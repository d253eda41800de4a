"""The launch plans of the tensor-core kernels (row 1, the flash-attention
forward; row 2, its merged backward; rows 6, 7, 8, 9, 10 and 11, the fused
CE forward, dh, dW, head-adapter forward, dh + dxa and dbt), on the CPU:
the pure-Python plans the wrappers pass to the card
(`ops/flash_attention.fwd_plan` with the key-tile bounds
`_kv_block_bounds`, `bwd_plan` with the q-block bounds `_q_block_bounds`;
`ops/fused_ce.fwd_mma_plan`, `dh_mma_plan`, with a rank for row 10,
`dw_mma_plan`, `fwd_lora_mma_plan` and `dbt_mma_plan`) cover every
(query block, head, batch), every (key block, head, batch), every (row
tile, vocab slab, H part) and every (vocab tile, H part) exactly once,
visit every attendable (row, key) pair, fit the card's shared memory,
and agree with
the constants of the CUDA sources; row 8's stores write each dW element
once, from the fragment that holds it; row 2's transposed fragment map,
replayed with ldmatrix and mma.sync emulated in numpy, computes the
plain version's dq, dk and dv, and rows 9 and 11's fragment maps their
plain versions' (lse, gold) and dbt; row 5's vector kernel
(`ops/lora_fused.epilogue_vec_plan`) covers every (row, column vector)
once with each warp on neighbouring vectors and fills the card; row 13's
flash-decoding split (`ops/decode_attention.decode_mma_plan`) covers
every key tile once, and its fragment map, replayed, computes the plain
version's ctx; row 12's chunk split (`ops/decode_attention.paged_plan`)
covers every logical column, so every live page's rows, once, and its
lane map loads each K and V element of a chunk once, a row's lanes on
contiguous bytes; and the dtype picks the library: bf16 /
f16 the `_mma` (and `_vec`) sources, f32 the 3xTF32 `_tf32` ones for rows
1-2 and 6-11 (row 11 dbt only), `lora_epilogue_vec_f32.cu` for row 5 (its
plan at 4-byte elements too) and the FMA flash-decoding splits for rows
12-13, whose `paged_f32_plan` and `decode_f32_plan` cover every column
once, fit the card, split the paths' shapes as their sources' notes say,
refuse what the kernels do not take and admit every f32 shape the first
versions took; the 3xTF32 plans, tiles and shared memory
too: rows 7 and 10's `dh_tf32_plan` and `dh_lora_tf32_plan` cover every
(row tile, vocab slab) once and every output column once, rows 6, 9 and
11's `fwd_tf32_plan`, `fwd_lora_tf32_plan` and `dbt_tf32_plan` every
(row tile, vocab slab) once, row 8's `dw_tf32_plan` every (vocab tile,
H part) once however many clusters the card holds; they fit the card at
every f32 shape the card checks run and refuse what they do not take.
No card needed."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from mobilefinetuner_tpu_torch.ops import decode_attention as da
from mobilefinetuner_tpu_torch.ops import flash_attention as fa
from mobilefinetuner_tpu_torch.ops import fused_ce as fc
from mobilefinetuner_tpu_torch.ops import lora_fused as lf

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
    "bwd": ("flash_attention_bwd_merged_mma",
            "mft_flash_attention_bwd_merged_mma"),
    "ce_fwd": ("fused_ce_fwd_mma", "mft_fused_ce_fwd_mma"),
    "dh": ("fused_ce_dh_mma", "mft_fused_ce_dh_mma"),
    "dw": ("fused_ce_dw_mma", "mft_fused_ce_dw_mma"),
    "dh_lora": ("fused_ce_dh_lora_mma", "mft_fused_ce_dh_lora_mma"),
    "ce_fwd_lora": ("fused_ce_fwd_lora_mma", "mft_fused_ce_fwd_lora_mma"),
    "dbt": ("fused_ce_dbt_mma", "mft_fused_ce_dbt_mma"),
    "epi": ("lora_epilogue_vec", "mft_lora_epilogue_vec"),
    "decode": ("decode_attention_mma", "mft_decode_attention_mma"),
    "paged": ("paged_decode_attention_vec",
              "mft_paged_decode_attention_vec")}
FMA_LIBS = {  # the f32 kernels': rows 1-2, 6-11 in 3xTF32 (row 11 dbt
    # only), row 5 on 16-byte vectors, rows 12-13 flash-decoding splits
    "fwd": ("flash_attention_fwd_tf32", "mft_flash_attention_fwd_tf32"),
    "bwd": ("flash_attention_bwd_merged_tf32",
            "mft_flash_attention_bwd_merged_tf32"),
    "ce_fwd": ("fused_ce_fwd_tf32", "mft_fused_ce_fwd_tf32"),
    "dh": ("fused_ce_dh_tf32", "mft_fused_ce_dh_tf32"),
    "dw": ("fused_ce_dw_tf32", "mft_fused_ce_dw_tf32"),
    "dh_lora": ("fused_ce_dh_lora_tf32", "mft_fused_ce_dh_lora_tf32"),
    "ce_fwd_lora": ("fused_ce_fwd_lora_tf32", "mft_fused_ce_fwd_lora_tf32"),
    "dbt": ("fused_ce_dbt_tf32", "mft_fused_ce_dbt_tf32"),
    "epi": ("lora_epilogue_vec_f32", "mft_lora_epilogue_vec_f32"),
    "decode": ("decode_attention_split_f32",
               "mft_decode_attention_split_f32"),
    "paged": ("paged_decode_attention_vec_f32",
              "mft_paged_decode_attention_vec_f32")}
ROUTES = {"fwd": fa.fwd_library, "dh": fc.dh_library, "dw": fc.dw_library,
          "dh_lora": fc.dh_lora_library, "bwd": fa.bwd_library,
          "ce_fwd": fc.fwd_library, "ce_fwd_lora": fc.fwd_lora_library,
          "dbt": fc.dbt_library, "epi": lf.epilogue_library,
          "decode": da.decode_library, "paged": da.paged_library}


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


@pytest.mark.parametrize("key", ["dw", "dh_lora", "bwd", "ce_fwd",
                                 "ce_fwd_lora", "dbt", "epi", "decode",
                                 "paged"])
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
    """The 16-bit cases left flash_attention_fwd.cu, the merged backward
    of flash_attention_bwd_merged.cu and the base forward, dh, dW and
    head-adapter forward and dh entries of fused_ce.cu; row 11's entry
    keeps every dtype for its dW + dbt mode and refuses 16-bit operands in
    its dbt-only mode (dw null), its template untouched, and the split
    backward keeps every dtype."""
    for name, sym in (("flash_attention_fwd.cu", "mft_flash_attention_fwd"),
                      ("flash_attention_bwd_merged.cu",
                       "mft_flash_attention_bwd_merged")):
        entry = _entry(_source(name), sym)
        assert "dispatch_d<float>" in entry
        assert "__nv_bfloat16" not in entry and "__half" not in entry
    assert "dtype != 0" in _entry(_source("flash_attention_bwd_merged.cu"),
                                  "mft_flash_attention_bwd_merged")
    split = _source("flash_attention_bwd_split.cu")
    for dt in ("float", "__nv_bfloat16", "__half"):
        assert f"dispatch_d<DQ, {dt}>" in split
    ce = _source("fused_ce.cu")
    for sym, launch in (("mft_fused_ce_fwd", "launch_fwd<float, false>"),
                        ("mft_fused_ce_dh", "launch_dh<float, false>"),
                        ("mft_fused_ce_dw", "launch_dw<float>"),
                        ("mft_fused_ce_dh_lora", "launch_dh<float, true>"),
                        ("mft_fused_ce_fwd_lora", "launch_fwd<float, true>")):
        entry = _entry(ce, sym)
        assert launch in entry and "dtype != 0" in entry
        assert "by_dtype" not in entry
    dw_lora = _entry(ce, "mft_fused_ce_dw_lora")
    assert "by_dtype" in dw_lora and "launch_dw<ELEM(tag)>" in dw_lora
    assert "(dw == nullptr && dtype != 0)" in dw_lora
    assert "launch_fwd<ELEM(tag)" not in ce


def test_tf32_sources_use_3xtf32_mma_sync():
    """Rows 1-2's f32 sources run m16n8k8 TF32 mma.sync through
    tensor_core_tf32.cuh: cvt.rna splits, three products a k-step (lo.hi,
    hi.lo, hi.hi), fragments by ldmatrix, tiles by 16-byte cp.async.
    Rows 7 and 10's split by the header's integer rounding (cvt.rna's
    bits), load h and W fragments by ldmatrix and W's transposed B
    fragments by 32-bit loads, and take the same three products a k-step
    (lo.hi, hi.lo, hi.hi), by mma_3xtf32 or term by term. Rows 6 and 11
    (dbt only) split with a raw lo (hi by the integer rounding, lo = x -
    hi, whose top 19 bits the mma.sync reads), load W's A and h's B
    fragments by ldmatrix and take the same three terms in the same
    order, straight-line around each mma.sync; row 9's f32 source is row
    6's loop on row 11's widened row and keeps all of that."""
    hdr = _source("tensor_core_tf32.cuh")
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in hdr
    assert "cvt.rna.tf32.f32" in hdr
    body = hdr[hdr.index("void mma_3xtf32("):]
    body = body[:body.index("}")]
    assert body.count("mma_1688_tf32(") == 3
    assert ("mma_1688_tf32(c, al, bh0, bh1);" in body
            and "mma_1688_tf32(c, ah, bl0, bl1);" in body
            and "mma_1688_tf32(c, ah, bh0, bh1);" in body)
    assert "cp_async_16" in hdr
    for name in ("flash_attention_fwd_tf32.cu",
                 "flash_attention_bwd_merged_tf32.cu"):
        text = _source(name)
        assert '#include "tensor_core_tf32.cuh"' in text
        assert "mma_3xtf32(" in text and "ldmatrix_x4(" in text
        assert "m16n8k8" in text
        assert "stage_rows_f32<" in text and "split_rows<" in text
        assert "mma_16816" not in text       # no 16-bit products
    body = hdr[hdr.index("uint32_t tf32_round_bits("):]
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in \
        body[:body.index("}")]
    for name in ("fused_ce_dh_tf32.cu", "fused_ce_dh_lora_tf32.cu"):
        text = _source(name)
        assert '#include "tensor_core_tf32.cuh"' in text
        assert "m16n8k8" in text and "ldmatrix_x4(" in text
        assert "mma_3xtf32(" in text and "cp_async_16(" in text
        assert "split_tf32_bits(" in text and "split_tf32(" not in text
        assert "mma_16816" not in text and "ldmatrix_x4_trans" not in text
        # the logits' k-step issues the three terms, lo.hi and hi.lo into
        # one accumulator, hi.hi into another
        i = text.index("mma_1688_tf32(sm[j], al, bh[2 * j], bh[2 * j + 1]);")
        j = text.index("mma_1688_tf32(hh[j], ah, bh[2 * j], bh[2 * j + 1]);")
        k = text.index("mma_1688_tf32(sm[j], ah, bl[2 * j], bl[2 * j + 1]);")
        assert i < j < k
    body = hdr[hdr.index("void split_tf32_raw_lo("):]
    body = body[:body.index("}")]
    assert "hi = tf32_round_bits(x);" in body
    assert "lo = __float_as_uint(x - __uint_as_float(hi));" in body
    for name in ("fused_ce_fwd_tf32.cu", "fused_ce_dbt_tf32.cu",
                 "fused_ce_fwd_lora_tf32.cu"):
        text = _source(name)
        assert '#include "tensor_core_tf32.cuh"' in text
        assert "m16n8k8" in text and "ldmatrix_x4(" in text
        assert "cp_async_16(" in text and "split_tf32_raw_lo(" in text
        assert "split_tf32(" not in text and "split_tf32_bits(" not in text
        assert "mma_16816" not in text and "ldmatrix_x4_trans" not in text
        i = text.index("mma_1688_tf32(sm[j], al, bh[j / 2][2 * (j % 2)],")
        j = text.index("mma_1688_tf32(hh[j], ah, bh[j / 2][2 * (j % 2)],")
        k = text.index("mma_1688_tf32(sm[j], ah, bl[j / 2][2 * (j % 2)],")
        assert i < j < k
        # no branch between a k-step's loads and its products
        chunk = text[text.index("void logits_chunk("):]
        chunk = chunk[:chunk.index("\n}\n")]
        assert chunk.count("if (") == 1 and "if (ks + 1 < NKS)" in chunk
    assert "mma_3xtf32(" in _source("fused_ce_dbt_tf32.cu")
    # row 9: the widened row's rank columns 4 bytes at a time, no atomics
    text = _source("fused_ce_fwd_lora_tf32.cu")
    assert "cp_async_4(" in text and "atomicAdd" not in text
    assert "const int HX = hx_of(H, rk), LDH = HX + 4;" in text


def test_tensor_core_sources_use_mma_sync():
    for name in ("flash_attention_fwd_mma.cu", "fused_ce_dh_mma.cu",
                 "fused_ce_dw_mma.cu", "fused_ce_dh_lora_mma.cu",
                 "flash_attention_bwd_merged_mma.cu",
                 "fused_ce_fwd_mma.cu", "fused_ce_fwd_lora_mma.cu",
                 "fused_ce_dbt_mma.cu"):
        text = _source(name)
        assert "mma_16816<T>" in text and "ldmatrix_x4" in text
        assert "ldmatrix_x4_trans" in text or name.startswith("flash") \
            or name.startswith("fused_ce_fwd")   # no .trans product
        assert "cp_async_16" in text
        assert '#include "tensor_core.cuh"' in text
    assert "mma.sync.aligned.m16n8k16" in _source("tensor_core.cuh")


def test_new_sources_are_built_and_call_no_library():
    from mobilefinetuner_tpu_torch.kernels import build
    for name in ("fused_ce_dw_mma", "fused_ce_dh_lora_mma",
                 "flash_attention_bwd_merged_mma", "fused_ce_fwd_mma",
                 "fused_ce_fwd_lora_mma", "fused_ce_dbt_mma",
                 "flash_attention_fwd_tf32",
                 "flash_attention_bwd_merged_tf32", "fused_ce_dh_tf32",
                 "fused_ce_dh_lora_tf32", "fused_ce_fwd_tf32",
                 "fused_ce_dbt_tf32", "fused_ce_fwd_lora_tf32",
                 "fused_ce_dw_tf32", "lora_epilogue_vec_f32",
                 "paged_decode_attention_vec_f32",
                 "decode_attention_split_f32"):
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
    (2, 4, 200, 64, torch.float32),     # the 3xTF32 kernel
    (16, 12, 512, 64, torch.float32),   # eval_mmlu's GPT-2 bucket 512
    (6, 12, 128, 64, torch.float32),    # the multi-tenant f32 run
    (2, 8, 90, 128, torch.float32),     # ragged S at D 128
    (16, 4, 256, 256, torch.float32),   # eval_mmlu's Gemma bucket 256
    (2, 8, 200, 256, torch.float32),    # ragged S at D 256
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
    # the f32 (3xTF32) kernel
    tf32 = _source("flash_attention_fwd_tf32.cu")
    assert _constexpr(tf32, "THREADS") == 128
    for line in (
            "static constexpr int DS = D == 256 ? 2 : 1;",
            "static constexpr int BQ = 16 * (4 / DS);",
            "static constexpr int BK = D == 256 ? 16 : 32;",
            "static constexpr int LD = D + 4;",
            "static constexpr int STAGES = 2;",
            "((size_t)2 * BQ * LD + (size_t)4 * STAGES * BK * LD + "
            "STAGES * BK) *",
            "min(nK, (row0 + BQ - 1) / BK + 1)",
            "floor_div(row0 - window + 1, BK)",
            "dim3 grid((S + Cfg<D>::BQ - 1) / Cfg<D>::BQ, Hq, B);"):
        assert line in tf32, line
    assert fa.TF32_STAGES == 2
    for D, (bq, bk, ds) in fa.FWD_TF32_TILES.items():
        plan = fa.fwd_plan(1, 1, 64, D, torch.float32)
        assert (plan["block_q"], plan["block_k"]) == (bq, bk)
        assert bq == 16 * (4 // ds) and ds == (2 if D == 256 else 1)
        assert bk == (16 if D == 256 else 32)


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
    64-row blocks' 64 (132 SMs); the f32 kernel's 32-row blocks at D 256
    too."""
    nx, ny, nz = fa.fwd_plan(4, 4, 256, 256, torch.bfloat16)["grid"]
    assert nx * ny * nz == 128
    nx, ny, nz = fa.fwd_plan(4, 4, 256, 256, torch.float32)["grid"]
    assert nx * ny * nz == 128


@pytest.mark.parametrize("B,Hq,S,D,dtype", [
    c for c in FLASH_SHAPES if c[-1] == torch.float32])
def test_flash_tf32_plan_fits_the_card(B, Hq, S, D, dtype):
    """The f32 entries take the 3xTF32 kernel's plan: Q split into hi / lo
    planes and a ring of two K / V tiles of four planes each, rows D + 4
    floats apart, within the 232,448 bytes a block may use (104,704 /
    203,008 / 199,808 at D 64 / 128 / 256)."""
    plan = fa.fwd_plan(B, Hq, S, D, dtype)
    bq, bk, _ = fa.FWD_TF32_TILES[D]
    assert (plan["block_q"], plan["block_k"]) == (bq, bk)
    assert plan["smem_bytes"] == 4 * (2 * bq * (D + 4)
                                      + 8 * bk * (D + 4) + 2 * bk)
    assert plan["smem_bytes"] <= fc.SMEM_MAX == 232448
    assert plan["smem_bytes"] == {64: 104704, 128: 203008,
                                  256: 199808}[D]


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


DW_TF32_SHAPES = [  # (R, V, H)
    (128, 262144, 640),     # the Gemma chunk: two parts of 320
    (120, 50257, 1152),     # chip_smoke's ragged_f32: four parts of 288
    (37, 50257, 1152),      # a ragged 64-row chunk
    (150, 20011, 640),      # three 64-row chunks
    (19, 1001, 136),        # one part, a narrow last W chunk
    (40, 3001, 1520),       # eight parts: the widest H within MAX_HIDDEN
    (8, 100, 8),
]


def test_dw_tf32_plan_constants_match_the_source():
    """The plan's constants and shared memory are the source's; the
    source is a cluster kernel whose partial logits meet through
    distributed shared memory, with no atomics, and streaming stores."""
    text = _source("fused_ce_dw_tf32.cu")
    assert _constexpr(text, "HP_MAX") == fc.DW_TF32_HP_MAX
    assert _constexpr(text, "KC") == fc.TF32_W_CHUNK
    assert _constexpr(text, "MAX_PARTS") == fc.DW_TF32_PARTS[-1]
    assert _constexpr(text, "ROWS_WHOLE") == fc.DW_TF32_ROWS_WHOLE
    assert _constexpr(text, "STAGES") == fc.DW_TF32_STAGES
    assert _constexpr(text, "WARPS") == 8
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert "((size_t)RC * (hp + 4) + (size_t)16 * VG * RC + (size_t)RC * 4" \
        " +\n          (size_t)STAGES * 16 * VG * LDW) *" in text
    assert "rc == ROWS_WHOLE && R <= ROWS_WHOLE) MFT_LAUNCH(4, 8);" in text
    assert "if (vg == 4 && rc == 64) MFT_LAUNCH(4, 4);" in text
    for s in ("cudaLaunchAttributeClusterDimension", "map_shared_rank(",
              "barrier.cluster.arrive.release.aligned",
              "barrier.cluster.wait.acquire.aligned",
              "cudaOccupancyMaxActiveClusters", "__stcs(",
              "split_tf32_raw_lo(", "ldmatrix_x4(", "m16n8k8"):
        assert s in text
    assert "atomicAdd" not in text and "wgmma" not in text.split("#include")[1]
    # the dW product's three terms, issued term by term over NG n-tiles
    i = text.index("mma_1688_tf32(acc[n0 + i], al, bh[i][0], bh[i][1]);")
    j = text.index("mma_1688_tf32(acc[n0 + i], ah, bl[i][0], bl[i][1]);")
    k = text.index("mma_1688_tf32(acc[n0 + i], ah, bh[i][0], bh[i][1]);")
    assert i < j < k
    assert fc.DW_TF32_HP_MAX // 16 % _constexpr(text, "NG") == 0


def _dw_tf32_smem(plan):
    vt, rc, hp = 16 * plan["vocab_groups"], plan["row_chunk"], plan["hp"]
    return (rc * (hp + 4) + vt * rc + rc * 4
            + fc.DW_TF32_STAGES * vt * (fc.TF32_W_CHUNK + 4)) * 4


@pytest.mark.parametrize("R,V,H", DW_TF32_SHAPES)
def test_dw_tf32_plan_covers_each_tile_and_part_once(R, V, H):
    """The clusters' grid-stride walk gives every (64-row vocab tile, H
    part) one CTA, at the plan's cluster count and at any fewer (the
    launch cuts them to what the card holds); the parts partition [0, H)
    in whole n-tiles of both warps' halves, the row chunks [0, R)."""
    plan = fc.dw_tf32_plan(R, V, H, N_SM)
    n_parts, hp = plan["n_parts"], plan["hp"]
    n_vt = -(-V // (16 * plan["vocab_groups"]))
    for n_clusters in sorted({plan["n_clusters"], 1,
                              max(1, plan["n_clusters"] - 3)}):
        seen = np.zeros((n_vt, n_parts), dtype=np.int64)
        for c in range(n_clusters):
            for p in range(n_parts):
                seen[c::n_clusters, p] += 1
        assert (seen == 1).all()
    assert hp % 16 == 0            # whole n-tiles in both warps' halves
    cols = np.zeros(H, dtype=np.int64)
    for p in range(n_parts):
        assert p * hp < H                   # no empty part
        cols[p * hp:(p + 1) * hp] += 1
    assert (cols == 1).all()
    rc = plan["row_chunk"]
    assert plan["n_chunks"] == -(-R // rc)
    assert (plan["n_chunks"] - 1) * rc < R <= plan["n_chunks"] * rc
    assert (rc == 128) == (64 < R <= 128)


@pytest.mark.parametrize("R,V,H", DW_TF32_SHAPES)
def test_dw_tf32_plan_fits_the_card(R, V, H):
    """The fewest parts whose columns fit HP_MAX, a cluster the portable
    size at most, shared memory within a block's 232,448 bytes, at most
    one cluster a pair of multiprocessors and no more than the tiles."""
    plan = fc.dw_tf32_plan(R, V, H, N_SM)
    n_parts, hp = plan["n_parts"], plan["hp"]
    assert n_parts in fc.DW_TF32_PARTS and hp <= fc.DW_TF32_HP_MAX
    fewer = [p for p in fc.DW_TF32_PARTS
             if p < n_parts and -(-(-(-H // p)) // 16) * 16
             <= fc.DW_TF32_HP_MAX]
    assert not fewer
    assert plan["smem_bytes"] == _dw_tf32_smem(plan) <= fc.SMEM_MAX
    assert plan["n_clusters"] == min(-(-V // 64), N_SM // n_parts)
    assert plan["grid"] == (n_parts, plan["n_clusters"])


def test_dw_tf32_plan_at_the_gemma_chunk_and_h_1152():
    """R 128, V 262,144, H 640: clusters of two CTAs, each holding h's
    128 rows x 320 columns, 66 clusters over 4,096 vocab tiles, 228,352
    bytes of shared memory; chip_smoke's ragged_f32 (R 120, V 50,257, H
    1,152): clusters of four 288-column parts."""
    plan = fc.dw_tf32_plan(128, 262144, 640, N_SM)
    assert (plan["n_parts"], plan["hp"], plan["row_chunk"],
            plan["n_chunks"], plan["n_clusters"], plan["smem_bytes"]) == \
        (2, 320, 128, 1, 66, 228352)
    plan = fc.dw_tf32_plan(120, 50257, 1152, N_SM)
    assert (plan["n_parts"], plan["hp"], plan["row_chunk"],
            plan["n_chunks"], plan["n_clusters"]) == (4, 288, 128, 1, 33)
    assert plan["smem_bytes"] <= fc.SMEM_MAX


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_dw_tf32_plan_refuses_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.dw_tf32_plan(16, 100, H, N_SM)


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


# ----------------------------------------------- rows 7 and 10 in f32 ------

TF32_SHAPES = [  # (R, V, H, r): r 0 is row 7
    (128, 262144, 640, 0),      # the Gemma chunk, default dtype
    (256, 262144, 640, 0),      # batch 8
    (120, 50257, 1152, 0),      # chip_smoke's ragged_f32 (Gemma-3-1B width)
    (37, 50257, 1152, 0),       # the card test's R 37
    (37, 1001, 200, 0),
    (8, 100, 8, 0),
    (40, 3001, 1520, 0),        # the widest H a multiple of 8 in MAX_HIDDEN
    (128, 262144, 640, 8),      # the Gemma chunk with the head adapter
    (128, 262144, 640, 1),
    (128, 262144, 640, 16),
    (128, 262144, 640, 128),    # the largest rank
    (120, 50257, 1000, 4),      # chip_smoke's ragged_f32
    (37, 50257, 1000, 3),       # an odd rank
    (37, 1001, 200, 5),
    (40, 3001, 1392, 128),      # H + r at MAX_HIDDEN's edge
]
TF32_SOURCES = {"fused_ce_dh_tf32.cu": "dh_tf32_kernel",
                "fused_ce_dh_lora_tf32.cu": "dh_lora_tf32_kernel"}


def _tf32_plan(R, V, H, r):
    return (fc.dh_lora_tf32_plan(R, V, H, r, N_SM) if r
            else fc.dh_tf32_plan(R, V, H, N_SM))


@pytest.mark.parametrize("name", sorted(TF32_SOURCES))
def test_tf32_dh_plan_constants_match_the_source(name):
    """VT, WG, LDC and the block limit, the shared-memory formula, the
    grid, the n-tiles a warp and the instantiated bounds (32-row tiles up
    to 6) are the plan's."""
    text = _source(name)
    assert _constexpr(text, "VT") == fc.TF32_VOCAB_TILE
    assert _constexpr(text, "WG") == fc.TF32_WARPS
    assert "constexpr int LDC = VT + 8;" in text
    assert fc.TF32_COEF_LD == fc.TF32_VOCAB_TILE + 8
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    x = "HX" if "lora" in name else "H"
    assert f"(size_t)(16 * RG + stages * VT) * ({x} + 4) + 2 * 16 * RG * " \
           f"LDC) *" in text
    assert "(size_t)RG * WG * 2 * 32 * 16;" in text
    assert f"return ({x} / 8 + RG * WG - 1) / (RG * WG);" in text
    assert "dim3 grid((R + 16 * RG - 1) / (16 * RG), n_slabs);" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert f"{TF32_SOURCES[name]}<RG, NT><<<grid, RG * WG * 32" in text
    launches = re.findall(r"if \(rg == (\d) && nt <= (\d+)\) "
                          r"MFT_LAUNCH\(\1, \2\);", text)
    assert {int(n) for _, n in launches} == set(fc.TF32_NT)
    assert max(int(n) for g, n in launches if g == "2") == 6
    assert [int(n) for g, n in launches if g == "1"] == \
        [b for b in fc.TF32_NT if b != 5]
    if "lora" in name:
        assert _constexpr(text, "MAX_RANK") == fc.MAX_RANK
        assert "return H + (r + 7) / 8 * 8;" in text


@pytest.mark.parametrize("R,V,H,r", TF32_SHAPES)
def test_tf32_dh_plan_covers_each_tile_once(R, V, H, r):
    """Every (row, 16-row vocab tile) lies in exactly one CTA, no CTA is
    empty, and the warps' n-tiles (nt each, for every row of the tile)
    cover the widened row's hx / 8 n-tiles once: dh's columns, then
    dxa's."""
    plan = _tf32_plan(R, V, H, r)
    rt, vt = 16 * plan["row_groups"], fc.TF32_VOCAB_TILE
    span = plan["tiles_per_slab"] * vt
    gx, gy = plan["grid"]
    assert gx == -(-R // rt) and gy == plan["n_slabs"]
    hits = np.zeros((R, -(-V // vt)), dtype=np.int64)
    for slab, x in itertools.product(range(gy), range(gx)):
        r0, v0 = x * rt, slab * span
        assert r0 < R and v0 < V          # no empty CTA
        hits[r0:r0 + rt, v0 // vt:(v0 + span) // vt] += 1
    assert (hits == 1).all()
    hx, nt = plan["hx"], plan["nt"]
    assert hx == H + -(-r // 8) * 8 and hx % 8 == 0
    cols = np.zeros(hx // 8, dtype=np.int64)
    for warp in range(fc.TF32_WARPS * plan["row_groups"]):
        n_own = min(nt, hx // 8 - warp * nt)
        cols[warp * nt:warp * nt + max(0, n_own)] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("R,V,H,r", TF32_SHAPES)
def test_tf32_dh_plan_fits_the_card(R, V, H, r):
    """The h (+ xa) tile, the W (+ bt) ring, the logits partials and the
    split coef tile within the 232,448 bytes a block may use, the n-tile
    bound of the instantiations, and one wave of CTAs."""
    plan = _tf32_plan(R, V, H, r)
    rg, st, hx = plan["row_groups"], plan["stages"], plan["hx"]
    assert plan["smem_bytes"] == ((16 * rg + st * 16) * (hx + 4)
                                  + 2 * 16 * rg * 24) * 4 + rg * 8 * 1024
    assert plan["smem_bytes"] <= fc.SMEM_MAX == 232448
    assert (rg, st) in ((2, 3), (2, 2), (1, 3), (1, 2), (1, 1))
    assert plan["nt"] == -(-(hx // 8) // (8 * rg))
    assert plan["nt_bound"] == min(b for b in fc.TF32_NT
                                   if b >= plan["nt"])
    assert rg == 1 or plan["nt_bound"] <= 6
    gx, gy = plan["grid"]
    if -(-V // fc.TF32_VOCAB_TILE) >= N_SM:
        assert gx * gy <= N_SM


def test_tf32_dh_plans_at_the_gemma_chunk():
    """R 128, V 262,144, H 640: 32-row tiles, three W tiles, 33 slabs of
    497 16-row tiles: 132 CTAs of 16 warps; row 7's warps hold 5 n-tiles
    each, row 10's 6 at every rank (r above 8 takes two W tiles)."""
    plan = fc.dh_tf32_plan(128, 262144, 640, N_SM)
    assert (plan["row_groups"], plan["stages"], plan["nt"],
            plan["nt_bound"], plan["n_slabs"], plan["tiles_per_slab"]) == \
        (2, 3, 5, 5, 33, 497)
    assert plan["grid"] == (4, 33) and plan["smem_bytes"] == 228608
    lora = fc.dh_lora_tf32_plan(128, 262144, 640, 8, N_SM)
    assert (lora["row_groups"], lora["stages"], lora["nt"], lora["hx"]) == \
        (2, 3, 6, 648)
    assert lora["grid"] == (4, 33) and lora["smem_bytes"] == 231168
    for r in range(1, fc.MAX_RANK + 1):
        p = fc.dh_lora_tf32_plan(128, 262144, 640, r, N_SM)
        assert (p["row_groups"], p["nt_bound"]) == (2, 6)
        assert p["stages"] == (3 if r <= 8 else 2)
        assert p["smem_bytes"] <= fc.SMEM_MAX


def test_tf32_dh_plans_limit_the_width():
    """One 32-row h tile and one W tile fit up to a widened row of 1,720
    columns (27 n-tiles a warp, under the bound 28): row 7 takes H 1,720
    and refuses 1,728, naming H; row 10 at r 128 takes H 1,592 and
    refuses 1,600, naming H and r. The wrappers' MAX_HIDDEN (H + r <=
    1,522) keeps every call inside."""
    assert fc.dh_tf32_plan(16, 100, 1720, N_SM)["nt"] == 27
    with pytest.raises(ValueError, match="H=1728 does not fit"):
        fc.dh_tf32_plan(16, 100, 1728, N_SM)
    assert fc.dh_lora_tf32_plan(16, 100, 1592, 128, N_SM)["hx"] == 1720
    with pytest.raises(ValueError, match="H=1600, r=128 does not fit"):
        fc.dh_lora_tf32_plan(16, 100, 1600, 128, N_SM)
    assert fc.MAX_HIDDEN + 7 <= 1720


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_tf32_dh_plans_refuse_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.dh_tf32_plan(16, 100, H, N_SM)
    with pytest.raises(ValueError, match="H % 8"):
        fc.dh_lora_tf32_plan(16, 100, H, 8, N_SM)


@pytest.mark.parametrize("r", [0, -1, 129])
def test_tf32_dh_lora_plan_refuses_a_rank_out_of_range(r):
    with pytest.raises(ValueError, match="rank"):
        fc.dh_lora_tf32_plan(16, 100, 64, r, N_SM)


# ----------------------------------------- rows 6 and 11 (dbt) in f32 ------

LOGITS_SHAPES = [  # (R, V, H, r): r 0 is row 6
    (128, 262144, 640, 0),      # the Gemma chunk, default dtype
    (256, 262144, 640, 0),      # batch 8
    (120, 50257, 1152, 0),      # chip_smoke's ragged_f32 (Gemma-3-1B width)
    (37, 50257, 1152, 0),
    (37, 1001, 200, 0),
    (8, 100, 8, 0),
    (300, 50257, 768, 0),       # GPT-2's width, more row tiles than slabs
    (40, 3001, 1520, 0),
    (128, 262144, 640, 8),      # the Gemma chunk with the head adapter
    (128, 262144, 640, 1),
    (128, 262144, 640, 128),    # the largest rank
    (128, 20011, 640, 8),       # the card test's ragged V
    (120, 50257, 1000, 4),      # chip_smoke's ragged_f32
    (37, 50257, 1000, 1),
    (37, 1001, 200, 3),
    (100, 5003, 640, 128),
]
LOGITS_SOURCES = {"fused_ce_fwd_tf32.cu": "fwd_tf32_kernel",
                  "fused_ce_dbt_tf32.cu": "dbt_tf32_kernel",
                  "fused_ce_fwd_lora_tf32.cu": "fwd_lora_tf32_kernel"}


def _logits_plan(R, V, H, r, n_sm=N_SM):
    return (fc.dbt_tf32_plan(R, V, H, r, n_sm) if r
            else fc.fwd_tf32_plan(R, V, H, n_sm))


@pytest.mark.parametrize("name", sorted(LOGITS_SOURCES))
def test_logits_tf32_plan_constants_match_the_source(name):
    """VT, WARPS, the stage bound and the block limit, the shared-memory
    formula (the h tile and a ring of W chunks, 16 rows a warp), the grid,
    and an instantiation for every (row tile, chunk) of LOGITS_PLANS and
    of kernel_variants.py's PLAN_SWEEP."""
    text = _source(name)
    assert _constexpr(text, "VT") == fc.LOGITS_VOCAB_TILE == 128
    assert _constexpr(text, "WARPS") == fc.LOGITS_WARPS == 8
    assert fc.LOGITS_VOCAB_TILE == 16 * fc.LOGITS_WARPS
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert _constexpr(text, "MAX_STAGES") >= max(p[2] for p in
                                                 fc.LOGITS_PLANS)
    widened = "dbt" in name or "lora" in name    # rows 11 and 9
    x = "HX" if widened else "H"
    assert f"return ((size_t)RT * ({x} + 4) + (size_t)stages * VT * (KC + " \
           f"4)) *" in text
    assert "float* w_w = w_s + warp * stages * 16 * LDW;" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert f"{LOGITS_SOURCES[name]}<NJ, KC><<<grid, THREADS, smem, st>>>" \
        in text
    launches = set(re.findall(r"if \(row_tile == (\d+) && chunk == (\d+)\) "
                              r"MFT_LAUNCH\((\d), (\d+)\);", text))
    assert all(int(rt) == 8 * int(nj) and kc == kc2
               for rt, kc, nj, kc2 in launches)
    import kernel_variants
    assert {(rt, kc) for rt, kc, _, kc2 in launches} >= \
        {(str(rt), str(kc)) for rt, kc, _ in
         fc.LOGITS_PLANS + kernel_variants.PLAN_SWEEP}
    if widened:
        assert _constexpr(text, "MAX_RANK") == fc.MAX_RANK
        assert "return H + (r + 7) / 8 * 8;" in text


@pytest.mark.parametrize("R,V,H,r", LOGITS_SHAPES)
def test_logits_tf32_plan_covers_each_tile_once(R, V, H, r):
    """Every (row, 128-row vocab tile) lies in exactly one CTA and no CTA
    is empty; the widened row is H plus r rounded up to 8."""
    _check_logits_cover(_logits_plan(R, V, H, r), R, V, H, r)


def _check_logits_cover(plan, R, V, H, r):
    rt, vt = plan["row_tile"], fc.LOGITS_VOCAB_TILE
    span = plan["tiles_per_slab"] * vt
    gx, gy = plan["grid"]
    assert gx == plan["row_tiles"] == -(-R // rt) and gy == plan["n_slabs"]
    hits = np.zeros((R, -(-V // vt)), dtype=np.int64)
    for slab, x in itertools.product(range(gy), range(gx)):
        r0, v0 = x * rt, slab * span
        assert r0 < R and v0 < V          # no empty CTA
        hits[r0:r0 + rt, v0 // vt:(v0 + span) // vt] += 1
    assert (hits == 1).all()
    assert plan["hx"] == H + -(-r // 8) * 8


@pytest.mark.parametrize("R,V,H,r", LOGITS_SHAPES)
def test_logits_tf32_plan_fits_the_card(R, V, H, r):
    """The h (+ xa) tile and every warp's ring of W chunks within the
    232,448 bytes a block may use, the first plan of LOGITS_PLANS that
    does, and one wave of CTAs when the vocabulary has enough tiles."""
    _check_logits_fit(_logits_plan(R, V, H, r), V)


def _check_logits_fit(plan, V):
    rt, kc, st, hx = (plan["row_tile"], plan["chunk"], plan["stages"],
                      plan["hx"])

    def smem(rt, kc, st):
        return (rt * (hx + 4) + st * 128 * (kc + 4)) * 4
    assert plan["smem_bytes"] == smem(rt, kc, st) <= fc.SMEM_MAX == 232448
    fits = [p for p in fc.LOGITS_PLANS if smem(*p) <= fc.SMEM_MAX]
    assert (rt, kc, st) == fits[0]
    gx, gy = plan["grid"]
    if -(-V // fc.LOGITS_VOCAB_TILE) * gx >= N_SM and gx <= N_SM:
        assert gx * gy <= N_SM


@pytest.mark.parametrize("R,V,H,r", [c for c in LOGITS_SHAPES if c[3]])
def test_fwd_lora_tf32_plan_covers_each_tile_once_and_fits(R, V, H, r):
    """Row 9's f32 launch: every (row, 128-row vocab tile) in exactly one
    CTA over the widened row, within the card's 232,448 bytes, the first
    plan of LOGITS_PLANS that fits, one wave of CTAs; row 11's dbt-only
    launch at the same shape is the same plan."""
    plan = fc.fwd_lora_tf32_plan(R, V, H, r, N_SM)
    _check_logits_cover(plan, R, V, H, r)
    _check_logits_fit(plan, V)
    assert plan == fc.dbt_tf32_plan(R, V, H, r, N_SM)


def test_logits_tf32_plans_at_the_gemma_chunk():
    """R 128, V 262,144, H 640: 64-row tiles, 32-column chunks, two
    stages a warp, 2 x 64 CTAs of 8 warps; row 11 the same at r 8, 32-row
    tiles and 64-column chunks at r 128."""
    plan = fc.fwd_tf32_plan(128, 262144, 640, N_SM)
    assert (plan["row_tile"], plan["chunk"], plan["stages"],
            plan["n_slabs"], plan["tiles_per_slab"]) == (64, 32, 2, 64, 32)
    assert plan["grid"] == (2, 64) and plan["smem_bytes"] == 201728
    lora = fc.dbt_tf32_plan(128, 262144, 640, 8, N_SM)
    assert (lora["row_tile"], lora["chunk"], lora["stages"], lora["hx"],
            lora["row_tiles"]) == (64, 32, 2, 648, 2)
    assert lora["grid"] == (2, 64)
    big = fc.dbt_tf32_plan(128, 262144, 640, 128, N_SM)
    assert (big["row_tile"], big["chunk"], big["hx"]) == (32, 64, 768)
    fwd_lora = fc.fwd_lora_tf32_plan(128, 262144, 640, 8, N_SM)
    assert (fwd_lora["row_tile"], fwd_lora["chunk"], fwd_lora["stages"],
            fwd_lora["hx"], fwd_lora["grid"]) == (64, 32, 2, 648, (2, 64))


def test_logits_tf32_plans_limit_the_width():
    """A 16-row h tile and one 64-column W chunk a warp fit up to a
    widened row of 3,084 columns: row 6 takes H 3,080 and refuses 3,088,
    naming H; row 11 at r 128 takes H 2,952 and refuses 2,960, naming H
    and r."""
    assert fc.fwd_tf32_plan(16, 100, 3080, N_SM)["stages"] == 1
    with pytest.raises(ValueError, match="H=3088 does not fit"):
        fc.fwd_tf32_plan(16, 100, 3088, N_SM)
    assert fc.dbt_tf32_plan(16, 100, 2952, 128, N_SM)["hx"] == 3080
    with pytest.raises(ValueError, match="H=2960, r=128 does not fit"):
        fc.dbt_tf32_plan(16, 100, 2960, 128, N_SM)


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_logits_tf32_plans_refuse_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.fwd_tf32_plan(16, 100, H, N_SM)
    with pytest.raises(ValueError, match="H % 8"):
        fc.dbt_tf32_plan(16, 100, H, 8, N_SM)
    with pytest.raises(ValueError, match="H % 8"):
        fc.fwd_lora_tf32_plan(16, 100, H, 8, N_SM)


@pytest.mark.parametrize("r", [0, -1, 129])
def test_dbt_tf32_plan_refuses_a_rank_out_of_range(r):
    with pytest.raises(ValueError, match="rank"):
        fc.dbt_tf32_plan(16, 100, 64, r, N_SM)
    with pytest.raises(ValueError, match="rank"):
        fc.fwd_lora_tf32_plan(16, 100, 64, r, N_SM)


# ------------------------------------------------------------- row 2 -------

BWD_SHAPES = [  # (B, Hq, Hkv, S, D, dtype)
    (8, 12, 12, 128, 64, torch.bfloat16),   # the GPT-2 training step
    (4, 4, 1, 256, 256, torch.bfloat16),    # the Gemma-3 training step
    (8, 4, 1, 256, 256, torch.bfloat16),    # batch 8
    (1, 12, 12, 100, 64, torch.bfloat16),
    (2, 8, 2, 200, 256, torch.float16),     # ragged S at D 256
    (1, 8, 2, 130, 256, torch.float16),
    (2, 8, 8, 96, 128, torch.bfloat16),
    (2, 4, 2, 200, 64, torch.float32),      # the 3xTF32 kernel
    (6, 12, 12, 128, 64, torch.float32),    # the multi-tenant f32 run
    (2, 8, 8, 90, 128, torch.float32),
    (2, 8, 2, 200, 256, torch.float32),     # GQA 4:1, ragged, D 256
]


def test_bwd_plan_constants_match_the_source():
    text = _source("flash_attention_bwd_merged_mma.cu")
    assert "static constexpr int BK = D == 128 ? 64 : 32;" in text
    assert "static constexpr int BQ = D == 128 ? 64 : 32;" in text
    assert "static constexpr int DS = D == 64 ? 1 : 2;" in text
    assert "static constexpr int WARPS = KG * DS;" in text
    assert "static constexpr int STAGES = 2;" in text
    assert "(2 * BK * LD + 2 * STAGES * BQ * LD + BK * LDS) * elem +" in text
    assert "(2 * STAGES * BQ + BK) * sizeof(float)" in text
    assert "const int qlo = causal ? col0 / BQ : 0;" in text
    assert "floor_div(col0 + BK + window - 2, BQ) + 1" in text
    assert "dim3 grid((S + C::BK - 1) / C::BK, Hq, B);" in text
    # the lane addresses and the fragment map _bwd_mma_replay mirrors
    for line in (
            "const int a_off = (kb0 + lr + (lm % 2) * 8) * LD + (lm / 2) * 8;",
            "const int b_off = (lr + (lm / 2) * 8) * LD + (lm % 2) * 8;",
            "const int bt_off = (lr + (lm % 2) * 8) * LD + d0 + (lm / 2) * 8;",
            "const int mq = warp % MT, dq0 = (warp / MT) * DQC;",
            "ds_s + (lr + (lm / 2) * 8) * LDS + mq * 16 + (lm % 2) * 8;",
            "k_s + (lr + (lm % 2) * 8) * LD + dq0 + (lm / 2) * 8;",
            "const int kl = kb0 + g + 8 * (e >> 1), key = col0 + kl;",
            "const int ql = j * 8 + 2 * t + (e & 1), row = row0 + ql;",
            "keep_bit(drop.seed, b, h, row, key, drop.thresh);",
            "const float* cp = &s[2 * kk + (i >> 1)][(i & 1) * 2];",
            "*reinterpret_cast<uint32_t*>(ds_s + (kb0 + g + 8 * i) * LDS +",
            "const int row = row0 + mq * 16 + g + 8 * i;",
            "float* dst = dq_acc + (qh + row) * D + dq0 + c0 + 2 * t;",
            "const int key = col0 + kb0 + g + 8 * i;"):
        assert line in text, line
    for D, (bk, bq, ds) in fa.BWD_MMA_TILES.items():
        plan = fa.bwd_plan(1, 1, 1, 64, D, torch.bfloat16)
        assert (plan["block_k"], plan["block_q"]) == (bk, bq)
        assert ds == (1 if D == 64 else 2)
        assert plan["warps"] == bk // 16 * ds
        assert plan["stages"] == fa.BWD_MMA_STAGES
    tf32 = _source("flash_attention_bwd_merged_tf32.cu")
    for line in (
            "static constexpr int BK = D == 256 ? 16 : 32;",
            "static constexpr int BQ = D == 256 ? 16 : 32;",
            "static constexpr int DS = D / 64;",
            "static constexpr int WARPS = KG * DS;",
            "static constexpr int LD = D + 4;",
            "static constexpr int LDS = BK + 8;",
            "static constexpr int STAGES = 2;",
            "((size_t)4 * BK * LD + (size_t)4 * STAGES * BQ * LD + "
            "2 * BQ * LDS +",
            "2 * STAGES * BQ + BK) *",
            "const int qlo = causal ? col0 / BQ : 0;",
            "floor_div(col0 + BK + window - 2, BQ) + 1",
            "dim3 grid((S + C::BK - 1) / C::BK, Hq, B);"):
        assert line in tf32, line
    for D, (bk, bq, ds) in fa.BWD_TF32_TILES.items():
        plan = fa.bwd_plan(1, 1, 1, 64, D, torch.float32)
        assert (plan["block_k"], plan["block_q"]) == (bk, bq)
        assert bk == bq == (16 if D == 256 else 32) and ds == D // 64
        assert plan["warps"] == bk // 16 * ds
        assert plan["stages"] == fa.TF32_STAGES


@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", BWD_SHAPES)
def test_bwd_plan_covers_each_key_block_once(B, Hq, Hkv, S, D, dtype):
    plan = fa.bwd_plan(B, Hq, Hkv, S, D, dtype)
    nx, ny, nz = plan["grid"]
    assert (ny, nz) == (Hq, B)
    seen = np.zeros((B, Hq, S), dtype=np.int64)
    for b, h, x in itertools.product(range(nz), range(ny), range(nx)):
        c0 = x * plan["block_k"]
        assert c0 < S                      # no CTA without a key
        seen[b, h, c0:c0 + plan["block_k"]] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", BWD_SHAPES)
def test_bwd_plan_fits_the_card(B, Hq, Hkv, S, D, dtype):
    plan = fa.bwd_plan(B, Hq, Hkv, S, D, dtype)
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    assert 32 * plan["warps"] <= 1024
    if dtype != torch.float32:
        bk, bq = plan["block_k"], plan["block_q"]
        # one warp a 16 keys and 64 or 128 dK/dV columns (64 or 128
        # registers of f32 accumulators); the dQ m-tiles split evenly
        # over the warps, a multiple of 64 columns a warp
        ds = 1 if D == 64 else 2
        assert plan["warps"] == bk // 16 * ds and D // ds in (64, 128)
        assert plan["warps"] % (bq // 16) == 0
        assert D * (bq // 16) // plan["warps"] % 64 == 0
    else:
        # the 3xTF32 kernel: 64 dK/dV columns a warp, the same dQ split
        bk, bq = plan["block_k"], plan["block_q"]
        assert plan["warps"] == bk // 16 * (D // 64)
        assert plan["warps"] % (bq // 16) == 0
        assert D * (bq // 16) // plan["warps"] % 64 == 0
        assert plan["smem_bytes"] == 4 * (
            4 * bk * (D + 4) + 8 * bq * (D + 4) + 2 * bq * (bk + 8)
            + 4 * bq + bk)


def test_bwd_plan_at_the_path_shapes():
    """384 CTAs of 2 warps at GPT-2's step, 128 of 4 at Gemma-3's."""
    plan = fa.bwd_plan(8, 12, 12, 128, 64, torch.bfloat16)
    assert plan["grid"] == (4, 12, 8) and plan["warps"] == 2
    plan = fa.bwd_plan(4, 4, 1, 256, 256, torch.bfloat16)
    assert plan["grid"] == (8, 4, 4) and plan["warps"] == 4
    assert plan["smem_bytes"] == 104576


@pytest.mark.parametrize("S,D,causal,window", [
    (256, 256, True, 512), (256, 256, True, 40), (200, 256, True, 24),
    (130, 256, True, None), (96, 128, True, None), (96, 128, False, 20),
    (128, 64, True, None), (100, 64, False, None), (200, 64, True, 24),
    (200, 64, False, 24), (1000, 128, True, 512), (33, 64, True, 1),
])
def test_bwd_q_blocks_reach_every_attendable_pair(S, D, causal, window):
    """[qlo, qhi) of each key block holds every query row that attends to
    one of its keys, and its first and last q-blocks are needed."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.bwd_plan(1, 1, 1, S, D, dtype)
        bq, bk = plan["block_q"], plan["block_k"]
        rows = np.arange(S)[:, None]
        cols = np.arange(S)[None, :]
        ok = np.ones((S, S), dtype=bool)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= cols > rows - window
        for x in range(plan["grid"][0]):
            c0 = x * bk
            qlo, qhi = fa._q_block_bounds(c0, -(-S // bq), causal, window,
                                          bq, bk)
            hit = np.nonzero(ok[:, c0:c0 + bk].any(1))[0]
            assert hit.min() >= qlo * bq and hit.max() < qhi * bq
            assert hit.max() >= (qhi - 1) * bq and hit.min() < (qlo + 1) * bq


@pytest.mark.parametrize("D", [96, 32, 0])
def test_bwd_plan_refuses_head_dims_the_kernels_do_not_take(D):
    with pytest.raises(ValueError, match="D in"):
        fa.bwd_plan(1, 2, 2, 64, D, torch.bfloat16)


# The m16n8k16 fragment layouts (csrc/tensor_core.cuh), emulated in numpy:
# lane = 4 g + t; each fragment register holds two consecutive values.

def _ldsm(mem, addrs, trans):
    """ldmatrix .x4 (.trans): mem a flat array, addrs [32] element offsets
    (lane l gives row l % 8 of matrix l // 8). Returns [32, 4, 2]."""
    rows = mem[np.asarray(addrs)[:, None] + np.arange(8)].reshape(4, 8, 8)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    out = np.empty((32, 4, 2), dtype=mem.dtype)
    for i in range(4):
        m = rows[i].T if trans else rows[i]
        out[:, i, 0] = m[g, 2 * t]
        out[:, i, 1] = m[g, 2 * t + 1]
    return out


def _mma(c, a, b0, b1):
    """c [32, 4] += A B for A fragments a [32, 4, 2], B fragments b0, b1
    [32, 2]: A 16x16, B 16x8, C 16x8 in the PTX ISA's layouts."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for i, (r, k) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        A[g + r, 2 * t + k] = a[:, i, 0]
        A[g + r, 2 * t + k + 1] = a[:, i, 1]
    for bb, k in ((b0, 0), (b1, 8)):
        Bm[2 * t + k, g] = bb[:, 0]
        Bm[2 * t + k + 1, g] = bb[:, 1]
    C = A @ Bm
    c[:, 0] += C[g, 2 * t]
    c[:, 1] += C[g, 2 * t + 1]
    c[:, 2] += C[g + 8, 2 * t]
    c[:, 3] += C[g + 8, 2 * t + 1]


def _repack(frags, kk):
    """A fragments [32, 4, 2] of k-step kk from C fragments [n, 32, 4]."""
    return np.stack([frags[2 * kk + (i >> 1)][:, (i & 1) * 2:(i & 1) * 2 + 2]
                     for i in range(4)], axis=1)


def _bwd_mma_replay(q, k, v, pad, lse, delta, do, scale, causal, window,
                    seed, p_drop):
    """csrc/flash_attention_bwd_merged_mma.cu replayed in f64: its grid,
    q-loop, lane addresses, fragment map, masks, keep bits, stores and dQ
    adds, with ldmatrix and mma.sync emulated. Returns (dq, dk, dv) and
    the count of dQ adds each (b, h, row, d) received."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    plan = fa.bwd_plan(B, Hq, Hkv, S, D, torch.bfloat16)
    BK, BQ, W = plan["block_k"], plan["block_q"], plan["warps"]
    KG, MT = BK // 16, BQ // 16
    DS = W // KG                        # warps sharing each 16 keys
    DQC = D * MT // W
    LD, LDS = D + 8, BQ + 8
    lane = np.arange(32)
    g, t, lr, lm = lane >> 2, lane & 3, lane % 8, lane // 8
    dq = np.zeros((B, Hq, S, D))
    adds = np.zeros((B, Hq, S, D), dtype=np.int64)
    dk = np.zeros((B, Hq, S, D))
    dv = np.zeros((B, Hq, S, D))
    keep_all = (fa.keep_mask(seed, torch.arange(B)[:, None, None, None],
                             torch.arange(Hq)[None, :, None, None],
                             torch.arange(S)[None, None, :, None],
                             torch.arange(S)[None, None, None, :],
                             p_drop).numpy() if p_drop else None)
    nx, _, _ = plan["grid"]

    def rows_of(src, r0, n):   # [n][LD] flat, zero past S
        out = np.zeros((n, LD))
        m = min(n, S - r0)
        out[:m, :D] = src[r0:r0 + m]
        return out.reshape(-1)

    for b, h, x in itertools.product(range(B), range(Hq), range(nx)):
        hk = h // (Hq // Hkv)
        col0 = x * BK
        k_s, v_s = rows_of(k[b, hk], col0, BK), rows_of(v[b, hk], col0, BK)
        pad_s = np.array([pad[b, c] if c < S else 0.0
                          for c in range(col0, col0 + BK)])
        qlo, qhi = fa._q_block_bounds(col0, -(-S // BQ), causal, window,
                                      BQ, BK)
        acc_k = np.zeros((W, D // DS // 8, 32, 4))
        acc_v = np.zeros_like(acc_k)
        for qi in range(qlo, qhi):
            row0 = qi * BQ
            q_s, do_s = rows_of(q[b, h], row0, BQ), rows_of(do[b, h], row0,
                                                            BQ)
            idx = np.minimum(np.arange(row0, row0 + BQ), S - 1)
            live = np.arange(row0, row0 + BQ) < S
            lq = np.where(live, lse[b, h, idx], 0.0)
            dlq = np.where(live, delta[b, h, idx], 0.0)
            ds_s = np.zeros(BK * LDS)
            ds_w = {}
            for w in range(W):
                kg, dsi = w % KG, w // KG
                kb0, d0 = kg * 16, dsi * (D // DS)
                a_off = (kb0 + lr + (lm % 2) * 8) * LD + (lm // 2) * 8
                b_off = (lr + (lm // 2) * 8) * LD + (lm % 2) * 8
                bt_off = (lr + (lm % 2) * 8) * LD + d0 + (lm // 2) * 8
                s = np.zeros((BQ // 8, 32, 4))
                dp = np.zeros_like(s)
                for kc in range(D // 16):
                    ak = _ldsm(k_s, a_off + kc * 16, False)
                    av = _ldsm(v_s, a_off + kc * 16, False)
                    for j in range(0, BQ // 8, 2):
                        bq_ = _ldsm(q_s, b_off + j * 8 * LD + kc * 16, False)
                        bo = _ldsm(do_s, b_off + j * 8 * LD + kc * 16, False)
                        _mma(s[j], ak, bq_[:, 0], bq_[:, 1])
                        _mma(s[j + 1], ak, bq_[:, 2], bq_[:, 3])
                        _mma(dp[j], av, bo[:, 0], bo[:, 1])
                        _mma(dp[j + 1], av, bo[:, 2], bo[:, 3])
                for j, e in itertools.product(range(BQ // 8), range(4)):
                    kl = kb0 + g + 8 * (e >> 1)
                    key = col0 + kl
                    ql = j * 8 + 2 * t + (e & 1)
                    row = row0 + ql
                    ok = (pad_s[kl] > 0) & (row < S)
                    if causal:
                        ok &= key <= row
                    if window is not None:
                        ok &= key > row - window
                    # the plain version's mask and keep bits at (row, key)
                    inb = (row < S) & (key < S)
                    rr, kk_ = np.minimum(row, S - 1), np.minimum(key, S - 1)
                    want = fa._tile_mask(
                        torch.as_tensor(pad), torch.as_tensor(rr)[:, None],
                        torch.as_tensor(kk_)[None, :], causal,
                        window)[b, 0, 0].expand(32, 32).numpy().diagonal()
                    want = want & inb
                    assert (ok == want).all()
                    p = np.where(ok, np.exp(s[j][:, e] * scale - lq[ql]),
                                 0.0)
                    pv, dpv = p, dp[j][:, e]
                    if p_drop:
                        keep = keep_all[b, h, rr, kk_] & inb
                        pv = np.where(keep, p / (1 - p_drop), 0.0)
                        dpv = np.where(keep, dpv / (1 - p_drop), 0.0)
                    s[j][:, e] = pv
                    dp[j][:, e] = p * (dpv - dlq[ql]) * scale
                for kk in range(BQ // 16):
                    pa, da = _repack(s, kk), _repack(dp, kk)
                    for n in range(0, D // DS // 8, 2):
                        bo = _ldsm(do_s, bt_off + kk * 16 * LD + n * 8, True)
                        bq_ = _ldsm(q_s, bt_off + kk * 16 * LD + n * 8, True)
                        _mma(acc_v[w, n], pa, bo[:, 0], bo[:, 1])
                        _mma(acc_v[w, n + 1], pa, bo[:, 2], bo[:, 3])
                        _mma(acc_k[w, n], da, bq_[:, 0], bq_[:, 1])
                        _mma(acc_k[w, n + 1], da, bq_[:, 2], bq_[:, 3])
                if dsi == 0:
                    for j, i in itertools.product(range(BQ // 8), range(2)):
                        o = (kb0 + g + 8 * i) * LDS + j * 8 + 2 * t
                        assert (ds_w.setdefault("o", set()).isdisjoint(
                            set((o).tolist())))
                        ds_w["o"].update((o).tolist())
                        ds_s[o] = dp[j][:, 2 * i]
                        ds_s[o + 1] = dp[j][:, 2 * i + 1]
            assert len(ds_w["o"]) == BK * BQ // 2   # dS^T written whole
            for w in range(W):
                mq, dq0 = w % MT, (w // MT) * DQC
                ds_a = (lr + (lm // 2) * 8) * LDS + mq * 16 + (lm % 2) * 8
                k_t = (lr + (lm % 2) * 8) * LD + dq0 + (lm // 2) * 8
                for c0 in range(0, DQC, 64):
                    acc = np.zeros((8, 32, 4))
                    for kc in range(BK // 16):
                        a = _ldsm(ds_s, ds_a + kc * 16 * LDS, True)
                        for n in range(0, 8, 2):
                            bk = _ldsm(k_s, k_t + kc * 16 * LD + c0 + n * 8,
                                       True)
                            _mma(acc[n], a, bk[:, 0], bk[:, 1])
                            _mma(acc[n + 1], a, bk[:, 2], bk[:, 3])
                    for i, n in itertools.product(range(2), range(8)):
                        row = row0 + mq * 16 + g + 8 * i
                        col = dq0 + c0 + n * 8 + 2 * t
                        m = row < S
                        for e in range(2):
                            dq[b, h, row[m], col[m] + e] += acc[n][m, 2 * i
                                                                   + e]
                            adds[b, h, row[m], col[m] + e] += 1
        for w in range(W):
            kb0, d0 = (w % KG) * 16, (w // KG) * (D // DS)
            for i, n in itertools.product(range(2), range(D // DS // 8)):
                key = col0 + kb0 + g + 8 * i
                m = key < S
                for e in range(2):
                    col = d0 + n * 8 + 2 * t + e
                    assert not dk[b, h, key[m], col[m]].any()  # written once
                    dk[b, h, key[m], col[m]] = acc_k[w, n][m, 2 * i + e]
                    dv[b, h, key[m], col[m]] = acc_v[w, n][m, 2 * i + e]
    G = Hq // Hkv
    return (dq, dk.reshape(B, Hkv, G, S, D).sum(2),
            dv.reshape(B, Hkv, G, S, D).sum(2), adds)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,n_pad,causal,window,p_drop", [
    (1, 4, 2, 70, 64, 9, True, 24, 0.1),      # GQA, window, dropout, ragged
    (2, 2, 1, 100, 64, 0, True, None, 0.0),   # ragged, two key blocks
    (1, 2, 2, 40, 128, 5, False, None, 0.1),  # non-causal, D 128, padded
    (1, 4, 1, 45, 256, 6, True, 20, 0.1),     # D 256, GQA 4:1, window
])
def test_bwd_mma_fragment_map_replays_the_plain_version(
        B, Hq, Hkv, S, D, n_pad, causal, window, p_drop):
    """Row 2's transposed tile, replayed element by element: each S^T
    fragment's (key, query) takes the plain version's mask and keep bit;
    the repacked P^T / dS^T fragments, dS^T through shared memory and the
    dQ adds give the plain version's dq, dk and dv (the replay in f64,
    the plain version in f32: 1e-5); each (row, d) of dQ is added once
    from each key block that sees its q-block."""
    rng = np.random.default_rng(S + D)
    q = rng.standard_normal((B, Hq, S, D))
    k = rng.standard_normal((B, Hkv, S, D))
    v = rng.standard_normal((B, Hkv, S, D))
    do = rng.standard_normal((B, Hq, S, D))
    pad = np.ones((B, S))
    pad[-1, S - n_pad:] = 0.0 if n_pad else 1.0
    scale = D ** -0.5
    seed = 20261017 if p_drop else None
    kw = dict(scale=scale, is_causal=causal, sliding_window=window,
              p_drop=p_drop, seed=seed)
    tq, tk, tv, tdo = (torch.as_tensor(a, dtype=torch.float64)
                       for a in (q, k, v, do))
    tpad = torch.as_tensor(pad)
    out, lse = fa.flash_attention_reference(tq, tk, tv, tpad, **{
        n: kw[n] for n in ("scale", "is_causal", "sliding_window", "p_drop",
                           "seed")})
    delta = (tdo * out).sum(-1, keepdim=True)
    want = fa.flash_bwd_merged_reference(tq, tk, tv, tpad, lse, delta, tdo,
                                         **kw)
    got = _bwd_mma_replay(q, k, v, pad, lse[..., 0].numpy(),
                          delta[..., 0].numpy(), do, scale, causal, window,
                          seed, p_drop)
    for a, b_ in zip(got[:3], want):   # the plain version runs in f32
        np.testing.assert_allclose(a, b_.numpy(), rtol=1e-4, atol=1e-5)
    plan = fa.bwd_plan(B, Hq, Hkv, S, D, torch.bfloat16)
    bq, bk = plan["block_q"], plan["block_k"]
    seen = np.zeros(S, dtype=np.int64)   # key blocks that see each row
    for x in range(plan["grid"][0]):
        qlo, qhi = fa._q_block_bounds(x * bk, -(-S // bq), causal, window,
                                      bq, bk)
        seen[qlo * bq:qhi * bq] += 1
    assert (got[3] == seen[None, None, :, None]).all()
    assert seen.min() >= 1


# ------------------------------------------------------------- row 6 -------

CE_FWD_SHAPES = [  # (R, V, H)
    (128, 262144, 640),     # the Gemma-3 chunk
    (256, 262144, 640),     # batch 8
    (37, 50257, 1152),      # R 37, a ragged V, H 1,152
    (120, 50257, 1152),
    (37, 1001, 200),
    (8, 100, 8),
    (40, 3001, 1520),
]


def test_fwd_mma_plan_constants_match_the_source():
    text = _source("fused_ce_fwd_mma.cu")
    assert _constexpr(text, "VT") == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "VG") * 16 == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert _constexpr(text, "KR") == fc.FWD_MMA_KREGS
    assert "return h16_of(H) <= 16 * KR;" in text
    assert "(16 * RG + stages * VT) * (h16_of(H) + 8) * elem" in text
    assert "const int row0 = blockIdx.x * RT;" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert "dim3 grid(row_tiles, n_slabs);" in text
    assert re.search(r"if \(h_in_regs\(H\)\).*\s+return rg == 4 \? "
                     r"launch<T, 4, true>", text)
    for rg in (4, 2):
        assert re.search(rf"case {rg}:\s+return launch<T, {rg}, false>",
                         text)


@pytest.mark.parametrize("R,V,H", CE_FWD_SHAPES)
def test_fwd_mma_plan_covers_each_tile_once(R, V, H):
    """Every (row, vocab column) pair lies in exactly one CTA: row tiles
    partition [0, R), slabs of whole 32-column tiles partition [0, V),
    and the x index runs over the row tiles of a slab."""
    plan = fc.fwd_mma_plan(R, V, H, N_SM)
    rt = 16 * plan["row_groups"]
    span = plan["tiles_per_slab"] * fc.MMA_VOCAB_TILE
    gx, gy = plan["grid"]
    assert gx == -(-R // rt) and gy == plan["n_slabs"]
    hits = np.zeros((R, -(-V // fc.MMA_VOCAB_TILE)), dtype=np.int64)
    for slab, x in itertools.product(range(gy), range(gx)):
        r0, v0 = x * rt, slab * span
        assert r0 < R and v0 < V          # no empty CTA
        hits[r0:r0 + rt, v0 // 32:(v0 + span) // 32] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("R,V,H", CE_FWD_SHAPES)
def test_fwd_mma_plan_fits_the_card(R, V, H):
    plan = fc.fwd_mma_plan(R, V, H, N_SM)
    rg, st = plan["row_groups"], plan["stages"]
    ld = -(-H // 16) * 16 + 8
    assert plan["h_in_regs"] == (ld - 8 <= 16 * fc.FWD_MMA_KREGS)
    assert rg == 4 or not plan["h_in_regs"]   # the source's one layout
    assert plan["smem_bytes"] == (16 * rg + st * 32) * ld * 2
    assert (rg, st) in ((4, 3), (4, 2), (2, 3), (2, 2), (2, 1))
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    gx, gy = plan["grid"]
    if -(-V // fc.MMA_VOCAB_TILE) >= N_SM:
        assert gx * gy <= N_SM


def test_fwd_mma_plan_at_the_gemma_chunk():
    """R 128, V 262,144, H 640: h's 40 k-steps in registers, 64-row
    tiles, three W buffers, 66 slabs of 125 tiles: 132 CTAs, two of them
    a slab; H 1,152 reads h from shared memory (32-row tiles, two
    buffers)."""
    plan = fc.fwd_mma_plan(128, 262144, 640, N_SM)
    assert (plan["row_groups"], plan["stages"], plan["n_slabs"],
            plan["tiles_per_slab"], plan["h_in_regs"]) == (4, 3, 66, 125,
                                                           True)
    assert plan["grid"] == (2, 66) and plan["smem_bytes"] == 207360
    plan = fc.fwd_mma_plan(37, 50257, 1152, N_SM)
    assert (plan["row_groups"], plan["stages"], plan["h_in_regs"]) == \
        (2, 2, False)


@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_fwd_mma_plan_refuses_h_not_a_multiple_of_8(H):
    with pytest.raises(ValueError, match="H % 8"):
        fc.fwd_mma_plan(16, 100, H, N_SM)


# -------------------------------------------------------- rows 9 and 11 ----

LORA_LOGITS_SHAPES = [  # (R, V, H, r)
    (128, 262144, 640, 8),      # the Gemma-3 chunk with the head adapter
    (128, 262144, 640, 1),
    (128, 262144, 640, 4),
    (128, 262144, 640, 16),
    (128, 262144, 640, 128),    # the largest rank
    (256, 262144, 640, 8),      # batch 8
    (120, 50257, 1000, 4),      # ragged
    (37, 50257, 1152, 3),       # R 37, H 1,152, an odd rank
    (37, 50257, 1152, 128),
    (40, 3001, 1520, 128),      # the widest H a multiple of 8 here
    (8, 100, 8, 5),
]
LORA_PLANS = {"fused_ce_fwd_lora_mma.cu": fc.fwd_lora_mma_plan,
              "fused_ce_dbt_mma.cu": fc.dbt_mma_plan}


@pytest.mark.parametrize("name", sorted(LORA_PLANS))
def test_lora_logits_plan_constants_match_the_source(name):
    text = _source(name)
    assert _constexpr(text, "VT") == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "VG") * 16 == fc.MMA_VOCAB_TILE
    assert _constexpr(text, "KR") == fc.FWD_MMA_KREGS
    assert _constexpr(text, "MAX_RANK") == fc.MAX_RANK
    assert _constexpr(text, "SMEM_MAX") == fc.SMEM_MAX
    assert "return h16_of(H) <= 16 * KR;" in text
    assert "return h_in_regs(H) && h16_of(rk) == 16;" in text
    if "dbt" in name:
        assert _constexpr(text, "GT") == fc.DBT_GROUP
        assert "((16 * RG + stages * VT) * (ld + ldr) + 16 * RG * " \
               "(GT * VT + 8)) *" in text
        assert "constexpr int LDC = GT * VT + 8;" in text
        assert "if (gi != GT - 1 && tile + 1 != t_end) continue;" in text
        # the logits' MMA chains are cut and folded into f32 sums
        assert _constexpr(text, "KP") == 8
        assert "if (kc % KP == KP - 1) fold();" in text
    else:
        assert "(16 * RG + stages * VT) * (ld + ldr) * elem" in text
    assert "const int row0 = blockIdx.x * RT;" in text
    assert "const int t0 = slab * tiles_per_slab;" in text
    assert "dim3 grid(row_tiles, n_slabs);" in text
    assert re.search(r"if \(h_in_regs\(H\)\) \{.*\s+if \(rg != 4\) return",
                     text)
    assert re.search(r"if \(xa_in_regs\(H, rk\)\)\s+return launch<T, 4, "
                     r"true, true>", text)
    for rg in (4, 2):
        assert re.search(rf"case {rg}:\s+return launch<T, {rg}, false, "
                         rf"false>", text)


@pytest.mark.parametrize("name", sorted(LORA_PLANS))
@pytest.mark.parametrize("R,V,H,r", LORA_LOGITS_SHAPES)
def test_lora_logits_plan_covers_each_tile_once(name, R, V, H, r):
    """Every (row, vocab tile) lies in exactly one CTA: row tiles
    partition [0, R), slabs of whole 32-column tiles partition [0, V),
    the x index runs over the row tiles of a slab (row 11: each CTA's
    partial is the row tile's, `row_tiles` of them)."""
    plan = LORA_PLANS[name](R, V, H, r, N_SM)
    rt = 16 * plan["row_groups"]
    span = plan["tiles_per_slab"] * fc.MMA_VOCAB_TILE
    gx, gy = plan["grid"]
    assert gx == plan["row_tiles"] == -(-R // rt) and gy == plan["n_slabs"]
    hits = np.zeros((R, -(-V // fc.MMA_VOCAB_TILE)), dtype=np.int64)
    for slab, x in itertools.product(range(gy), range(gx)):
        r0, v0 = x * rt, slab * span
        assert r0 < R and v0 < V          # no empty CTA
        hits[r0:r0 + rt, v0 // 32:(v0 + span) // 32] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("name", sorted(LORA_PLANS))
@pytest.mark.parametrize("R,V,H,r", LORA_LOGITS_SHAPES)
def test_lora_logits_plan_fits_the_card(name, R, V, H, r):
    """Shared memory with xa's row tile, the bt tiles (and row 11's coef
    tile of four W tiles) within a block's 227 KB at every rank, the
    64-row tile wherever h's fragments sit in registers, xa's too only at
    r16 = 16, and one
    wave of CTAs."""
    plan = LORA_PLANS[name](R, V, H, r, N_SM)
    rg, st = plan["row_groups"], plan["stages"]
    ld = -(-H // 16) * 16 + 8
    r16 = -(-r // 16) * 16
    coef = 16 * rg * (fc.DBT_GROUP * 32 + 8) if "dbt" in name else 0
    assert plan["smem_bytes"] == ((16 * rg + st * 32) * (ld + r16 + 8)
                                  + coef) * 2
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    assert (rg, st) in ((4, 3), (4, 2), (2, 3), (2, 2), (2, 1))
    assert plan["h_in_regs"] == (ld - 8 <= 16 * fc.FWD_MMA_KREGS)
    assert rg == 4 or not plan["h_in_regs"]   # the source's one layout
    assert plan["xa_in_regs"] == (plan["h_in_regs"] and r16 == 16)
    gx, gy = plan["grid"]
    if -(-V // fc.MMA_VOCAB_TILE) >= N_SM:
        assert gx * gy <= N_SM


@pytest.mark.parametrize("r", [1, 4, 8, 16, 128])
def test_lora_logits_plans_fit_every_rank_at_the_gemma_width(r):
    for plan_fn in LORA_PLANS.values():
        plan = plan_fn(128, 262144, 640, r, N_SM)
        assert plan["smem_bytes"] <= fc.SMEM_MAX
        assert plan["row_groups"] == 4 and plan["h_in_regs"]


def test_lora_logits_plans_at_the_gemma_chunk():
    """R 128, V 262,144, H 640, r 8: row 6's launch (64-row tiles, three
    buffers, 66 slabs of 125 tiles: 132 CTAs) with h's and xa's fragments
    in registers; row 11 two row-tile partials, its coef tile filling
    the block's 227 KB to the byte; rank 128 takes two buffers, never a
    narrower tile."""
    fwd = fc.fwd_lora_mma_plan(128, 262144, 640, 8, N_SM)
    dbt = fc.dbt_mma_plan(128, 262144, 640, 8, N_SM)
    for plan in (fwd, dbt):
        assert (plan["row_groups"], plan["stages"], plan["n_slabs"],
                plan["tiles_per_slab"], plan["h_in_regs"],
                plan["xa_in_regs"], plan["row_tiles"]) == \
            (4, 3, 66, 125, True, True, 2)
        assert plan["grid"] == (2, 66)
    assert (fwd["smem_bytes"], dbt["smem_bytes"]) == (215040, 232448)
    for plan_fn in LORA_PLANS.values():
        big = plan_fn(128, 262144, 640, 128, N_SM)
        assert (big["row_groups"], big["stages"], big["xa_in_regs"]) == \
            (4, 2, False)


@pytest.mark.parametrize("name", sorted(LORA_PLANS))
@pytest.mark.parametrize("H", [1004, 642, 7, 0])
def test_lora_logits_plan_refuses_h_not_a_multiple_of_8(name, H):
    with pytest.raises(ValueError, match="H % 8"):
        LORA_PLANS[name](16, 100, H, 8, N_SM)


@pytest.mark.parametrize("name", sorted(LORA_PLANS))
@pytest.mark.parametrize("r", [0, -1, 129])
def test_lora_logits_plan_refuses_a_rank_out_of_range(name, r):
    with pytest.raises(ValueError, match="rank"):
        LORA_PLANS[name](16, 100, 64, r, N_SM)


def _lora_logits_replay(h, w, xa, bt, plan):
    """The logits loop of csrc/fused_ce_fwd_lora_mma.cu and
    fused_ce_dbt_mma.cu replayed in f64: the staged row tiles and W / bt
    tiles (zero past R, V, H and r), the lane addresses and the m16n8k16
    k-steps over H and then over r16, ldmatrix and mma.sync emulated.
    Yields (x, slab, tile, rg, vg, x_s, row0) with x the warp's two C
    fragments [2, 32, 4] and x_s its CTA's xa tile [RT * LDR]."""
    R, H = h.shape
    V, rk = bt.shape
    RG = plan["row_groups"]
    RT = 16 * RG
    H16, R16 = -(-H // 16) * 16, -(-rk // 16) * 16
    LD, LDR = H16 + 8, R16 + 8
    lane = np.arange(32)
    lr, lm = lane % 8, lane // 8

    def staged(src, first, n, ld):
        out = np.zeros((n, ld))
        m = max(0, min(n, src.shape[0] - first))
        out[:m, :src.shape[1]] = src[first:first + m]
        return out.reshape(-1)

    n_vt = -(-V // 32)
    for slab in range(plan["n_slabs"]):
        t0 = slab * plan["tiles_per_slab"]
        for x in range(plan["grid"][0]):
            row0 = x * RT
            h_s, x_s = staged(h, row0, RT, LD), staged(xa, row0, RT, LDR)
            for tile in range(t0, min(n_vt, t0 + plan["tiles_per_slab"])):
                w_s = staged(w, tile * 32, 32, LD)
                b_s = staged(bt, tile * 32, 32, LDR)
                for rg, vg in itertools.product(range(RG), range(2)):
                    a_row = rg * 16 + lr + (lm % 2) * 8
                    b_row = vg * 16 + lr + (lm // 2) * 8
                    frag = np.zeros((2, 32, 4))
                    for src_a, src_b, ld, k16 in ((h_s, w_s, LD, H16),
                                                  (x_s, b_s, LDR, R16)):
                        for kc in range(0, k16, 16):
                            a = _ldsm(src_a, a_row * ld + (lm // 2) * 8 + kc,
                                      False)
                            b = _ldsm(src_b, b_row * ld + (lm % 2) * 8 + kc,
                                      False)
                            _mma(frag[0], a, b[:, 0], b[:, 1])
                            _mma(frag[1], a, b[:, 2], b[:, 3])
                    yield frag, slab, tile, rg, vg, x_s, row0


def _fwd_lora_replay(h, w, xa, bt, labels, plan):
    """Row 9 replayed: the online (m, s, gold) of each lane over its
    columns, the quads' xor-shuffle merge, the vg = 1 warps' rows merged
    into the vg = 0 warps', a partial per (slab, row) and the merge pass
    in slab order. Returns (lse, gold) [R]."""
    R, V = h.shape[0], w.shape[0]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    state = {}
    for frag, slab, tile, rg, vg, _, row0 in _lora_logits_replay(
            h, w, xa, bt, plan):
        key = (slab, row0, rg, vg)
        m, s, gl = state.setdefault(key, (np.full((2, 32), -1e30),
                                          np.zeros((2, 32)),
                                          np.zeros((2, 32))))
        v0 = tile * 32 + vg * 16
        for i in range(2):
            rows = row0 + rg * 16 + g + 8 * i
            lab = np.where(rows < R, labels[np.minimum(rows, R - 1)], -1)
            cols = [(v0 + j * 8 + 2 * t + e, frag[j][:, 2 * i + e])
                    for j in range(2) for e in range(2)]
            mx = m[i].copy()
            for v, xv in cols:
                mx = np.where(v < V, np.maximum(mx, xv), mx)
                gl[i] += np.where((v < V) & (v == lab), xv, 0.0)
            se = sum(np.exp(np.where(v < V, xv - mx, -np.inf))
                     for v, xv in cols)
            s[i] = s[i] * np.exp(m[i] - mx) + se
            m[i] = mx

    def merge(m, s, mo, so):
        mx = np.maximum(m, mo)
        return mx, s * np.exp(m - mx) + so * np.exp(mo - mx)

    part = np.zeros((plan["n_slabs"], R, 3))
    written = np.zeros((plan["n_slabs"], R), dtype=np.int64)
    for (slab, row0, rg, vg), (m, s, gl) in state.items():
        for off in (1, 2):                 # the quads' xor shuffles
            mo, so, go = m[:, lane ^ off], s[:, lane ^ off], gl[:, lane ^ off]
            m, s = merge(m, s, mo, so)
            gl = gl + go
        state[(slab, row0, rg, vg)] = (m, s, gl)
    for (slab, row0, rg, vg), (m, s, gl) in state.items():
        if vg:
            continue
        mo, so, go = state[(slab, row0, rg, 1)]
        for i in range(2):
            for ln in range(0, 32, 4):     # t == 0 lanes
                r = row0 + rg * 16 + ln // 4 + 8 * i
                if r < R:
                    mm, ss = merge(m[i, ln], s[i, ln], mo[i, ln], so[i, ln])
                    part[slab, r] = (mm, ss, gl[i, ln] + go[i, ln])
                    written[slab, r] += 1
    assert (written == 1).all()
    mx = part[:, :, 0].max(0)
    return mx + np.log((part[:, :, 1] * np.exp(part[:, :, 0] - mx)).sum(0)), \
        part[:, :, 2].sum(0)


def _dbt_replay(h, w, xa, bt, labels, lse, dlse, dgold, plan):
    """Row 11's dbt-only kernel replayed: coef on the C fragments (f32
    rounding, the storage dtype of an f32 case), written to the coef tile
    [RT, GT x 32 + 8] from the fragment map, GT = 4 W tiles a group; at a
    group's end (or the slab's) its (16-column m-tile, rank pair) items
    dealt to the warps in turn, coef^T read back by ldmatrix.trans and
    multiplied with xa's staged rows (ldmatrix.trans); each row tile's
    [V, r] partial written once an element, summed over row tiles in
    order. Returns dbt [V, r]."""
    R, V = h.shape[0], w.shape[0]
    rk = bt.shape[1]
    RG = plan["row_groups"]
    RT, W = 16 * RG, 2 * RG
    R16 = -(-rk // 16) * 16
    GT = 4
    LDR, LDC = R16 + 8, GT * 32 + 8
    n_vt = -(-V // 32)
    lane = np.arange(32)
    g, t, lr, lm = lane >> 2, lane & 3, lane % 8, lane // 8
    part = np.zeros((plan["row_tiles"], V, rk))
    hits = np.zeros((plan["row_tiles"], V, rk), dtype=np.int64)
    c_s = {}                               # each CTA's coef tile

    def product(gi, tile, x_s, c_s, row0):
        n_m, gv0 = (gi + 1) * 2, (tile - gi) * 32
        ct = (lr + (lm // 2) * 8) * LDC + (lm % 2) * 8
        xt = (lr + (lm % 2) * 8) * LDR + (lm // 2) * 8
        for warp in range(W):
            for item in range(warp, n_m * (R16 // 16), W):
                mt, p = item % n_m, item // n_m
                d = np.zeros((2, 32, 4))
                for kk in range(RG):
                    a = _ldsm(c_s, ct + kk * 16 * LDC + mt * 16, True)
                    b = _ldsm(x_s, xt + kk * 16 * LDR + p * 16, True)
                    _mma(d[0], a, b[:, 0], b[:, 1])
                    _mma(d[1], a, b[:, 2], b[:, 3])
                for e, j in itertools.product(range(4), range(2)):
                    v = gv0 + mt * 16 + g + 8 * (e >> 1)
                    col = p * 16 + j * 8 + 2 * t + (e & 1)
                    ok = (v < V) & (col < rk)
                    part[row0 // RT, v[ok], col[ok]] = d[j][ok, e]
                    hits[row0 // RT, v[ok], col[ok]] += 1

    n_warps = 0
    for frag, slab, tile, rg, vg, x_s, row0 in _lora_logits_replay(
            h, w, xa, bt, plan):
        t0 = slab * plan["tiles_per_slab"]
        t_end = min(n_vt, t0 + plan["tiles_per_slab"])
        gi = (tile - t0) % GT
        cs = c_s.setdefault((slab, row0), np.zeros(RT * LDC))
        v0 = tile * 32 + vg * 16
        for i in range(4):
            j, rr = i >> 1, i & 1
            rows = row0 + rg * 16 + g + 8 * rr
            ok_r = rows < R
            rc = np.minimum(rows, R - 1)
            for e in range(2):
                v = v0 + j * 8 + 2 * t + e
                c = dlse[rc] * np.exp(frag[j][:, rr * 2 + e] - lse[rc]) \
                    + np.where(v == labels[rc], dgold[rc], 0.0)
                c = np.where(ok_r & (v < V), c, 0.0).astype(np.float32)
                cs[(rg * 16 + g + 8 * rr) * LDC + gi * 32 + vg * 16 + j * 8
                   + 2 * t + e] = c
        n_warps += 1
        if n_warps % W == 0 and (gi == GT - 1 or tile + 1 == t_end):
            product(gi, tile, x_s, cs, row0)   # after the group's sync
    assert (hits == 1).all()
    out = np.zeros((V, rk))
    for k in range(plan["row_tiles"]):     # the reduce pass, in order
        out += part[k]
    return out


def _lora_case(R, V, H, r, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((R, H)).astype(np.float32),
            (0.3 * rng.standard_normal((V, H))).astype(np.float32),
            rng.standard_normal((R, r)).astype(np.float32),
            (0.3 * rng.standard_normal((V, r))).astype(np.float32),
            rng.integers(0, V, R), rng.standard_normal(R),
            rng.standard_normal(R))


@pytest.mark.parametrize("R,V,H,r,row_groups", [
    (37, 301, 40, 3, None),      # ragged R, V and H, r < 16, one row tile
    (37, 301, 40, 8, None),
    (37, 301, 40, 8, 2),         # two 32-row tiles
    (20, 70, 16, 16, 2),         # r16 = 16 exactly
    (37, 130, 24, 20, 2),        # two rank k-steps, a ragged pair
])
def test_lora_fragment_maps_replay_the_plain_versions(R, V, H, r,
                                                      row_groups):
    """Rows 9 and 11's fragment maps, replayed with ldmatrix and mma.sync
    emulated in numpy (f64; the plain versions in f32: 1e-5): the rank
    k-steps over r16 with the columns past r zero give the plain
    version's (lse, gold); coef through the coef tile, ldmatrix.trans
    and the per-row-tile partials summed in order give its dbt
    (fused_ce_dw_lora_reference, want_dw=False)."""
    h, w, xa, bt, lab, dlse, dgold = _lora_case(R, V, H, r, R + V + r)
    T = {n: torch.as_tensor(a) for n, a in zip(
        ("h", "w", "xa", "bt", "lab"), (h, w, xa, bt, lab))}
    plans = {}
    for name, plan_fn in LORA_PLANS.items():
        plan = plan_fn(R, V, H, r, N_SM)
        if row_groups:                     # the kernel's other tile
            rt = 16 * row_groups
            plan = fc._slab_plan(dict(plan, row_groups=row_groups,
                                      row_tiles=-(-R // rt)),
                                 -(-R // rt), V, N_SM)
        plans[name] = plan
    lse, gold = _fwd_lora_replay(h, w, xa, bt, lab,
                                 plans["fused_ce_fwd_lora_mma.cu"])
    rl, rg = fc.fused_ce_fwd_lora_reference(T["h"], T["w"], T["xa"],
                                            T["bt"], T["lab"])
    np.testing.assert_allclose(lse, rl.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gold, rg.numpy(), rtol=1e-5, atol=1e-5)
    lse64 = rl.numpy().astype(np.float64)
    got = _dbt_replay(h, w, xa, bt, lab, lse64, dlse, dgold,
                      plans["fused_ce_dbt_mma.cu"])
    no_dw, want = fc.fused_ce_dw_lora_reference(
        T["h"], T["w"], T["xa"], T["bt"], T["lab"], rl,
        torch.as_tensor(dlse, dtype=torch.float32),
        torch.as_tensor(dgold, dtype=torch.float32), want_dw=False)
    assert no_dw is None
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------- rows 5 and 13: sources --

def test_first_versions_of_rows_5_and_13_keep_only_f32():
    """The 16-bit cases left csrc/lora_epilogue.cu and
    csrc/decode_attention.cu for the new sources; their f32 kernels stay."""
    epi = _entry(_source("lora_epilogue.cu"), "mft_lora_epilogue")
    assert "dtype != 0" in epi and "launch<float>" in epi
    dec = _entry(_source("decode_attention.cu"), "mft_decode_attention")
    assert "dtype != 0" in dec and "dispatch_d<float>" in dec
    for entry in (epi, dec):
        assert "__nv_bfloat16" not in entry and "__half" not in entry


def test_row_5_and_13_sources_are_built_and_call_no_library():
    from mobilefinetuner_tpu_torch.kernels import build
    for name in ("lora_epilogue_vec", "decode_attention_mma"):
        assert name in build.SOURCES
        text = _source(f"{name}.cu")
        for lib in ("cublas", "cutlass", "torch/", "<aten"):
            assert lib not in text.lower()
    dec = _source("decode_attention_mma.cu")
    assert "mma_16816<T>" in dec and "ldmatrix_x4(" in dec
    assert "ldmatrix_x4_trans" in dec and "cp_async_16" in dec
    assert '#include "tensor_core.cuh"' in dec
    epi = _source("lora_epilogue_vec.cu")
    # no shared memory and no barrier: y's loads come first
    assert "__shared__" not in epi and "__syncthreads" not in epi


# ------------------------------------------------------------- row 5 -------

EPI_SHAPES = [  # (N, d_out): the paths' sites and the decode shapes
    (1024, 2304), (1024, 768),                 # GPT-2 attn_qkv, attn_proj
    (1024, 2048), (1024, 1024), (1024, 640),   # Gemma gate/up, q, o/down
    (1024, 256),                               # Gemma k/v
    (8, 2304), (8, 768), (4, 2048), (4, 256),  # generate's decode steps
    (4, 262144),                               # the head adapter's lm_head
    (37, 300), (1000, 770), (5, 301), (3, 2),  # narrower vectors
]


def test_epilogue_vec_plan_constants_match_the_source():
    text = _source("lora_epilogue_vec.cu")
    assert _constexpr(text, "THREADS") == lf.VEC_THREADS
    assert _constexpr(text, "MAX_RANK") == lf.MAX_RANK
    assert f"if (rows == {lf.VEC_ROWS} && vec == 8)\n    return " \
        f"launch<T, 8, {lf.VEC_ROWS}>" in text
    for vec in (8, 4, 2, 1):
        assert f"case {vec}:\n      return launch<T, {vec}, 1>" in text


@pytest.mark.parametrize("N,d_out", EPI_SHAPES)
def test_epilogue_vec_plan_covers_each_vector_once(N, d_out):
    """The kernel's slot map (slot -> column vector slot % ncv, rows
    slot / ncv + i rs), replayed: every (row, column vector) once, and the
    32 slots of a warp on 32 neighbouring vectors of the flat [N, d_out]
    array for each of a thread's rows."""
    plan = lf.epilogue_vec_plan(N, d_out, N_SM)
    vec, rows, rs, ncv = (plan[k] for k in ("vec", "rows", "rs", "ncv"))
    assert ncv * vec == d_out and rs * rows >= N > rs * (rows - 1) - 1
    slots = np.arange(plan["ctas"] * lf.VEC_THREADS)
    slots = slots[slots < ncv * rs]
    cv, n0 = slots % ncv, slots // ncv
    hits = np.zeros((N, ncv), np.int64)
    for i in range(rows):
        n = n0 + i * rs
        keep = n < N
        np.add.at(hits, (n[keep], cv[keep]), 1)
        flat = n * ncv + cv                      # vector index in the array
        for w in range(0, len(slots), 32):       # a warp's vectors
            f = flat[w:w + 32][keep[w:w + 32]]
            assert (np.diff(f) == 1).all()
    assert (hits == 1).all()


@pytest.mark.parametrize("N,d_out", [s for s in EPI_SHAPES if s[0] >= 1024]
                         + [(4, 262144)])
def test_epilogue_vec_plan_fills_the_card(N, d_out):
    """At every training site and the head adapter's decode site the grid
    has at least one CTA an SM (attn_proj: 768, where the first version
    had 96), with 16-byte vectors."""
    plan = lf.epilogue_vec_plan(N, d_out, N_SM)
    assert plan["ctas"] >= N_SM and plan["vec"] == 8


def test_epilogue_vec_plan_widths_and_rows():
    """16-byte vectors where d_out and the addresses allow, narrower ones
    where not (rank128_f16's d_out 300: 8 bytes); four rows a thread only
    where they are all the rows (N <= 4), the vectors 16 bytes and the
    CTAs still a wave (the head adapter's lm_head)."""
    def plan(N, d_out, **kw):
        return lf.epilogue_vec_plan(N, d_out, N_SM, **kw)
    assert [plan(37, d)["vec"] for d in (300, 770, 301)] == [4, 2, 1]
    assert plan(1024, 2304, addr_align=8)["vec"] == 4
    assert plan(1024, 2304, addr_align=2)["vec"] == 1
    assert [plan(N, 262144)["rows"] for N in (1024, 8, 5, 4, 1)] == \
        [1, 1, 1, 4, 4]
    assert plan(4, 2048)["rows"] == 1 and plan(4, 300)["rows"] == 1
    assert plan(1024, 768)["ctas"] == 768
    assert plan(4, 262144)["ctas"] == 256


def test_epilogue_vec_f32_constants_match_the_source():
    text = _source("lora_epilogue_vec_f32.cu")
    assert _constexpr(text, "THREADS") == lf.VEC_THREADS
    assert _constexpr(text, "MAX_RANK") == lf.MAX_RANK
    assert f"if (rows == {lf.VEC_ROWS} && vec == 4)\n    return " \
        f"launch<4, {lf.VEC_ROWS}>" in text
    for vec in (4, 2, 1):
        assert f"case {vec}:\n      return launch<{vec}, 1>" in text
    assert "__shared__" not in text and "__syncthreads" not in text
    assert "xv[kk] *= s;" in text          # the scale folded in, in f32


@pytest.mark.parametrize("N,d_out", EPI_SHAPES)
def test_epilogue_vec_f32_plan_covers_each_vector_once(N, d_out):
    """The f32 plan (4-byte elements): every (row, column vector) once,
    16 bytes at most a vector, a warp's slots on neighbouring vectors."""
    plan = lf.epilogue_vec_plan(N, d_out, N_SM, elem_bytes=4)
    vec, rows, rs, ncv = (plan[k] for k in ("vec", "rows", "rs", "ncv"))
    assert vec in (4, 2, 1) and ncv * vec == d_out
    slots = np.arange(plan["ctas"] * lf.VEC_THREADS)
    slots = slots[slots < ncv * rs]
    cv, n0 = slots % ncv, slots // ncv
    hits = np.zeros((N, ncv), np.int64)
    for i in range(rows):
        n = n0 + i * rs
        keep = n < N
        np.add.at(hits, (n[keep], cv[keep]), 1)
        flat = n * ncv + cv
        for w in range(0, len(slots), 32):
            f = flat[w:w + 32][keep[w:w + 32]]
            assert (np.diff(f) == 1).all()
    assert (hits == 1).all()


def test_epilogue_vec_f32_plan_widths_and_rows():
    """In f32 the vectors are 4 floats where d_out and the addresses
    allow (16 bytes), 2 or 1 where not; four rows a thread at N <= 4 on
    16-byte vectors when the CTAs still fill the card (the lm_head)."""
    def plan(N, d_out, **kw):
        return lf.epilogue_vec_plan(N, d_out, N_SM, elem_bytes=4, **kw)
    assert [plan(1024, d)["vec"] for d in (2304, 770, 301)] == [4, 2, 1]
    assert plan(1024, 2304, addr_align=8)["vec"] == 2
    assert plan(1024, 2304, addr_align=4)["vec"] == 1
    assert [plan(N, 262144)["rows"] for N in (1024, 5, 4, 1)] == \
        [1, 1, 4, 4]
    assert plan(4, 2048)["rows"] == 1 and plan(4, 770)["rows"] == 1
    assert plan(1024, 2304)["ctas"] == 1024 * 576 // 128


# ------------------------------------------------------------ row 13 -------

DECODE_SHAPES = [  # (B, KV, G, T, D)
    (4, 1, 4, 665, 256),       # Gemma's last generate step
    (8, 12, 1, 192, 64),       # GPT-2's
    (1, 1, 4, 32768, 256),     # a whole Gemma-3 context
    (4, 1, 4, 1, 256),         # T 1
    (3, 2, 2, 20, 32),         # T under one tile
    (3, 2, 2, 40, 32),
    (2, 3, 40, 77, 128),       # G past one CTA's 16 heads
    (65535, 1, 1, 64, 64),     # the most batch rows
]


def test_decode_mma_plan_constants_match_the_source():
    text = _source("decode_attention_mma.cu")
    assert _constexpr(text, "TILE") == da.DECODE_MMA_TILE
    assert _constexpr(text, "QR") == da.DECODE_MMA_QROWS
    assert _constexpr(text, "STAGES") == da.DECODE_MMA_STAGES
    assert _constexpr(text, "MERGE_MAX_CHUNKS") == da.DECODE_MMA_MAX_CHUNKS
    assert "constexpr int SP = TILE + 8;" in text
    assert _constexpr(text, "MERGE_BATCH") == 32
    assert "static constexpr int WARPS = D >= 64 ? 4 : 2;" in text
    assert "static constexpr int LD = DW + 8;" in text


@pytest.mark.parametrize("B,KV,G,T,D", DECODE_SHAPES)
def test_decode_mma_plan_covers_each_tile_once(B, KV, G, T, D):
    """Every 32-key tile in exactly one chunk, every query head in one
    group of 16, a workspace for each chunk's (m, l, acc) when there is
    more than one."""
    plan = da.decode_mma_plan(B, KV, G, T, D, torch.bfloat16, N_SM)
    tpc, n_chunks = plan["tiles_per_chunk"], plan["n_chunks"]
    n_tiles = -(-T // 32)
    seen = np.zeros(n_tiles, np.int64)
    for c in range(n_chunks):
        seen[c * tpc:min((c + 1) * tpc, n_tiles)] += 1
    assert (seen == 1).all() and (n_chunks - 1) * tpc < n_tiles
    heads = np.zeros(G, np.int64)
    for qg in range(plan["n_qg"]):
        heads[16 * qg:16 * qg + 16] += 1
    assert (heads == 1).all()
    assert plan["grid"] == (n_chunks, KV * plan["n_qg"], B)
    assert plan["ws_floats"] == (n_chunks * B * KV * G * (D + 2)
                                 if n_chunks > 1 else 0)


@pytest.mark.parametrize("B,KV,G,T,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_mma_plan_fits_the_card(B, KV, G, T, D, dtype):
    """Shared memory within a block's 227 KB, grid dimensions within the
    card's limits, at most DECODE_MMA_MAX_CHUNKS chunks, and at least a
    wave of CTAs wherever T has the tiles for it (or one chunk a tile)."""
    plan = da.decode_mma_plan(B, KV, G, T, D, dtype, N_SM)
    assert plan["smem_bytes"] <= fc.SMEM_MAX
    gx, gy, gz = plan["grid"]
    assert gy <= 65535 and gz <= 65535
    assert gx <= da.DECODE_MMA_MAX_CHUNKS
    units = B * KV * plan["n_qg"]
    assert gx * units >= min(N_SM, units * -(-T // 32)) * 31 // 32 \
        or plan["tiles_per_chunk"] == 1


def test_decode_mma_plan_at_the_path_shapes():
    """Gemma's last step: 21 chunks of one tile (84 CTAs, was 16);
    GPT-2's: 6 chunks of one tile (576 CTAs, was 96); T 1 and T < 32: one
    chunk, no workspace, no merge; T 32,768 at B 1: 128 chunks of 8 (the
    most the merge takes)."""
    def split(*shape):
        p = da.decode_mma_plan(*shape, torch.bfloat16, N_SM)
        return p["n_chunks"], p["tiles_per_chunk"], p["ws_floats"]
    assert split(4, 1, 4, 665, 256) == (21, 1, 21 * 16 * 258)
    assert split(8, 12, 1, 192, 64) == (6, 1, 6 * 96 * 66)
    assert split(4, 1, 4, 1, 256) == (1, 1, 0)
    assert split(3, 2, 2, 20, 32) == (1, 1, 0)
    assert split(1, 1, 4, 32768, 256)[:2] == (128, 8)
    assert da.decode_mma_plan(4, 1, 4, 665, 256, torch.bfloat16,
                              N_SM)["grid"] == (21, 1, 4)


def test_decode_mma_plan_refuses_what_the_kernel_does_not_take():
    for args in ((4, 1, 4, 665, 96, torch.bfloat16),
                 (4, 1, 4, 0, 256, torch.bfloat16),
                 (4, 1, 4, 665, 256, torch.float32),
                 (65536, 1, 1, 64, 64, torch.bfloat16)):
        with pytest.raises(ValueError):
            da.decode_mma_plan(*args)


def _decode_mma_replay(q, kc, vc, ok, scale, plan, round_p):
    """csrc/decode_attention_mma.cu replayed in f64: its grid (chunks, kv
    heads, groups of 16 query heads, b; a chunk with no attendable column
    skips all its tiles and stores (NEG_INF, 0)), each warp's column slice
    of the
    K/V tiles with masked rows zero-filled, Q's A fragments, the partial
    S by ldmatrix and mma.sync emulated, the partials through the
    [warp][row][key] buffer summed in warp order, the quad softmax, P
    repacked into A fragments (rounded to bf16 when round_p), V's B
    fragments by ldmatrix.trans, the stores of ctx or of the partials,
    and the merge in chunk order. Returns ctx [B, KV, G, D]."""
    import torch as _t
    B, KV, G, D = q.shape
    T = kc.shape[2]
    W = plan["warps"]
    DW = D // W
    LD, KS, ND = DW + 8, DW // 16, DW // 8
    NEG = da.NEG_INF
    lane = np.arange(32)
    g, t, lr, lm = lane >> 2, lane & 3, lane & 7, lane >> 3
    k_off = (lr + (lm >> 1) * 8) * LD + (lm & 1) * 8
    v_off = (lr + (lm & 1) * 8) * LD + (lm >> 1) * 8
    tpc, n_chunks = plan["tiles_per_chunk"], plan["n_chunks"]
    n_tiles = -(-T // 32)
    rows_total = B * KV * G
    ws_ml = np.full((n_chunks, rows_total, 2), np.nan)
    ws_acc = np.full((n_chunks, rows_total, D), np.nan)
    ctx = np.full((B * KV * G, D), np.nan)

    def rnd(x):
        return _t.from_numpy(x).to(_t.bfloat16).double().numpy() \
            if round_p else x

    def quad(x, op):                  # xor 1, xor 2 over a lane quad
        y = op(x, x[lane ^ 1])
        return op(y, y[lane ^ 2])
    for b, kv, qg, chunk in itertools.product(
            range(B), range(KV), range(plan["n_qg"]), range(n_chunks)):
        qg0 = 16 * qg
        nq = min(16, G - qg0)
        row0 = (b * KV + kv) * G + qg0
        tile0, tile1 = chunk * tpc, min(chunk * tpc + tpc, n_tiles)
        qf = np.zeros((W, KS, 32, 4, 2))     # Q's A fragments
        for w, ks, i in itertools.product(range(W), range(KS), range(4)):
            row = g + (i & 1) * 8
            col = w * DW + ks * 16 + (i >> 1) * 8 + 2 * t
            live_l = row < nq
            src = q[b, kv, np.minimum(qg0 + row, G - 1)]
            qf[w, ks, :, i, 0] = np.where(live_l, src[lane, col], 0)
            qf[w, ks, :, i, 1] = np.where(live_l, src[lane, col + 1], 0)
        live = [g < nq, g + 8 < nq]
        o = np.zeros((W, ND, 32, 4))
        m = np.full((32, 2), NEG)
        l = np.zeros((32, 2))
        for tile in range(tile0, tile1):
            t0 = 32 * tile
            okt = np.zeros(32, bool)
            okt[:min(32, T - t0)] = ok[b, t0:t0 + 32]
            if not okt.any():
                continue
            s_part = np.full((W, 16, 40), np.nan)
            k_s, v_s = [], []
            for w in range(W):
                kt = np.zeros((32, LD))
                vt = np.zeros((32, LD))
                for rr in np.nonzero(okt)[0]:
                    kt[rr, :DW] = kc[b, kv, t0 + rr, w * DW:(w + 1) * DW]
                    vt[rr, :DW] = vc[b, kv, t0 + rr, w * DW:(w + 1) * DW]
                k_s.append(kt.reshape(-1))
                v_s.append(vt.reshape(-1))
                s = np.zeros((4, 32, 4))
                for ks in range(KS):
                    for j in (0, 2):
                        bk = _ldsm(k_s[w], k_off + j * 8 * LD + ks * 16,
                                   False)
                        _mma(s[j], qf[w, ks], bk[:, 0], bk[:, 1])
                        _mma(s[j + 1], qf[w, ks], bk[:, 2], bk[:, 3])
                for j in range(4):
                    s_part[w, g, j * 8 + 2 * t] = s[j][:, 0]
                    s_part[w, g, j * 8 + 2 * t + 1] = s[j][:, 1]
                    s_part[w, g + 8, j * 8 + 2 * t] = s[j][:, 2]
                    s_part[w, g + 8, j * 8 + 2 * t + 1] = s[j][:, 3]
            # every warp sums the partials in warp order: the same scores
            sc = np.zeros((4, 32, 4))
            okb = np.zeros((4, 32, 4), bool)
            for j, e in itertools.product(range(4), range(4)):
                key = j * 8 + 2 * t + (e & 1)
                row = g + (e >> 1) * 8
                tot = np.zeros(32)
                for w in range(W):
                    tot = tot + s_part[w, row, key]
                okb[j, :, e] = live[e >> 1] & okt[key]
                sc[j, :, e] = np.where(okb[j, :, e], tot * scale, NEG)
            mx = np.stack([sc[:, :, [0, 1]].max(axis=(0, 2)),
                           sc[:, :, [2, 3]].max(axis=(0, 2))], 1)
            mx = np.stack([quad(mx[:, i], np.maximum) for i in range(2)], 1)
            m_new = np.maximum(m, mx)
            alpha = np.exp(m - m_new)
            m = m_new
            p = np.where(okb, np.exp(sc - m[None, :, [0, 0, 1, 1]]), 0.0)
            psum = np.stack([p[:, :, [0, 1]].sum(axis=(0, 2)),
                             p[:, :, [2, 3]].sum(axis=(0, 2))], 1)
            psum = np.stack([quad(psum[:, i], np.add) for i in range(2)], 1)
            l = l * alpha + psum
            o *= alpha[None, None, :, [0, 0, 1, 1]]
            pr = rnd(p)
            for w, kk in itertools.product(range(W), range(2)):
                a = np.stack([pr[2 * kk + (i >> 1), :, (i & 1) * 2:
                                 (i & 1) * 2 + 2] for i in range(4)], 1)
                for n in range(0, ND, 2):
                    bv = _ldsm(v_s[w], v_off + kk * 16 * LD + n * 8, True)
                    _mma(o[w, n], a, bv[:, 0], bv[:, 1])
                    _mma(o[w, n + 1], a, bv[:, 2], bv[:, 3])
        for i, w, n in itertools.product(range(2), range(W), range(ND)):
            row = g + 8 * i
            sel = row < nq
            cols = w * DW + n * 8 + 2 * t
            for c in (0, 1):
                val = o[w, n, :, 2 * i + c]
                if n_chunks == 1:
                    val = np.where(l[:, i] > 0,
                                   val / np.maximum(l[:, i], 1e-300), 0.0)
                    ctx[row0 + row[sel], cols[sel] + c] = val[sel]
                else:
                    ws_acc[chunk, row0 + row[sel], cols[sel] + c] = val[sel]
            if n_chunks > 1 and w == 0 and n == 0:
                first = sel & (t == 0)
                ws_ml[chunk, row0 + row[first]] = np.stack(
                    [m[first, i], l[first, i]], 1)
    if n_chunks > 1:                    # the merge kernel, chunk order
        lc = ws_ml[:, :, 1]
        mmax = np.where(lc > 0, ws_ml[:, :, 0], NEG).max(0)
        num = np.zeros((rows_total, D))
        den = np.zeros(rows_total)
        for c in range(n_chunks):
            f = np.where(lc[c] > 0, np.exp(ws_ml[c, :, 0] - mmax), 0.0)
            num += np.where(lc[c][:, None] > 0,
                            f[:, None] * np.nan_to_num(ws_acc[c]), 0.0)
            den += np.where(lc[c] > 0, f * lc[c], 0.0)
        ctx = np.where(den[:, None] > 0, num / np.maximum(den, 1e-300)
                       [:, None], 0.0)
    assert not np.isnan(ctx).any()          # every row written
    return ctx.reshape(B, KV, G, D)


@pytest.mark.parametrize("B,KV,G,T,D,pads,window,tpc", [
    (2, 2, 1, 70, 64, (0, 40), None, None),     # GPT-2 layout, 2 chunks
    (2, 1, 4, 100, 256, (0, 3), 40, None),      # Gemma layout, window
    (2, 1, 4, 100, 128, (0, 60), None, 1),      # a masked chunk (b 1)
    (3, 2, 2, 40, 32, (5, 0, 39), None, 2),     # one chunk, two warps
    (1, 1, 18, 45, 64, (2,), None, 1),          # two groups of heads
])
def test_decode_mma_fragment_map_replays_the_plain_version(
        B, KV, G, T, D, pads, window, tpc):
    """Row 13's fragment map, replayed with ldmatrix and mma.sync emulated
    in numpy (f64): with p kept in f32 it gives xla_reference's ctx
    (1e-5), masked K/V rows holding Inf and NaN changing nothing; with p
    rounded to bf16, within the bf16 tolerance of it."""
    rng = np.random.default_rng(T + D)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, T, D)).astype(np.float32)
    cols = np.arange(T)
    ok = cols[None, :] >= np.asarray(pads)[:, None]
    if window is not None:
        ok &= cols[None, :] > T - 1 - window
    scale = D ** -0.5
    want = da.xla_reference(*(torch.from_numpy(a) for a in (q, kc, vc, ok)),
                            scale).numpy()
    masked = np.broadcast_to(~ok[:, None, :], kc.shape[:3])
    kc[masked] = np.inf
    vc[masked] = np.nan
    plan = da.decode_mma_plan(B, KV, G, T, D, torch.bfloat16, N_SM)
    if tpc is not None:
        n_tiles = -(-T // 32)
        plan = dict(plan, tiles_per_chunk=tpc, n_chunks=-(-n_tiles // tpc))
    got = _decode_mma_replay(q, kc, vc, ok, scale, plan, round_p=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got = _decode_mma_replay(q, kc, vc, ok, scale, plan, round_p=True)
    assert np.max(np.abs(got - want)) <= 2e-2


# ------------------------------------------------------------ row 12 -------

PAGED_SHAPES = [  # (S, KV, G, M, bT, D)
    (8, 12, 1, 12, 16, 64),      # GPT-2 small's serve step
    (8, 1, 4, 42, 16, 256),      # Gemma-3-270M serving, T 672
    (8, 1, 4, 12, 16, 256),
    (1, 12, 1, 12, 16, 64),      # one slot
    (4, 4, 1, 5, 8, 128),
    (2, 2, 6, 7, 8, 64),         # two groups of query heads
    (1, 1, 4, 2048, 16, 256),    # a 32,768-token Gemma-3 context
    (8, 12, 1, 12, 1024, 64),    # the largest pages
    (2, 1, 4, 3, 1024, 256),     # chunks end inside a page
    (3, 2, 2, 1, 1, 128),        # one column a slot
]


def test_paged_plan_constants_match_the_source():
    text = _source("paged_decode_attention_vec.cu")
    assert _constexpr(text, "ROW_SLOTS") == da.PAGED_VEC_ROW_SLOTS
    assert _constexpr(text, "MAX_QG") == da.PAGED_VEC_MAX_QG
    assert _constexpr(text, "MAX_CHUNKS") == da.PAGED_VEC_MAX_CHUNKS
    assert _constexpr(text, "MERGE_BATCH") == 32
    assert "return QG == 4 ? 8 : 16;" in text
    assert "constexpr int LPR = D / 8;" in text
    # the shared memory the launch asks for, as the plan counts it
    assert ("return ((size_t)2 * warps_for(QG) * QG +\n"
            "          (size_t)warps_for(QG) * QG * D) * 4;") in text
    assert "const int qg = G == 1 ? 1 : G == 2 ? 2 : MAX_QG;" in text
    assert "(long long)cpc * D > (long long)ROW_SLOTS * 256" in text
    assert "n_chunks != (M * bT + cpc - 1) / cpc" in text


@pytest.mark.parametrize("S,KV,G,M,bT,D", PAGED_SHAPES)
def test_paged_plan_covers_each_live_page_once(S, KV, G, M, bT, D):
    """The chunks (chunk c: logical columns [c cpc, c cpc + cpc)) cover
    every column once, so each row of every live page once; a chunk
    touches at most the pages its table stage holds; every query head is
    in one group; the workspace holds each chunk's (m, l, acc)."""
    plan = da.paged_plan(S, KV, G, M, bT, D, torch.bfloat16, N_SM)
    cpc, n_chunks, qg = plan["cpc"], plan["n_chunks"], plan["qg"]
    cols = M * bT
    rng = np.random.default_rng(cols + D)
    live = rng.random((S, M)) < 0.6          # pages with a live column
    hits = np.zeros((S, M, bT), np.int64)
    for c in range(n_chunks):
        c0, c1 = c * cpc, min(c * cpc + cpc, cols)
        assert c0 < c1
        assert (c1 - 1) // bT - c0 // bT + 1 <= (cpc - 1) // bT + 2
        col = np.arange(c0, c1)
        for s in range(S):
            page, row = col // bT, col % bT
            keep = live[s, page]
            np.add.at(hits[s], (page[keep], row[keep]), 1)
    assert (hits[live] == 1).all() and (hits[~live] == 0).all()
    heads = np.zeros(G, np.int64)
    for group in range(plan["n_qg"]):
        heads[group * qg:min(group * qg + qg, G)] += 1
    assert (heads == 1).all()
    assert plan["grid"] == (n_chunks, KV * plan["n_qg"], S)
    assert plan["ws_floats"] == (n_chunks * S * KV * G * (D + 2)
                                 if n_chunks > 1 else 0)


@pytest.mark.parametrize("S,KV,G,M,bT,D", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_plan_fits_the_card(S, KV, G, M, bT, D, dtype):
    """Shared memory within the default 48 KB, a chunk's rows within
    what its lanes hold in registers (ROW_SLOTS passes of 256 / D rows),
    grid dimensions within the card's limits, the merge's chunks within
    MAX_CHUNKS, and the CTAs within a wave unless a chunk is as small as
    the plan makes one (or as the registers cap it)."""
    plan = da.paged_plan(S, KV, G, M, bT, D, dtype, N_SM)
    cpc = plan["cpc"]
    assert plan["smem_bytes"] <= 48 * 1024
    max_cpc = da.PAGED_VEC_ROW_SLOTS * 256 // D
    assert cpc <= max_cpc and plan["warps"] * 32 <= 1024
    gx, gy, gz = plan["grid"]
    assert gx <= da.PAGED_VEC_MAX_CHUNKS and gy <= 65535 and gz <= 65535
    assert gx * gy * gz <= max(N_SM, gy * gz) \
        or cpc in (da.PAGED_VEC_MIN_COLS, max_cpc - max_cpc % bT, max_cpc)


def test_paged_plan_at_the_path_shapes():
    """GPT-2's serve step: one chunk of all 12 pages (96 CTAs: the first
    version's count, no merge, no workspace); Gemma serving at T 672:
    14 chunks of 3 pages (112 CTAs, where the first version ran 32 of
    one query head); a 32,768-token context: chunks of 96 columns, the
    most a CTA's lanes hold at D 256 (8 warps x 12 rows)."""
    def split(*shape):
        p = da.paged_plan(*shape, torch.bfloat16, N_SM)
        return p["n_chunks"], p["cpc"], p["ws_floats"]
    assert split(8, 12, 1, 12, 16, 64) == (1, 192, 0)
    assert da.paged_plan(8, 12, 1, 12, 16, 64, torch.bfloat16,
                         N_SM)["grid"] == (1, 12, 8)
    assert split(8, 1, 4, 42, 16, 256) == (14, 48, 14 * 32 * 258)
    assert split(1, 1, 4, 2048, 16, 256)[:2] == (342, 96)
    assert split(3, 2, 2, 1, 1, 128) == (1, 1, 0)
    assert da.paged_plan(8, 1, 4, 42, 16, 256, torch.float16,
                         N_SM)["qg"] == 4


def test_paged_plan_refuses_what_the_kernel_does_not_take():
    for args in ((8, 12, 1, 12, 16, 32, torch.bfloat16),     # D
                 (8, 12, 1, 12, 16, 96, torch.bfloat16),
                 (8, 12, 1, 12, 16, 64, torch.float32),      # f32: its own
                 (8, 12, 1, 12, 2048, 64, torch.bfloat16),   # bT
                 (0, 12, 1, 12, 16, 64, torch.bfloat16),
                 (8, 12, 1, 0, 16, 64, torch.bfloat16),
                 (65536, 1, 1, 1, 16, 64, torch.bfloat16),   # grid z
                 (1, 65536, 1, 1, 16, 64, torch.bfloat16),   # grid y
                 (1, 1, 4, 4097 * 6, 16, 256, torch.bfloat16)):  # chunks
        with pytest.raises(ValueError):
            da.paged_plan(*args)
    assert not da.paged_eligible(1, 4, 16, 32, 2)
    assert not da.paged_eligible(1, 4, 2048, 64, 2)
    assert not da.paged_eligible(65536, 1, 16, 64, 2)
    assert da.paged_eligible(65536, 1, 16, 64, 4)   # the f32 kernel's grid


@pytest.mark.parametrize("D,warps", [(64, 16), (128, 16), (256, 8),
                                     (256, 16)])
def test_paged_vec_lane_maps_read_each_element_once(D, warps):
    """The 16-bit kernel's lane map, replayed: lane l of warp w holds the
    16-byte piece l % (D / 8) of rows w (256 / D) + l / (D / 8) + p warps
    (256 / D) for passes p < ROW_SLOTS / warps, so a chunk's K and V
    elements are each loaded once, by one lane, a row's lanes on 2 D
    contiguous bytes, and the CTA's rows cover exactly the most columns
    a chunk takes."""
    lpr = D // 8
    rpp = 32 // lpr
    passes = da.PAGED_VEC_ROW_SLOTS // warps
    rows = passes * warps * rpp
    assert rows == da.PAGED_VEC_ROW_SLOTS * 256 // D
    hits = np.zeros((rows, D), np.int64)
    lane = np.arange(32)
    cl, rg = lane % lpr, lane // lpr
    for w in range(warps):
        for p in range(passes):
            r = w * rpp + rg + p * warps * rpp
            for e in range(8):
                np.add.at(hits, (r, cl * 8 + e), 1)
            for row in np.unique(r):        # a row's lanes: 2 D bytes
                addr = np.sort(cl[r == row] * 16)
                assert (np.diff(addr) == 16).all() and len(addr) == lpr
    assert (hits == 1).all()


def test_first_version_of_row_12_keeps_only_f32():
    """The 16-bit cases left csrc/paged_decode_attention.cu for
    paged_decode_attention_vec.cu; its f32 kernel takes D 256 now (two
    16-byte loads a lane), and its shared memory stays within the
    default 48 KB at the largest page (bT 1,024, D 256)."""
    text = _source("paged_decode_attention.cu")
    entry = _entry(text, "mft_paged_decode_attention")
    assert "dtype != 0" in entry and "dispatch_d<float>" in entry
    assert "__nv_bfloat16" not in text and "__half" not in text
    assert "case 256:" in text
    assert "constexpr int LPR = D / VEC < 32 ? D / VEC : 32;" in text
    warps = _constexpr(text, "WARPS")
    assert "(size_t)(WARPS * bT + 2 * WARPS + WARPS * D) *" in text
    assert (warps * da.MAX_BLOCK_T + 2 * warps + warps * 256) * 4 <= 49152


def test_row_12_source_is_built_and_calls_no_library():
    from mobilefinetuner_tpu_torch.kernels import build
    assert "paged_decode_attention_vec" in build.SOURCES
    text = _source("paged_decode_attention_vec.cu")
    for lib in ("cublas", "cutlass", "torch/", "<aten"):
        assert lib not in text.lower()
    assert "mma_16816" not in text and "cp_async" not in text
    # every K and V load is issued before the first score
    assert text.index("// 3. scores") > text.rindex("vr[p] = *")
    assert "griddepcontrol.launch_dependents" in text


# ---------------------------------- rows 12 and 13 in f32: the splits -----

def test_split_f32_constants_match_the_sources():
    text = _source("decode_split_f32.cuh")
    assert _constexpr(text, "ROW_SLOTS") == da.SPLIT_F32_ROW_SLOTS
    assert _constexpr(text, "MAX_QG") == da.SPLIT_F32_MAX_QG
    assert _constexpr(text, "MAX_CHUNKS") == da.SPLIT_F32_MAX_CHUNKS
    assert _constexpr(text, "MERGE_BATCH") == 32
    assert "return QG == 4 ? 8 : 16;" in text
    assert "return G == 1 ? 1 : G == 2 ? 2 : MAX_QG;" in text
    assert "constexpr int LPR = D / 8;" in text
    # the shared memory the launch asks for, as the plans count it
    assert ("return ((size_t)2 * warps_for(QG) * QG +\n"
            "          (size_t)warps_for(QG) * QG * D) * 4;") in text
    assert "n_chunks == (cols + cpc - 1) / cpc && n_chunks <= MAX_CHUNKS" \
        in text
    assert "dim3 grid(KV * n_qg, n_chunks, S);" in text
    paged = _entry(_source("paged_decode_attention_vec_f32.cu"),
                   "mft_paged_decode_attention_vec_f32")
    dec = _entry(_source("decode_attention_split_f32.cu"),
                 "mft_decode_attention_split_f32")
    for entry in (paged, dec):
        assert "dtype != 0" in entry and "split_f32::plan_ok(" in entry
        assert "int cpc, int n_chunks, int dtype" in " ".join(entry.split())
    assert "D != 32 &&" in dec and "D != 32" not in paged
    for name in ("paged_decode_attention_vec_f32",
                 "decode_attention_split_f32"):
        text = _source(f"{name}.cu")
        assert '#include "decode_split_f32.cuh"' in text
        for lib in ("cublas", "cutlass", "torch/", "<aten", "mma.sync",
                    "mma_16816", "wgmma"):
            assert lib not in text.lower()
    split = _source("decode_split_f32.cuh")   # FMA only, no atomics
    assert "mma_" not in split and "mma.sync" not in split
    assert "atomic" not in split
    # every K and V load of a round is issued before its first score
    assert split.index("// 3. scores") > split.rindex("vr[p][1] = *")
    assert "griddepcontrol.launch_dependents" in split
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in split


SPLIT_F32_SHAPES = [  # ("paged", S, KV, G, M, bT, D) / ("decode", B, KV, G, T, D)
    ("paged", 8, 1, 4, 42, 16, 256),     # gemma_serve_f32
    ("paged", 8, 12, 1, 12, 16, 64),     # GPT-2's serve step
    ("paged", 5, 2, 2, 6, 16, 64),
    ("paged", 2, 2, 6, 3, 64, 256),      # chunks end inside a page
    ("paged", 1, 1, 4, 2048, 16, 256),   # a 32,768-token context
    ("paged", 3, 2, 2, 1, 1024, 256),    # the largest pages
    ("decode", 4, 1, 4, 617, 256),       # Gemma's last f32 generate step
    ("decode", 8, 12, 1, 144, 64),       # GPT-2's
    ("decode", 1, 1, 4, 32768, 256),
    ("decode", 3, 2, 3, 77, 32),
    ("decode", 4, 1, 4, 1, 256),
    ("decode", 65535, 1, 1, 64, 64),
]


def _split_plan(kind, *shape):
    if kind == "paged":
        S, KV, G, M, bT, D = shape
        return (da.paged_f32_plan(S, KV, G, M, bT, D, torch.float32, N_SM),
                S, KV, G, M * bT, bT, D)
    B, KV, G, T, D = shape
    return (da.decode_f32_plan(B, KV, G, T, D, torch.float32, N_SM), B, KV,
            G, T, 1, D)


@pytest.mark.parametrize("shape", SPLIT_F32_SHAPES)
def test_split_f32_plans_cover_each_column_once(shape):
    """The chunks (chunk c: columns [c cpc, c cpc + cpc)) cover every
    column once, in as many rounds of round_rows rows as a chunk needs;
    every query head is in one group of up to 4; whole pages a chunk where
    a chunk holds one; the workspace holds each chunk's (m, l, acc)."""
    plan, S, KV, G, cols, page, D = _split_plan(*shape)
    cpc, n_chunks, qg = plan["cpc"], plan["n_chunks"], plan["qg"]
    seen = np.zeros(cols, np.int64)
    for c in range(n_chunks):
        c0, c1 = c * cpc, min(c * cpc + cpc, cols)
        assert c0 < c1
        for base in range(c0, c1, plan["round_rows"]):
            seen[base:min(base + plan["round_rows"], c1)] += 1
    assert (seen == 1).all()
    assert n_chunks == -(-cols // cpc) <= da.SPLIT_F32_MAX_CHUNKS
    if cpc >= page:
        assert cpc % page == 0
    assert cpc >= min(cols, plan["round_rows"])
    heads = np.zeros(G, np.int64)
    for group in range(plan["n_qg"]):
        heads[group * qg:min(group * qg + qg, G)] += 1
    assert (heads == 1).all()
    assert plan["grid"] == (KV * plan["n_qg"], n_chunks, S)
    assert plan["ws_floats"] == (n_chunks * S * KV * G * (D + 2)
                                 if n_chunks > 1 else 0)


@pytest.mark.parametrize("shape", SPLIT_F32_SHAPES)
def test_split_f32_plans_fit_the_card(shape):
    """Shared memory within the default 48 KB (the launches set no
    attribute), the merge's (m, l) too, grid dimensions within the
    card's limits, and the CTAs within one wave of the SMs unless the
    units alone are more."""
    plan, S, KV, G, cols, page, D = _split_plan(*shape)
    assert plan["smem_bytes"] <= 48 * 1024
    assert 2 * plan["n_chunks"] * 4 <= 48 * 1024
    assert plan["warps"] * 32 <= 1024
    gx, gy, gz = plan["grid"]
    assert gx <= da.MAX_GRID_X and gy <= 65535 and gz <= 65535
    units = gx * gz
    assert gx * gy * gz <= max(N_SM, units)


@pytest.mark.parametrize("D,warps", [(32, 16), (64, 16), (128, 16),
                                     (128, 8), (256, 8), (256, 16)])
def test_split_f32_lane_map_reads_each_element_once(D, warps):
    """The split's lane map, replayed: lane l of warp w holds floats
    [4 c, 4 c + 4) and [D / 2 + 4 c, D / 2 + 4 c + 4) (c = l % (D / 8)) of
    rows w (256 / D) + l / (D / 8) + p warps (256 / D) of a round, so each
    K and V element of a round is loaded once, by one lane, each load
    instruction of a row's lanes on 2 D contiguous bytes, and a round
    holds round_rows rows."""
    lpr = D // 8
    rpp = 32 // lpr
    passes = da.SPLIT_F32_ROW_SLOTS // warps
    rows = passes * warps * rpp
    assert rows == da.SPLIT_F32_ROW_SLOTS * 256 // D
    hits = np.zeros((rows, D), np.int64)
    lane = np.arange(32)
    cl, rg = lane % lpr, lane // lpr
    for w in range(warps):
        for p in range(passes):
            r = w * rpp + rg + p * warps * rpp
            for half in (0, D // 2):
                for e in range(4):
                    np.add.at(hits, (r, half + cl * 4 + e), 1)
                for row in np.unique(r):    # one instruction: 2 D bytes
                    addr = np.sort((half + cl[r == row] * 4) * 4)
                    assert (np.diff(addr) == 16).all() and len(addr) == lpr
    assert (hits == 1).all()


def test_split_f32_plans_at_the_path_shapes():
    """gemma_serve_f32 (8 slots x 1 kv head, 42 pages of 16): 14 chunks of
    3 pages (112 CTAs, where the first version ran 32 of one query
    head); Gemma's last f32 generate step (4 rows, T 617): 13 chunks of
    one round, 48 (52 CTAs, was 16); GPT-2's (8 x 12 heads, T 144): one
    chunk, 96 CTAs, no workspace, no merge; a 32,768-token context: 132
    chunks of 249 columns, each looping over 6 rounds; chunks of a round
    where the wave would cut them shorter."""
    def split(plan):
        return plan["n_chunks"], plan["cpc"], plan["ws_floats"]
    f32 = torch.float32
    p = da.paged_f32_plan(8, 1, 4, 42, 16, 256, f32, N_SM)
    assert split(p) == (14, 48, 14 * 32 * 258)
    assert p["grid"] == (1, 14, 8) and p["warps"] == 8
    p = da.decode_f32_plan(4, 1, 4, 617, 256, f32, N_SM)
    assert split(p) == (13, 48, 13 * 16 * 258) and p["grid"] == (1, 13, 4)
    p = da.decode_f32_plan(8, 12, 1, 144, 64, f32, N_SM)
    assert split(p) == (1, 144, 0) and p["grid"] == (12, 1, 8)
    assert p["warps"] == 16 and p["round_rows"] == 192
    p = da.decode_f32_plan(1, 1, 4, 32768, 256, f32, N_SM)
    assert split(p)[:2] == (132, 249) and -(-249 // p["round_rows"]) == 6
    for D, rows in ((32, 384), (64, 192), (128, 96), (256, 48)):
        p = da.decode_f32_plan(2, 1, 1, 1000, D, f32, N_SM)
        assert p["round_rows"] == rows == p["cpc"]


def test_split_f32_plans_refuse_what_the_kernels_do_not_take():
    f32 = torch.float32
    for args in ((8, 1, 4, 42, 16, 256, torch.bfloat16),
                 (8, 1, 4, 42, 16, 32, f32),       # D 32: not paged
                 (8, 1, 4, 42, 16, 96, f32),
                 (8, 1, 4, 42, 2048, 256, f32),    # bT
                 (65536, 1, 1, 1, 16, 64, f32),    # grid z
                 (0, 1, 4, 42, 16, 256, f32),
                 (8, 1, 4, 0, 16, 256, f32)):
        with pytest.raises(ValueError):
            da.paged_f32_plan(*args)
    for args in ((4, 1, 4, 617, 256, torch.float16),
                 (4, 1, 4, 617, 96, f32),
                 (4, 1, 4, 0, 256, f32),
                 (65536, 1, 1, 64, 64, f32)):
        with pytest.raises(ValueError):
            da.decode_f32_plan(*args)


def test_every_f32_shape_admitted_before_is_still_admitted():
    """The first versions took, in f32, any KV, G >= 1, any T >= 1 and D
    in {32, 64, 128, 256} (contiguous), pages of 1 to MAX_BLOCK_T and D in
    {64, 128, 256} (paged): every such shape is still eligible, and the
    new plans split it within MAX_CHUNKS chunks."""
    f32 = torch.float32
    for KV, G, D in itertools.product((1, 2, 12, 70000), (1, 2, 3, 4, 40),
                                      (32, 64, 128, 256)):
        for T in (1, 7, 77, 617, 32768, 10 ** 7):
            assert da.decode_eligible(KV, T, D, 4, G)
            plan = da.decode_f32_plan(3, KV, G, T, D, f32, N_SM)
            assert plan["n_chunks"] <= da.SPLIT_F32_MAX_CHUNKS
        if D == 32:
            continue
        for bT, M in ((1, 1), (16, 42), (1024, 3), (16, 2048), (7, 300)):
            assert da.paged_eligible(KV, G, bT, D, 4)
            plan = da.paged_f32_plan(8, KV, G, M, bT, D, f32, N_SM)
            assert plan["n_chunks"] <= da.SPLIT_F32_MAX_CHUNKS
