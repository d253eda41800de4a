"""Decode attention: the Hopper kernels, their wrappers and their plain
versions (port of mobilefinetuner_tpu/ops/decode_attention.py): the
contiguous-cache `decode_attention` (row 13) and the block-paged
`paged_decode_attention` (row 12).

Contiguous cache (the generate path, models/generate.py; GPT-2 is the
G = 1 case):
  q        [B, KV, G, D]       current-token queries, grouped by kv head,
                               in the cache dtype
  k_cache  [B, KV, T, D]       any T >= 1 (T = P + N is ragged)
  v_cache  [B, KV, T, D]
  ok       [B, T] bool         attendable columns (validity AND any
                               sliding window: the caller composes)
  -> ctx   [B, KV, G, D] float32

  xla_reference           the plain version (the kernel's oracle): f32
                          scores of the storage-dtype operands, NEG_INF
                          masking, f32 softmax, probabilities cast to the
                          cache dtype, f32 P.V.
  decode_attention        CUDA tensors launch the kernel of
                          decode_library(dtype) (or raise ValueError):
                          bf16 / f16 `csrc/decode_attention_mma.cu`
                          (flash-decoding on the tensor cores, with its
                          merge pass), f32
                          `csrc/decode_attention_split_f32.cu`
                          (flash-decoding on FMA, K/V rows in registers,
                          with its merge pass); CPU tensors take
                          xla_reference. `decode_attention.launches`
                          counts the calls that launched a kernel.
  decode_eligible         the kernels' own shape rule.
  decode_mma_plan         the tensor-core kernel's split of T into chunks
                          (from shapes only), its grid and workspace.
  decode_f32_plan         the f32 kernel's split of T into chunks (from
                          shapes only), its grid and workspace.

Block-paged pool (the serve engine):
  q        [S, KV, G, D]       current-token queries per slot
  pool_k   [NB, L, KV, bT, D]  shared block pools (all layers)
  pool_v   [NB, L, KV, bT, D]
  tbl      [S, M] int32        per-slot block table (unused rows -> trash
                               block 0, masked by ok)
  layer    int                 which layer's pages to read
  ok       [S, M*bT] bool      attendable logical columns (occupancy AND
                               any sliding window: the caller composes)
  -> ctx   [S, KV, G, D] float32

  paged_attention         the plain version: gather the slot's pages,
                          masked softmax, f32 accumulation.
  paged_decode_attention  CUDA tensors launch the kernel of
                          paged_library(dtype) (or raise ValueError):
                          bf16 / f16 `csrc/paged_decode_attention_vec.cu`
                          (each lane's K/V rows loaded straight into
                          registers, chunks merged in order), f32
                          `csrc/paged_decode_attention_vec_f32.cu` (the
                          same design on 16-byte f32 pieces,
                          `csrc/decode_split_f32.cuh`); CPU tensors take
                          paged_attention.
                          `paged_decode_attention.launches` counts the
                          calls that launched a kernel; both counts stay
                          exact under CUDA-graph replay (kernels/
                          graphs.py).
  paged_eligible          the kernels' own shape rule.
  paged_plan              the 16-bit kernel's split of the M * bT logical
                          columns into chunks (from shapes only), its
                          grid, warps, shared memory and workspace.
  paged_f32_plan          the same for the f32 kernel.

The f32 first versions, `csrc/paged_decode_attention.cu` and
`csrc/decode_attention.cu`, are built but on no path: they stay to time
the f32 kernels against.
"""

from __future__ import annotations

import ctypes

import torch

from mobilefinetuner_tpu_torch.kernels import build, graphs

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_BLOCK_T = 1024
DECODE_HEAD_DIMS = (32, 64, 128, 256)
MAX_BATCH = 65535                    # the contiguous kernels' grid rows
N_SM = 132                           # an H100 SXM's multiprocessors
DECODE_MMA_TILE = 32                 # csrc/decode_attention_mma.cu TILE
DECODE_MMA_QROWS = 16                # its QR: query heads a CTA
DECODE_MMA_STAGES = 2                # its STAGES
DECODE_MMA_MAX_CHUNKS = 128          # its MERGE_MAX_CHUNKS
# CTAs an SM the chunk split aims at: at GPT-2's generate step 6 chunks of
# one tile took 8.96 us against 9.65 for 3 of two on an H100 (PERF.md)
DECODE_MMA_CTAS_PER_SM = 4
PAGED_HEAD_DIMS = (64, 128, 256)
PAGED_VEC_ROW_SLOTS = 96      # csrc/paged_decode_attention_vec.cu ROW_SLOTS
PAGED_VEC_MAX_QG = 4          # its MAX_QG: query heads a CTA
PAGED_VEC_MAX_CHUNKS = 4096   # its MAX_CHUNKS
PAGED_VEC_MIN_COLS = 32       # the fewest columns a chunk
# the f32 kernels' csrc/decode_split_f32.cuh
SPLIT_F32_ROW_SLOTS = 48      # its ROW_SLOTS: warps x passes a round
SPLIT_F32_MAX_QG = 4          # its MAX_QG: query heads a CTA
SPLIT_F32_MAX_CHUNKS = 4096   # its MAX_CHUNKS
MAX_GRID_X = 2 ** 31 - 1      # the f32 kernels' grid x: KV x query groups


def xla_reference(q, k_cache, v_cache, ok, scale):
    """Plain contiguous decode attention (the kernel's oracle; the JAX
    package's `xla_reference`, the models/generate.py decode-step
    attention): scores of q against the cache in f32, NEG_INF where ok is
    false, softmax in f32, probabilities cast to the cache dtype, f32 P.V."""
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k_cache.float()) * scale
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p.to(v_cache.dtype).float(),
                        v_cache.float())


def decode_eligible(KV: int, T: int, D: int, itemsize: int,
                    G: int = 1) -> bool:
    """The kernels take any T >= 1 (chunks of T merged in order, each an
    online softmax: no whole-T block to fit), D in DECODE_HEAD_DIMS in
    f32, bf16 and f16, and any KV, G >= 1 (the tensor-core kernel: KV *
    ceil(G / 16) up to MAX_BATCH, its grid's second dimension; the f32
    kernel: KV * its query-head groups up to MAX_GRID_X, its grid's
    first)."""
    if not (KV >= 1 and G >= 1 and T >= 1 and D in DECODE_HEAD_DIMS
            and itemsize in (2, 4)):
        return False
    if itemsize == 4:
        return KV * -(-G // _split_qg(G)) <= MAX_GRID_X
    return KV * -(-G // DECODE_MMA_QROWS) <= MAX_BATCH


def decode_library(dtype: torch.dtype):
    """(source, C symbol) of the contiguous decode kernel for `dtype`:
    bf16 and f16 the tensor-core flash-decoding kernel, f32 the FMA
    flash-decoding split."""
    if dtype in (torch.bfloat16, torch.float16):
        return "decode_attention_mma", "mft_decode_attention_mma"
    if dtype == torch.float32:
        return "decode_attention_split_f32", "mft_decode_attention_split_f32"
    raise ValueError(f"decode_attention kernel takes one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


def decode_mma_plan(B: int, KV: int, G: int, T: int, D: int,
                    dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """The tensor-core kernel's launch, from shapes only (never from the
    mask, so a CUDA graph can capture it): one CTA per (chunk of
    `tiles_per_chunk` 32-key tiles, kv head, group of up to 16 query
    heads, b), grid (n_chunks, KV * n_qg, B). The chunk count aims at
    DECODE_MMA_CTAS_PER_SM CTAs an SM (a CTA holds 64 or 128 threads):
    the fewest tiles a chunk that keep the CTAs at least that many n_sm
    where T has the tiles, and at most DECODE_MMA_MAX_CHUNKS chunks (the
    merge walks them in order).
    `ws_floats`: the partials' workspace (m, l and acc [G, D] a chunk),
    none for one chunk."""
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"decode_attention tensor-core kernel takes bf16 "
                         f"or f16, got {dtype}")
    if D not in DECODE_HEAD_DIMS or min(B, KV, G, T) < 1 or B > MAX_BATCH:
        raise ValueError(f"decode_attention tensor-core kernel does not "
                         f"take B={B}, KV={KV}, G={G}, T={T}, D={D}")
    n_qg = -(-G // DECODE_MMA_QROWS)
    units = B * KV * n_qg
    n_tiles = -(-T // DECODE_MMA_TILE)
    want = min(n_tiles, DECODE_MMA_MAX_CHUNKS,
               max(1, -(-DECODE_MMA_CTAS_PER_SM * n_sm // units)))
    tpc = -(-n_tiles // want)
    n_chunks = -(-n_tiles // tpc)
    warps = 4 if D >= 64 else 2
    ld = D // warps + 8
    elem = torch.finfo(dtype).bits // 8
    smem = (warps * 2 * DECODE_MMA_STAGES * DECODE_MMA_TILE * ld * elem
            + 2 * warps * DECODE_MMA_QROWS * (DECODE_MMA_TILE + 8) * 4)
    return {"tiles_per_chunk": tpc, "n_chunks": n_chunks, "n_qg": n_qg,
            "grid": (n_chunks, KV * n_qg, B), "warps": warps,
            "smem_bytes": smem,
            "ws_floats": n_chunks * B * KV * G * (D + 2)
            if n_chunks > 1 else 0}


def _split_qg(G: int) -> int:
    """Query heads a CTA of the f32 kernels (csrc/decode_split_f32.cuh's
    qg_for) and of the 16-bit paged kernel (its QG instantiations)."""
    return G if G <= 2 else SPLIT_F32_MAX_QG


def _split_f32_plan(S: int, KV: int, G: int, n_cols: int, page: int, D: int,
                    n_sm: int) -> dict:
    """The f32 split of `n_cols` logical columns of each (slot or batch
    row, kv head, query group) unit, from shapes only: grid (KV * n_qg,
    n_chunks, S), the most chunks that keep the CTAs within one wave of
    n_sm (one chunk where the units alone are more than half a wave: no
    merge), but at least a round's rows a chunk (SPLIT_F32_ROW_SLOTS x 256 / D: 96 KB of
    K and V a CTA, where the columns have them; at Gemma's f32 generate
    step 13 chunks of a round took 10.88 us against 12.19 for the wave's
    33 of 19 columns on an H100, PERF.md), whole pages of `page` columns
    where a chunk holds one, at most SPLIT_F32_MAX_CHUNKS chunks (the
    merge walks them in order). A chunk longer than a round loops."""
    qg = _split_qg(G)
    n_qg = -(-G // qg)
    rnd = SPLIT_F32_ROW_SLOTS * 256 // D       # rows a CTA a round
    want = max(1, n_sm // (S * KV * n_qg))    # chunks a unit
    cpc = max(-(-n_cols // want), min(n_cols, rnd),
              -(-n_cols // SPLIT_F32_MAX_CHUNKS))
    if cpc >= page:
        cpc = -(-cpc // page) * page
    n_chunks = -(-n_cols // cpc)
    warps = 8 if qg == SPLIT_F32_MAX_QG else 16
    return {"cpc": cpc, "n_chunks": n_chunks, "qg": qg, "n_qg": n_qg,
            "grid": (KV * n_qg, n_chunks, S), "warps": warps,
            "round_rows": rnd,
            "smem_bytes": (2 * warps * qg + warps * qg * D) * 4,
            "ws_floats": n_chunks * S * KV * G * (D + 2)
            if n_chunks > 1 else 0}


def decode_f32_plan(B: int, KV: int, G: int, T: int, D: int,
                    dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """The f32 kernel's launch (csrc/decode_attention_split_f32.cu), from
    shapes only (never from the mask, so a CUDA graph can capture it):
    one CTA per (kv head x group of up to SPLIT_F32_MAX_QG query heads,
    chunk of `cpc` columns, b), grid (KV * n_qg, n_chunks, B), `warps`
    warps a CTA, the chunk split of _split_f32_plan with no pages.
    `ws_floats`: the partials' workspace (m, l and acc [G, D] a chunk),
    none for one chunk."""
    if dtype != torch.float32:
        raise ValueError(f"decode_attention f32 kernel takes float32, got "
                         f"{dtype}")
    if D not in DECODE_HEAD_DIMS or min(B, KV, G, T) < 1 or B > MAX_BATCH \
            or KV * -(-G // _split_qg(G)) > MAX_GRID_X:
        raise ValueError(f"decode_attention f32 kernel does not take B={B}, "
                         f"KV={KV}, G={G}, T={T}, D={D}")
    return _split_f32_plan(B, KV, G, T, 1, D, n_sm)


def _decode_kernel(dtype):
    lib, sym = decode_library(dtype)
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, ok, scale):
    """Decode attention over a whole contiguous cache (shapes in the
    module docstring): the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if q.dtype != k_cache.dtype or v_cache.dtype != k_cache.dtype:
        # the kernel reads q in the cache dtype; a silent downcast of f32
        # queries against a bf16 cache would diverge from xla_reference
        raise ValueError(
            f"decode_attention requires q.dtype == cache dtype "
            f"(got {q.dtype} vs {k_cache.dtype}/{v_cache.dtype})")
    if q.device.type == "cpu":
        return xla_reference(q, k_cache, v_cache, ok, scale)
    B, KV, G, D = q.shape
    T = k_cache.shape[2]
    dev = q.device
    if not all(t.device == dev for t in (k_cache, v_cache, ok)):
        raise ValueError(f"decode_attention: every operand must be on {dev}")
    if k_cache.shape != (B, KV, T, D) or v_cache.shape != k_cache.shape \
            or ok.shape != (B, T):
        raise ValueError(
            f"decode_attention shapes: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, ok "
            f"{tuple(ok.shape)}")
    if ok.dtype != torch.bool or q.dtype not in DTYPE_CODES:
        raise ValueError(f"decode_attention dtypes: ok {ok.dtype} (bool), "
                         f"q {q.dtype}")
    if not decode_eligible(KV, T, D, q.element_size(), G) or B > MAX_BATCH:
        raise ValueError(
            f"decode_attention kernel does not take B={B}, KV={KV}, G={G}, "
            f"T={T}, D={D}, {q.dtype} (see decode_eligible)")
    ts = (q, k_cache, v_cache, ok)
    if not all(t.is_contiguous() for t in ts) \
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16 \
            or q.data_ptr() % 4:
        raise ValueError("decode_attention takes contiguous operands, "
                         "16-byte aligned caches and a 4-byte aligned q")
    ctx = torch.empty(B, KV, G, D, device=dev, dtype=torch.float32)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if q.dtype == torch.float32:
        plan = decode_f32_plan(B, KV, G, T, D, q.dtype, n_sm)
        step = plan["cpc"]
    else:
        plan = decode_mma_plan(B, KV, G, T, D, q.dtype, n_sm)
        step = plan["tiles_per_chunk"]
    ws = (torch.empty(plan["ws_floats"], device=dev)
          if plan["ws_floats"] else None)
    code = _decode_kernel(q.dtype)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ok.data_ptr(),
        ctx.data_ptr(), None if ws is None else ws.data_ptr(), B, KV, G, D,
        T, step, plan["n_chunks"], DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("decode_attention", code)
    decode_attention.launches += 1
    return ctx


decode_attention.launches = 0
graphs.counted(decode_attention)


def paged_attention(q, pool_k, pool_v, tbl, layer, ok, scale):
    """Plain paged decode attention (the kernel's oracle): scores of q
    (in the pool dtype) against the gathered pages in f32, masked
    softmax, probabilities cast to the pool dtype, f32 P.V."""
    kc = pool_k[tbl.long(), layer]                 # [S, M, KV, bT, D]
    vc = pool_v[tbl.long(), layer]
    S, M, KV, bT, D = kc.shape
    G = q.shape[2]
    s = torch.einsum("skgd,smktd->skgmt", q.float(), kc.float()) * scale
    s = s.reshape(S, KV, G, M * bT)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).reshape(S, KV, G, M, bT)
    return torch.einsum("skgmt,smktd->skgd", p.to(vc.dtype).float(),
                        vc.float())


def paged_eligible(KV: int, G: int, bT: int, D: int, itemsize: int) -> bool:
    """The kernels take D in PAGED_HEAD_DIMS in f32, bf16 and f16, pages
    of at most MAX_BLOCK_T tokens (the pool's page limit, the same in
    every dtype: neither kernel stages a page, a chunk's rows sit in
    registers and a chunk may end inside a page) and any KV, G >= 1 (KV
    * the query-head groups up to MAX_BATCH in the 16-bit kernel, its
    grid's second dimension, and up to MAX_GRID_X in the f32 kernel, its
    grid's first)."""
    if not (KV >= 1 and G >= 1 and 1 <= bT <= MAX_BLOCK_T
            and D in PAGED_HEAD_DIMS and itemsize in (2, 4)):
        return False
    return KV * -(-G // _split_qg(G)) <= (MAX_GRID_X if itemsize == 4
                                          else MAX_BATCH)


def paged_library(dtype: torch.dtype):
    """(source, C symbol) of the paged decode kernel for `dtype`: bf16 and
    f16 the kernel that loads a chunk's K/V rows into registers, f32 the
    same design on f32 pieces."""
    if dtype in (torch.bfloat16, torch.float16):
        return "paged_decode_attention_vec", "mft_paged_decode_attention_vec"
    if dtype == torch.float32:
        return ("paged_decode_attention_vec_f32",
                "mft_paged_decode_attention_vec_f32")
    raise ValueError(f"paged_decode_attention kernel takes one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


def paged_plan(S: int, KV: int, G: int, M: int, bT: int, D: int,
               dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """The 16-bit kernel's launch, from shapes only (never from the mask
    or the table, so a CUDA graph can capture it): one CTA per (chunk of
    `cpc` logical columns, kv head, group of up to PAGED_VEC_MAX_QG query
    heads, slot), grid (n_chunks, KV * n_qg, S), `warps` warps a CTA.
    The chunk count is the most that keeps the CTAs within one wave (n_sm;
    one chunk where the units alone are more than half a wave: no merge);
    a chunk holds at least PAGED_VEC_MIN_COLS columns (where there are
    that many), whole pages where they fit, and at most the rows its
    lanes hold in registers: PAGED_VEC_ROW_SLOTS passes of 256 / D rows.
    `ws_floats`: the partials' workspace (m, l and acc [G, D] a chunk),
    none for one chunk."""
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"paged_decode_attention 16-bit kernel takes bf16 "
                         f"or f16, got {dtype}")
    qg = _split_qg(G)
    n_qg = -(-G // qg) if G >= 1 else 0
    if D not in PAGED_HEAD_DIMS or min(S, KV, G, M) < 1 \
            or not 1 <= bT <= MAX_BLOCK_T or S > MAX_BATCH \
            or KV * n_qg > MAX_BATCH:
        raise ValueError(f"paged_decode_attention 16-bit kernel does not "
                         f"take S={S}, KV={KV}, G={G}, M={M}, bT={bT}, "
                         f"D={D}")
    cols = M * bT
    max_cpc = PAGED_VEC_ROW_SLOTS * 256 // D
    if bT <= max_cpc:
        max_cpc -= max_cpc % bT               # whole pages
    want = max(1, n_sm // (S * KV * n_qg))    # chunks a unit
    cpc = max(-(-cols // want), min(cols, PAGED_VEC_MIN_COLS))
    if cpc >= bT:
        cpc = -(-cpc // bT) * bT
    cpc = min(cpc, max_cpc)
    n_chunks = -(-cols // cpc)
    if n_chunks > PAGED_VEC_MAX_CHUNKS:
        raise ValueError(f"paged_decode_attention 16-bit kernel does not "
                         f"take {cols} columns a slot at D={D} "
                         f"({n_chunks} chunks)")
    warps = 8 if qg == PAGED_VEC_MAX_QG else 16
    smem = (2 * warps * qg + warps * qg * D) * 4
    return {"cpc": cpc, "n_chunks": n_chunks, "qg": qg, "n_qg": n_qg,
            "grid": (n_chunks, KV * n_qg, S), "warps": warps,
            "smem_bytes": smem,
            "ws_floats": n_chunks * S * KV * G * (D + 2)
            if n_chunks > 1 else 0}


def paged_f32_plan(S: int, KV: int, G: int, M: int, bT: int, D: int,
                   dtype: torch.dtype, n_sm: int = N_SM) -> dict:
    """The f32 kernel's launch (csrc/paged_decode_attention_vec_f32.cu),
    from shapes only (never from the mask or the table, so a CUDA graph
    can capture it): one CTA per (kv head x group of up to
    SPLIT_F32_MAX_QG query heads, chunk of `cpc` logical columns, slot),
    grid (KV * n_qg, n_chunks, S), `warps` warps a CTA, the chunk split
    of _split_f32_plan over the M * bT columns in pages of bT.
    `ws_floats`: the partials' workspace (m, l and acc [G, D] a chunk),
    none for one chunk."""
    if dtype != torch.float32:
        raise ValueError(f"paged_decode_attention f32 kernel takes float32, "
                         f"got {dtype}")
    if D not in PAGED_HEAD_DIMS or min(S, KV, G, M) < 1 \
            or not 1 <= bT <= MAX_BLOCK_T or S > MAX_BATCH \
            or KV * -(-G // _split_qg(G)) > MAX_GRID_X \
            or M * bT > MAX_GRID_X:
        raise ValueError(f"paged_decode_attention f32 kernel does not take "
                         f"S={S}, KV={KV}, G={G}, M={M}, bT={bT}, D={D}")
    return _split_f32_plan(S, KV, G, M * bT, bT, D, n_sm)


def _paged_kernel(dtype):
    lib, sym = paged_library(dtype)
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q, pool_k, pool_v, tbl, layer, ok, scale):
    """Paged decode attention (shapes in the module docstring): the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if q.dtype != pool_k.dtype or pool_v.dtype != pool_k.dtype:
        raise ValueError(
            f"paged_decode_attention requires q.dtype == pool dtype "
            f"(got {q.dtype} vs {pool_k.dtype}/{pool_v.dtype})")
    if q.device.type == "cpu":
        return paged_attention(q, pool_k, pool_v, tbl, layer, ok, scale)
    S, KV, G, D = q.shape
    NB, L, _, bT, _ = pool_k.shape
    M = tbl.shape[1]
    dev = q.device
    if not all(t.device == dev for t in (pool_k, pool_v, tbl, ok)):
        raise ValueError("paged_decode_attention: every operand must be on "
                         f"{dev}")
    if pool_k.shape != (NB, L, KV, bT, D) or pool_v.shape != pool_k.shape \
            or tbl.shape != (S, M) or ok.shape != (S, M * bT):
        raise ValueError(
            f"paged_decode_attention shapes: q {tuple(q.shape)}, pools "
            f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}, tbl "
            f"{tuple(tbl.shape)}, ok {tuple(ok.shape)}")
    if tbl.dtype != torch.int32 or ok.dtype != torch.bool \
            or q.dtype not in DTYPE_CODES:
        raise ValueError(f"paged_decode_attention dtypes: tbl {tbl.dtype} "
                         f"(int32), ok {ok.dtype} (bool), q {q.dtype}")
    if not paged_eligible(KV, G, bT, D, q.element_size()):
        raise ValueError(
            f"paged_decode_attention kernel does not take KV={KV}, G={G}, "
            f"bT={bT}, D={D}, {q.dtype} (see paged_eligible)")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    ts = (q, pool_k, pool_v, tbl, ok)
    if not all(t.is_contiguous() for t in ts) or S > MAX_BATCH \
            or any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged_decode_attention takes contiguous operands, "
                         f"16-byte aligned pools and q, and S <= "
                         f"{MAX_BATCH}")
    ctx = torch.empty(S, KV, G, D, device=dev, dtype=torch.float32)
    plan = (paged_f32_plan if q.dtype == torch.float32 else paged_plan)(
        S, KV, G, M, bT, D, q.dtype,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    ws = (torch.empty(plan["ws_floats"], device=dev)
          if plan["ws_floats"] else None)
    code = _paged_kernel(q.dtype)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        ok.data_ptr(), ctx.data_ptr(), None if ws is None else ws.data_ptr(),
        S, KV, G, D, NB, L, int(layer), bT, M, plan["cpc"],
        plan["n_chunks"], DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("paged_decode_attention", code)
    paged_decode_attention.launches += 1
    return ctx


paged_decode_attention.launches = 0
graphs.counted(paged_decode_attention)
