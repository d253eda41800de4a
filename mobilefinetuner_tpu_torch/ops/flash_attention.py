"""Flash attention: the Hopper kernels, their wrappers and their plain
versions (port of mobilefinetuner_tpu/ops/flash_attention.py).

  flash_attention_fwd        (out, lse). CUDA tensors launch a kernel
                             (or raise), chosen by dtype (fwd_library):
                             bf16 / f16 the tensor-core kernel
                             `csrc/flash_attention_fwd_mma.cu`, f32 the
                             3xTF32 tensor-core kernel
                             `csrc/flash_attention_fwd_tf32.cu`; CPU
                             tensors take `flash_attention_reference`.
  flash_attention_bwd_merged (dq, dk, dv) in one pass per key block,
                             chosen by dtype (bwd_library): bf16 / f16
                             the tensor-core kernel
                             `csrc/flash_attention_bwd_merged_mma.cu`,
                             f32 the 3xTF32 one
                             `csrc/flash_attention_bwd_merged_tf32.cu`;
                             CPU tensors take `flash_bwd_merged_reference`.
                             (The f32 FMA first versions,
                             `csrc/flash_attention_fwd.cu` and
                             `csrc/flash_attention_bwd_merged.cu`, are
                             built but on no path.)
  flash_attention_bwd_dq     the split pair, `csrc/flash_attention_bwd_
  flash_attention_bwd_dkv    split.cu` (two kernels, two counters), or
                             `flash_bwd_split_reference` on the CPU.
  flash_attention            drop-in for ops.attention.dot_product_attention
                             (out only), differentiable: a
                             torch.autograd.Function whose backward
                             computes delta = rowsum(dO * O) in torch and
                             launches the backward kernel(s) `bwd_impl`
                             names ("auto" -> resolve_bwd_impl).
  keep_mask                  the dropout keep bits of `_keep_mask`, bit
                             for bit.

Each wrapper has a `launches` count of its kernel launches; the forward
also counts them `.by_shape`, by (dtype, B, Hq, S, D), and the merged
backward `.by_dtype`; kernels/graphs.py keeps them exact under CUDA-graph
replay. The plain versions are the kernels' blocked
algorithms written in torch (64 x 64 tiles, the same [lo, hi) block
bounds, masks and f32 arithmetic); they run on any device and are the
kernels' references on the card.

Masks (as the TPU kernel's `_block_mask`): key padding, causal, and an
optional sliding window (col > row - window); GQA reads kv-head h // G.
Unlike the dense oracle, a fully masked row gives 0 (the TPU kernel's
l_safe rule), not the mean of V; the port right-pads, so it never has one.
Train-mode dropout follows HF probs-dropout semantics, as the TPU kernel:
the softmax denominator sums the undropped probabilities and only P.V
sees the kept ones, scaled by 1/(1-p). The keep bit is a hash of
(seed, b, h, row, col), so every kernel regenerates the forward's mask.

The kernels take D in {64, 128, 256} and any S (they mask the ragged
edge), in f32, bf16 or f16; the forward and merged backward (tensor-core
kernels in every dtype) also need 16-byte aligned q, k and v (and dO).
`fwd_plan` and `bwd_plan` are the forward and merged backward kernels'
launch plans in Python, as the sources compute them.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Optional, Tuple

import torch

from mobilefinetuner_tpu_torch.kernels import build, graphs

NEG_INF = -1e30
BLOCK_Q = 64            # the plain versions' tile sizes (and the kernels'
BLOCK_K = 64            # at D <= 128; csrc/flash_attention_bwd.cuh)
KERNEL_HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BWD_IMPLS = ("auto", "merged", "split")
_M32 = 0xFFFFFFFF


def flash_eligible(D: int, dtype: torch.dtype) -> bool:
    """The kernels' own rule: head dim and dtype they were built for."""
    return D in KERNEL_HEAD_DIMS and dtype in DTYPE_CODES


def resolve_bwd_impl(S: int, D: int, dtype: torch.dtype) -> str:
    """The `auto` backward on this card: the merged one-pass kernel, at
    every shape. It does 5 tile products a tile against the split pair's
    7 and launches once; in bf16 / f16 it runs on the tensor cores while
    the split pair stays on the FMA units. chip_smoke.py's `bwd_sweep`
    on an H100 (bf16, causal) timed merged 5.2x faster than split at
    B 8 x 12 heads x S 128 x D 64, 16-18x at S 512 and 2048 (D 64) and at
    D 128, S 1024, and 22-25x at D 256 with GQA; with both on the FMA
    units (before the merged kernel's tensor-core version) merged led by
    1.4-2.5x (PERF.md). "split" stays as the parity oracle and an
    option."""
    return "merged"


# ------------------------------------------------------------- dropout ------

def keep_mask(seed: int, b, h, rows, cols, p_drop: float) -> torch.Tensor:
    """The TPU kernel's `_keep_mask` on global coordinates, broadcasting
    (b, h, rows, cols: non-negative ints or int64 tensors): wrapping
    32-bit arithmetic carried in int64 (_mul32 keeps every product below
    2^49, so nothing overflows)."""
    x = (int(seed) & _M32) ^ _mul32(b, 0x9E3779B9) ^ _mul32(h, 0x85EBCA6B)
    z = (x + _mul32(rows, 0xC2B2AE35) + _mul32(cols, 0x27D4EB2F)) & _M32
    z = z ^ (z >> 16)
    z = _mul32(z, 0x7FEB352D)
    z = z ^ (z >> 15)
    z = _mul32(z, 0x846CA68B)
    z = z ^ (z >> 16)
    return ((z >> 8) & 0xFFFFFF) < keep_threshold(p_drop)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32, in two 16-bit halves of c."""
    x = x & _M32
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def keep_threshold(p_drop: float) -> int:
    return round((1.0 - p_drop) * (1 << 24))


def _dropout_args(p_drop: float, seed: Optional[int]):
    """(on, seed u32, thresh, inv_keep) for the kernels' C interface."""
    if p_drop <= 0.0 or seed is None:
        return 0, 0, 0, 1.0
    return 1, int(seed) & _M32, keep_threshold(p_drop), 1.0 / (1.0 - p_drop)


def _kv_block_bounds(row0: int, n_kv_blocks: int, causal: bool,
                     window: Optional[int], block_q: int = BLOCK_Q,
                     block_k: int = BLOCK_K) -> Tuple[int, int]:
    """[lo, hi) key blocks reachable from query rows [row0, row0+block_q),
    as every forward kernel computes them for its own tile sizes."""
    hi = (min(n_kv_blocks, (row0 + block_q - 1) // block_k + 1)
          if causal else n_kv_blocks)
    lo = max(0, (row0 - window + 1) // block_k) if window is not None else 0
    return lo, hi


def _q_block_bounds(col0: int, n_q_blocks: int, causal: bool,
                    window: Optional[int], block_q: int = BLOCK_Q,
                    block_k: int = BLOCK_K) -> Tuple[int, int]:
    """[qlo, qhi) q-blocks that can see the key block at col0, as every
    merged backward kernel computes them for its own tile sizes."""
    qlo = col0 // block_q if causal else 0
    qhi = (min(n_q_blocks, (col0 + block_k + window - 2) // block_q + 1)
           if window is not None else n_q_blocks)
    return qlo, qhi


def _tile_mask(pad, rows, cols, causal, window):
    """[B, 1, 1, R, C] attend mask of one tile (rows/cols global)."""
    mask = (pad[:, cols[0]] > 0)[:, None, None, None, :]
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def _head_index(B, Hkv, G, device):
    """(b, h) as broadcastable int64 tensors over [B, Hkv, G, 1, 1], h the
    q-head index hk * G + g."""
    b = torch.arange(B, device=device).reshape(B, 1, 1, 1, 1)
    h = torch.arange(Hkv * G, device=device).reshape(1, Hkv, G, 1, 1)
    return b, h


# ------------------------------------------------------------- forward ------

def flash_attention_reference(q, k, v, padding_mask=None, *,
                              scale: Optional[float] = None,
                              is_causal: bool = True,
                              sliding_window: Optional[int] = None,
                              p_drop: float = 0.0,
                              seed: Optional[int] = None):
    """The forward kernel's algorithm in torch: (out [B,Hq,S,D] q.dtype,
    lse [B,Hq,S,1] f32). `is_causal` and `sliding_window` are independent
    here, as in the kernel."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dropout = p_drop > 0.0 and seed is not None
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    pad = (torch.ones(B, S, device=q.device) if padding_mask is None
           else padding_mask.float())
    bi, hi_ = _head_index(B, Hkv, G, q.device)
    out = torch.zeros(B, Hkv, G, S, D, device=q.device)
    lse = torch.zeros(B, Hkv, G, S, device=q.device)
    n_kv = -(-S // BLOCK_K)
    for row0 in range(0, S, BLOCK_Q):
        row1 = min(S, row0 + BLOCK_Q)
        qb = qf[:, :, :, row0:row1]
        rows = torch.arange(row0, row1, device=q.device)[:, None]
        m = torch.full((B, Hkv, G, row1 - row0, 1), NEG_INF,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, G, row1 - row0, D, device=q.device)
        lo, hi = _kv_block_bounds(row0, n_kv, is_causal, sliding_window)
        for kb in range(lo, hi):
            col0, col1 = kb * BLOCK_K, min(S, (kb + 1) * BLOCK_K)
            s = qb @ kf[..., col0:col1, :].transpose(-1, -2) * scale
            cols = torch.arange(col0, col1, device=q.device)[None, :]
            mask = _tile_mask(pad, rows, cols, is_causal, sliding_window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            if dropout:
                keep = keep_mask(seed, bi, hi_, rows, cols, p_drop)
                p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - p_drop))
            acc = acc * alpha + p @ vf[..., col0:col1, :]
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, :, :, row0:row1] = acc / l_safe
        lse[:, :, :, row0:row1] = (m + torch.log(l_safe))[..., 0]
    return (out.reshape(B, Hq, S, D).to(q.dtype),
            lse.reshape(B, Hq, S, 1))


def fwd_library(dtype: torch.dtype) -> Tuple[str, str]:
    """(source, C symbol) of the forward kernel for `dtype`: bf16 and f16
    run on the tensor-core kernel, f32 on the 3xTF32 tensor-core kernel
    (there is no fallback from one to another)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "flash_attention_fwd_mma", "mft_flash_attention_fwd_mma"
    if dtype == torch.float32:
        return "flash_attention_fwd_tf32", "mft_flash_attention_fwd_tf32"
    raise ValueError(f"flash_attention kernel takes one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


# csrc/flash_attention_fwd_tf32.cu Cfg<D>: D -> (query rows a CTA, keys a
# tile, warps sharing each 16 query rows); 4 warps, a K / V ring of 2
FWD_TF32_TILES = {64: (64, 32, 1), 128: (64, 32, 1), 256: (32, 16, 2)}
TF32_STAGES = 2         # the f32 kernels' K / V (forward), Q / dO rings


def fwd_plan(B: int, Hq: int, S: int, D: int, dtype: torch.dtype) -> dict:
    """The forward kernel's launch, as its source computes it: query rows
    a CTA (`block_q`), keys a tile (`block_k`), the grid (query blocks,
    q-heads, batch) and `smem_bytes`. The bf16 / f16 kernel takes 32-row
    blocks of two warps (128 CTAs at Gemma-3's B 4 x Hq 4 x S 256) and
    32-key tiles at D = 256; the f32 (3xTF32) kernel 4 warps on 64 rows
    (32 at D = 256) with Q and a ring of two K / V tiles staged in f32 and
    split into TF32 halves in shared memory (FWD_TF32_TILES)."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in "
                         f"{KERNEL_HEAD_DIMS}, got D={D}")
    if fwd_library(dtype)[0] == "flash_attention_fwd_mma":
        block_q, block_k = 32, (32 if D == 256 else 64)
        smem = ((block_q + 2 * 3 * block_k) * (D + 8) * 2
                + 3 * block_k * 4)
    else:
        block_q, block_k, _ = FWD_TF32_TILES[D]
        smem = (2 * block_q * (D + 4) + 4 * TF32_STAGES * block_k * (D + 4)
                + TF32_STAGES * block_k) * 4
    return {"block_q": block_q, "block_k": block_k,
            "grid": (-(-S // block_q), Hq, B), "smem_bytes": smem}


def bwd_library(dtype: torch.dtype) -> Tuple[str, str]:
    """(source, C symbol) of the merged backward kernel for `dtype`: bf16
    and f16 run on the tensor-core kernel, f32 on the 3xTF32 tensor-core
    kernel (there is no fallback from one to another)."""
    if dtype in (torch.bfloat16, torch.float16):
        return ("flash_attention_bwd_merged_mma",
                "mft_flash_attention_bwd_merged_mma")
    if dtype == torch.float32:
        return ("flash_attention_bwd_merged_tf32",
                "mft_flash_attention_bwd_merged_tf32")
    raise ValueError(f"flash_attention_bwd_merged kernel takes one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


# csrc/flash_attention_bwd_merged_mma.cu Cfg<D>: D -> (keys a CTA, query
# rows a q-block, warps sharing each 16 keys)
BWD_MMA_TILES = {64: (32, 32, 1), 128: (64, 64, 2), 256: (32, 32, 2)}
BWD_MMA_STAGES = 2      # its Q / dO ring
# csrc/flash_attention_bwd_merged_tf32.cu Cfg<D>: the same for f32
BWD_TF32_TILES = {64: (32, 32, 1), 128: (32, 32, 2), 256: (16, 16, 4)}


def bwd_plan(B: int, Hq: int, Hkv: int, S: int, D: int,
             dtype: torch.dtype) -> dict:
    """The merged backward kernel's launch, as its source computes it:
    keys a CTA (`block_k`), query rows a q-block (`block_q`), `warps`,
    the Q / dO ring's `stages`, the grid (key blocks, q-heads, batch) and
    `smem_bytes`. One warp per 16 keys and 64 or 128 of dK / dV's columns.
    The bf16 / f16 kernel: all of them at D 64, half at D >= 128
    (BWD_MMA_TILES: 384 CTAs at GPT-2's B 8 x 12 heads x S 128, 128 at
    Gemma-3's B 4 x Hq 4 x S 256); the f32 (3xTF32) kernel: 64 columns a
    warp, K, V, Q and dO staged in f32 and split into TF32 halves in
    shared memory (BWD_TF32_TILES)."""
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_merged kernel takes D in "
                         f"{KERNEL_HEAD_DIMS}, got D={D}")
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd_merged: Hq {Hq} is not a "
                         f"multiple of Hkv {Hkv}")
    if bwd_library(dtype)[0] == "flash_attention_bwd_merged_mma":
        block_k, block_q, d_split = BWD_MMA_TILES[D]
        stages = BWD_MMA_STAGES
        ld = D + 8
        smem = ((2 * block_k * ld + 2 * stages * block_q * ld
                 + block_k * (block_q + 8)) * 2
                + (2 * stages * block_q + block_k) * 4)
    else:
        block_k, block_q, d_split = BWD_TF32_TILES[D]
        stages = TF32_STAGES
        ld = D + 4
        smem = (4 * block_k * ld + 4 * stages * block_q * ld
                + 2 * block_q * (block_k + 8) + 2 * stages * block_q
                + block_k) * 4
    return {"block_k": block_k, "block_q": block_q,
            "warps": block_k // 16 * d_split, "stages": stages,
            "grid": (-(-S // block_k), Hq, B), "smem_bytes": smem}


def _fn(lib: str, sym: str, n_ptrs: int):
    """The ctypes entry `sym` of csrc/<lib>.cu: n_ptrs pointers, then the
    shape and mask ints, the scale, the dropout arguments and the stream."""
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v, what: str):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _check_kernel_inputs(what: str, q, tensors, f32s):
    """The kernels' rule for CUDA tensors: one device, one dtype of
    DTYPE_CODES, D in KERNEL_HEAD_DIMS, contiguous; f32s contiguous f32."""
    D = q.shape[-1]
    for t in list(tensors) + list(f32s):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: tensors on {t.device} and {q.device};"
                             f" the kernel takes one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if not flash_eligible(D, q.dtype) or any(t.dtype != q.dtype
                                             for t in tensors):
        raise ValueError(
            f"{what} kernel takes D in {KERNEL_HEAD_DIMS} and one dtype of "
            f"{sorted(map(str, DTYPE_CODES))}, got D={D}, "
            f"{[str(t.dtype) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{what} kernel takes f32 padding, lse and delta")


def _pad_f32(padding_mask, B, S, device):
    pad = (torch.ones(B, S, device=device) if padding_mask is None
           else padding_mask.to(device=device,
                                dtype=torch.float32).contiguous())
    if pad.shape != (B, S):
        raise ValueError(f"padding_mask {tuple(pad.shape)} != {(B, S)}")
    return pad


def flash_attention_fwd(q, k, v, padding_mask=None, *,
                        scale: Optional[float] = None,
                        is_causal: bool = True,
                        sliding_window: Optional[int] = None,
                        p_drop: float = 0.0, seed: Optional[int] = None):
    """(out, lse) for q [B,Hq,S,D], k/v [B,Hkv,S,D], padding_mask [B,S]
    (1/True = real key); dropout with probability p_drop when a seed is
    given. CPU tensors: the plain version. CUDA tensors: the kernel of
    fwd_library(q.dtype), or ValueError for what it does not take."""
    _check_qkv(q, k, v, "flash_attention")
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, padding_mask, scale=scale, is_causal=is_causal,
            sliding_window=sliding_window, p_drop=p_drop, seed=seed)
    B, Hq, S, D = q.shape
    pad = _pad_f32(padding_mask, B, S, q.device)
    _check_kernel_inputs("flash_attention", q, (q, k, v), (pad,))
    lib, sym = fwd_library(q.dtype)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention tensor-core kernel takes 16-byte "
                         "aligned q, k and v")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, S, 1, device=q.device, dtype=torch.float32)
    code = _fn(lib, sym, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Hq, k.shape[1], S, D,
        DTYPE_CODES[q.dtype], float(scale), int(bool(is_causal)),
        int(sliding_window is not None),
        0 if sliding_window is None else int(sliding_window),
        *_dropout_args(p_drop, seed),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_attention_fwd", code)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.by_shape[(q.dtype, B, Hq, S, D)] += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.by_shape = collections.Counter()
graphs.counted(flash_attention_fwd)


# ------------------------------------------------------------ backward ------

def _bwd_tile_reference(qb, dob, lseb, deltab, kb, vb, pad, rows, cols, bi,
                        hi_, scale, causal, window, p_drop, seed):
    """One (q-block, key-block) tile of the backward (`_bwd_tile`): (pv,
    ds) over [B, Hkv, G, R, C], f32."""
    s = qb @ kb.transpose(-1, -2) * scale
    mask = _tile_mask(pad, rows, cols, causal, window)
    p = torch.where(mask, torch.exp(s - lseb), 0.0)
    dp = dob @ vb.transpose(-1, -2)
    pv = p
    if p_drop > 0.0 and seed is not None:
        keep = keep_mask(seed, bi, hi_, rows, cols, p_drop)
        inv = 1.0 / (1.0 - p_drop)
        pv = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    return pv, p * (dp - deltab) * scale


def _bwd_views(q, k, v, lse, delta, dout, padding_mask):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    f = lambda t: t.float().reshape(B, Hkv, G, S, -1)  # noqa: E731
    pad = (torch.ones(B, S, device=q.device) if padding_mask is None
           else padding_mask.float())
    return (B, Hq, Hkv, G, S, D, f(q), k.float()[:, :, None],
            v.float()[:, :, None], f(lse), f(delta), f(dout), pad)


def flash_bwd_merged_reference(q, k, v, padding_mask, lse, delta, dout, *,
                               scale, is_causal=True, sliding_window=None,
                               p_drop=0.0, seed=None):
    """The merged kernel's algorithm in torch: per key block, dK/dV over
    the q-blocks that see it and that tile's dQ rows added into an f32
    accumulator; per-q-head dK/dV partials group-summed at the end.
    Returns (dq q.dtype, dk k.dtype, dv v.dtype)."""
    (B, Hq, Hkv, G, S, D, qf, kf, vf, lsef, dlf, dof,
     pad) = _bwd_views(q, k, v, lse, delta, dout, padding_mask)
    bi, hi_ = _head_index(B, Hkv, G, q.device)
    dq = torch.zeros(B, Hkv, G, S, D, device=q.device)
    dk = torch.zeros(B, Hkv, G, S, D, device=q.device)
    dv = torch.zeros(B, Hkv, G, S, D, device=q.device)
    n_q = -(-S // BLOCK_Q)
    for col0 in range(0, S, BLOCK_K):
        col1 = min(S, col0 + BLOCK_K)
        cols = torch.arange(col0, col1, device=q.device)[None, :]
        kb, vb = kf[..., col0:col1, :], vf[..., col0:col1, :]
        qlo, qhi = _q_block_bounds(col0, n_q, is_causal, sliding_window)
        for qi in range(qlo, qhi):
            row0, row1 = qi * BLOCK_Q, min(S, (qi + 1) * BLOCK_Q)
            rows = torch.arange(row0, row1, device=q.device)[:, None]
            r = slice(row0, row1)
            pv, ds = _bwd_tile_reference(
                qf[..., r, :], dof[..., r, :], lsef[..., r, :],
                dlf[..., r, :], kb, vb, pad, rows, cols, bi, hi_, scale,
                is_causal, sliding_window, p_drop, seed)
            dv[..., col0:col1, :] += pv.transpose(-1, -2) @ dof[..., r, :]
            dk[..., col0:col1, :] += ds.transpose(-1, -2) @ qf[..., r, :]
            dq[..., r, :] += ds @ kb
    return (dq.reshape(B, Hq, S, D).to(q.dtype),
            dk.sum(2).to(k.dtype), dv.sum(2).to(v.dtype))


def flash_bwd_split_reference(q, k, v, padding_mask, lse, delta, dout, *,
                              scale, is_causal=True, sliding_window=None,
                              p_drop=0.0, seed=None):
    """The split pair's algorithm in torch: dQ per q-block over its
    [lo, hi) key blocks, then dK/dV per key block over the q-blocks that
    see it, the G q-heads of a kv-head summed. (dq, dk, dv) as the merged
    version."""
    (B, Hq, Hkv, G, S, D, qf, kf, vf, lsef, dlf, dof,
     pad) = _bwd_views(q, k, v, lse, delta, dout, padding_mask)
    bi, hi_ = _head_index(B, Hkv, G, q.device)
    dq = torch.zeros(B, Hkv, G, S, D, device=q.device)
    dk = torch.zeros(B, Hkv, S, D, device=q.device)
    dv = torch.zeros(B, Hkv, S, D, device=q.device)
    n_q, n_kv = -(-S // BLOCK_Q), -(-S // BLOCK_K)

    def tile(row0, row1, col0, col1):
        rows = torch.arange(row0, row1, device=q.device)[:, None]
        cols = torch.arange(col0, col1, device=q.device)[None, :]
        r = slice(row0, row1)
        return _bwd_tile_reference(
            qf[..., r, :], dof[..., r, :], lsef[..., r, :], dlf[..., r, :],
            kf[..., col0:col1, :], vf[..., col0:col1, :], pad, rows, cols,
            bi, hi_, scale, is_causal, sliding_window, p_drop, seed)

    for row0 in range(0, S, BLOCK_Q):
        row1 = min(S, row0 + BLOCK_Q)
        lo, hi = _kv_block_bounds(row0, n_kv, is_causal, sliding_window)
        for kb in range(lo, hi):
            col0, col1 = kb * BLOCK_K, min(S, (kb + 1) * BLOCK_K)
            _, ds = tile(row0, row1, col0, col1)
            dq[..., row0:row1, :] += ds @ kf[..., col0:col1, :]
    for col0 in range(0, S, BLOCK_K):
        col1 = min(S, col0 + BLOCK_K)
        qlo, qhi = _q_block_bounds(col0, n_q, is_causal, sliding_window)
        for qi in range(qlo, qhi):
            row0, row1 = qi * BLOCK_Q, min(S, (qi + 1) * BLOCK_Q)
            pv, ds = tile(row0, row1, col0, col1)
            r = slice(row0, row1)
            dv[..., col0:col1, :] += (pv.transpose(-1, -2)
                                      @ dof[..., r, :]).sum(2)
            dk[..., col0:col1, :] += (ds.transpose(-1, -2)
                                      @ qf[..., r, :]).sum(2)
    return (dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bwd_common(q, k, v, padding_mask, lse, delta, dout, what):
    """Checks shared by the backward wrappers: (pad, lse, delta) as the
    kernels take them, f32 [B, S] and [B, Hq, S, 1]."""
    _check_qkv(q, k, v, what)
    B, Hq, S, D = q.shape
    if dout.shape != q.shape or lse.shape != (B, Hq, S, 1) \
            or delta.shape != (B, Hq, S, 1):
        raise ValueError(f"{what}: dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"for q {tuple(q.shape)}")
    pad = _pad_f32(padding_mask, B, S, q.device)
    _check_kernel_inputs(what, q, (q, k, v, dout), (pad, lse, delta))
    return pad


def _bwd_scalars(q, k, scale, is_causal, sliding_window, p_drop, seed):
    B, Hq, S, D = q.shape
    return (B, Hq, k.shape[1], S, D, DTYPE_CODES[q.dtype], float(scale),
            int(bool(is_causal)), int(sliding_window is not None),
            0 if sliding_window is None else int(sliding_window),
            *_dropout_args(p_drop, seed),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_merged(q, k, v, padding_mask, lse, delta, dout, *,
                               scale: float, is_causal: bool = True,
                               sliding_window: Optional[int] = None,
                               p_drop: float = 0.0,
                               seed: Optional[int] = None):
    """(dq, dk, dv) by the merged one-pass kernel. delta = rowsum(dO*O)
    [B,Hq,S,1] f32; lse from the forward. CPU tensors: the plain version.
    CUDA tensors: the kernel of bwd_library(q.dtype), or ValueError."""
    kw = dict(scale=scale, is_causal=is_causal,
              sliding_window=sliding_window, p_drop=p_drop, seed=seed)
    if q.device.type == "cpu":
        _check_qkv(q, k, v, "flash_attention_bwd_merged")
        return flash_bwd_merged_reference(q, k, v, padding_mask, lse, delta,
                                          dout, **kw)
    pad = _bwd_common(q, k, v, padding_mask, lse, delta, dout,
                      "flash_attention_bwd_merged")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dout.data_ptr())
    scalars = _bwd_scalars(q, k, scale, is_causal, sliding_window, p_drop,
                           seed)
    lib, sym = bwd_library(q.dtype)
    if any(t.data_ptr() % 16 for t in (q, k, v, dout)):
        raise ValueError("flash_attention_bwd_merged tensor-core kernel "
                         "takes 16-byte aligned q, k, v and dout")
    n = q.numel()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if lib == "flash_attention_bwd_merged_tf32":
        # dq is zeroed by the launcher; with G > 1, one f32 workspace for
        # the per-q-head dK / dV partials its finish pass sums
        ws = (torch.empty(2 * n, device=q.device, dtype=torch.float32)
              if G > 1 else None)
        parts = ((ws.data_ptr(), ws[n:].data_ptr()) if G > 1
                 else (None, None))
        code = _fn(lib, sym, 12)(*ins, dq.data_ptr(), *parts, dk.data_ptr(),
                                 dv.data_ptr(), *scalars)
    else:
        # one f32 workspace: dQ's sums (zeroed by the launcher) and, with
        # G > 1, the per-q-head dK / dV partials its finish pass sums
        ws = torch.empty((3 if G > 1 else 1) * n, device=q.device,
                         dtype=torch.float32)
        parts = (ws[n:].data_ptr(), ws[2 * n:].data_ptr()) if G > 1 \
            else (None, None)
        code = _fn(lib, sym, 13)(*ins, ws.data_ptr(), *parts, dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), *scalars)
    build.check_launch("flash_attention_bwd_merged", code)
    flash_attention_bwd_merged.launches += 1
    flash_attention_bwd_merged.by_dtype[q.dtype] += 1
    return dq, dk, dv


flash_attention_bwd_merged.launches = 0
flash_attention_bwd_merged.by_dtype = collections.Counter()
graphs.counted(flash_attention_bwd_merged)


def flash_attention_bwd_dq(q, k, v, padding_mask, lse, delta, dout, *,
                           scale: float, is_causal: bool = True,
                           sliding_window: Optional[int] = None,
                           p_drop: float = 0.0, seed: Optional[int] = None):
    """dq [B,Hq,S,D] in q's dtype by the split pair's dQ kernel (CUDA
    tensors only; the CPU's plain split version is
    flash_bwd_split_reference)."""
    pad = _bwd_common(q, k, v, padding_mask, lse, delta, dout,
                      "flash_attention_bwd_dq")
    dq = torch.empty_like(q)
    code = _fn("flash_attention_bwd_split", "mft_flash_attention_bwd_dq",
               8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dq.data_ptr(),
        *_bwd_scalars(q, k, scale, is_causal, sliding_window, p_drop, seed))
    build.check_launch("flash_attention_bwd_dq", code)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0
graphs.counted(flash_attention_bwd_dq)


def flash_attention_bwd_dkv(q, k, v, padding_mask, lse, delta, dout, *,
                            scale: float, is_causal: bool = True,
                            sliding_window: Optional[int] = None,
                            p_drop: float = 0.0,
                            seed: Optional[int] = None):
    """(dk, dv) [B,Hkv,S,D] in k's dtype by the split pair's dK/dV kernel
    (CUDA tensors only, as flash_attention_bwd_dq)."""
    pad = _bwd_common(q, k, v, padding_mask, lse, delta, dout,
                      "flash_attention_bwd_dkv")
    dk = torch.empty(k.shape, device=q.device, dtype=torch.float32)
    dv = torch.empty_like(dk)
    code = _fn("flash_attention_bwd_split", "mft_flash_attention_bwd_dkv",
               9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dout.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        *_bwd_scalars(q, k, scale, is_causal, sliding_window, p_drop, seed))
    build.check_launch("flash_attention_bwd_dkv", code)
    flash_attention_bwd_dkv.launches += 1
    return dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_dkv.launches = 0
graphs.counted(flash_attention_bwd_dkv)


def flash_attention_bwd_split(q, k, v, padding_mask, lse, delta, dout, *,
                              scale: float, is_causal: bool = True,
                              sliding_window: Optional[int] = None,
                              p_drop: float = 0.0,
                              seed: Optional[int] = None):
    """(dq, dk, dv) by the split pair: the two kernels on CUDA tensors,
    flash_bwd_split_reference on CPU tensors."""
    kw = dict(scale=scale, is_causal=is_causal,
              sliding_window=sliding_window, p_drop=p_drop, seed=seed)
    if q.device.type == "cpu":
        _check_qkv(q, k, v, "flash_attention_bwd_split")
        return flash_bwd_split_reference(q, k, v, padding_mask, lse, delta,
                                         dout, **kw)
    dq = flash_attention_bwd_dq(q, k, v, padding_mask, lse, delta, dout,
                                **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, padding_mask, lse, delta,
                                     dout, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v); the forward saves (out, lse)
    only, the backward recomputes the probabilities blockwise."""

    @staticmethod
    def forward(ctx, q, k, v, pad, scale, causal, window, p_drop, seed,
                bwd_impl):
        out, lse = flash_attention_fwd(q, k, v, pad, scale=scale,
                                       is_causal=causal,
                                       sliding_window=window, p_drop=p_drop,
                                       seed=seed)
        ctx.save_for_backward(q, k, v, pad, out, lse)
        ctx.cfg = dict(scale=scale, is_causal=causal, sliding_window=window,
                       p_drop=p_drop, seed=seed)
        ctx.bwd_impl = bwd_impl
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, pad, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # delta = rowsum(dO * O): one torch pass shared by every kernel
        delta = (dout.float() * out.float()).sum(-1, keepdim=True)
        impl = ctx.bwd_impl
        if impl == "auto":
            impl = resolve_bwd_impl(q.shape[2], q.shape[3], q.dtype)
        bwd = (flash_attention_bwd_merged if impl == "merged"
               else flash_attention_bwd_split)
        dq, dk, dv = bwd(q, k, v, pad, lse, delta, dout, **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    is_causal: bool = True,
                    sliding_window: Optional[int] = None,
                    padding_mask=None, attn_dropout: float = 0.0,
                    dropout_seed: Optional[int] = None,
                    bwd_impl: str = "auto"):
    """Drop-in for ops.attention.dot_product_attention: out only, with
    gradients to q, k and v. A sliding window implies causal, as in the
    dense oracle's masks. Dropout runs with probability attn_dropout when
    a dropout_seed (an int; the JAX wrapper's int32 seed) is given, and
    not at all without one (eval)."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got "
                         f"{bwd_impl!r}")
    _check_qkv(q, k, v, "flash_attention")
    B, Hq, S, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    pad = (torch.ones(B, S, device=q.device) if padding_mask is None
           else padding_mask.to(torch.float32).contiguous())
    p_drop = float(attn_dropout) if dropout_seed is not None else 0.0
    return FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), pad, float(scale),
        bool(is_causal or sliding_window is not None),
        None if sliding_window is None else int(sliding_window), p_drop,
        None if p_drop <= 0.0 else int(dropout_seed), bwd_impl)
