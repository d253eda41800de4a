"""Flash-attention forward: the Hopper kernel, its wrapper and its plain
version (port of mobilefinetuner_tpu/ops/flash_attention.py, forward only).

  flash_attention_fwd        (out, lse). CUDA tensors launch the kernel
                             `csrc/flash_attention_fwd.cu` (or raise); CPU
                             tensors take `flash_attention_reference`.
                             `flash_attention_fwd.launches` counts the
                             kernel launches.
  flash_attention            drop-in for ops.attention.dot_product_attention
                             (returns out only).
  flash_attention_reference  the kernel's blocked online softmax written
                             in torch: 64 x 64 tiles, the same [lo, hi)
                             key-block bounds, the same masks and f32
                             arithmetic. It runs on any device.

Masks (as the TPU kernel's `_block_mask`): key padding, causal, and an
optional sliding window (col > row - window); GQA reads kv-head h // G.
Unlike the dense oracle, a fully masked row gives 0 (the TPU kernel's
l_safe rule), not the mean of V; serving right-pads, so it never has one.

The kernel takes D in {64, 128, 256} and any S (it masks the ragged
edge). Train-mode dropout (`_keep_mask`) and the backward kernels come
with the training slice.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from mobilefinetuner_tpu_torch.kernels import build

NEG_INF = -1e30
BLOCK_Q = 64            # the kernel's tile sizes (csrc/flash_attention_fwd.cu)
BLOCK_K = 64
KERNEL_HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def flash_eligible(D: int, dtype: torch.dtype) -> bool:
    """The kernel's own rule: head dim and dtype it was built for."""
    return D in KERNEL_HEAD_DIMS and dtype in DTYPE_CODES


def _kv_block_bounds(row0: int, n_kv_blocks: int, causal: bool,
                     window: Optional[int]) -> Tuple[int, int]:
    """[lo, hi) key blocks reachable from query rows [row0, row0+BLOCK_Q)."""
    hi = (min(n_kv_blocks, (row0 + BLOCK_Q - 1) // BLOCK_K + 1)
          if causal else n_kv_blocks)
    lo = max(0, (row0 - window + 1) // BLOCK_K) if window is not None else 0
    return lo, hi


def flash_attention_reference(q, k, v, padding_mask=None, *,
                              scale: Optional[float] = None,
                              is_causal: bool = True,
                              sliding_window: Optional[int] = None):
    """The kernel's algorithm in torch: (out [B,Hq,S,D] q.dtype,
    lse [B,Hq,S,1] f32). `is_causal` and `sliding_window` are independent
    here, as in the kernel."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    pad = (torch.ones(B, S, device=q.device) if padding_mask is None
           else padding_mask.float())
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
            mask = (pad[:, col0:col1] > 0)[:, None, None, None, :]
            if is_causal:
                mask = mask & (cols <= rows)
            if sliding_window is not None:
                mask = mask & (cols > rows - sliding_window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[..., col0:col1, :]
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        out[:, :, :, row0:row1] = acc / l_safe
        lse[:, :, :, row0:row1] = (m + torch.log(l_safe))[..., 0]
    return (out.reshape(B, Hq, S, D).to(q.dtype),
            lse.reshape(B, Hq, S, 1))


def _kernel():
    fn = build.load("flash_attention_fwd").mft_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, padding_mask=None, *,
                        scale: Optional[float] = None,
                        is_causal: bool = True,
                        sliding_window: Optional[int] = None):
    """(out, lse) for q [B,Hq,S,D], k/v [B,Hkv,S,D], padding_mask [B,S]
    (1/True = real key). CPU tensors: the plain version. CUDA tensors:
    the kernel, or ValueError for what it does not take."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, padding_mask, scale=scale, is_causal=is_causal,
            sliding_window=sliding_window)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q/k/v on {q.device}/{k.device}/"
                         f"{v.device}; the kernel takes one CUDA device")
    if not flash_eligible(D, q.dtype) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes D in {KERNEL_HEAD_DIMS} and one "
            f"dtype of {sorted(map(str, DTYPE_CODES))}, got D={D}, "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel takes contiguous q/k/v")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    pad = (torch.ones(B, S, device=q.device) if padding_mask is None
           else padding_mask.to(device=q.device,
                                dtype=torch.float32).contiguous())
    if pad.shape != (B, S):
        raise ValueError(f"padding_mask {tuple(pad.shape)} != {(B, S)}")
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, S, 1, device=q.device, dtype=torch.float32)
    code = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pad.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, S, D,
        DTYPE_CODES[q.dtype], float(scale), int(bool(is_causal)),
        int(sliding_window is not None),
        0 if sliding_window is None else int(sliding_window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_attention_fwd", code)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    is_causal: bool = True,
                    sliding_window: Optional[int] = None,
                    padding_mask=None, attn_dropout: float = 0.0):
    """Drop-in for ops.attention.dot_product_attention: out only. A
    sliding window implies causal, as in the dense oracle's masks."""
    if attn_dropout > 0.0:
        raise NotImplementedError(
            "attention dropout in the flash kernel comes with the training "
            "slice (ROADMAP.md, port kernel queue: flash backward)")
    return flash_attention_fwd(
        q, k, v, padding_mask, scale=scale,
        is_causal=is_causal or sliding_window is not None,
        sliding_window=sliding_window)[0]
