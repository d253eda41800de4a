"""LoRA epilogue: the Hopper kernel, its wrapper and its plain version
(port of mobilefinetuner_tpu/ops/lora_fused.py).

A LoRA site computes y = x @ W (+ b) and then y + scale * (xa @ B) with
xa = x @ A, the rank-r bottleneck. Written as two torch ops, the
[N, d_out] delta is written to device memory and read back to be added;
the epilogue kernel (`csrc/lora_epilogue.cu`) adds xa @ B to y in one
pass over y, accumulating the rank-r product in f32.

  lora_epilogue            out = y2 + xa2 @ b2 on 2-D operands (xa2
                           already scale-folded): CUDA tensors launch the
                           kernel (or raise), CPU tensors take
                           `lora_epilogue_reference`. `.launches` counts
                           the kernel launches.
  lora_epilogue_reference  the plain version: f32 product, one rounding.
  lora_epilogue_add        y + scale * (xa @ B) for any leading shape,
                           differentiable: the scale is folded into xa
                           in f32 outside the kernel (as the JAX wrapper
                           does, scale carrying no gradient), and the
                           backward of the kernel call is plain matmuls
                           as the JAX custom_vjp's: dy = g,
                           dxa = g @ B^T, dB = xa^T @ g, f32-accumulated.
  lora_epilogue_eligible   the kernel's own rule: a rank in [1, 128], one
                           dtype of f32/bf16/f16. Any N and d_out (the
                           kernel masks its ragged edges).
"""

from __future__ import annotations

import ctypes

import torch

from mobilefinetuner_tpu_torch.kernels import build

MAX_RANK = 128           # csrc/lora_epilogue.cu MAX_RANK
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def lora_epilogue_eligible(r: int, dtype: torch.dtype) -> bool:
    return 0 < r <= MAX_RANK and dtype in DTYPE_CODES


def lora_epilogue_reference(y2, xa2, b2):
    """y2 + xa2 @ b2 with the product in f32 and one cast to y2's dtype."""
    return (y2.float() + xa2.float() @ b2.float()).to(y2.dtype)


def _kernel():
    fn = build.load("lora_epilogue").mft_lora_epilogue
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def lora_epilogue(y2, xa2, b2):
    """out [N, d_out] = y2 [N, d_out] + xa2 [N, r] @ b2 [r, d_out]. CPU
    tensors: the plain version. CUDA tensors: the kernel, or ValueError
    for what it does not take."""
    N, d_out = y2.shape
    r = xa2.shape[-1]
    if xa2.shape != (N, r) or b2.shape != (r, d_out):
        raise ValueError(f"lora_epilogue: y {tuple(y2.shape)}, xa "
                         f"{tuple(xa2.shape)}, B {tuple(b2.shape)}")
    if y2.device.type == "cpu":
        return lora_epilogue_reference(y2, xa2, b2)
    for t in (y2, xa2, b2):
        if not t.is_cuda or t.device != y2.device:
            raise ValueError(f"lora_epilogue: tensors on {t.device} and "
                             f"{y2.device}; the kernel takes one CUDA device")
        if not t.is_contiguous():
            raise ValueError("lora_epilogue kernel takes contiguous tensors")
    if not lora_epilogue_eligible(r, y2.dtype) \
            or xa2.dtype != y2.dtype or b2.dtype != y2.dtype:
        raise ValueError(
            f"lora_epilogue kernel takes a rank in [1, {MAX_RANK}] and one "
            f"dtype of {sorted(map(str, DTYPE_CODES))}, got r={r}, "
            f"{y2.dtype}/{xa2.dtype}/{b2.dtype}")
    out = torch.empty_like(y2)
    code = _kernel()(y2.data_ptr(), xa2.data_ptr(), b2.data_ptr(),
                     out.data_ptr(), N, d_out, r, DTYPE_CODES[y2.dtype],
                     torch.cuda.current_stream(y2.device).cuda_stream)
    build.check_launch("lora_epilogue", code)
    lora_epilogue.launches += 1
    return out


lora_epilogue.launches = 0


class LoRAEpilogue(torch.autograd.Function):
    """y2 + xa2 @ b2 through the epilogue kernel; the backward has no
    y-sized temporary to save, so it is plain matmuls."""

    @staticmethod
    def forward(ctx, y2, xa2, b2):
        ctx.save_for_backward(xa2, b2)
        return lora_epilogue(y2, xa2, b2)

    @staticmethod
    def backward(ctx, g):
        xa2, b2 = ctx.saved_tensors
        gf = g.float()
        dxa = (gf @ b2.float().T).to(xa2.dtype)
        db = (xa2.float().T @ gf).to(b2.dtype)
        return g, dxa, db


def lora_epilogue_add(y, xa, B, scale):
    """y + scale * (xa @ B) through the epilogue kernel. y [..., d_out],
    xa [..., r] the bottleneck in the compute dtype, B [r, d_out], scale a
    scalar tensor (no gradient flows to it). Returns y's shape and dtype."""
    d_out = y.shape[-1]
    r = xa.shape[-1]
    xs = (xa.float() * scale.detach().float()).to(y.dtype)
    out = LoRAEpilogue.apply(y.reshape(-1, d_out), xs.reshape(-1, r),
                             B.to(y.dtype).contiguous())
    return out.reshape(y.shape)
