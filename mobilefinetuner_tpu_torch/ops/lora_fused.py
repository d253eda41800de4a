"""LoRA epilogue: the Hopper kernels, their wrapper and their plain version
(port of mobilefinetuner_tpu/ops/lora_fused.py).

A LoRA site computes y = x @ W (+ b) and then y + scale * (xa @ B) with
xa = x @ A, the rank-r bottleneck. Written as two torch ops, the
[N, d_out] delta is written to device memory and read back to be added;
the epilogue kernel adds xa @ B to y in one pass over y, accumulating the
rank-r product in f32. bf16 and f16 run `csrc/lora_epilogue_vec.cu`, f32
`csrc/lora_epilogue_vec_f32.cu`; both fold the scale in (xs =
f32(xa) * scale, rounded to the storage dtype, the scale read from its
device address), in one launch. `csrc/lora_epilogue.cu`, which f32 ran
before on an xs the wrapper formed in launches of its own, stays built
as its first version on no path.

  lora_epilogue            (out, xs): out = y2 + xs @ b2 on 2-D operands,
                           xs = xa2 folded with `scale` (an f32 0-d tensor
                           on y2's device): CUDA tensors launch the kernel
                           of epilogue_library(dtype) (or raise), CPU
                           tensors take `lora_epilogue_reference`.
                           `.launches` counts the kernel launches,
                           `.by_shape` them by (dtype, N, d_out), both
                           exact under CUDA-graph replay (kernels/
                           graphs.py).
  lora_epilogue_reference  the plain version: f32 product, one rounding.
  scaled_bottleneck        xs = (f32(xa) * scale) rounded to a dtype: the
                           JAX wrapper's fold, which the 16-bit kernel
                           repeats bit for bit.
  lora_epilogue_add        y + scale * (xa @ B) for any leading shape,
                           differentiable (scale carries no gradient), as
                           the JAX custom_vjp's: dy = g, dxs = g @ B^T,
                           dxa = dxs * scale, dB = xs^T @ g, f32-accumulated,
                           each rounded where autograd through the fold
                           rounds it.
  lora_epilogue_eligible   the kernels' own rule: a rank in [1, 128], one
                           dtype of f32/bf16/f16. Any N and d_out (ragged
                           edges masked, narrower vectors where d_out or an
                           address does not allow 16 bytes).
  epilogue_vec_plan        the vector kernels' launch (vector width, rows a
                           thread, CTAs) by element size, checked on the
                           CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch

from mobilefinetuner_tpu_torch.kernels import build, graphs

MAX_RANK = 128           # both sources' MAX_RANK
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VEC_THREADS = 128        # csrc/lora_epilogue_vec.cu, _vec_f32.cu THREADS
VEC_ROWS = 4             # their rows a thread at N <= 4 (16-byte vectors)


def lora_epilogue_eligible(r: int, dtype: torch.dtype) -> bool:
    return 0 < r <= MAX_RANK and dtype in DTYPE_CODES


def epilogue_library(dtype: torch.dtype) -> Tuple[str, str]:
    """(source, C symbol) of the epilogue kernel for `dtype`: the vector
    kernel with the scale fold, bf16 and f16 on one source, f32 on its
    own."""
    if dtype in (torch.bfloat16, torch.float16):
        return "lora_epilogue_vec", "mft_lora_epilogue_vec"
    if dtype == torch.float32:
        return "lora_epilogue_vec_f32", "mft_lora_epilogue_vec_f32"
    raise ValueError(f"lora_epilogue kernel takes one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


def epilogue_vec_plan(N: int, d_out: int, n_sm: int,
                      addr_align: int = 16, elem_bytes: int = 2) -> dict:
    """The vector kernels' launch for elements of `elem_bytes` (2: the
    16-bit source, 4: the f32 one): `vec` elements a thread (16 bytes'
    worth, or 8, 4, 2 or 1 fewer, where d_out and `addr_align`, the
    alignment in bytes common to y, out and B, allow it), `rows` rows a
    thread strided `rs` apart (VEC_ROWS where they are all N <= VEC_ROWS
    rows, the vectors 16 bytes and the CTAs still at least n_sm: B's slab
    is then read once; else 1), `ncv` column vectors a row, `ctas` CTAs
    of VEC_THREADS threads."""
    vec = next(v for v in (8, 4, 2, 1)
               if v * elem_bytes <= 16 and d_out % v == 0
               and addr_align % (elem_bytes * v) == 0)
    ncv = d_out // vec

    def ctas(rows):
        return -(-ncv * -(-N // rows) // VEC_THREADS)
    rows = VEC_ROWS if (vec * elem_bytes == 16 and N <= VEC_ROWS
                        and ctas(VEC_ROWS) >= n_sm) else 1
    return {"vec": vec, "rows": rows, "rs": -(-N // rows), "ncv": ncv,
            "ctas": ctas(rows)}


def scaled_bottleneck(xa, scale, dtype):
    """xs = f32(xa) * scale rounded once to `dtype`."""
    return (xa.float() * scale.float()).to(dtype)


def lora_epilogue_reference(y2, xa2, b2, scale):
    """y2 + xs @ b2 with xs = scaled_bottleneck(xa2, scale, y2.dtype), the
    product in f32 and one cast to y2's dtype."""
    xs = scaled_bottleneck(xa2, scale, y2.dtype)
    return (y2.float() + xs.float() @ b2.float()).to(y2.dtype)


def _kernel(dtype):
    lib, sym = epilogue_library(dtype)
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _addr_align(*ts) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    a = 16
    while any(t.data_ptr() % a for t in ts):
        a //= 2
    return a


def lora_epilogue(y2, xa2, b2, scale):
    """(out, xs): out [N, d_out] = y2 [N, d_out] + xs @ b2 [r, d_out], xs
    [N, r] the scaled xa2 (scaled_bottleneck, in y2's dtype), the operand
    of the backward's dB. CPU tensors: the plain version. CUDA tensors: the
    kernel, or ValueError for what it does not take."""
    N, d_out = y2.shape
    r = xa2.shape[-1]
    if xa2.shape != (N, r) or b2.shape != (r, d_out):
        raise ValueError(f"lora_epilogue: y {tuple(y2.shape)}, xa "
                         f"{tuple(xa2.shape)}, B {tuple(b2.shape)}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"lora_epilogue takes an f32 scale of one "
                         f"element, got {scale.dtype} {tuple(scale.shape)}")
    if y2.device.type == "cpu":
        return (lora_epilogue_reference(y2, xa2, b2, scale),
                scaled_bottleneck(xa2, scale, y2.dtype))
    for t in (y2, xa2, b2, scale):
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
    xs = torch.empty_like(xa2)
    plan = epilogue_vec_plan(
        N, d_out,
        torch.cuda.get_device_properties(y2.device).multi_processor_count,
        _addr_align(y2, out, b2), y2.element_size())
    code = _kernel(y2.dtype)(
        y2.data_ptr(), xa2.data_ptr(), b2.data_ptr(), scale.data_ptr(),
        out.data_ptr(), xs.data_ptr(), N, d_out, r, plan["vec"],
        plan["rows"], DTYPE_CODES[y2.dtype],
        torch.cuda.current_stream(y2.device).cuda_stream)
    build.check_launch("lora_epilogue", code)
    lora_epilogue.launches += 1
    lora_epilogue.by_shape[(y2.dtype, N, d_out)] += 1
    return out, xs


lora_epilogue.launches = 0
lora_epilogue.by_shape = collections.Counter()
graphs.counted(lora_epilogue)


class LoRAEpilogue(torch.autograd.Function):
    """y2 + xs @ b2, xs = scaled_bottleneck(xa2, scale, y2.dtype), through
    the epilogue kernel; the backward has no y-sized temporary to save, so
    it is plain matmuls, rounded where autograd through the fold and the
    kernel call would round: dxs to y2's dtype, dxa = dxs * scale to
    xa2's."""

    @staticmethod
    def forward(ctx, y2, xa2, b2, scale):
        out, xs = lora_epilogue(y2, xa2, b2, scale)
        ctx.xa_dtype = xa2.dtype
        ctx.save_for_backward(xs, b2, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, b2, scale = ctx.saved_tensors
        gf = g.float()
        dxs = (gf @ b2.float().T).to(xs.dtype)
        dxa = (dxs.float() * scale).to(ctx.xa_dtype)
        db = (xs.float().T @ gf).to(b2.dtype)
        return g, dxa, db, None


def lora_epilogue_add(y, xa, B, scale):
    """y + scale * (xa @ B) through the epilogue kernel. y [..., d_out],
    xa [..., r] the bottleneck in the compute dtype, B [r, d_out], scale a
    scalar tensor (no gradient flows to it). Returns y's shape and dtype."""
    d_out = y.shape[-1]
    r = xa.shape[-1]
    out = LoRAEpilogue.apply(y.reshape(-1, d_out),
                             xa.reshape(-1, r).contiguous(),
                             B.to(y.dtype).contiguous(),
                             scale.detach().float())
    return out.reshape(y.shape)
