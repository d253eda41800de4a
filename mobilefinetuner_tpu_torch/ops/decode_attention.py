"""Block-paged decode attention: the Hopper kernel, its wrapper and its
plain version (port of mobilefinetuner_tpu/ops/decode_attention.py, the
paged part; the contiguous-cache `decode_attention` is still to port).

Shapes (GPT-2 is the G = 1 case):
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
  paged_decode_attention  CUDA tensors launch `csrc/
                          paged_decode_attention.cu` (or raise); CPU
                          tensors take paged_attention.
                          `paged_decode_attention.launches` counts the
                          kernel launches.
  paged_eligible          the kernel's own shape rule.
"""

from __future__ import annotations

import ctypes

import torch

from mobilefinetuner_tpu_torch.kernels import build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_BLOCK_T = 1024


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
    """The kernel takes D in {64, 128} (and 256 for 2-byte dtypes: a K
    row must fit one warp's 16-byte loads) and pages of at most
    MAX_BLOCK_T tokens (their scores live in shared memory)."""
    return (KV >= 1 and G >= 1 and 1 <= bT <= MAX_BLOCK_T
            and itemsize in (2, 4)
            and (D in (64, 128) or (D == 256 and itemsize == 2)))


def _kernel():
    fn = build.load("paged_decode_attention").mft_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
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
    if not all(t.is_contiguous() for t in ts) \
            or pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_decode_attention takes contiguous operands "
                         "and 16-byte aligned pools")
    ctx = torch.empty(S, KV, G, D, device=dev, dtype=torch.float32)
    code = _kernel()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tbl.data_ptr(),
        ok.data_ptr(), ctx.data_ptr(), S, KV, G, D, NB, L, int(layer), bT,
        M, DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("paged_decode_attention", code)
    paged_decode_attention.launches += 1
    return ctx


paged_decode_attention.launches = 0
