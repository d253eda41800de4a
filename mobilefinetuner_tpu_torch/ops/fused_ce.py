"""Fused cross-entropy head: the Hopper kernels, their wrappers and their
plain versions (port of mobilefinetuner_tpu/ops/fused_ce.py).

The chunked loss (ops/loss.py) projects each sequence chunk's hidden
states onto the [V, H] head. At Gemma's 262,144-entry vocabulary a
chunk's [R, V] logits are hundreds of MB; the kernels below compute
them tile by tile and keep them out of device memory:

  fused_ce_fwd      (lse, gold) [R] f32: logsumexp of each row's logits
                    and its label's logit (TPU `_fwd_kernel`, row 6);
                    bf16 and f16 on the tensor-core kernel of
                    `csrc/fused_ce_fwd_mma.cu`, f32 on the 3xTF32 one of
                    `csrc/fused_ce_fwd_tf32.cu` (H % 8 == 0; fwd_library,
                    fwd_mma_plan, fwd_tf32_plan).
  fused_ce_bwd_dh   dh [R, H] f32 = coef @ W (`_dh_kernel`, row 7); bf16
                    and f16 on the tensor-core kernel of
                    `csrc/fused_ce_dh_mma.cu`, f32 on the 3xTF32 one of
                    `csrc/fused_ce_dh_tf32.cu` (H % 8 == 0; dh_library,
                    dh_mma_plan, dh_tf32_plan).
  fused_ce_bwd_dw   dW [V, H] f32 = coef^T @ h (`_dw_kernel`, row 8);
                    bf16 and f16 on the tensor-core kernel of
                    `csrc/fused_ce_dw_mma.cu`, f32 on the 3xTF32 one of
                    `csrc/fused_ce_dw_tf32.cu`, a thread-block cluster
                    over H parts (H % 8 == 0; dw_library, dw_mma_plan,
                    dw_tf32_plan).
                    coef = dlse * softmax(logits) + dgold * onehot(label),
                    rounded to the storage dtype before the product.
  fused_ce_rows     (lse, gold), differentiable in h and W: a
                    torch.autograd.Function that saves (h, W, labels,
                    lse) only and launches the dW kernel only when W needs
                    a gradient (a frozen head, as in LoRA, runs fwd + dh).
  fused_ce_nll_sum  (sum_nll, valid_count) of one already-shifted chunk,
                    with an optional head adapter.
  head_bottleneck   (xa, bt) of a head-adapter entry {A, B, scale}.

A LoRA adapter on the tied head adds xa @ bt^T to the logits, xa =
scale * (h @ A) [R, r] and bt = B^T [V, r]; its variants fold that delta
into the same tile loop, so the [R, V] delta never exists either:

  fused_ce_fwd_lora     (lse, gold) (`_fwd_kernel_lora`, row 9); bf16
                        and f16 on `csrc/fused_ce_fwd_lora_mma.cu`, f32
                        on the 3xTF32 kernel of
                        `csrc/fused_ce_fwd_lora_tf32.cu` (H % 8 == 0;
                        fwd_lora_library, fwd_lora_mma_plan,
                        fwd_lora_tf32_plan).
  fused_ce_bwd_dh_lora  (dh, dxa [R, r] = coef @ bt) (`_dh_kernel_lora`,
                        row 10); bf16 and f16 on
                        `csrc/fused_ce_dh_lora_mma.cu`, f32 on the 3xTF32
                        kernel of `csrc/fused_ce_dh_lora_tf32.cu` (H % 8
                        == 0; dh_lora_library, dh_lora_mma_plan,
                        dh_lora_tf32_plan).
  fused_ce_bwd_dw_lora  (dW or None, dbt [V, r] = coef^T @ xa)
                        (`_dw_kernel_lora`, row 11); dW only when asked
                        for (the tied embedding is frozen in LoRA). dbt
                        alone in bf16 and f16 on
                        `csrc/fused_ce_dbt_mma.cu`, in f32 on the 3xTF32
                        kernel of `csrc/fused_ce_dbt_tf32.cu` (H % 8 ==
                        0; dbt_library, dbt_mma_plan, dbt_tf32_plan); dW
                        + dbt in every dtype on `csrc/fused_ce.cu`.
  fused_ce_rows_lora    (lse, gold), differentiable in h, W, xa and bt
                        (FusedCERowsLora); the A / B / scale chain
                        around it is plain autograd, as in the JAX
                        package.

Each wrapper has a `launches` count of its calls that launch the kernel
(the forwards' merge passes and the dh and dbt reduce passes are part
of their kernel's launch). CUDA tensors launch the kernel or raise; CPU tensors
take the plain versions (`*_reference`), which compute the same function
tile by tile over the vocabulary in f32 with the same coef rounding, and
run on any device as the kernels' references on the card.

Bounds and design: csrc/fused_ce.cu and the tensor-core sources
csrc/fused_ce_fwd_mma.cu, fused_ce_dh_mma.cu, fused_ce_dw_mma.cu,
fused_ce_fwd_lora_mma.cu, fused_ce_dh_lora_mma.cu, fused_ce_dbt_mma.cu
and the 3xTF32 fused_ce_fwd_tf32.cu, fused_ce_dh_tf32.cu,
fused_ce_dw_tf32.cu, fused_ce_fwd_lora_tf32.cu, fused_ce_dh_lora_tf32.cu
and fused_ce_dbt_tf32.cu. fused_ce.cu's f32 forward (mft_fused_ce_fwd),
head-adapter forward (mft_fused_ce_fwd_lora), dh kernels
(mft_fused_ce_dh, mft_fused_ce_dh_lora), dW (mft_fused_ce_dw) and
dbt-only mode (mft_fused_ce_dw_lora with no dW), which rows 6, 9, 7, 10,
8 and 11 ran in f32 before, stay built as those rows' earlier versions
on no path (chip_smoke.py times them); its dW + dbt mode is row 11's
only kernel when the tied head trains beside a head adapter, in every
dtype.
The kernels take any R and V, H % 8 == 0
within their plans' shared memory, h and W (and xa, bt) in one of f32 /
bf16 / f16; the backward wrappers refuse H + r > MAX_HIDDEN (fused_ce.cu
holds [32, H] (+ [32, r]) f32 accumulators in shared memory) but in row
11's dbt-only mode; the rank is 1..MAX_RANK, taken as it is (the TPU's
padding of r to 128 lanes is a layout trick of that chip).

Eligibility: `fused_ce_eligible(R, V, H, r, dtype, head_grad)` says,
from shapes, dtype, rank and whether the head weight trains, whether
every kernel a loss chunk's forward and backward launch takes it; the
chunked loss (ops/loss.py) sends a chunk for which it is False to its
plain body before any launch (a Gemma-3 hidden size of 2,304 or 2,560
does not fit these layouts), as the JAX package's `_use_fused_ce` checks
`fused_ce_eligible` / `fused_ce_lora_eligible`. The wrappers themselves
keep raising on what their kernels refuse.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mobilefinetuner_tpu_torch.kernels import build, graphs

BLOCK_V = 4096          # the plain versions' vocab tile
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROW_TILE = 32           # csrc/fused_ce.cu FWD_TM: rows of a forward / dh CTA
VOCAB_TILE = 64         # FWD_TN: vocab columns of a forward / dh tile
# shared memory of the dh / dW kernels: 9,408 staging floats + [32, H]
# (+ [32, r] with a head adapter) f32 accumulators, within the card's
# 232,448 bytes a block: H + r <= MAX_HIDDEN
MAX_HIDDEN = (232448 // 4 - 9408) // 32
MAX_RANK = 128          # csrc/fused_ce.cu MAX_RANK, the JAX LORA_R_PAD
SMEM_MAX = 232448       # shared memory a block may use on the card
MMA_VOCAB_TILE = 32     # csrc/fused_ce_dh_mma.cu VT: vocab of a W tile
MMA_HP_MAX = 320        # HP_MAX: dh columns of a CTA (its accumulators)
DH_LORA_HP_MAX = 640    # csrc/fused_ce_dh_lora_mma.cu HP_MAX: 2 x 320
DW_VOCAB_TILE = 32      # csrc/fused_ce_dw_mma.cu VT: vocab rows of a tile
DW_HP_MAX = 640         # HP_MAX: dW columns of a CTA, 8 warps x WC_MAX
DW_ROW_CHUNKS = (128, 64, 32)   # rows of h a CTA holds (its RC)
DW_TF32_VOCAB_GROUPS = 4  # csrc/fused_ce_dw_tf32.cu VG: 16-row vocab groups
DW_TF32_HP_MAX = 320      # HP_MAX: columns of an H part, 2 warps x 20 n-tiles
DW_TF32_PARTS = (1, 2, 4, 8)    # H parts (CTAs of a cluster), fewest first
DW_TF32_ROWS_WHOLE = 128  # ROWS_WHOLE: rows of h a CTA holds for its life
                          # (64 < R <= 128); other R in 64-row chunks
DW_TF32_STAGES = 3        # STAGES: W chunks in the ring
FWD_MMA_KREGS = 40      # csrc/fused_ce_fwd_mma.cu KR: h's k-steps a lane
DBT_GROUP = 4           # csrc/fused_ce_dbt_mma.cu GT: W tiles a coef group
TF32_VOCAB_TILE = 16    # csrc/fused_ce_dh_tf32.cu VT: vocab of a W tile
TF32_WARPS = 8          # WG: warps of a row group
TF32_COEF_LD = 24       # LDC: coef row stride, floats
TF32_NT = (2, 5, 6, 12, 28)     # dh n-tiles a warp, the instantiated
                                # bounds (6 at most with 32-row tiles)
TF32_W_CHUNK = 32       # csrc/fused_ce_dw_tf32.cu KC: columns of a W chunk
LOGITS_VOCAB_TILE = 128  # csrc/fused_ce_fwd_tf32.cu, fused_ce_dbt_tf32.cu
                         # VT: vocab rows of a tile, 16 a warp
LOGITS_WARPS = 8         # WARPS
# (rows of a CTA, columns of a W chunk, W chunks in a warp's ring) of
# rows 6 and 11's f32 launch, in order of preference: the first whose
# shared memory fits is taken (kernel_variants.py --f32_ce_plans times
# others)
LOGITS_PLANS = ((64, 32, 2), (32, 64, 2), (16, 64, 2), (16, 64, 1))


# ------------------------------------------------------ plain versions ------

def _tile_coef(logits, cols, labels, lse, dlse, dgold, dtype):
    """coef of one [R, bv] logits tile, rounded to `dtype`, back in f32."""
    p = torch.exp(logits - lse[:, None])
    hit = cols[None, :] == labels[:, None]
    coef = dlse[:, None] * p + torch.where(hit, dgold[:, None], 0.0)
    return coef.to(dtype).float()


def _tiles(V: int, block_v: int):
    for v0 in range(0, V, block_v):
        yield v0, min(V, v0 + block_v)


def _tile_logits(hf, w, xa, bt, v0: int, v1: int):
    """f32 logits of the vocab tile [v0, v1): h @ W^T, plus xa @ bt^T with
    a head adapter."""
    logits = hf @ w[v0:v1].float().T
    if xa is not None:
        logits = logits + xa.float() @ bt[v0:v1].float().T
    return logits


def fused_ce_fwd_lora_reference(h, w, xa, bt, labels,
                                block_v: int = BLOCK_V
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 9's plain version: (lse, gold) [R] f32 of h @ W^T + xa @ bt^T
    by an online logsumexp over vocab tiles (xa = bt = None: row 6)."""
    hf = h.float()
    R = h.shape[0]
    lab = labels.long()
    m = torch.full((R,), -math.inf, device=h.device)
    s = torch.zeros(R, device=h.device)
    gold = torch.zeros(R, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        logits = _tile_logits(hf, w, xa, bt, v0, v1)
        cols = torch.arange(v0, v1, device=h.device)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
        gold = gold + torch.where(cols[None, :] == lab[:, None], logits,
                                  0.0).sum(-1)
    return m + torch.log(s), gold


def fused_ce_dh_lora_reference(h, w, xa, bt, labels, lse, dlse, dgold,
                               block_v: int = BLOCK_V):
    """Row 10's plain version: (dh [R, H], dxa [R, r]) f32, summed over
    vocab tiles of coef @ W_tile and coef @ bt_tile, coef rounded to W's
    dtype (xa = bt = None: row 7, dxa None)."""
    hf = h.float()
    lab = labels.long()
    dh = torch.zeros(h.shape, device=h.device)
    dxa = None if xa is None else torch.zeros(xa.shape, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        wt = w[v0:v1].float()
        coef = _tile_coef(_tile_logits(hf, w, xa, bt, v0, v1),
                          torch.arange(v0, v1, device=h.device), lab, lse,
                          dlse, dgold, w.dtype)
        dh += coef @ wt
        if xa is not None:
            dxa += coef @ bt[v0:v1].float()
    return dh, dxa


def fused_ce_dw_lora_reference(h, w, xa, bt, labels, lse, dlse, dgold,
                               want_dw: bool = True,
                               block_v: int = BLOCK_V):
    """Row 11's plain version: (dW [V, H] or None unless want_dw,
    dbt [V, r]) f32, one vocab tile at a time: coef_tile^T @ h and
    coef_tile^T @ xa, coef rounded to h's dtype (xa = bt = None: row 8,
    dbt None)."""
    hf = h.float()
    lab = labels.long()
    dw = torch.empty(w.shape, device=h.device) if want_dw else None
    dbt = None if xa is None else torch.empty(bt.shape, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        coef = _tile_coef(_tile_logits(hf, w, xa, bt, v0, v1),
                          torch.arange(v0, v1, device=h.device), lab, lse,
                          dlse, dgold, h.dtype)
        if want_dw:
            dw[v0:v1] = coef.T @ hf
        if xa is not None:
            dbt[v0:v1] = coef.T @ xa.float()
    return dw, dbt


def fused_ce_fwd_reference(h, w, labels, block_v: int = BLOCK_V
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) [R] f32 by an online logsumexp over vocab tiles."""
    return fused_ce_fwd_lora_reference(h, w, None, None, labels, block_v)


def fused_ce_dh_reference(h, w, labels, lse, dlse, dgold,
                          block_v: int = BLOCK_V) -> torch.Tensor:
    """dh [R, H] f32 = sum over vocab tiles of coef @ W_tile."""
    return fused_ce_dh_lora_reference(h, w, None, None, labels, lse, dlse,
                                      dgold, block_v)[0]


def fused_ce_dw_reference(h, w, labels, lse, dlse, dgold,
                          block_v: int = BLOCK_V) -> torch.Tensor:
    """dW [V, H] f32, one vocab tile at a time: coef_tile^T @ h."""
    return fused_ce_dw_lora_reference(h, w, None, None, labels, lse, dlse,
                                      dgold, True, block_v)[0]


# ------------------------------------------------------------ wrappers ------

def _fn(sym: str, n_ptrs: int, n_ints: int, lib: str = "fused_ce"):
    """The ctypes entry `sym` of csrc/<lib>.cu: n_ptrs pointers, n_ints
    ints (shapes, slabs, dtype), the stream."""
    fn = getattr(build.load(lib), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, ops, f32s, backward: bool):
    """The kernels' rule for CUDA tensors: h [R, H], W [V, H] (and xa,
    bt) on one CUDA device in one dtype of DTYPE_CODES, contiguous; the
    row vectors contiguous f32; H + r <= MAX_HIDDEN for the backward
    kernels."""
    h = ops[0]
    for t in (*ops, *f32s):
        if not t.is_cuda or t.device != h.device:
            raise ValueError(f"{what}: tensors on {t.device} and {h.device};"
                             f" the kernel takes one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if h.dtype not in DTYPE_CODES or any(t.dtype != h.dtype for t in ops):
        raise ValueError(f"{what} kernel takes h, W (xa, bt) in one dtype of"
                         f" {sorted(map(str, DTYPE_CODES))}, got "
                         f"{[str(t.dtype) for t in ops]}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{what} kernel takes f32 lse, dlse and dgold")
    cols = h.shape[1] + (ops[2].shape[1] if len(ops) == 4 else 0)
    if backward and cols > MAX_HIDDEN:
        raise ValueError(f"{what} kernel takes H + r <= {MAX_HIDDEN}, got "
                         f"{cols}")


def _check_shapes(what, h, w, labels, xa=None, bt=None):
    R, H = h.shape
    if w.ndim != 2 or w.shape[1] != H or labels.shape != (R,):
        raise ValueError(f"{what}: h {tuple(h.shape)}, W {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)}")
    if xa is not None:
        r = xa.shape[-1]
        if xa.shape != (R, r) or bt.shape != (w.shape[0], r) \
                or not 0 < r <= MAX_RANK:
            raise ValueError(f"{what}: xa {tuple(xa.shape)} and bt "
                             f"{tuple(bt.shape)} must be [R, r] and [V, r], "
                             f"1 <= r <= {MAX_RANK}")


def _slabs(R: int, V: int, device, ctas_per_sm: int) -> Tuple[int, int]:
    """(n_slabs, vocab tiles a slab): enough (row tile, slab) CTAs for
    `ctas_per_sm` a multiprocessor, slabs of whole 64-column tiles."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_vt = -(-V // VOCAB_TILE)
    row_tiles = -(-R // ROW_TILE)
    n_slabs = min(n_vt, max(1, -(-ctas_per_sm * n_sm // row_tiles)))
    per_slab = -(-n_vt // n_slabs)
    return -(-n_vt // per_slab), per_slab


def _route(what: str, mma: Tuple[str, str], f32: Tuple[str, str],
           dtype: torch.dtype) -> Tuple[str, str]:
    """(source, C symbol) of a kernel for `dtype`: bf16 and f16 run on the
    tensor-core kernel `mma`, f32 on `f32` (a 3xTF32 one); no fallback
    from one to the other."""
    if dtype in (torch.bfloat16, torch.float16):
        return mma
    if dtype == torch.float32:
        return f32
    raise ValueError(f"{what} kernel takes its operands in one dtype of "
                     f"{sorted(map(str, DTYPE_CODES))}, got {dtype}")


def fwd_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 6's kernel for `dtype` (_route)."""
    return _route("fused_ce_fwd",
                  ("fused_ce_fwd_mma", "mft_fused_ce_fwd_mma"),
                  ("fused_ce_fwd_tf32", "mft_fused_ce_fwd_tf32"), dtype)


def dh_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 7's kernel for `dtype` (_route)."""
    return _route("fused_ce_bwd_dh",
                  ("fused_ce_dh_mma", "mft_fused_ce_dh_mma"),
                  ("fused_ce_dh_tf32", "mft_fused_ce_dh_tf32"), dtype)


def dw_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 8's kernel for `dtype` (_route)."""
    return _route("fused_ce_bwd_dw",
                  ("fused_ce_dw_mma", "mft_fused_ce_dw_mma"),
                  ("fused_ce_dw_tf32", "mft_fused_ce_dw_tf32"), dtype)


def dh_lora_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 10's kernel for `dtype` (_route)."""
    return _route("fused_ce_bwd_dh_lora",
                  ("fused_ce_dh_lora_mma", "mft_fused_ce_dh_lora_mma"),
                  ("fused_ce_dh_lora_tf32", "mft_fused_ce_dh_lora_tf32"),
                  dtype)


def fwd_lora_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 9's kernel for `dtype` (_route)."""
    return _route("fused_ce_fwd_lora",
                  ("fused_ce_fwd_lora_mma", "mft_fused_ce_fwd_lora_mma"),
                  ("fused_ce_fwd_lora_tf32", "mft_fused_ce_fwd_lora_tf32"),
                  dtype)


def dbt_library(dtype: torch.dtype) -> Tuple[str, str]:
    """Row 11's dbt-only kernel for `dtype` (_route); its dW + dbt mode
    is fused_ce.cu's mft_fused_ce_dw_lora in every dtype."""
    return _route("fused_ce_bwd_dw_lora",
                  ("fused_ce_dbt_mma", "mft_fused_ce_dbt_mma"),
                  ("fused_ce_dbt_tf32", "mft_fused_ce_dbt_tf32"), dtype)


def _require_h8(what: str, H: int) -> None:
    if H <= 0 or H % 8:
        raise ValueError(f"{what} tensor-core kernel takes H % 8 == 0 "
                         f"(16-byte rows), got H={H}")


def _slab_plan(plan: dict, ctas_per_slab: int, V: int, n_sm: int,
               vt: int = MMA_VOCAB_TILE) -> dict:
    """`plan` with the vocabulary cut into `n_slabs` slabs of
    `tiles_per_slab` `vt`-column tiles: the most slabs that keep the grid
    one wave of `n_sm` CTAs (at least one), each slab `ctas_per_slab`
    CTAs, and the grid (ctas_per_slab, n_slabs)."""
    n_vt = -(-V // vt)
    n_slabs = min(n_vt, max(1, n_sm // ctas_per_slab))
    tiles_per_slab = -(-n_vt // n_slabs)
    n_slabs = -(-n_vt // tiles_per_slab)
    return dict(plan, n_slabs=n_slabs, tiles_per_slab=tiles_per_slab,
                grid=(ctas_per_slab, n_slabs))


# ---- shared-memory picks: (the first layout of a kernel's list of
# preference whose shared memory fits the card, its bytes), or None; no
# check of H or r and no exception, so that fused_ce_eligible can ask them

STAGED_LAYOUTS = ((4, 3), (4, 2), (2, 3), (2, 2), (2, 1))  # (row groups,
# W buffers) of the 16-bit kernels, in order of preference
TF32_LAYOUTS = ((2, 3), (2, 2), (1, 3), (1, 2), (1, 1))     # rows 7, 10


def _first_fit(layouts, smem):
    for layout in layouts:
        nbytes = smem(*layout)
        if nbytes is not None and nbytes <= SMEM_MAX:
            return layout, nbytes
    return None


def _fwd_mma_pick(H: int, elem_bytes: int):
    """Row 6's 16-bit layout (fwd_mma_plan)."""
    h16 = -(-H // 16) * 16
    return _first_fit(STAGED_LAYOUTS, lambda rg, st: (
        (16 * rg + st * MMA_VOCAB_TILE) * (h16 + 8) * elem_bytes))


def _dh_mma_pick(H: int, elem_bytes: int):
    """Row 7's 16-bit layout (dh_mma_plan)."""
    n_parts = -(-H // MMA_HP_MAX)
    hp = -(-(-(-H // n_parts)) // 16) * 16
    ld = -(-H // 16) * 16 + 8
    return _first_fit(STAGED_LAYOUTS, lambda rg, st: max(
        (16 * rg + st * MMA_VOCAB_TILE) * ld * elem_bytes, 16 * rg * hp * 4))


def _dh_lora_mma_pick(H: int, r: int, elem_bytes: int):
    """Row 10's 16-bit layout (dh_lora_mma_plan)."""
    ld = -(-H // 16) * 16 + 8
    r16 = -(-r // 16) * 16
    return _first_fit(STAGED_LAYOUTS, lambda rg, st: (
        2 * rg * r16 * 64 + ((16 * rg + st * MMA_VOCAB_TILE) * (ld + r16 + 8)
                             + 16 * rg * (MMA_VOCAB_TILE + 8)) * elem_bytes))


def _lora_logits_pick(H: int, r: int, elem_bytes: int, coef_tile: bool):
    """Rows 9 and 11's (dbt-only) 16-bit layout (_lora_logits_plan)."""
    ld = -(-H // 16) * 16 + 8
    r16 = -(-r // 16) * 16
    return _first_fit(STAGED_LAYOUTS, lambda rg, st: (
        ((16 * rg + st * MMA_VOCAB_TILE) * (ld + r16 + 8)
         + coef_tile * 16 * rg * (DBT_GROUP * MMA_VOCAB_TILE + 8))
        * elem_bytes))


def _tf32_nt(hx: int, row_groups: int) -> int:
    return -(-(hx // 8) // (TF32_WARPS * row_groups))


def _tf32_pick(hx: int):
    """Rows 7 and 10's f32 layout over the widened row hx (_tf32_plan):
    a layout whose n-tiles a warp have no instantiated bound is passed
    over."""
    def smem(rg, st):
        bounds = [b for b in TF32_NT if b >= _tf32_nt(hx, rg)]
        if not bounds or (rg == 2 and bounds[0] > 6):
            return None
        return ((16 * rg + st * TF32_VOCAB_TILE) * (hx + 4)
                + 2 * 16 * rg * TF32_COEF_LD) * 4 \
            + rg * TF32_WARPS * 2 * 32 * 16
    return _first_fit(TF32_LAYOUTS, smem)


def _logits_tf32_pick(hx: int):
    """Rows 6, 9 and 11's (dbt-only) f32 layout over the widened row hx
    (_logits_tf32_plan)."""
    return _first_fit(LOGITS_PLANS, lambda rt, kc, st: (
        (rt * (hx + 4) + st * LOGITS_VOCAB_TILE * (kc + 4)) * 4))


def _dw_mma_smem(H: int, rc: int, elem_bytes: int) -> int:
    ld = -(-H // 16) * 16 + 8
    return ((rc + DW_VOCAB_TILE) * ld + DW_VOCAB_TILE * (rc + 8)) \
        * elem_bytes + rc * 16


def _dw_mma_fits(H: int, elem_bytes: int) -> list:
    """The row chunks of DW_ROW_CHUNKS whose row 8 16-bit layout fits
    (dw_mma_plan)."""
    return [rc for rc in DW_ROW_CHUNKS
            if _dw_mma_smem(H, rc, elem_bytes) <= SMEM_MAX]


def _dw_tf32_smem(vocab_groups: int, rc: int, hp: int) -> int:
    return (rc * (hp + 4) + 16 * vocab_groups * rc + rc * 4
            + DW_TF32_STAGES * 16 * vocab_groups * (TF32_W_CHUNK + 4)) * 4


def _dw_tf32_pick(H: int):
    """Row 8's f32 layout (dw_tf32_plan): ((n_parts, hp), bytes) of the
    fewest H parts of DW_TF32_PARTS whose columns a part (hp, a multiple
    of 16) are at most DW_TF32_HP_MAX and whose shared memory at
    DW_TF32_ROWS_WHOLE rows fits."""
    for n_parts in DW_TF32_PARTS:
        hp = -(-(-(-H // n_parts)) // 16) * 16
        if hp > DW_TF32_HP_MAX or hp * (n_parts - 1) >= H:
            continue
        nbytes = _dw_tf32_smem(DW_TF32_VOCAB_GROUPS, DW_TF32_ROWS_WHOLE, hp)
        if nbytes <= SMEM_MAX:
            return (n_parts, hp), nbytes
    return None


def fwd_mma_plan(R: int, V: int, H: int, n_sm: int,
                 elem_bytes: int = 2) -> dict:
    """The tensor-core forward's launch, as csrc/fused_ce_fwd_mma.cu takes
    it: rows in tiles of 16 x `row_groups` with a ring of `stages` W
    tiles, the first of (4, 3), (4, 2), (2, 3), (2, 2), (2, 1) whose
    shared memory (h's row tile and the ring, [., H16 + 8] in the operand
    dtype) fits; up to FWD_MMA_KREGS k-steps (H <= 640) each lane also
    holds its rows' A fragments of h in registers (`h_in_regs`), past
    that it reads them from shared memory for every tile. The
    vocabulary in `n_slabs` slabs of `tiles_per_slab` 32-column tiles,
    one CTA per (row tile, slab), the slab count the most that keeps the
    grid one wave of `n_sm` CTAs (at least one slab)."""
    _require_h8("fused_ce_fwd", H)
    h16 = -(-H // 16) * 16
    pick = _fwd_mma_pick(H, elem_bytes)
    if pick is None:
        raise ValueError(f"fused_ce_fwd tensor-core kernel: H={H} does not "
                         f"fit shared memory")
    (row_groups, stages), smem = pick
    row_tiles = -(-R // (16 * row_groups))
    return _slab_plan({"row_groups": row_groups, "stages": stages,
                       "h_in_regs": h16 <= 16 * FWD_MMA_KREGS,
                       "smem_bytes": smem}, row_tiles, V, n_sm)


def dh_mma_plan(R: int, V: int, H: int, n_sm: int,
                elem_bytes: int = 2) -> dict:
    """The tensor-core dh kernel's launch, as csrc/fused_ce_dh_mma.cu
    takes it: H cut into `n_parts` parts of `hp` columns (a multiple of
    16, at most MMA_HP_MAX: the accumulators of a warp); rows in tiles of
    16 x `row_groups`, with a ring of `stages` W tiles, the first of
    (4, 3), (4, 2), (2, 3), (2, 2), (2, 1) whose shared memory fits; the
    vocabulary in `n_slabs` slabs of `tiles_per_slab` 32-column tiles,
    one CTA per (row tile, H part, slab), the slab count the most that
    keeps the grid one wave of `n_sm` CTAs (at least one slab)."""
    _require_h8("fused_ce_bwd_dh", H)
    n_parts = -(-H // MMA_HP_MAX)
    hp = -(-(-(-H // n_parts)) // 16) * 16
    pick = _dh_mma_pick(H, elem_bytes)
    if pick is None:
        raise ValueError(f"fused_ce_bwd_dh tensor-core kernel: H={H} does "
                         f"not fit shared memory")
    (row_groups, stages), smem = pick
    row_tiles = -(-R // (16 * row_groups))
    return _slab_plan({"row_groups": row_groups, "stages": stages,
                       "hp": hp, "n_parts": n_parts, "smem_bytes": smem},
                      row_tiles * n_parts, V, n_sm)


def dh_lora_mma_plan(R: int, V: int, H: int, r: int, n_sm: int,
                     elem_bytes: int = 2) -> dict:
    """Row 10's launch, as csrc/fused_ce_dh_lora_mma.cu takes it: row 7's
    layout (dh_mma_plan) with parts of up to DH_LORA_HP_MAX columns (a
    multiple of 32: the two warps of a row group take half each), since
    a CTA forms each logits tile once for all of its part; the shared
    memory also holds xa's row tile and a bt tile a W buffer ([., r16 +
    8], the rank rounded up to 16), the coef tile [16 row_groups, 40] and
    the dxa accumulators of the 2 x row_groups warps (r16 x 64 bytes
    each): a large rank takes fewer buffers or row groups, never a
    narrower H part."""
    _require_h8("fused_ce_bwd_dh_lora", H)
    _require_rank("fused_ce_bwd_dh_lora", r)
    n_parts = -(-H // DH_LORA_HP_MAX)
    hp = -(-(-(-H // n_parts)) // 32) * 32
    pick = _dh_lora_mma_pick(H, r, elem_bytes)
    if pick is None:
        raise ValueError(f"fused_ce_bwd_dh_lora tensor-core kernel: H={H},"
                         f" r={r} does not fit shared memory")
    (row_groups, stages), smem = pick
    row_tiles = -(-R // (16 * row_groups))
    return _slab_plan({"row_groups": row_groups, "stages": stages,
                       "hp": hp, "n_parts": n_parts, "smem_bytes": smem},
                      row_tiles * n_parts, V, n_sm)


def _tf32_plan(what: str, R: int, V: int, H: int, r: int,
               n_sm: int) -> dict:
    """Rows 7 and 10's f32 launch, as csrc/fused_ce_dh_tf32.cu and
    csrc/fused_ce_dh_lora_tf32.cu take it: the row widened to hx = H (row
    7) or H + r rounded up to 8 (row 10: [h | xa], [W | bt]); rows in
    tiles of 16 x `row_groups` with a ring of `stages` W tiles of
    TF32_VOCAB_TILE rows, the first of (2, 3), (2, 2), (1, 3), (1, 2),
    (1, 1) whose shared memory (the h tile and the ring [., hx + 4], the
    logits partials and the split coef tile, all f32) fits and whose
    `nt` = ceil(hx / 8 / (8 row_groups)) n-tiles of 8 output columns a
    warp (for every row of the tile) has an instantiated bound
    (`nt_bound` of TF32_NT, 6 at most with 32-row tiles); the vocabulary
    in `n_slabs` slabs of `tiles_per_slab` 16-row tiles, one CTA per
    (row tile, slab), the grid one wave of `n_sm` CTAs."""
    _require_h8(what, H)
    hx = H + (-(-r // 8) * 8 if r else 0)
    pick = _tf32_pick(hx)
    if pick is None:
        raise ValueError(f"{what} 3xTF32 kernel: H={H}"
                         + (f", r={r}" if r else "")
                         + " does not fit shared memory")
    (row_groups, stages), smem = pick
    nt = _tf32_nt(hx, row_groups)
    bounds = [b for b in TF32_NT if b >= nt]
    row_tiles = -(-R // (16 * row_groups))
    return _slab_plan({"row_groups": row_groups, "stages": stages,
                       "hx": hx, "nt": nt, "nt_bound": bounds[0],
                       "smem_bytes": smem}, row_tiles, V, n_sm,
                      TF32_VOCAB_TILE)


def dh_tf32_plan(R: int, V: int, H: int, n_sm: int) -> dict:
    """Row 7's f32 launch (_tf32_plan): at the Gemma chunk (R 128, H 640)
    32-row tiles, three W buffers, 5 n-tiles a warp."""
    return _tf32_plan("fused_ce_bwd_dh", R, V, H, 0, n_sm)


def dh_lora_tf32_plan(R: int, V: int, H: int, r: int, n_sm: int) -> dict:
    """Row 10's f32 launch (_tf32_plan with the rank's columns)."""
    _require_rank("fused_ce_bwd_dh_lora", r)
    return _tf32_plan("fused_ce_bwd_dh_lora", R, V, H, r, n_sm)


def _logits_tf32_plan(what: str, R: int, V: int, H: int, r: int,
                      n_sm: int) -> dict:
    """Rows 6 and 11's (dbt-only) f32 launch, as csrc/fused_ce_fwd_tf32.cu
    and csrc/fused_ce_dbt_tf32.cu take it: the row widened to hx = H (row
    6) or H + r rounded up to 8 (row 11: [h | xa], [W | bt]); rows in
    tiles of `row_tile`, the h tile [row_tile, hx + 4] f32 in shared
    memory with a ring of `stages` W chunks [LOGITS_VOCAB_TILE, `chunk` +
    4] f32: the first of LOGITS_PLANS that fits; the vocabulary in
    `n_slabs` slabs of `tiles_per_slab` 128-row tiles, one CTA per (row
    tile, slab), the grid one wave of `n_sm` CTAs. `row_tiles` is the
    count of row tiles (row 11's partials)."""
    _require_h8(what, H)
    hx = H + (-(-r // 8) * 8 if r else 0)
    pick = _logits_tf32_pick(hx)
    if pick is None:
        raise ValueError(f"{what} 3xTF32 kernel: H={H}"
                         + (f", r={r}" if r else "")
                         + " does not fit shared memory")
    (row_tile, chunk, stages), smem = pick
    row_tiles = -(-R // row_tile)
    return _slab_plan({"row_tile": row_tile, "chunk": chunk,
                       "stages": stages, "hx": hx, "row_tiles": row_tiles,
                       "smem_bytes": smem},
                      row_tiles, V, n_sm, LOGITS_VOCAB_TILE)


def fwd_tf32_plan(R: int, V: int, H: int, n_sm: int) -> dict:
    """Row 6's f32 launch (_logits_tf32_plan)."""
    return _logits_tf32_plan("fused_ce_fwd", R, V, H, 0, n_sm)


def dbt_tf32_plan(R: int, V: int, H: int, r: int, n_sm: int) -> dict:
    """Row 11's dbt-only f32 launch (_logits_tf32_plan with the rank's
    columns)."""
    _require_rank("fused_ce_bwd_dw_lora", r)
    return _logits_tf32_plan("fused_ce_bwd_dw_lora", R, V, H, r, n_sm)


def fwd_lora_tf32_plan(R: int, V: int, H: int, r: int, n_sm: int) -> dict:
    """Row 9's f32 launch (_logits_tf32_plan with the rank's columns): at
    the Gemma chunk (R 128, H 640, r 8) row 6's 64-row tiles and 32-column
    chunks over the widened row of 648."""
    _require_rank("fused_ce_fwd_lora", r)
    return _logits_tf32_plan("fused_ce_fwd_lora", R, V, H, r, n_sm)


def _require_rank(what: str, r: int) -> None:
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"{what}: rank {r} outside [1, {MAX_RANK}]")


def _lora_logits_plan(what: str, R: int, V: int, H: int, r: int,
                      n_sm: int, elem_bytes: int, coef_tile: bool) -> dict:
    """Rows 9 and 11's (dbt-only) launch: row 6's layout (fwd_mma_plan)
    with xa's row tile and a bt tile a W buffer in shared memory ([.,
    r16 + 8], the rank rounded up to 16) and, for row 11, the coef tile
    of DBT_GROUP W tiles [16 row_groups, 136]: a large rank takes fewer
    buffers or row groups, never a narrower tile. Up to H 640 each lane
    holds h's A fragments (`h_in_regs`) and, at r16 = 16, xa's
    (`xa_in_regs`)."""
    _require_h8(what, H)
    _require_rank(what, r)
    ld = -(-H // 16) * 16 + 8
    r16 = -(-r // 16) * 16
    pick = _lora_logits_pick(H, r, elem_bytes, coef_tile)
    if pick is None:
        raise ValueError(f"{what} tensor-core kernel: H={H}, r={r} does "
                         f"not fit shared memory")
    (row_groups, stages), smem = pick
    h_in_regs = ld - 8 <= 16 * FWD_MMA_KREGS
    row_tiles = -(-R // (16 * row_groups))
    return _slab_plan({"row_groups": row_groups, "stages": stages,
                       "h_in_regs": h_in_regs,
                       "xa_in_regs": h_in_regs and r16 == 16,
                       "row_tiles": row_tiles, "smem_bytes": smem},
                      row_tiles, V, n_sm)


def fwd_lora_mma_plan(R: int, V: int, H: int, r: int, n_sm: int,
                      elem_bytes: int = 2) -> dict:
    """Row 9's launch, as csrc/fused_ce_fwd_lora_mma.cu takes it
    (_lora_logits_plan): one CTA per (row tile, vocab slab), a (m, s,
    gold) partial per (slab, row) merged in slab order."""
    return _lora_logits_plan("fused_ce_fwd_lora", R, V, H, r, n_sm,
                             elem_bytes, coef_tile=False)


def dbt_mma_plan(R: int, V: int, H: int, r: int, n_sm: int,
                 elem_bytes: int = 2) -> dict:
    """Row 11's dbt-only launch, as csrc/fused_ce_dbt_mma.cu takes it
    (_lora_logits_plan with the coef tile): one CTA per (row tile, vocab
    slab), a [V, r] f32 partial per row tile (`row_tiles`) summed in order
    by a reduce pass when there is more than one."""
    return _lora_logits_plan("fused_ce_bwd_dw_lora", R, V, H, r, n_sm,
                             elem_bytes, coef_tile=True)


def dw_mma_plan(R: int, V: int, H: int, n_sm: int,
                elem_bytes: int = 2) -> dict:
    """The tensor-core dW kernel's launch, as csrc/fused_ce_dw_mma.cu
    takes it: H cut into `n_parts` parts of `hp` columns (a multiple of
    128, at most DW_HP_MAX: eight warps' accumulators), each part of a
    32-row vocab tile one item; h held in chunks of `row_chunk` rows (of
    DW_ROW_CHUNKS, the smallest that holds all R rows, else the largest
    whose shared memory fits; `n_chunks` > 1 reloads h every item);
    `n_ctas` persistent CTAs, one an SM, walking the items with a grid
    stride."""
    _require_h8("fused_ce_bwd_dw", H)
    n_parts = -(-H // DW_HP_MAX)
    hp = -(-(-(-H // n_parts)) // 128) * 128
    fits = _dw_mma_fits(H, elem_bytes)
    if not fits:
        raise ValueError(f"fused_ce_bwd_dw tensor-core kernel: H={H} does "
                         f"not fit shared memory")
    rc = min((c for c in fits if c >= R), default=max(fits))
    n_items = -(-V // DW_VOCAB_TILE) * n_parts
    return {"row_chunk": rc, "n_chunks": -(-R // rc), "hp": hp,
            "n_parts": n_parts, "n_items": n_items,
            "n_ctas": min(n_sm, n_items),
            "smem_bytes": _dw_mma_smem(H, rc, elem_bytes)}


def dw_tf32_plan(R: int, V: int, H: int, n_sm: int) -> dict:
    """Row 8's f32 launch, as csrc/fused_ce_dw_tf32.cu takes it: H cut
    into `n_parts` parts of `hp` columns (_dw_tf32_pick: 2 x 320 at the
    Gemma chunk), one CTA of a thread-block cluster each, holding h's
    part for all R rows (`row_chunk` DW_TF32_ROWS_WHOLE for 64 < R <=
    128; else `n_chunks` chunks of 64 rows, reloaded for every tile when
    there are more than one); the vocabulary in tiles of 16
    `vocab_groups` rows that `n_clusters` clusters walk with a grid
    stride (at most one a pair of multiprocessors, never more than the
    tiles; the launch cuts them to what the card holds at once), the
    grid (n_parts, n_clusters)."""
    _require_h8("fused_ce_bwd_dw", H)
    pick = _dw_tf32_pick(H)
    if pick is None:
        raise ValueError(f"fused_ce_bwd_dw 3xTF32 kernel: H={H} does not "
                         f"fit {DW_TF32_PARTS[-1]} parts of "
                         f"{DW_TF32_HP_MAX} columns")
    (n_parts, hp), _ = pick
    rc = DW_TF32_ROWS_WHOLE if 64 < R <= DW_TF32_ROWS_WHOLE else 64
    vg = DW_TF32_VOCAB_GROUPS
    n_clusters = min(-(-V // (16 * vg)), max(1, n_sm // n_parts))
    return {"vocab_groups": vg, "row_chunk": rc, "n_chunks": -(-R // rc),
            "hp": hp, "n_parts": n_parts, "n_clusters": n_clusters,
            "grid": (n_parts, n_clusters),
            "smem_bytes": _dw_tf32_smem(vg, rc, hp)}


def fused_ce_eligible(R: int, V: int, H: int, r: int = 0,
                      dtype: torch.dtype = torch.float32,
                      head_grad: bool = False) -> bool:
    """Whether every kernel that one loss chunk of R rows against a [V, H]
    head launches, forward and autograd backward, takes that chunk on the
    card: rows 6 and 7, with row 8 when the head weight needs a gradient
    (`head_grad`); with a head adapter of rank r, rows 9 and 10 and row 11
    (its dW + dbt mode when `head_grad`, else dbt only). Each kernel of
    `dtype`'s route must plan (the `_mma` layouts for bf16 / f16, the
    3xTF32 ones for f32, fused_ce.cu for row 11's dW + dbt mode: the
    plans' shared-memory picks,
    H % 8 == 0, 1 <= r <= MAX_RANK) and pass its wrapper's check (H + r <=
    MAX_HIDDEN for the backward wrappers but row 11's dbt-only mode).
    Decided from shapes, dtype, rank and head_grad alone: no kernel is
    called and no error caught. ops/loss.py sends a chunk for which it is
    False to its plain body, as the JAX package's `_use_fused_ce` sends
    an ineligible chunk to the XLA one."""
    if dtype not in DTYPE_CODES or R <= 0 or V <= 0 or H <= 0 or H % 8:
        return False
    if r and not 0 < r <= MAX_RANK:
        return False
    if H + r > MAX_HIDDEN:                 # the dh wrappers' check
        return False
    hx = H + -(-r // 8) * 8
    if dtype == torch.float32:
        # rows 6 / 9 and 11 (dbt only) on the logits layout, rows 7 / 10
        # on theirs, row 8 on its H parts; row 11's dW + dbt mode on
        # fused_ce.cu, whose only limit is the wrappers' MAX_HIDDEN
        return _logits_tf32_pick(hx) is not None \
            and _tf32_pick(hx) is not None \
            and (not head_grad or r > 0 or _dw_tf32_pick(H) is not None)
    eb = dtype.itemsize
    if not r:
        return _fwd_mma_pick(H, eb) is not None \
            and _dh_mma_pick(H, eb) is not None \
            and (not head_grad or bool(_dw_mma_fits(H, eb)))
    # row 11's dW + dbt mode runs fused_ce.cu in every dtype
    return _lora_logits_pick(H, r, eb, False) is not None \
        and _dh_lora_mma_pick(H, r, eb) is not None \
        and (head_grad or _lora_logits_pick(H, r, eb, True) is not None)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _labels(labels, h):
    return labels.to(device=h.device, dtype=torch.int32).contiguous()


def _launch_fwd(h, w, labels, lora):
    """(code, lse, gold) through fused_ce.cu's f32 forward, the first
    version of row 9 with lora = (xa, bt) and of row 6 with lora None,
    both on no path."""
    R, H = h.shape
    V = w.shape[0]
    n_slabs, per_slab = _slabs(R, V, h.device, 4)
    lab = _labels(labels, h)
    part = torch.empty(n_slabs, R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    outs = (lab.data_ptr(), part.data_ptr(), lse.data_ptr(), gold.data_ptr())
    tail = (n_slabs, per_slab, DTYPE_CODES[h.dtype], _stream(h))
    if lora is None:
        code = _fn("mft_fused_ce_fwd", 6, 6)(
            h.data_ptr(), w.data_ptr(), *outs, R, V, H, *tail)
    else:
        xa, bt = lora
        code = _fn("mft_fused_ce_fwd_lora", 8, 7)(
            h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(), *outs,
            R, V, H, xa.shape[1], *tail)
    return code, lse, gold


def _launch_fwd_mma(h, w, labels):
    """(code, lse, gold) through row 6's tensor-core kernel and its merge
    pass."""
    R, H = h.shape
    V = w.shape[0]
    plan = fwd_mma_plan(R, V, H, _n_sm(h), h.element_size())
    _aligned16("fused_ce_fwd", h, w)
    part = torch.empty(plan["n_slabs"], R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    lib, sym = fwd_library(h.dtype)
    code = _fn(sym, 6, 8, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        part.data_ptr(), lse.data_ptr(), gold.data_ptr(), R, V, H,
        plan["row_groups"], plan["stages"], plan["n_slabs"],
        plan["tiles_per_slab"], DTYPE_CODES[h.dtype], _stream(h))
    return code, lse, gold


def _launch_fwd_tf32(h, w, labels):
    """(code, lse, gold) through row 6's f32 (3xTF32) kernel and its merge
    pass."""
    R, H = h.shape
    V = w.shape[0]
    plan = fwd_tf32_plan(R, V, H, _n_sm(h))
    _aligned16("fused_ce_fwd", h, w)
    part = torch.empty(plan["n_slabs"], R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    lib, sym = fwd_library(h.dtype)
    code = _fn(sym, 6, 9, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        part.data_ptr(), lse.data_ptr(), gold.data_ptr(), R, V, H,
        plan["row_tile"], plan["chunk"], plan["stages"], plan["n_slabs"],
        plan["tiles_per_slab"], DTYPE_CODES[h.dtype], _stream(h))
    return code, lse, gold


def _launch_fwd_lora_mma(h, w, xa, bt, labels):
    """(code, lse, gold) through row 9's tensor-core kernel and its merge
    pass."""
    R, H = h.shape
    V, r = bt.shape
    plan = fwd_lora_mma_plan(R, V, H, r, _n_sm(h), h.element_size())
    _aligned16("fused_ce_fwd_lora", h, w)
    part = torch.empty(plan["n_slabs"], R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    lib, sym = fwd_lora_library(h.dtype)
    code = _fn(sym, 8, 9, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), part.data_ptr(), lse.data_ptr(),
        gold.data_ptr(), R, V, H, r, plan["row_groups"], plan["stages"],
        plan["n_slabs"], plan["tiles_per_slab"], DTYPE_CODES[h.dtype],
        _stream(h))
    return code, lse, gold


def _launch_fwd_lora_tf32(h, w, xa, bt, labels):
    """(code, lse, gold) through row 9's f32 (3xTF32) kernel and its merge
    pass."""
    R, H = h.shape
    V, r = bt.shape
    plan = fwd_lora_tf32_plan(R, V, H, r, _n_sm(h))
    _aligned16("fused_ce_fwd_lora", h, w)
    part = torch.empty(plan["n_slabs"], R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    lib, sym = fwd_lora_library(h.dtype)
    code = _fn(sym, 8, 10, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), part.data_ptr(), lse.data_ptr(),
        gold.data_ptr(), R, V, H, r, plan["row_tile"], plan["chunk"],
        plan["stages"], plan["n_slabs"], plan["tiles_per_slab"],
        DTYPE_CODES[h.dtype], _stream(h))
    return code, lse, gold


def fused_ce_fwd(h, w, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) [R] f32 for h [R, H], W [V, H] and in-range labels
    [R]. CPU tensors: the plain version. CUDA tensors: the kernel of
    fwd_library(h.dtype) (with a merge pass over its vocab slabs), or
    ValueError for what it does not take."""
    _check_shapes("fused_ce_fwd", h, w, labels)
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w, labels)
    _check("fused_ce_fwd", (h, w), (), backward=False)
    if fwd_library(h.dtype)[0] == "fused_ce_fwd_mma":
        code, lse, gold = _launch_fwd_mma(h, w, labels)
    else:
        code, lse, gold = _launch_fwd_tf32(h, w, labels)
    build.check_launch("fused_ce_fwd", code)
    fused_ce_fwd.launches += 1
    return lse, gold


fused_ce_fwd.launches = 0
graphs.counted(fused_ce_fwd)


def fused_ce_fwd_lora(h, w, xa, bt, labels
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) [R] f32 of h @ W^T + xa @ bt^T for h [R, H], W [V, H],
    xa [R, r], bt [V, r] and in-range labels [R]. CPU tensors: the plain
    version. CUDA tensors: the kernel of fwd_lora_library(h.dtype) (with
    a merge pass over its vocab slabs), or ValueError for what it does
    not take."""
    _check_shapes("fused_ce_fwd_lora", h, w, labels, xa, bt)
    if h.device.type == "cpu":
        return fused_ce_fwd_lora_reference(h, w, xa, bt, labels)
    _check("fused_ce_fwd_lora", (h, w, xa, bt), (), backward=False)
    if fwd_lora_library(h.dtype)[0] == "fused_ce_fwd_lora_mma":
        code, lse, gold = _launch_fwd_lora_mma(h, w, xa, bt, labels)
    else:
        code, lse, gold = _launch_fwd_lora_tf32(h, w, xa, bt, labels)
    build.check_launch("fused_ce_fwd_lora", code)
    fused_ce_fwd_lora.launches += 1
    return lse, gold


fused_ce_fwd_lora.launches = 0
graphs.counted(fused_ce_fwd_lora)


def _bwd_args(what, h, w, labels, lse, dlse, dgold, xa=None, bt=None):
    _check_shapes(what, h, w, labels, xa, bt)
    rows = tuple(t.to(device=h.device, dtype=torch.float32).contiguous()
                 for t in (lse, dlse, dgold))
    if any(t.shape != labels.shape for t in rows):
        raise ValueError(f"{what}: lse / dlse / dgold must be [R]")
    return rows


def _n_sm(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def _aligned16(what, *ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what} tensor-core kernel takes 16-byte aligned "
                         f"h and W")


def _launch_dh_mma(h, w, labels, rows):
    """(code, dh) through the tensor-core dh kernel and its reduce pass."""
    R, H = h.shape
    V = w.shape[0]
    plan = dh_mma_plan(R, V, H, _n_sm(h), h.element_size())
    _aligned16("fused_ce_bwd_dh", h, w)
    part = torch.empty(plan["n_slabs"], R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    lib, sym = dh_library(h.dtype)
    code = _fn(sym, 8, 10, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        *(t.data_ptr() for t in rows), part.data_ptr(), dh.data_ptr(),
        R, V, H, plan["row_groups"], plan["stages"], plan["hp"],
        plan["n_parts"], plan["n_slabs"], plan["tiles_per_slab"],
        DTYPE_CODES[h.dtype], _stream(h))
    return code, dh


def _launch_dh_tf32(h, w, labels, rows):
    """(code, dh) through row 7's f32 (3xTF32) kernel and its reduce
    pass."""
    R, H = h.shape
    V = w.shape[0]
    plan = dh_tf32_plan(R, V, H, _n_sm(h))
    _aligned16("fused_ce_bwd_dh", h, w)
    part = torch.empty(plan["n_slabs"], R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    lib, sym = dh_library(h.dtype)
    code = _fn(sym, 8, 8, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        *(t.data_ptr() for t in rows), part.data_ptr(), dh.data_ptr(),
        R, V, H, plan["row_groups"], plan["stages"], plan["n_slabs"],
        plan["tiles_per_slab"], DTYPE_CODES[h.dtype], _stream(h))
    return code, dh


def _launch_dh_lora_tf32(h, w, xa, bt, labels, rows):
    """(code, dh, dxa) through row 10's f32 (3xTF32) kernel and its
    reduce passes."""
    R, H = h.shape
    V, r = bt.shape
    plan = dh_lora_tf32_plan(R, V, H, r, _n_sm(h))
    _aligned16("fused_ce_bwd_dh_lora", h, w)
    part = torch.empty(plan["n_slabs"], R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    xpart = torch.empty(plan["n_slabs"], R, r, device=h.device)
    dxa = torch.empty(R, r, device=h.device)
    lib, sym = dh_lora_library(h.dtype)
    code = _fn(sym, 12, 9, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
        part.data_ptr(), dh.data_ptr(), xpart.data_ptr(), dxa.data_ptr(),
        R, V, H, r, plan["row_groups"], plan["stages"], plan["n_slabs"],
        plan["tiles_per_slab"], DTYPE_CODES[h.dtype], _stream(h))
    return code, dh, dxa


def _launch_dh_lora_mma(h, w, xa, bt, labels, rows):
    """(code, dh, dxa) through row 10's tensor-core kernel and its reduce
    passes."""
    R, H = h.shape
    V, r = bt.shape
    plan = dh_lora_mma_plan(R, V, H, r, _n_sm(h), h.element_size())
    _aligned16("fused_ce_bwd_dh_lora", h, w)
    part = torch.empty(plan["n_slabs"], R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    xpart = torch.empty(plan["n_slabs"], R, r, device=h.device)
    dxa = torch.empty(R, r, device=h.device)
    lib, sym = dh_lora_library(h.dtype)
    code = _fn(sym, 12, 11, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
        part.data_ptr(), dh.data_ptr(), xpart.data_ptr(), dxa.data_ptr(),
        R, V, H, r, plan["row_groups"], plan["stages"], plan["hp"],
        plan["n_parts"], plan["n_slabs"], plan["tiles_per_slab"],
        DTYPE_CODES[h.dtype], _stream(h))
    return code, dh, dxa


def _launch_dw_mma(h, w, labels, rows):
    """(code, dW) through row 8's tensor-core kernel."""
    R, H = h.shape
    V = w.shape[0]
    plan = dw_mma_plan(R, V, H, _n_sm(h), h.element_size())
    _aligned16("fused_ce_bwd_dw", h, w)
    dw = torch.empty(V, H, device=h.device)
    lib, sym = dw_library(h.dtype)
    code = _fn(sym, 7, 8, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        *(t.data_ptr() for t in rows), dw.data_ptr(), R, V, H,
        plan["row_chunk"], plan["hp"], plan["n_parts"], plan["n_ctas"],
        DTYPE_CODES[h.dtype], _stream(h))
    return code, dw


def _launch_dw_tf32(h, w, labels, rows, plan=None):
    """(code, dW) through row 8's f32 (3xTF32) kernel, at dw_tf32_plan's
    launch or at `plan` (kernel_variants.py's other layout)."""
    R, H = h.shape
    V = w.shape[0]
    plan = plan or dw_tf32_plan(R, V, H, _n_sm(h))
    _aligned16("fused_ce_bwd_dw", h, w)
    dw = torch.empty(V, H, device=h.device)
    lib, sym = dw_library(h.dtype)
    code = _fn(sym, 7, 9, lib)(
        h.data_ptr(), w.data_ptr(), _labels(labels, h).data_ptr(),
        *(t.data_ptr() for t in rows), dw.data_ptr(), R, V, H,
        plan["vocab_groups"], plan["row_chunk"], plan["hp"],
        plan["n_parts"], plan["n_clusters"], DTYPE_CODES[h.dtype],
        _stream(h))
    return code, dw


def _launch_dbt_mma(h, w, xa, bt, labels, rows):
    """(code, dbt) through row 11's dbt-only tensor-core kernel and its
    reduce pass over row tiles."""
    R, H = h.shape
    V, r = bt.shape
    plan = dbt_mma_plan(R, V, H, r, _n_sm(h), h.element_size())
    _aligned16("fused_ce_bwd_dw_lora", h, w)
    part = (torch.empty(plan["row_tiles"], V, r, device=h.device)
            if plan["row_tiles"] > 1 else None)
    dbt = torch.empty(V, r, device=h.device)
    lib, sym = dbt_library(h.dtype)
    code = _fn(sym, 10, 9, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
        None if part is None else part.data_ptr(), dbt.data_ptr(), R, V, H,
        r, plan["row_groups"], plan["stages"], plan["n_slabs"],
        plan["tiles_per_slab"], DTYPE_CODES[h.dtype], _stream(h))
    return code, dbt


def _launch_dbt_tf32(h, w, xa, bt, labels, rows):
    """(code, dbt) through row 11's dbt-only f32 (3xTF32) kernel and its
    reduce pass over row tiles."""
    R, H = h.shape
    V, r = bt.shape
    plan = dbt_tf32_plan(R, V, H, r, _n_sm(h))
    _aligned16("fused_ce_bwd_dw_lora", h, w)
    part = (torch.empty(plan["row_tiles"], V, r, device=h.device)
            if plan["row_tiles"] > 1 else None)
    dbt = torch.empty(V, r, device=h.device)
    lib, sym = dbt_library(h.dtype)
    code = _fn(sym, 10, 10, lib)(
        h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
        _labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
        None if part is None else part.data_ptr(), dbt.data_ptr(), R, V, H,
        r, plan["row_tile"], plan["chunk"], plan["stages"],
        plan["n_slabs"], plan["tiles_per_slab"], DTYPE_CODES[h.dtype],
        _stream(h))
    return code, dbt


def fused_ce_bwd_dh(h, w, labels, lse, dlse, dgold) -> torch.Tensor:
    """dh [R, H] f32 = coef @ W. CPU tensors: the plain version; CUDA
    tensors: the kernel of dh_library(h.dtype) (with a reduce pass over
    its vocab slabs), or ValueError for what it does not take."""
    rows = _bwd_args("fused_ce_bwd_dh", h, w, labels, lse, dlse, dgold)
    if h.device.type == "cpu":
        return fused_ce_dh_reference(h, w, labels, *rows)
    _check("fused_ce_bwd_dh", (h, w), rows, backward=True)
    if dh_library(h.dtype)[0] == "fused_ce_dh_mma":
        code, dh = _launch_dh_mma(h, w, labels, rows)
    else:
        code, dh = _launch_dh_tf32(h, w, labels, rows)
    build.check_launch("fused_ce_bwd_dh", code)
    fused_ce_bwd_dh.launches += 1
    return dh


fused_ce_bwd_dh.launches = 0
graphs.counted(fused_ce_bwd_dh)


def fused_ce_bwd_dh_lora(h, w, xa, bt, labels, lse, dlse, dgold
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dh [R, H], dxa [R, r]) f32 = (coef @ W, coef @ bt) of the
    head-adapter logits. CPU tensors: the plain version; CUDA tensors:
    the kernel of dh_lora_library(h.dtype) (with reduce passes over its
    vocab slabs), or ValueError for what it does not take."""
    rows = _bwd_args("fused_ce_bwd_dh_lora", h, w, labels, lse, dlse, dgold,
                     xa, bt)
    if h.device.type == "cpu":
        return fused_ce_dh_lora_reference(h, w, xa, bt, labels, *rows)
    _check("fused_ce_bwd_dh_lora", (h, w, xa, bt), rows, backward=True)
    if dh_lora_library(h.dtype)[0] == "fused_ce_dh_lora_mma":
        code, dh, dxa = _launch_dh_lora_mma(h, w, xa, bt, labels, rows)
    else:
        code, dh, dxa = _launch_dh_lora_tf32(h, w, xa, bt, labels, rows)
    build.check_launch("fused_ce_bwd_dh_lora", code)
    fused_ce_bwd_dh_lora.launches += 1
    return dh, dxa


fused_ce_bwd_dh_lora.launches = 0
graphs.counted(fused_ce_bwd_dh_lora)


def fused_ce_bwd_dw(h, w, labels, lse, dlse, dgold) -> torch.Tensor:
    """dW [V, H] f32 = coef^T @ h. CPU tensors: the plain version; CUDA
    tensors: the kernel of dw_library(h.dtype), or ValueError for what it
    does not take."""
    rows = _bwd_args("fused_ce_bwd_dw", h, w, labels, lse, dlse, dgold)
    if h.device.type == "cpu":
        return fused_ce_dw_reference(h, w, labels, *rows)
    _check("fused_ce_bwd_dw", (h, w), rows, backward=True)
    if dw_library(h.dtype)[0] == "fused_ce_dw_mma":
        code, dw = _launch_dw_mma(h, w, labels, rows)
    else:
        code, dw = _launch_dw_tf32(h, w, labels, rows)
    build.check_launch("fused_ce_bwd_dw", code)
    fused_ce_bwd_dw.launches += 1
    return dw


fused_ce_bwd_dw.launches = 0
graphs.counted(fused_ce_bwd_dw)


def fused_ce_bwd_dw_lora(h, w, xa, bt, labels, lse, dlse, dgold,
                         want_dw: bool = True):
    """(dW [V, H] f32 or None, dbt [V, r] f32) = (coef^T @ h, coef^T @ xa)
    of the head-adapter logits; dW only when `want_dw` (the frozen-
    embedding case skips it). CPU tensors: the plain version; CUDA
    tensors: dbt alone on the kernel of dbt_library(h.dtype) (with a
    reduce pass over its row tiles), dW + dbt on fused_ce.cu's, or
    ValueError for what the kernel does not take."""
    rows = _bwd_args("fused_ce_bwd_dw_lora", h, w, labels, lse, dlse, dgold,
                     xa, bt)
    if h.device.type == "cpu":
        return fused_ce_dw_lora_reference(h, w, xa, bt, labels, *rows,
                                          want_dw=want_dw)
    # dbt alone needs only a [32, r] accumulator: H is then not bounded
    _check("fused_ce_bwd_dw_lora", (h, w, xa, bt), rows, backward=want_dw)
    dw = None
    if not want_dw and dbt_library(h.dtype)[0] == "fused_ce_dbt_mma":
        code, dbt = _launch_dbt_mma(h, w, xa, bt, labels, rows)
    elif not want_dw:
        code, dbt = _launch_dbt_tf32(h, w, xa, bt, labels, rows)
    else:
        R, H = h.shape
        V, r = bt.shape
        dw = torch.empty(V, H, device=h.device) if want_dw else None
        dbt = torch.empty(V, r, device=h.device)
        code = _fn("mft_fused_ce_dw_lora", 10, 5)(
            h.data_ptr(), w.data_ptr(), xa.data_ptr(), bt.data_ptr(),
            _labels(labels, h).data_ptr(), *(t.data_ptr() for t in rows),
            None if dw is None else dw.data_ptr(), dbt.data_ptr(), R, V, H,
            r, DTYPE_CODES[h.dtype], _stream(h))
    build.check_launch("fused_ce_bwd_dw_lora", code)
    fused_ce_bwd_dw_lora.launches += 1
    return dw, dbt


fused_ce_bwd_dw_lora.launches = 0
graphs.counted(fused_ce_bwd_dw_lora)


# ---------------------------------------------------------- autograd ------

class FusedCERows(torch.autograd.Function):
    """(lse, gold) of h [R, H] against W [V, H]; saves (h, W, labels, lse)
    only. The backward launches the dh kernel when h needs a gradient and
    the dW kernel when W does: the counterpart of the JAX package's
    dead-code elimination of an unused dW."""

    @staticmethod
    def forward(ctx, h, w, labels):
        lse, gold = fused_ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return lse, gold

    @staticmethod
    def backward(ctx, dlse, dgold):
        h, w, labels, lse = ctx.saved_tensors
        dlse = torch.zeros_like(lse) if dlse is None else dlse.float()
        dgold = torch.zeros_like(lse) if dgold is None else dgold.float()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = fused_ce_bwd_dh(h, w, labels, lse, dlse,
                                 dgold).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(h, w, labels, lse, dlse,
                                 dgold).to(w.dtype)
        return dh, dw, None


def fused_ce_rows(hidden2d, w, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse [R], gold [R]) for rows of hidden states against the [V, H]
    head; labels must be in range (the caller substitutes 0 for ignored
    positions and masks the NLL). Differentiable in hidden2d and w."""
    return FusedCERows.apply(hidden2d.contiguous(), w.contiguous(), labels)


class FusedCERowsLora(torch.autograd.Function):
    """(lse, gold) of h [R, H] against W [V, H] plus the head adapter's
    xa [R, r] @ bt [V, r]^T; saves (h, W, labels, lse, xa, bt). The
    backward launches the dh kernel (dh and dxa) when h or xa needs a
    gradient and the dW kernel when W or bt does, its dW product only
    when W does (the tied embedding is frozen under LoRA: dbt alone)."""

    @staticmethod
    def forward(ctx, h, w, labels, xa, bt):
        lse, gold = fused_ce_fwd_lora(h, w, xa, bt, labels)
        ctx.save_for_backward(h, w, labels, lse, xa, bt)
        return lse, gold

    @staticmethod
    def backward(ctx, dlse, dgold):
        h, w, labels, lse, xa, bt = ctx.saved_tensors
        dlse = torch.zeros_like(lse) if dlse is None else dlse.float()
        dgold = torch.zeros_like(lse) if dgold is None else dgold.float()
        need_h, need_w, _, need_xa, need_bt = ctx.needs_input_grad
        dh = dw = dxa = dbt = None
        args = (h, w, xa, bt, labels, lse, dlse, dgold)
        if need_h or need_xa:
            dh, dxa = fused_ce_bwd_dh_lora(*args)
            dh, dxa = dh.to(h.dtype), dxa.to(xa.dtype)
        if need_w or need_bt:
            dw, dbt = fused_ce_bwd_dw_lora(*args, want_dw=need_w)
            dw = None if dw is None else dw.to(w.dtype)
            dbt = dbt.to(bt.dtype)
        return dh, dw, None, dxa, dbt


def fused_ce_rows_lora(hidden2d, w, labels, xa, bt
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_ce_rows with the head-adapter delta folded into the tile
    loop: logits_tile = h @ W_tile^T + xa @ bt_tile^T, xa [R, r] the
    scale-folded bottleneck, bt = B^T [V, r] (head_bottleneck).
    Differentiable in hidden2d, w, xa and bt."""
    return FusedCERowsLora.apply(hidden2d.contiguous(), w.contiguous(),
                                 labels, xa.contiguous(), bt.contiguous())


def head_bottleneck(hidden2d, lora_head):
    """(xa, bt) kernel operands of a head-adapter entry {A [H, r],
    B [r, V], scale}: xa = scale * (h @ A), f32-accumulated, in h's
    dtype, and bt = B^T; the scale carries no gradient. Shared by the
    kernel route and ops/loss.py's plain chunk body."""
    A = lora_head["A"].to(hidden2d.dtype)
    scale = lora_head["scale"].detach().float()
    xa = ((hidden2d.float() @ A.float()) * scale).to(hidden2d.dtype)
    return xa, lora_head["B"].T.to(hidden2d.dtype)


def fused_ce_nll_sum(hidden, lm_head_w, labels, ignore_index: int,
                     lora_head=None, branch_hidden=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll f32, valid_count) over one already-shifted chunk
    hidden [B, C, H] / labels [B, C]: ignored positions get label 0 in
    the kernels and are masked after. lora_head: an optional {A, B,
    scale} head adapter folded into the kernels' tile loop;
    branch_hidden: the adapter branch's input where it differs from
    `hidden` (train-mode LoRA dropout drops the branch copy only; the
    base logits read the undropped hidden)."""
    B, C, H = hidden.shape
    lab = labels.reshape(B * C)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    h2 = hidden.reshape(B * C, H)
    if lora_head is None:
        lse, gold = fused_ce_rows(h2, lm_head_w, safe)
    else:
        hb2 = h2 if branch_hidden is None \
            else branch_hidden.reshape(B * C, H)
        xa, bt = head_bottleneck(hb2, lora_head)
        lse, gold = fused_ce_rows_lora(h2, lm_head_w, safe, xa, bt)
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum()
