"""Fused cross-entropy head: the Hopper kernels, their wrappers and their
plain versions (port of mobilefinetuner_tpu/ops/fused_ce.py, the base
kernels; the head-adapter variants are ROADMAP.md rows 9-11).

The chunked loss (ops/loss.py) projects each sequence chunk's hidden
states onto the [V, H] head. At Gemma's 262,144-entry vocabulary a
chunk's [R, V] logits are hundreds of MB; the kernels of
`csrc/fused_ce.cu` compute them tile by tile and keep them out of device
memory:

  fused_ce_fwd      (lse, gold) [R] f32: logsumexp of each row's logits
                    and its label's logit (TPU `_fwd_kernel`, row 6).
  fused_ce_bwd_dh   dh [R, H] f32 = coef @ W (`_dh_kernel`, row 7).
  fused_ce_bwd_dw   dW [V, H] f32 = coef^T @ h (`_dw_kernel`, row 8).
                    coef = dlse * softmax(logits) + dgold * onehot(label),
                    rounded to the storage dtype before the product.
  fused_ce_rows     (lse, gold), differentiable in h and W: a
                    torch.autograd.Function that saves (h, W, labels,
                    lse) only and launches the dW kernel only when W needs
                    a gradient (a frozen head, as in LoRA, runs fwd + dh).
  fused_ce_nll_sum  (sum_nll, valid_count) of one already-shifted chunk.
  head_bottleneck   (xa, bt) of a head adapter, for the variants to come.

Each wrapper has a `launches` count of its calls that launch the kernel
(the forward's merge pass and the dh reduce pass are part of their
kernel's launch). CUDA tensors launch the kernel or raise; CPU tensors
take the plain versions (`*_reference`), which compute the same function
tile by tile over the vocabulary in f32 with the same coef rounding, and
run on any device as the kernels' references on the card.

Bounds and design: csrc/fused_ce.cu. The kernels take any R, V and H up
to MAX_HIDDEN (the dh and dW kernels hold a [32, H] f32 accumulator in
shared memory), h and W in one of f32 / bf16 / f16.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mobilefinetuner_tpu_torch.kernels import build

BLOCK_V = 4096          # the plain versions' vocab tile
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROW_TILE = 32           # csrc/fused_ce.cu FWD_TM: rows of a forward / dh CTA
VOCAB_TILE = 64         # FWD_TN: vocab columns of a forward / dh tile
# shared memory of the dh / dW kernels: 9,408 staging floats + a [32, H]
# f32 accumulator, within the card's 232,448 bytes a block
MAX_HIDDEN = (232448 // 4 - 9408) // 32


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


def fused_ce_fwd_reference(h, w, labels, block_v: int = BLOCK_V
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) [R] f32 by an online logsumexp over vocab tiles."""
    hf = h.float()
    R = h.shape[0]
    lab = labels.long()
    m = torch.full((R,), -math.inf, device=h.device)
    s = torch.zeros(R, device=h.device)
    gold = torch.zeros(R, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        logits = hf @ w[v0:v1].float().T
        cols = torch.arange(v0, v1, device=h.device)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(logits - m_new[:, None]).sum(-1)
        m = m_new
        gold = gold + torch.where(cols[None, :] == lab[:, None], logits,
                                  0.0).sum(-1)
    return m + torch.log(s), gold


def fused_ce_dh_reference(h, w, labels, lse, dlse, dgold,
                          block_v: int = BLOCK_V) -> torch.Tensor:
    """dh [R, H] f32 = sum over vocab tiles of coef @ W_tile."""
    hf = h.float()
    lab = labels.long()
    dh = torch.zeros(h.shape, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        wt = w[v0:v1].float()
        coef = _tile_coef(hf @ wt.T, torch.arange(v0, v1, device=h.device),
                          lab, lse, dlse, dgold, w.dtype)
        dh += coef @ wt
    return dh


def fused_ce_dw_reference(h, w, labels, lse, dlse, dgold,
                          block_v: int = BLOCK_V) -> torch.Tensor:
    """dW [V, H] f32, one vocab tile at a time: coef_tile^T @ h."""
    hf = h.float()
    lab = labels.long()
    dw = torch.empty(w.shape, device=h.device)
    for v0, v1 in _tiles(w.shape[0], block_v):
        coef = _tile_coef(hf @ w[v0:v1].float().T,
                          torch.arange(v0, v1, device=h.device), lab, lse,
                          dlse, dgold, h.dtype)
        dw[v0:v1] = coef.T @ hf
    return dw


# ------------------------------------------------------------ wrappers ------

def _fn(sym: str, n_ptrs: int, n_ints: int):
    """The ctypes entry `sym` of csrc/fused_ce.cu: n_ptrs pointers, n_ints
    ints (shapes, slabs, dtype), the stream."""
    fn = getattr(build.load("fused_ce"), sym)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(what: str, h, w, f32s, backward: bool):
    """The kernels' rule for CUDA tensors: h [R, H] and W [V, H] on one
    CUDA device in one dtype of DTYPE_CODES, contiguous; the row vectors
    contiguous f32; H <= MAX_HIDDEN for the backward kernels."""
    for t in (h, w, *f32s):
        if not t.is_cuda or t.device != h.device:
            raise ValueError(f"{what}: tensors on {t.device} and {h.device};"
                             f" the kernel takes one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous tensors")
    if h.dtype not in DTYPE_CODES or w.dtype != h.dtype:
        raise ValueError(f"{what} kernel takes h and W in one dtype of "
                         f"{sorted(map(str, DTYPE_CODES))}, got {h.dtype} "
                         f"and {w.dtype}")
    if any(t.dtype != torch.float32 for t in f32s):
        raise ValueError(f"{what} kernel takes f32 lse, dlse and dgold")
    if backward and h.shape[1] > MAX_HIDDEN:
        raise ValueError(f"{what} kernel takes H <= {MAX_HIDDEN}, got "
                         f"{h.shape[1]}")


def _check_shapes(what, h, w, labels):
    R, H = h.shape
    if w.ndim != 2 or w.shape[1] != H or labels.shape != (R,):
        raise ValueError(f"{what}: h {tuple(h.shape)}, W {tuple(w.shape)}, "
                         f"labels {tuple(labels.shape)}")


def _slabs(R: int, V: int, device, ctas_per_sm: int) -> Tuple[int, int]:
    """(n_slabs, vocab tiles a slab): enough (row tile, slab) CTAs for
    `ctas_per_sm` a multiprocessor, slabs of whole 64-column tiles."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    n_vt = -(-V // VOCAB_TILE)
    row_tiles = -(-R // ROW_TILE)
    n_slabs = min(n_vt, max(1, -(-ctas_per_sm * n_sm // row_tiles)))
    per_slab = -(-n_vt // n_slabs)
    return -(-n_vt // per_slab), per_slab


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd(h, w, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) [R] f32 for h [R, H], W [V, H] and in-range labels
    [R]. CPU tensors: the plain version. CUDA tensors: the kernel, or
    ValueError for what it does not take."""
    _check_shapes("fused_ce_fwd", h, w, labels)
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w, labels)
    _check("fused_ce_fwd", h, w, (), backward=False)
    R, H = h.shape
    V = w.shape[0]
    n_slabs, per_slab = _slabs(R, V, h.device, 4)
    lab = labels.to(device=h.device, dtype=torch.int32).contiguous()
    part = torch.empty(n_slabs, R, 3, device=h.device)
    lse = torch.empty(R, device=h.device)
    gold = torch.empty(R, device=h.device)
    code = _fn("mft_fused_ce_fwd", 6, 6)(
        h.data_ptr(), w.data_ptr(), lab.data_ptr(), part.data_ptr(),
        lse.data_ptr(), gold.data_ptr(), R, V, H, n_slabs, per_slab,
        DTYPE_CODES[h.dtype], _stream(h))
    build.check_launch("fused_ce_fwd", code)
    fused_ce_fwd.launches += 1
    return lse, gold


fused_ce_fwd.launches = 0


def _bwd_args(what, h, w, labels, lse, dlse, dgold):
    _check_shapes(what, h, w, labels)
    rows = tuple(t.to(device=h.device, dtype=torch.float32).contiguous()
                 for t in (lse, dlse, dgold))
    if any(t.shape != labels.shape for t in rows):
        raise ValueError(f"{what}: lse / dlse / dgold must be [R]")
    return rows


def fused_ce_bwd_dh(h, w, labels, lse, dlse, dgold) -> torch.Tensor:
    """dh [R, H] f32 = coef @ W. CPU tensors: the plain version; CUDA
    tensors: the kernel (with a reduce pass over its vocab slabs)."""
    lse, dlse, dgold = _bwd_args("fused_ce_bwd_dh", h, w, labels, lse, dlse,
                                 dgold)
    if h.device.type == "cpu":
        return fused_ce_dh_reference(h, w, labels, lse, dlse, dgold)
    _check("fused_ce_bwd_dh", h, w, (lse, dlse, dgold), backward=True)
    R, H = h.shape
    V = w.shape[0]
    n_slabs, per_slab = _slabs(R, V, h.device, 2)
    lab = labels.to(device=h.device, dtype=torch.int32).contiguous()
    part = torch.empty(n_slabs, R, H, device=h.device)
    dh = torch.empty(R, H, device=h.device)
    code = _fn("mft_fused_ce_dh", 8, 6)(
        h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dgold.data_ptr(), part.data_ptr(), dh.data_ptr(),
        R, V, H, n_slabs, per_slab, DTYPE_CODES[h.dtype], _stream(h))
    build.check_launch("fused_ce_bwd_dh", code)
    fused_ce_bwd_dh.launches += 1
    return dh


fused_ce_bwd_dh.launches = 0


def fused_ce_bwd_dw(h, w, labels, lse, dlse, dgold) -> torch.Tensor:
    """dW [V, H] f32 = coef^T @ h. CPU tensors: the plain version; CUDA
    tensors: the kernel."""
    lse, dlse, dgold = _bwd_args("fused_ce_bwd_dw", h, w, labels, lse, dlse,
                                 dgold)
    if h.device.type == "cpu":
        return fused_ce_dw_reference(h, w, labels, lse, dlse, dgold)
    _check("fused_ce_bwd_dw", h, w, (lse, dlse, dgold), backward=True)
    R, H = h.shape
    V = w.shape[0]
    lab = labels.to(device=h.device, dtype=torch.int32).contiguous()
    dw = torch.empty(V, H, device=h.device)
    code = _fn("mft_fused_ce_dw", 7, 4)(
        h.data_ptr(), w.data_ptr(), lab.data_ptr(), lse.data_ptr(),
        dlse.data_ptr(), dgold.data_ptr(), dw.data_ptr(), R, V, H,
        DTYPE_CODES[h.dtype], _stream(h))
    build.check_launch("fused_ce_bwd_dw", code)
    fused_ce_bwd_dw.launches += 1
    return dw


fused_ce_bwd_dw.launches = 0


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


def head_bottleneck(hidden2d, lora_head):
    """(xa, bt) kernel operands of a head-adapter entry {A [H, r],
    B [r, V], scale}: xa = scale * (h @ A), f32-accumulated, in h's
    dtype, and bt = B^T; the scale carries no gradient. The operands of
    the head-adapter kernels (ROADMAP.md rows 9-11)."""
    A = lora_head["A"].to(hidden2d.dtype)
    scale = lora_head["scale"].detach().float()
    xa = ((hidden2d.float() @ A.float()) * scale).to(hidden2d.dtype)
    return xa, lora_head["B"].T.to(hidden2d.dtype)


def fused_ce_nll_sum(hidden, lm_head_w, labels, ignore_index: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_nll f32, valid_count) over one already-shifted chunk
    hidden [B, C, H] / labels [B, C]: ignored positions get label 0 in
    the kernels and are masked after."""
    B, C, H = hidden.shape
    lab = labels.reshape(B * C)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    lse, gold = fused_ce_rows(hidden.reshape(B * C, H), lm_head_w, safe)
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum(), valid.sum()
