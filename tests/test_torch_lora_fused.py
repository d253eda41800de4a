"""Port LoRA epilogue (mobilefinetuner_tpu_torch/ops/lora_fused.py) and the
`fused` LoRA site (models/lora_apply.py) against the JAX package's Pallas
epilogue in interpret mode on the CPU: forward and the gradients dy, dxa,
dB, then maybe_lora(impl="fused") against impl="naive" and against the
JAX site. f32; the tolerance is 1e-5 of max(1, max |reference|): the
factor gradients sum over every row, in another order than XLA's. The
scale fold inside the epilogue call equals the composition it replaced
(f32(xa) * scale cast to y's dtype, then the epilogue) bit for bit, output
and gradients, in f32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.models.lora_apply import maybe_lora as jax_maybe_lora
from mobilefinetuner_tpu.ops.lora_fused import \
    lora_epilogue_add as jax_epilogue_add
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops import lora_fused

TOL = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def test_epilogue_forward_and_grads_match_jax():
    """y [2, 32, 384] + 2.0 * xa [2, 32, 8] @ B [8, 384]."""
    y, xa, b, g = _arrays(0, (2, 32, 384), (2, 32, 8), (8, 384),
                          (2, 32, 384))
    scale = np.float32(2.0)
    out, vjp = jax.vjp(lambda y, xa, b: jax_epilogue_add(
        y, xa, b, jnp.asarray(scale)), *map(jnp.asarray, (y, xa, b)))
    want = [out, *vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (y, xa, b)]
    lora_fused.lora_epilogue.launches = 0
    got = lora_fused.lora_epilogue_add(*leaves, torch.tensor(scale))
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert lora_fused.lora_epilogue.launches == 0    # CPU: the plain version
    assert not lora_fused.lora_epilogue.by_shape
    for name, a, w in zip(("out", "dy", "dxa", "dB"), (got, *grads), want):
        assert a.shape == tuple(w.shape)
        assert _err(a.detach(), w) <= TOL, name


@pytest.mark.parametrize("target", ["fused_qkv", "ragged"])
def test_fused_site_matches_naive_and_jax(target):
    """maybe_lora(impl="fused") equals impl="naive" and the JAX fused site,
    values and grads to x, A, B; a ragged row count (N = 3 x 7) that the
    TPU tiling would refuse runs the port's epilogue path all the same."""
    B_, S, d_in, d_out, r = (2, 16, 64, 192, 8) if target == "fused_qkv" \
        else (3, 7, 48, 80, 4)
    x, y, A, Bm, g = _arrays(1, (B_, S, d_in), (B_, S, d_out), (d_in, r),
                             (r, d_out), (B_, S, d_out))
    res = {}
    for impl in ("fused", "naive"):
        leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, A, Bm)]
        entry = {"A": leaves[1], "B": leaves[2], "scale": torch.tensor(2.0)}
        out = maybe_lora(torch.from_numpy(y), leaves[0], entry, impl=impl)
        res[impl] = [out.detach(), *torch.autograd.grad(
            out, leaves, torch.from_numpy(g))]
    for a, b in zip(res["fused"], res["naive"]):
        assert _err(a, b) <= TOL

    def f(x, A, Bm):
        return jax_maybe_lora(jnp.asarray(y), x, {"A": A, "B": Bm,
                                                  "scale": jnp.float32(2.0)},
                              impl="fused")
    out, vjp = jax.vjp(f, *map(jnp.asarray, (x, A, Bm)))
    for a, w in zip(res["fused"], [out, *vjp(jnp.asarray(g))]):
        assert _err(a, w) <= TOL


def test_epilogue_rules():
    """The kernel's own eligibility: a rank in [1, 128] and a float dtype;
    mismatched shapes and a scale that is not one f32 raise before any
    kernel is touched."""
    assert lora_fused.lora_epilogue_eligible(8, torch.bfloat16)
    assert lora_fused.lora_epilogue_eligible(128, torch.float32)
    assert not lora_fused.lora_epilogue_eligible(129, torch.float32)
    assert not lora_fused.lora_epilogue_eligible(8, torch.int32)
    with pytest.raises(ValueError, match="lora_epilogue"):
        lora_fused.lora_epilogue(torch.zeros(4, 8), torch.zeros(4, 2),
                                 torch.zeros(3, 8), torch.tensor(1.0))
    for bad in (torch.tensor(1.0, dtype=torch.float64), torch.ones(2)):
        with pytest.raises(ValueError, match="scale"):
            lora_fused.lora_epilogue(torch.zeros(4, 8), torch.zeros(4, 2),
                                     torch.zeros(2, 8), bad)


class _Unfolded(torch.autograd.Function):
    """The epilogue call as it was before the scale fold moved into the
    kernel: y2 + xs2 @ b2 on an already-scaled xs2, plain matmuls back."""

    @staticmethod
    def forward(ctx, y2, xs2, b2):
        ctx.save_for_backward(xs2, b2)
        return lora_fused.lora_epilogue_reference(y2, xs2, b2,
                                                  torch.tensor(1.0))

    @staticmethod
    def backward(ctx, g):
        xs2, b2 = ctx.saved_tensors
        gf = g.float()
        return (g, (gf @ b2.float().T).to(xs2.dtype),
                (xs2.float().T @ gf).to(b2.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [2.0, 0.3])
def test_scale_fold_matches_the_composition_bit_for_bit(dtype, scale):
    """lora_epilogue_add with the scale folded into the epilogue call
    equals the composition it replaces, (f32(xa) * scale) cast to y's
    dtype, then the epilogue on it, bit for bit on the CPU: the output
    and the gradients of y, xa and B."""
    y, xa, b, g = _arrays(7, (3, 5, 96), (3, 5, 8), (8, 96), (3, 5, 96))
    s = torch.tensor(scale, dtype=torch.float32)
    res = []
    for fold in (True, False):
        leaves = [torch.from_numpy(t).to(dtype).requires_grad_(True)
                  for t in (y, xa, b)]
        yl, xal, bl = leaves
        if fold:
            out = lora_fused.lora_epilogue_add(yl, xal, bl, s)
        else:
            xs = (xal.float() * s).to(dtype)
            out = _Unfolded.apply(yl.reshape(-1, 96), xs.reshape(-1, 8),
                                  bl.contiguous()).reshape(yl.shape)
        res.append([out.detach(), *torch.autograd.grad(
            out, leaves, torch.from_numpy(g).to(dtype))])
    for name, a, w in zip(("out", "dy", "dxa", "dB"), *res):
        assert a.dtype == w.dtype and torch.equal(a, w), name


def test_epilogue_returns_the_scaled_bottleneck():
    """lora_epilogue returns (out, xs), xs = round(f32(xa) * scale) in y's
    dtype, the operand dB is formed from; a scale of 1 leaves xa as it
    is."""
    y, xa, b = (torch.from_numpy(a).bfloat16()
                for a in _arrays(8, (6, 40), (6, 4), (4, 40)))
    s = torch.tensor(1.7)
    out, xs = lora_fused.lora_epilogue(y, xa, b, s)
    assert torch.equal(xs, (xa.float() * 1.7).bfloat16())
    assert torch.equal(out, lora_fused.lora_epilogue_reference(y, xa, b, s))
    _, xs1 = lora_fused.lora_epilogue(y, xa, b, torch.tensor(1.0))
    assert torch.equal(xs1, xa)


@pytest.mark.parametrize("dtype,lib", [
    (torch.bfloat16, ("lora_epilogue_vec", "mft_lora_epilogue_vec")),
    (torch.float16, ("lora_epilogue_vec", "mft_lora_epilogue_vec")),
    (torch.float32, ("lora_epilogue_vec_f32", "mft_lora_epilogue_vec_f32"))])
def test_epilogue_library_by_dtype(dtype, lib):
    assert lora_fused.epilogue_library(dtype) == lib
    with pytest.raises(ValueError, match="dtype"):
        lora_fused.epilogue_library(torch.float64)
