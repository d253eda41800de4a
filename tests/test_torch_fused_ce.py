"""The fused CE head (mobilefinetuner_tpu_torch/ops/fused_ce.py) and the
chunked loss (ops/loss.py) against the JAX package, on the CPU in f32:
the kernels' plain versions (rows 6-8, and the head-adapter rows 9-11)
against the JAX `fused_ce_rows` / `fused_ce_rows_lora` (Pallas in
interpret mode) forward and vjp, and the chunked loss with its pad tail
and ignored positions, with and without a head adapter, against the JAX
chunked loss on its fused-kernel and XLA paths. The same seeded numpy
inputs go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import fused_ce as jfc
from mobilefinetuner_tpu.ops import loss as jloss
from mobilefinetuner_tpu_torch.ops import fused_ce as fc
from mobilefinetuner_tpu_torch.ops import loss

TOL = 1e-5


def make(R, V, H, seed, n_ignored=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, R).astype(np.int32)
    lab[:n_ignored] = -100
    return h, w, lab


def close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("R,V,H", [(16, 384, 32), (24, 512, 64)])
def test_plain_versions_match_jax_fused_ce_rows(R, V, H):
    h, w, lab = make(R, V, H, seed=R + V)
    rng = np.random.default_rng(H)
    dlse = rng.normal(size=R).astype(np.float32)
    dgold = rng.normal(size=R).astype(np.float32)
    (jl, jg), vjp = jax.vjp(lambda h_, w_: jfc.fused_ce_rows(
        h_, w_, jnp.asarray(lab)), jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = vjp((jnp.asarray(dlse), jnp.asarray(dgold)))
    th, tw, tl = map(torch.from_numpy, (h, w, lab))
    # vocab tiles of 128: several tiles at both widths
    lse, gold = fc.fused_ce_fwd_reference(th, tw, tl, block_v=128)
    close(lse, jl)
    close(gold, jg)
    args = (th, tw, tl, lse, torch.from_numpy(dlse), torch.from_numpy(dgold))
    close(fc.fused_ce_dh_reference(*args, block_v=128), jdh)
    close(fc.fused_ce_dw_reference(*args, block_v=128), jdw)


def test_wrappers_and_autograd_on_cpu_match_jax():
    """The CPU wrappers (plain versions) and the autograd Function: lse,
    gold and both gradients; dW is computed only when W needs it."""
    h, w, lab = make(24, 384, 32, seed=5)
    (jl, jg), vjp = jax.vjp(lambda h_, w_: jfc.fused_ce_rows(
        h_, w_, jnp.asarray(lab)), jnp.asarray(h), jnp.asarray(w))
    g = np.linspace(-1, 1, 24, dtype=np.float32)
    jdh, jdw = vjp((jnp.asarray(g), jnp.asarray(-g)))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    lse, gold = fc.fused_ce_rows(th, tw, torch.from_numpy(lab))
    close(lse, jl)
    close(gold, jg)
    tg = torch.from_numpy(g)
    dh, dw = torch.autograd.grad((lse * tg - gold * tg).sum(), [th, tw])
    close(dh, jdh)
    close(dw, jdw)
    n0 = fc.fused_ce_bwd_dw.launches
    frozen = torch.from_numpy(w)          # a frozen head: no dW pass
    lse, _ = fc.fused_ce_rows(th, frozen, torch.from_numpy(lab))
    (dh2,) = torch.autograd.grad(lse.sum(), [th])
    assert fc.fused_ce_bwd_dw.launches == n0   # CPU: counts stay 0 anyway
    assert dh2.shape == th.shape


def test_nll_sum_ignores_positions_like_jax():
    h, w, lab = make(16, 384, 32, seed=9, n_ignored=5)
    jh = jnp.asarray(h).reshape(2, 8, 32)
    jlab = jnp.asarray(lab).reshape(2, 8)
    js, jc = jfc.fused_ce_nll_sum(jh, jnp.asarray(w), jlab, -100)
    s, c = fc.fused_ce_nll_sum(torch.from_numpy(h).reshape(2, 8, 32),
                               torch.from_numpy(w),
                               torch.from_numpy(lab).reshape(2, 8), -100)
    close(s, js, 1e-4)
    assert int(c) == int(jc) == 11


def test_head_bottleneck_matches_jax():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(8, 16)).astype(np.float32)
    A = rng.normal(size=(16, 4)).astype(np.float32)
    B = rng.normal(size=(4, 40)).astype(np.float32)
    jxa, jbt = jfc.head_bottleneck(jnp.asarray(h), {
        "A": jnp.asarray(A), "B": jnp.asarray(B), "scale": 2.0})
    xa, bt = fc.head_bottleneck(torch.from_numpy(h), {
        "A": torch.from_numpy(A), "B": torch.from_numpy(B),
        "scale": torch.tensor(2.0)})
    close(xa, jxa)
    close(bt, jbt)


@pytest.mark.parametrize("S,chunks,pad", [(256, 8, 1), (41, 4, 0),
                                          (40, 8, 1)])
def test_chunk_len_and_pad_tail_match_jax(S, chunks, pad):
    assert loss.chunk_len(S, chunks) == jloss.chunk_len(S, chunks)
    assert chunks * loss.chunk_len(S, chunks) - (S - 1) == pad


def kernel_route_sum(hidden, w, labels, num_chunks):
    """The chunked loss's route on a CUDA tensor, run on the CPU:
    fused_ce_nll_sum (the kernels' plain versions) over the chunks."""
    hs, ls = loss._shift_and_chunk(hidden, labels, -100, num_chunks)
    parts = [fc.fused_ce_nll_sum(h, w, lab, -100) for h, lab in zip(hs, ls)]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


@pytest.mark.parametrize("impl,jax_fused", [("kernels", True),
                                            ("plain", False),
                                            ("auto", False)])
def test_chunked_loss_matches_jax(impl, jax_fused):
    """[B=4, S=31, H=32] through 4 chunks of 8 (a pad tail of 2) and 5
    chunks of 6 (none), right-padded labels, loss and both gradients (the
    JAX kernel path needs B * chunk % 8 == 0). "kernels" is the route a
    CUDA tensor takes, through the kernels' plain versions."""
    rng = np.random.default_rng(11)
    B, S, H, V = 4, 31, 32, 384
    hid = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    lab[1, 25:] = -100
    for n in (4, 5):
        def jf(h_, w_):
            return jloss.chunked_lm_cross_entropy(
                h_, w_, jnp.asarray(lab), num_chunks=n,
                use_fused_kernel=jax_fused)
        jv, (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(
            jnp.asarray(hid), jnp.asarray(w))
        th = torch.from_numpy(hid).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        tl = torch.from_numpy(lab)
        if impl == "kernels":
            s, c = kernel_route_sum(th, tw, tl, n)
            v = s / torch.clamp_min(c, 1).float()
        else:
            v = loss.chunked_lm_cross_entropy(th, tw, tl, num_chunks=n,
                                              impl=impl)
            s, c = loss.chunked_lm_cross_entropy_sum(
                th.detach(), tw.detach(), tl, num_chunks=n, impl=impl)
        dh, dw = torch.autograd.grad(v, [th, tw])
        close(v, jv)
        close(dh, jdh)
        close(dw, jdw)
        js, jc = jloss.chunked_lm_cross_entropy_sum(
            jnp.asarray(hid), jnp.asarray(w), jnp.asarray(lab),
            num_chunks=n, use_fused_kernel=jax_fused)
        close(s, js, 1e-4)
        assert int(c) == int(jc)


def test_chunked_loss_refuses_what_is_not_ported():
    h = torch.zeros(1, 9, 8)
    w = torch.zeros(16, 8)
    lab = torch.zeros(1, 9, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="P9"):
        loss.chunked_lm_cross_entropy_sum(h, w, lab, mesh=object())
    for impl in ("xla", "fused"):
        with pytest.raises(ValueError, match="impl"):
            loss.chunked_lm_cross_entropy_sum(h, w, lab, impl=impl)
    with pytest.raises(ValueError, match="lora_impl"):
        loss.chunked_lm_cross_entropy_sum(h, w, lab, lora_impl="dense")


# ------------------------------------------ head adapter (rows 9-11) ------

def make_lora(R, V, r, seed):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(R, r)).astype(np.float32)
    bt = (rng.normal(size=(V, r)) * 0.3).astype(np.float32)
    return xa, bt


def _oracle_rows_lora(h, w, labels, xa, bt):
    """The head-adapter rows in plain jnp: the JAX kernels' function at
    shapes their (8, 128) tiling does not take."""
    logits = h @ w.T + xa @ bt.T
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)[:, 0]
    return lse, gold


@pytest.mark.parametrize("R,V,H,r,jax_kernel", [(16, 256, 32, 4, True),
                                                (13, 200, 24, 3, False)])
@pytest.mark.parametrize("zero_dgold", [False, True])
def test_lora_plain_versions_and_autograd_match_jax(R, V, H, r, jax_kernel,
                                                    zero_dgold):
    """Rows 9-11's plain versions (lse, gold, dh, dxa, dW, dbt; dW-mode
    and dbt-only) and FusedCERowsLora's gradients in h, W, xa and bt
    against the JAX fused_ce_rows_lora (Pallas, interpret mode) and its
    vjp, or, at a ragged shape the TPU kernels do not take, against jax
    autodiff of the same function in jnp. dgold = 0 holds the softmax
    part alone."""
    h, w, lab = make(R, V, H, seed=R * V)
    xa, bt = make_lora(R, V, r, seed=r)
    rng = np.random.default_rng(H)
    dlse = rng.normal(size=R).astype(np.float32)
    dgold = (np.zeros(R) if zero_dgold else rng.normal(size=R)).astype(
        np.float32)
    fn = jfc.fused_ce_rows_lora if jax_kernel else _oracle_rows_lora
    (jl, jg), vjp = jax.vjp(
        lambda h_, w_, xa_, bt_: fn(h_, w_, jnp.asarray(lab), xa_, bt_),
        *map(jnp.asarray, (h, w, xa, bt)))
    jdh, jdw, jdxa, jdbt = vjp((jnp.asarray(dlse), jnp.asarray(dgold)))
    th, tw, txa, tbt, tl = map(torch.from_numpy, (h, w, xa, bt, lab))
    lse, gold = fc.fused_ce_fwd_lora_reference(th, tw, txa, tbt, tl,
                                               block_v=64)
    close(lse, jl)
    close(gold, jg)
    args = (th, tw, txa, tbt, tl, lse, torch.from_numpy(dlse),
            torch.from_numpy(dgold))
    dh, dxa = fc.fused_ce_dh_lora_reference(*args, block_v=64)
    close(dh, jdh)
    close(dxa, jdxa)
    dw, dbt = fc.fused_ce_dw_lora_reference(*args, block_v=64)
    close(dw, jdw)
    close(dbt, jdbt)
    no_dw, dbt_only = fc.fused_ce_dw_lora_reference(*args, want_dw=False)
    assert no_dw is None
    close(dbt_only, jdbt)
    # the autograd Function through the CPU wrappers
    leaves = [t.clone().requires_grad_(True) for t in (th, tw, txa, tbt)]
    lse, gold = fc.fused_ce_rows_lora(leaves[0], leaves[1], tl, leaves[2],
                                      leaves[3])
    close(lse, jl)
    obj = (lse * torch.from_numpy(dlse)).sum() \
        + (gold * torch.from_numpy(dgold)).sum()
    for g, want in zip(torch.autograd.grad(obj, leaves),
                       (jdh, jdw, jdxa, jdbt)):
        close(g, want)


def test_lora_wrappers_check_their_operands():
    h, w, lab = make(8, 64, 16, seed=1)
    xa, bt = make_lora(8, 64, 4, seed=1)
    th, tw, txa, tbt, tl = map(torch.from_numpy, (h, w, xa, bt, lab))
    with pytest.raises(ValueError, match="xa"):
        fc.fused_ce_fwd_lora(th, tw, txa[:, :3], tbt, tl)
    with pytest.raises(ValueError, match="xa"):
        fc.fused_ce_fwd_lora(th, tw, txa, tbt[:60], tl)
    wide = torch.zeros(8, fc.MAX_RANK + 1)
    with pytest.raises(ValueError, match="r <="):
        fc.fused_ce_fwd_lora(th, tw, wide, torch.zeros(64, fc.MAX_RANK + 1),
                             tl)


def _head_inputs(seed, B=4, S=33, H=32, V=256, r=4):
    rng = np.random.default_rng(seed)
    hid = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    lab = rng.integers(0, V, (B, S)).astype(np.int32)
    lab[2, 20:] = -100
    A = (rng.normal(size=(H, r)) * 0.2).astype(np.float32)
    Bm = (rng.normal(size=(r, V)) * 0.2).astype(np.float32)
    return hid, w, lab, A, Bm


@pytest.mark.parametrize("impl", ["kernels", "plain", "auto"])
@pytest.mark.parametrize("jax_fused", [True, False])
def test_chunked_loss_with_head_adapter_matches_jax(impl, jax_fused):
    """The chunked loss with an lm_head adapter ([B=4, S=33] in 4 chunks
    of 8 rows a batch row, ignored positions) against the JAX chunked
    loss on its kernel (use_fused_kernel=True) and XLA paths: the sum,
    the count and the gradients of A, B and the hidden states. "kernels"
    is the route a CUDA tensor takes (fused_ce_nll_sum with the head
    adapter over the chunks, through rows 9-11's plain versions)."""
    hid, w, lab, A, Bm = _head_inputs(21)
    scale = 2.0

    def jf(h_, a_, b_):
        return jloss.chunked_lm_cross_entropy_sum(
            h_, jnp.asarray(w), jnp.asarray(lab), num_chunks=4,
            use_fused_kernel=jax_fused, lora_impl="fused",
            lora_head={"A": a_, "B": b_, "scale": jnp.float32(scale)})
    (js, jc), vjp = jax.vjp(jf, *map(jnp.asarray, (hid, A, Bm)))
    jdh, jdA, jdB = vjp((jnp.float32(1.0), np.zeros((), jax.dtypes.float0)))
    th = torch.from_numpy(hid).requires_grad_(True)
    tA = torch.from_numpy(A).requires_grad_(True)
    tB = torch.from_numpy(Bm).requires_grad_(True)
    head = {"A": tA, "B": tB, "scale": torch.tensor(scale)}
    tw, tl = torch.from_numpy(w), torch.from_numpy(lab)
    if impl == "kernels":
        hs, ls = loss._shift_and_chunk(th, tl, -100, 4)
        parts = [fc.fused_ce_nll_sum(h, tw, lb, -100, lora_head=head)
                 for h, lb in zip(hs, ls)]
        s, c = sum(p[0] for p in parts), sum(p[1] for p in parts)
    else:
        s, c = loss.chunked_lm_cross_entropy_sum(th, tw, tl, num_chunks=4,
                                                 impl=impl, lora_head=head)
    close(s, js)
    assert int(c) == int(jc)
    for g, want in zip(torch.autograd.grad(s, [th, tA, tB]),
                       (jdh, jdA, jdB)):
        close(g, want)


def test_naive_lora_impl_takes_the_plain_body():
    """lora_impl "naive" sends an adapted head to the plain chunk body on
    any device: on the CPU, the same numbers as the other routes; the
    head-adapter kernels' counts stay 0."""
    hid, w, lab, A, Bm = _head_inputs(5)
    head = {"A": torch.from_numpy(A), "B": torch.from_numpy(Bm),
            "scale": torch.tensor(1.5)}
    args = (torch.from_numpy(hid), torch.from_numpy(w), torch.from_numpy(lab))
    a = loss.chunked_lm_cross_entropy(*args, num_chunks=4, lora_head=head,
                                      lora_impl="naive")
    b = loss.chunked_lm_cross_entropy(*args, num_chunks=4, lora_head=head)
    close(a, b)
    assert fc.fused_ce_fwd_lora.launches == 0
