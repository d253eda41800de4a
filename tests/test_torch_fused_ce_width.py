"""The fused CE kernels' width rule on the CPU
(mobilefinetuner_tpu_torch/ops/fused_ce.fused_ce_eligible, applied by
ops/loss.use_fused_ce before any launch).

The chunked loss sends a chunk to the fused CE kernels only when every
kernel its forward and backward launch takes the chunk's shape: rows 6
and 7 (and row 8 for a trained head weight), or rows 9, 10 and 11 with a
head adapter, each on its dtype's route. At the Gemma chunk (R 128, V
262,144) the verdict is true at the repo's widths (H 640, 1,152) and
false wherever a plan or the backward wrappers' MAX_HIDDEN refuses
(1,536, and Gemma-3's 2,304 and 2,560, and 3,840); such a chunk takes the
plain chunk body, as the JAX package's `_use_fused_ce` takes its XLA
chunk when `fused_ce_eligible` is false. The route is shown on meta
tensors (a device that is not the CPU, with no card), and the plain
chunk at a small wide-H shape is held against the JAX chunked loss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops import loss as jloss
from mobilefinetuner_tpu_torch.ops import fused_ce as fc
from mobilefinetuner_tpu_torch.ops import loss

R, V = 128, 262144                      # the Gemma chunk: 4 x 32 rows
WIDTHS = (640, 1152, 1536, 2304, 2560, 3840)


def _plans(H, r, dtype, head_grad):
    """{kernel: its plan call} of the chunk's forward and backward on
    `dtype`'s route (every dtype's dW + dbt mode, on fused_ce.cu, has no
    plan: MAX_HIDDEN is its limit)."""
    f32 = dtype == torch.float32
    eb = 2
    if not r:
        plans = {"fwd": (lambda: fc.fwd_tf32_plan(R, V, H, 132)) if f32
                 else (lambda: fc.fwd_mma_plan(R, V, H, 132, eb)),
                 "dh": (lambda: fc.dh_tf32_plan(R, V, H, 132)) if f32
                 else (lambda: fc.dh_mma_plan(R, V, H, 132, eb))}
        if head_grad:
            plans["dw"] = (lambda: fc.dw_tf32_plan(R, V, H, 132)) if f32 \
                else (lambda: fc.dw_mma_plan(R, V, H, 132, eb))
        return plans
    plans = {"fwd_lora": (lambda: fc.fwd_lora_tf32_plan(R, V, H, r, 132))
             if f32 else (lambda: fc.fwd_lora_mma_plan(R, V, H, r, 132, eb)),
             "dh_lora": (lambda: fc.dh_lora_tf32_plan(R, V, H, r, 132))
             if f32 else (lambda: fc.dh_lora_mma_plan(R, V, H, r, 132, eb))}
    if not head_grad:
        plans["dbt"] = (lambda: fc.dbt_tf32_plan(R, V, H, r, 132)) if f32 \
            else (lambda: fc.dbt_mma_plan(R, V, H, r, 132, eb))
    return plans


def _refusals(H, r, dtype, head_grad):
    """The kernels of the chunk that refuse it: plans that raise, and the
    backward wrappers' H + r <= MAX_HIDDEN."""
    out = []
    for name, plan in _plans(H, r, dtype, head_grad).items():
        try:
            plan()
        except ValueError:
            out.append(name)
    if H + r > fc.MAX_HIDDEN:
        out.append("MAX_HIDDEN")
    return out


@pytest.mark.parametrize("head_grad", [False, True])
@pytest.mark.parametrize("r", [0, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", WIDTHS)
def test_width_rule_verdicts_at_the_gemma_chunk(H, dtype, r, head_grad):
    """True at H 640 and 1,152, where every kernel plans; false at 1,536
    (MAX_HIDDEN), 2,304, 2,560 and 3,840 (plans too), each false verdict
    with a refusal behind it."""
    verdict = fc.fused_ce_eligible(R, V, H, r, dtype, head_grad)
    refusals = _refusals(H, r, dtype, head_grad)
    assert verdict == (H <= 1152)
    assert verdict == (not refusals), refusals
    if H >= 2304:        # Gemma-3's widths fail on a layout, not only the
        assert set(refusals) - {"MAX_HIDDEN"}      # wrappers' check
    if H == 1536:        # every plan fits; MAX_HIDDEN (1,522) refuses
        assert refusals == ["MAX_HIDDEN"]


@pytest.mark.parametrize("R_,V_,H,r,dtype", [
    (128, 262144, 644, 0, torch.float32),      # H % 8 != 0
    (128, 262144, 1004, 8, torch.bfloat16),
    (128, 262144, 640, 129, torch.float32),    # rank past MAX_RANK
    (128, 262144, 640, 8, torch.float64),      # no kernel in that dtype
    (128, 262144, 640, 0, torch.int32),
    (0, 262144, 640, 0, torch.float32),        # no rows
    (128, 262144, 1520, 8, torch.float32),     # H + r past MAX_HIDDEN
])
def test_width_rule_refuses_what_no_kernel_takes(R_, V_, H, r, dtype):
    assert not fc.fused_ce_eligible(R_, V_, H, r, dtype)


def test_width_rule_takes_the_presets_at_ragged_shapes():
    """A ragged R and V at the repo's widths, rank 1 to 128."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for H in (640, 1152, 768):
            for r in (0, 1, 3, 128):
                assert fc.fused_ce_eligible(37, 50257, H, r, dtype)
                assert fc.fused_ce_eligible(37, 50257, H, r, dtype, True)


@pytest.mark.parametrize("H,want", [(640, True), (1152, True),
                                    (2560, False)])
def test_width_rule_keeps_row_8_in_f32(H, want):
    """f32 full fine-tuning (the head trains, every CLI's default dtype)
    keeps the fused path at Gemma-3-270M's and Gemma-3-1B's widths, row 8
    on its 3xTF32 kernel's H parts (two and four); Gemma-3-4B's 2,560
    takes the plain chunk."""
    assert fc.fused_ce_eligible(R, V, H, 0, torch.float32,
                                head_grad=True) is want
    if want:
        assert fc.dw_tf32_plan(R, V, H, 132)["n_parts"] == H // 320 + 1 \
            - (H % 320 == 0)


def _meta_case(H, r, head_grad):
    hid = torch.empty(4, 257, H, device="meta", requires_grad=True)
    w = torch.empty(1000, H, device="meta", requires_grad=head_grad)
    lab = torch.zeros(4, 257, dtype=torch.long, device="meta")
    head = None if not r else {
        "A": torch.empty(H, r, device="meta", requires_grad=True),
        "B": torch.empty(r, 1000, device="meta", requires_grad=True),
        "scale": torch.tensor(2.0, device="meta")}
    return hid, w, lab, head


@pytest.mark.parametrize("r,head_grad", [(0, False), (0, True), (8, False),
                                         (8, True)])
@pytest.mark.parametrize("H", [640, 2304, 2560])
def test_wide_h_reaches_the_plain_chunk(monkeypatch, H, r, head_grad):
    """Meta tensors (off the CPU, no card): use_fused_ce, which
    _chunked_nll_sum consults, is true at H 640 and false at Gemma-3's
    2,304 and 2,560; the chunked loss then runs every chunk through the
    fused route or every chunk through the plain body, never a mix."""
    calls = {"fused": 0, "plain": 0}
    real_plain = loss._plain_chunk

    def plain(*a):
        calls["plain"] += 1
        return real_plain(*a)

    def fused(h, *a, **k):
        calls["fused"] += 1
        return (torch.zeros((), device=h.device),
                torch.zeros((), dtype=torch.long, device=h.device))
    monkeypatch.setattr(loss, "_plain_chunk", plain)
    monkeypatch.setattr(loss, "fused_ce_nll_sum", fused)
    hid, w, lab, head = _meta_case(H, r, head_grad)
    want = H == 640
    assert loss.use_fused_ce(hid, w, 8, "auto", head, "auto") is want
    assert not loss.use_fused_ce(hid, w, 8, "plain", head, "auto")
    loss.chunked_lm_cross_entropy_sum(hid, w, lab, num_chunks=8,
                                      lora_head=head)
    assert calls == ({"fused": 8, "plain": 0} if want
                     else {"fused": 0, "plain": 8})


def test_use_fused_ce_keeps_the_cpu_and_naive_routes():
    """The CPU and the adapter's naive oracle take the plain body at any
    width."""
    hid = torch.zeros(2, 9, 640)
    w = torch.zeros(100, 640)
    assert not loss.use_fused_ce(hid, w, 2, "auto", None, "auto")
    m_hid, m_w, _, head = _meta_case(640, 8, False)
    assert not loss.use_fused_ce(m_hid, m_w, 8, "auto", head, "naive")
    assert loss.use_fused_ce(m_hid, m_w, 8, "auto", head, "fused")


@pytest.mark.parametrize("r", [0, 4])
def test_wide_h_chunked_loss_matches_jax(r):
    """The chunked loss at Gemma-3-4B's width (H 2,560) on a small chunk
    ([2, 17] in 4 chunks, V 384, ignored positions, with and without a
    head adapter): the sum, the count and the gradients of the hidden
    states (and A, B) against the JAX chunked loss on its XLA path."""
    B, S, H, Vs = 2, 17, 2560, 384
    rng = np.random.default_rng(r + 3)
    hid = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(Vs, H)) * 0.02).astype(np.float32)
    lab = rng.integers(0, Vs, (B, S)).astype(np.int32)
    lab[1, 12:] = -100
    A = (rng.normal(size=(H, r)) * 0.02).astype(np.float32)
    Bm = (rng.normal(size=(r, Vs)) * 0.1).astype(np.float32)
    import jax
    jhead = (lambda a, b: {"A": a, "B": b, "scale": jnp.float32(2.0)}) \
        if r else (lambda a, b: None)

    def jf(h_, a_, b_):
        return jloss.chunked_lm_cross_entropy_sum(
            h_, jnp.asarray(w), jnp.asarray(lab), num_chunks=4,
            use_fused_kernel=False, lora_head=jhead(a_, b_),
            lora_impl="naive")
    (js, jc), vjp = jax.vjp(jf, *map(jnp.asarray, (hid, A, Bm)))
    want = vjp((jnp.float32(1.0), np.zeros((), jax.dtypes.float0)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (hid, A, Bm)]
    head = {"A": leaves[1], "B": leaves[2],
            "scale": torch.tensor(2.0)} if r else None
    s, c = loss.chunked_lm_cross_entropy_sum(
        leaves[0], torch.from_numpy(w), torch.from_numpy(lab), num_chunks=4,
        lora_head=head)
    assert int(c) == int(jc)
    np.testing.assert_allclose(float(s.detach()), float(js), rtol=1e-5,
                               atol=1e-4)
    grads = torch.autograd.grad(s, leaves if r else leaves[:1])
    for g, jg in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)
