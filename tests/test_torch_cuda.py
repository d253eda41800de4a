"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA inputs. Marked `cuda`: without an NVIDIA card and
nvcc every test here skips (the CPU run cannot build or launch a kernel).
On a machine with a card: `python -m pytest tests/test_torch_cuda.py`.
`chip_smoke.py` runs the same comparisons at the serving shapes."""

import dataclasses
import types

import pytest
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.kernels import build
from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec, init_lora_gemma3,
                                                 init_lora_gpt2)
from mobilefinetuner_tpu_torch.models import gemma3, generate, gpt2
from mobilefinetuner_tpu_torch.models.lora_apply import maybe_lora
from mobilefinetuner_tpu_torch.ops import attention as attn
from mobilefinetuner_tpu_torch.ops import decode_attention as da
from mobilefinetuner_tpu_torch.ops import flash_attention as fa
from mobilefinetuner_tpu_torch.ops import fused_ce as fc
from mobilefinetuner_tpu_torch.ops import loss
from mobilefinetuner_tpu_torch.ops import lora_fused as lf
from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    build.build_all()
    return torch.device("cuda", 0)


def _randn(dev, dtype, *shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


@pytest.mark.parametrize("dtype,D,Hkv,S,window,tol", [
    (torch.float32, 64, 4, 200, 24, 1e-4),
    (torch.bfloat16, 64, 12, 128, None, 1e-2),
    (torch.bfloat16, 128, 2, 96, None, 1e-2),
    (torch.float16, 256, 1, 70, 16, 1e-2),
])
def test_flash_kernel_matches_plain(dev, dtype, D, Hkv, S, window, tol):
    B, Hq = 2, 4 if Hkv < 12 else 12
    q = _randn(dev, dtype, B, Hq, S, D, seed=1)
    k = _randn(dev, dtype, B, Hkv, S, D, seed=2)
    v = _randn(dev, dtype, B, Hkv, S, D, seed=3)
    pad = torch.ones(B, S, device=dev)
    pad[1, S - 30:] = 0
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, pad, sliding_window=window)
    assert fa.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad,
                                                sliding_window=window)
    torch.cuda.synchronize()
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,Hq,Hkv,S,D,window,tol", [
    (torch.bfloat16, 12, 12, 512, 64, None, 1e-2),
    (torch.bfloat16, 12, 12, 1024, 64, None, 1e-2),
    (torch.bfloat16, 4, 1, 512, 256, 512, 1e-2),
    (torch.bfloat16, 4, 1, 1024, 256, 512, 1e-2),
    (torch.float32, 12, 12, 512, 64, None, 1e-4),
    (torch.float32, 4, 1, 512, 256, 512, 1e-4),
])
def test_flash_kernel_matches_plain_at_mmlu_buckets(dev, dtype, Hq, Hkv, S,
                                                    D, window, tol):
    """The forward at eval_mmlu's bucket shapes (16 prompts, causal, no
    padding mask: GPT-2's heads; Gemma's 4 over 1 with the sliding
    layers' window, which cuts at S 1024): out within `tol`, lse within
    1e-4 of the plain version."""
    B = 16
    q = _randn(dev, dtype, B, Hq, S, D, seed=1)
    k = _randn(dev, dtype, B, Hkv, S, D, seed=2)
    v = _randn(dev, dtype, B, Hkv, S, D, seed=3)
    kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window)
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, None, **kw)
    assert fa.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = fa.flash_attention_reference(q, k, v, None, **kw)
    torch.cuda.synchronize()
    assert float((out.float() - ref.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,G,D,tol", [
    (torch.float32, 2, 64, 1e-4), (torch.bfloat16, 1, 64, 2e-2),
    (torch.bfloat16, 4, 256, 2e-2), (torch.float16, 1, 64, 2e-2),
    (torch.float16, 4, 256, 2e-2), (torch.float32, 4, 256, 1e-4),
    (torch.bfloat16, 2, 128, 2e-2), (torch.bfloat16, 6, 64, 2e-2)])
def test_paged_kernel_matches_plain(dev, dtype, G, D, tol):
    """Row 12 against paged_attention: bf16 / f16 on
    paged_decode_attention_vec.cu (one chunk at G 1, several with a merge
    where the slots are few), f32 on paged_decode_attention_vec_f32.cu,
    D 256 in f32 too. Every pool row no slot attends (masked columns of live
    pages, unused table rows, the trash page but the idle slot's column)
    poisoned with Inf in K and NaN in V leaves ctx bit for bit as it was;
    two calls are bit-identical; a CUDA graph of the call replays it."""
    S, KV, bT, M, L = 5, 2, 16, 4, 3
    NB = S * M + 1
    pk = _randn(dev, dtype, NB, L, KV, bT, D, seed=4)
    pv = _randn(dev, dtype, NB, L, KV, bT, D, seed=5)
    pk[0] = pv[0] = 0
    q = _randn(dev, dtype, S, KV, G, D, seed=6)
    tbl = torch.zeros(S, M, dtype=torch.int32)
    pos = torch.tensor([63, 17, 3, 40, 0])
    for s in range(S):
        tbl[s, :int(pos[s]) // bT + 1] = torch.arange(
            1 + s * M, 1 + s * M + int(pos[s]) // bT + 1)
    ok = torch.arange(M * bT)[None] <= pos[:, None]
    ok[0, :20] = False                       # a window: a whole page out
    attended = torch.zeros(NB, bT, dtype=torch.bool)
    for s in range(S):
        cols = torch.nonzero(ok[s]).flatten()
        attended[tbl[s, cols // bT].long(), cols % bT] = True
    tbl, ok = tbl.to(dev), ok.to(dev)
    n0 = da.paged_decode_attention.launches
    ctx = da.paged_decode_attention(q, pk, pv, tbl, 2, ok, D ** -0.5)
    assert da.paged_decode_attention.launches == n0 + 1
    ref = da.paged_attention(q, pk, pv, tbl, 2, ok, D ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ctx).all())
    assert float((ctx - ref).abs().max()) <= tol
    dead = ~attended.to(dev)[:, None, None, :, None]
    kp = pk.masked_fill(dead, float("inf"))
    vp = pv.masked_fill(dead, float("nan"))
    poisoned = da.paged_decode_attention(q, kp, vp, tbl, 2, ok, D ** -0.5)
    again = da.paged_decode_attention(q, kp, vp, tbl, 2, ok, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, ctx) and torch.equal(again, ctx)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.paged_decode_attention(q, kp, vp, tbl, 2, ok, D ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = da.paged_decode_attention(q, kp, vp, tbl, 2, ok,
                                             D ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, ctx)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 64, device=dev).transpose(1, 2)
        fa.flash_attention_fwd(t, t, t)
    pk = torch.zeros(3, 1, 1, 8, 32, device=dev)
    with pytest.raises(ValueError, match="does not take"):
        da.paged_decode_attention(
            torch.zeros(1, 1, 1, 32, device=dev), pk, pk,
            torch.zeros(1, 1, dtype=torch.int32, device=dev), 0,
            torch.ones(1, 8, dtype=torch.bool, device=dev), 1.0)


def test_auto_dispatch_raises_where_the_kernels_do_not_take(dev):
    """impl="auto" never serves a CUDA tensor through a plain version: a
    head dim the kernels do not take, or an attn_mask matrix, raises."""
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError, match="D in"):
        attn.attention(q, q, q, impl="auto")
    q64 = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="attn_mask"):
        attn.attention(q64, q64, q64, impl="auto",
                       attn_mask=torch.ones(8, 8, dtype=torch.bool,
                                            device=dev))
    cfg = GPT2Config.tiny(vocab_size=50)                # D = 16
    params = gpt2.init_params(cfg, seed=0, device=dev)
    shape = (3, cfg.n_layer, cfg.n_head, 8, cfg.head_dim)
    pk = torch.zeros(shape, device=dev)
    pv = torch.zeros(shape, device=dev)
    tok = torch.tensor([1], device=dev)
    pos = torch.tensor([0], device=dev)
    tbl = torch.ones(1, 2, dtype=torch.int32, device=dev)
    n0 = da.paged_decode_attention.launches
    with pytest.raises(ValueError, match="does not take"):
        generate.gpt2_decode_step_paged(cfg, params, pk, pv, tok, pos, tbl,
                                        attn_impl="auto")
    assert da.paged_decode_attention.launches == n0
    logits, _, _ = generate.gpt2_decode_step_paged(
        cfg, params, pk, pv, tok, pos, tbl, attn_impl="plain")
    assert logits.shape == (1, cfg.vocab_size)


def test_engine_kernel_path_matches_plain_path(dev):
    """A small GPT-2 with D = 64 served in f32 on the card through the
    kernels and through the plain versions: identical greedy tokens."""
    cfg = dataclasses.replace(GPT2Config.tiny(vocab_size=300), n_embd=128,
                              n_head=2, n_layer=2, n_positions=128)
    params = gpt2.init_params(cfg, seed=0, device=dev)
    outs = []
    for impl in ("auto", "plain"):
        fa.flash_attention_fwd.launches = 0
        da.paged_decode_attention.launches = 0
        eng = ServeEngine("gpt2", cfg, params, ServeConfig(
            num_slots=3, block_T=16, num_blocks=32, max_prompt=32,
            max_new_tokens=16, attn_impl=impl), device=dev)
        reqs = [eng.submit(list(range(1 + i, 6 + 3 * i))) for i in range(5)]
        eng.drain()
        outs.append([r.tokens for r in reqs])
        n = cfg.n_layer if impl == "auto" else 0
        assert fa.flash_attention_fwd.launches == n * eng.prefills
        assert da.paged_decode_attention.launches == n * eng.decode_steps
    assert outs[0] == outs[1]


def _rel_err(a, b):
    """max |a - b| over max(1, max |b|): the tolerance scale for outputs
    of a few units rounded to bf16/f16."""
    b = b.float()
    return float((a.float() - b).abs().max()) / max(1.0,
                                                    float(b.abs().max()))


def _flash_case(dev, dtype, B, Hq, Hkv, S, D, n_pad, seed):
    q = _randn(dev, dtype, B, Hq, S, D, seed=seed)
    k = _randn(dev, dtype, B, Hkv, S, D, seed=seed + 1)
    v = _randn(dev, dtype, B, Hkv, S, D, seed=seed + 2)
    do = _randn(dev, dtype, B, Hq, S, D, seed=seed + 3)
    pad = torch.ones(B, S, device=dev)
    if n_pad:
        pad[-1, S - n_pad:] = 0
    return q, k, v, do, pad


# (dtype, B, Hq, Hkv, S, D, n_pad, window, p_drop, tol): tolerance of
# _rel_err; f32 differs only in summation order (dQ atomics), bf16/f16 by
# the rounding of dq/dk/dv to 8/11 bits
BWD_CASES = [
    (torch.bfloat16, 2, 12, 12, 128, 64, 0, None, 0.0, 2e-2),
    (torch.float32, 2, 4, 2, 200, 64, 37, 24, 0.0, 1e-5),
    (torch.bfloat16, 1, 4, 4, 96, 128, 10, None, 0.0, 2e-2),
    (torch.float16, 1, 8, 2, 130, 256, 0, None, 0.0, 5e-3),
    (torch.float32, 2, 4, 4, 128, 64, 0, None, 0.1, 1e-5),
    (torch.bfloat16, 2, 4, 4, 128, 64, 28, None, 0.1, 2e-2),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernels_match_plain(dev, case):
    dtype, B, Hq, Hkv, S, D, n_pad, window, p_drop, tol = case
    q, k, v, do, pad = _flash_case(dev, dtype, B, Hq, Hkv, S, D, n_pad, 11)
    kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window,
              p_drop=p_drop, seed=12345 if p_drop else None)
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **{
        k_: kw[k_] for k_ in ("scale", "sliding_window", "p_drop",
                              "seed")})
    ref_out, _ = fa.flash_attention_reference(q, k, v, pad, **{
        k_: kw[k_] for k_ in ("scale", "sliding_window", "p_drop",
                              "seed")})
    assert _rel_err(out, ref_out) <= max(tol, 1e-5)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    want = fa.flash_bwd_merged_reference(q, k, v, pad, lse, delta, do, **kw)
    want_split = fa.flash_bwd_split_reference(q, k, v, pad, lse, delta, do,
                                              **kw)
    n = (fa.flash_attention_bwd_merged.launches,
         fa.flash_attention_bwd_dq.launches,
         fa.flash_attention_bwd_dkv.launches)
    got = fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, do, **kw)
    got_split = fa.flash_attention_bwd_split(q, k, v, pad, lse, delta, do,
                                             **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_merged.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (n[0] + 1, n[1] + 1,
                                                     n[2] + 1)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, got_split, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        assert _rel_err(a, c) <= tol, name
        assert _rel_err(b, want_split[("dq", "dk", "dv").index(name)]) \
            <= tol, name


def test_flash_tensor_core_kernel_d256_gqa_window_ragged(dev):
    """bf16 at D = 256 with GQA 4:1, a window that ends inside a key tile
    (40 keys) and a ragged S (200, a padded tail too), against the plain
    version at the bf16 tolerances (out 1e-2, lse 1e-4)."""
    q, k, v, _, pad = _flash_case(dev, torch.bfloat16, 2, 8, 2, 200, 256,
                                  50, 21)
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, pad, sliding_window=40)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad,
                                                sliding_window=40)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,B,Hq,Hkv,S,D,n_pad,window,p_drop", [
    (torch.bfloat16, 4, 4, 1, 256, 256, 0, 512, 0.0),   # Gemma-3's step
    (torch.bfloat16, 2, 8, 2, 200, 256, 50, 40, 0.1),   # ragged, dropout
    (torch.float16, 2, 8, 2, 96, 128, 10, None, 0.1),
])
def test_flash_backward_tensor_core_kernel(dev, dtype, B, Hq, Hkv, S, D,
                                           n_pad, window, p_drop):
    """Row 2's tensor-core kernel against the plain merged version (one
    launch a call; dq, dk, dv in the inputs' dtype) at Gemma-3's training
    shape (GQA 4:1, the 512 window) and at D 256 with a ragged S of 200,
    a padded tail, a window that ends inside a key block and dropout 0.1;
    dK and dV, written once an element, repeat bit for bit (dQ's atomic
    sums need not)."""
    q, k, v, do, pad = _flash_case(dev, dtype, B, Hq, Hkv, S, D, n_pad, 31)
    kw = dict(scale=D ** -0.5, is_causal=True, sliding_window=window,
              p_drop=p_drop, seed=4242 if p_drop else None)
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    args = (q, k, v, pad, lse, delta, do)
    n0 = fa.flash_attention_bwd_merged.launches
    got = fa.flash_attention_bwd_merged(*args, **kw)
    again = fa.flash_attention_bwd_merged(*args, **kw)
    want = fa.flash_bwd_merged_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_merged.launches == n0 + 2
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        assert _rel_err(a, b) <= tol, name
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


def test_fused_ce_fwd_tensor_core_kernel(dev):
    """Row 6 in bf16 at the Gemma-3 chunk (R 128, V 262,144, H 640) and at
    R 37, a ragged V (50,257) and H 1,152 against the plain version (lse
    and gold, max abs error <= 2e-3); two calls give identical bits (no
    atomics); one launch a call."""
    for R, V, H in ((128, 262144, 640), (37, 50257, 1152)):
        h, w, lab, _, _ = _ce_case(dev, torch.bfloat16, R, V, H, seed=R)
        n0 = fc.fused_ce_fwd.launches
        lse, gold = fc.fused_ce_fwd(h, w, lab)
        lse2, gold2 = fc.fused_ce_fwd(h, w, lab)
        rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
        torch.cuda.synchronize()
        assert fc.fused_ce_fwd.launches == n0 + 2
        assert torch.equal(lse, lse2) and torch.equal(gold, gold2)
        assert float((lse - rl).abs().max()) <= 2e-3
        assert float((gold - rg).abs().max()) <= 2e-3


def test_kernels_are_chosen_by_dtype(dev, monkeypatch):
    """bf16 / f16 launch the tensor-core sources, f32 the 3xTF32 ones for
    the flash forward (row 1), merged backward (row 2), the fused CE
    forward (row 6), dh (row 7), dW (row 8), head-adapter forward (row 9)
    and dh + dxa (row 10) and the dbt-only mode of row 11; row 11's dW +
    dbt mode loads fused_ce.cu in every dtype: the libraries the wrappers
    load are recorded."""
    loaded = []
    real = build.load

    def record(name):
        loaded.append(name)
        return real(name)
    monkeypatch.setattr(build, "load", record)
    for dtype, fwd, dh in (
            (torch.bfloat16, "flash_attention_fwd_mma", "fused_ce_dh_mma"),
            (torch.float16, "flash_attention_fwd_mma", "fused_ce_dh_mma"),
            (torch.float32, "flash_attention_fwd_tf32", "fused_ce_dh_tf32")):
        q, k, v, do, pad = _flash_case(dev, dtype, 1, 2, 2, 64, 64, 0, 3)
        loaded.clear()
        out, lse = fa.flash_attention_fwd(q, k, v, pad)
        assert loaded == [fwd]
        delta = (do.float() * out.float()).sum(-1, keepdim=True)
        loaded.clear()
        fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, do,
                                      scale=0.125)
        assert loaded == [fwd.replace("_fwd", "_bwd_merged")]
        h, w, lab, dl, dg = _ce_case(dev, dtype, 16, 300, 64, 4)
        mma = dtype != torch.float32
        loaded.clear()
        fc.fused_ce_fwd(h, w, lab)
        assert loaded == ["fused_ce_fwd_mma" if mma else "fused_ce_fwd_tf32"]
        lse = fc.fused_ce_fwd_reference(h, w, lab)[0]
        loaded.clear()
        fc.fused_ce_bwd_dh(h, w, lab, lse, dl, dg)
        assert loaded == [dh]
        loaded.clear()
        fc.fused_ce_bwd_dw(h, w, lab, lse, dl, dg)
        assert loaded == ["fused_ce_dw_mma" if mma else "fused_ce_dw_tf32"]
        xa, bt = _lora_case(dev, dtype, 16, 300, 4, 5)
        loaded.clear()
        fc.fused_ce_bwd_dh_lora(h, w, xa, bt, lab, lse, dl, dg)
        assert loaded == [dh.replace("_dh_", "_dh_lora_")]
        loaded.clear()
        fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
        assert loaded == ["fused_ce_fwd_lora_mma" if mma
                          else "fused_ce_fwd_lora_tf32"]
        loaded.clear()
        fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, lse, dl, dg,
                                want_dw=False)
        assert loaded == ["fused_ce_dbt_mma" if mma else "fused_ce_dbt_tf32"]
        loaded.clear()
        fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, lse, dl, dg)
        assert loaded == ["fused_ce"]
    torch.cuda.synchronize()


def test_tensor_core_wrappers_refuse_what_their_kernels_do_not_take(dev):
    """Row 1 refuses a head dim outside {64, 128, 256} in bf16, rows 6,
    7, 8, 9, 10 and 11 (dbt-only) a bf16 H that is not a multiple of 8,
    rows 2 and 6 16-bit operands that are not 16-byte aligned, before any
    launch."""
    q = torch.zeros(1, 2, 8, 96, device=dev, dtype=torch.bfloat16)
    n0 = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_fwd(q, q, q)
    assert fa.flash_attention_fwd.launches == n0
    h, w, lab, dl, dg = _ce_case(dev, torch.bfloat16, 8, 100, 1004, 2)
    n0 = fc.fused_ce_bwd_dh.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_bwd_dh(h, w, lab, dl, dl, dg)
    assert fc.fused_ce_bwd_dh.launches == n0
    n0 = fc.fused_ce_bwd_dw.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_bwd_dw(h, w, lab, dl, dl, dg)
    assert fc.fused_ce_bwd_dw.launches == n0
    xa, bt = _lora_case(dev, torch.bfloat16, 8, 100, 8, 2)
    n0 = fc.fused_ce_bwd_dh_lora.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_bwd_dh_lora(h, w, xa, bt, lab, dl, dl, dg)
    assert fc.fused_ce_bwd_dh_lora.launches == n0
    n0 = fc.fused_ce_fwd_lora.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    assert fc.fused_ce_fwd_lora.launches == n0
    n0 = fc.fused_ce_bwd_dw_lora.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, dl, dl, dg,
                                want_dw=False)
    assert fc.fused_ce_bwd_dw_lora.launches == n0
    n0 = fc.fused_ce_fwd.launches
    with pytest.raises(ValueError, match="H % 8"):
        fc.fused_ce_fwd(h, w, lab)
    h, w, lab, _, _ = _ce_case(dev, torch.bfloat16, 8, 100, 72, 2)
    hm = torch.empty(8 * 72 + 1, device=dev, dtype=torch.bfloat16)[1:]
    hm = hm.view(8, 72).copy_(h)          # 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="aligned"):
        fc.fused_ce_fwd(hm, w, lab)
    assert fc.fused_ce_fwd.launches == n0
    q, k, v, do, pad = _flash_case(dev, torch.bfloat16, 1, 2, 2, 64, 64, 0,
                                   3)
    out, lse = fa.flash_attention_fwd(q, k, v, pad)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    dm = torch.empty(do.numel() + 1, device=dev, dtype=do.dtype)[1:]
    dm = dm.view(do.shape).copy_(do)
    n0 = fa.flash_attention_bwd_merged.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, dm,
                                      scale=0.125)
    assert fa.flash_attention_bwd_merged.launches == n0


# (B, Hq, Hkv, S, D, n_pad, causal, window, p_drop): the f32 (3xTF32)
# kernels at D 128 and 256, against the plain versions at the f32
# tolerances (out and lse 1e-4, dq / dk / dv 1e-5 of max(1, |ref|))
TF32_CASES = [
    (2, 8, 8, 90, 128, 29, False, None, 0.0),    # non-causal, ragged S
    (2, 8, 2, 200, 256, 50, True, 40, 0.1),      # GQA 4:1, window, dropout
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_flash_tf32_kernels_match_plain(dev, case):
    B, Hq, Hkv, S, D, n_pad, causal, window, p_drop = case
    q, k, v, do, pad = _flash_case(dev, torch.float32, B, Hq, Hkv, S, D,
                                   n_pad, 41)
    kw = dict(scale=D ** -0.5, is_causal=causal, sliding_window=window,
              p_drop=p_drop, seed=2026 if p_drop else None)
    n = (fa.flash_attention_fwd.launches,
         fa.flash_attention_bwd_merged.launches)
    out, lse = fa.flash_attention_fwd(q, k, v, pad, **kw)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, pad, **kw)
    delta = (do * out).sum(-1, keepdim=True)
    got = fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, do, **kw)
    want = fa.flash_bwd_merged_reference(q, k, v, pad, lse, delta, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_merged.launches) == (n[0] + 1, n[1] + 1)
    assert float((out - ref).abs().max()) <= 1e-4
    assert float((lse - ref_lse).abs().max()) <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.isfinite(a).all() and _rel_err(a, b) <= 1e-5, name


def test_f32_launches_reach_the_tf32_symbols(dev, monkeypatch):
    """An f32 forward and merged backward call the `_tf32` C entries and
    no FMA entry (mft_flash_attention_fwd / _bwd_merged); an f32 q that
    is not 16-byte aligned is refused before any launch; the f32 fused CE
    forward, head-adapter forward and dbt-only calls reach
    mft_fused_ce_fwd_tf32, mft_fused_ce_fwd_lora_tf32 and
    mft_fused_ce_dbt_tf32 and no fused_ce.cu entry."""
    called = []
    real = fa._fn

    def record(lib, sym, n_ptrs):
        called.append((lib, sym))
        return real(lib, sym, n_ptrs)
    monkeypatch.setattr(fa, "_fn", record)
    q, k, v, do, pad = _flash_case(dev, torch.float32, 1, 4, 2, 64, 64, 0,
                                   5)
    out, lse = fa.flash_attention_fwd(q, k, v, pad)
    delta = (do * out).sum(-1, keepdim=True)
    fa.flash_attention_bwd_merged(q, k, v, pad, lse, delta, do, scale=0.125)
    torch.cuda.synchronize()
    assert called == [
        ("flash_attention_fwd_tf32", "mft_flash_attention_fwd_tf32"),
        ("flash_attention_bwd_merged_tf32",
         "mft_flash_attention_bwd_merged_tf32")]
    qm = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape).copy_(q)
    n0 = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(qm, k, v, pad)
    assert fa.flash_attention_fwd.launches == n0 and len(called) == 2
    # the fused CE rows 6, 9 and 11 (dbt only) in f32: their `_tf32`
    # entries, no fused_ce.cu entry
    ce_called = []
    real_fn = fc._fn

    def record_fn(sym, n_ptrs, n_ints, lib="fused_ce"):
        ce_called.append((lib, sym))
        return real_fn(sym, n_ptrs, n_ints, lib)
    monkeypatch.setattr(fc, "_fn", record_fn)
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, 16, 300, 64, 4)
    xa, bt = _lora_case(dev, torch.float32, 16, 300, 4, 5)
    lse = fc.fused_ce_fwd(h, w, lab)[0]
    fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    fc.fused_ce_bwd_dw_lora(h, w, xa, bt, lab, lse, dl, dg, want_dw=False)
    torch.cuda.synchronize()
    assert ce_called == [("fused_ce_fwd_tf32", "mft_fused_ce_fwd_tf32"),
                         ("fused_ce_fwd_lora_tf32",
                          "mft_fused_ce_fwd_lora_tf32"),
                         ("fused_ce_dbt_tf32", "mft_fused_ce_dbt_tf32")]


def test_flash_autograd_launches_the_backward_kernels(dev):
    """torch.autograd through flash_attention on the card: the forward
    and the backward kernels launch, and the grads equal the plain
    versions' on the same inputs."""
    q, k, v, do, pad = _flash_case(dev, torch.float32, 2, 4, 2, 128, 64, 9,
                                   21)
    for impl, counts in (("merged", (1, 0, 0)), ("split", (0, 1, 1))):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n = (fa.flash_attention_bwd_merged.launches,
             fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches)
        out = fa.flash_attention(*leaves, padding_mask=pad, bwd_impl=impl)
        grads = torch.autograd.grad(out, leaves, do)
        assert tuple(c - c0 for c, c0 in zip(
            (fa.flash_attention_bwd_merged.launches,
             fa.flash_attention_bwd_dq.launches,
             fa.flash_attention_bwd_dkv.launches), n)) == counts
        _, lse = fa.flash_attention_reference(q, k, v, pad)
        delta = (do * out.detach()).sum(-1, keepdim=True)
        want = fa.flash_bwd_merged_reference(q, k, v, pad, lse, delta, do,
                                             scale=0.125)
        for a, b in zip(grads, want):
            assert _rel_err(a, b) <= 1e-5


@pytest.mark.parametrize("dtype,N,d_out,r,tol", [
    (torch.bfloat16, 1024, 2304, 8, 1e-2),
    (torch.bfloat16, 1024, 768, 8, 1e-2),
    (torch.float32, 1000, 768, 8, 1e-5),
    (torch.float16, 37, 300, 16, 1e-2),
    (torch.float32, 64, 512, 128, 1e-5),
    (torch.bfloat16, 256, 262144, 8, 1e-2),     # Gemma's lm_head: d_out V
])
def test_lora_epilogue_kernel_matches_plain(dev, dtype, N, d_out, r, tol):
    y = _randn(dev, dtype, N, d_out, seed=31)
    xa = _randn(dev, dtype, N, r, seed=32)
    b = _randn(dev, dtype, r, d_out, seed=33)
    one = torch.tensor(1.0, device=dev)
    n0 = lf.lora_epilogue.launches
    m0 = lf.lora_epilogue.by_shape[(dtype, N, d_out)]
    out, _ = lf.lora_epilogue(y, xa, b, one)
    assert lf.lora_epilogue.launches == n0 + 1
    assert lf.lora_epilogue.by_shape[(dtype, N, d_out)] == m0 + 1
    ref = lf.lora_epilogue_reference(y, xa, b, one)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _rel_err(out, ref) <= tol


@pytest.mark.parametrize("dtype,N,d_out,r", [
    (torch.bfloat16, 1024, 2304, 8),       # GPT-2 attn_qkv
    (torch.bfloat16, 1024, 256, 8),        # Gemma k/v: one row a thread
    (torch.bfloat16, 8, 2304, 8),          # generate's decode shapes
    (torch.bfloat16, 4, 262144, 8),        # the head adapter's lm_head
    (torch.float16, 37, 300, 128),         # 8-byte vectors, rank 128
    (torch.bfloat16, 33, 1000, 20),        # a rank past one slab of 8
    (torch.float16, 5, 301, 3),            # 2-byte vectors
])
def test_lora_epilogue_vec_kernel_folds_the_scale(dev, dtype, N, d_out, r):
    """The 16-bit kernel (csrc/lora_epilogue_vec.cu) with the scale read
    from the device: within 1e-2 of the plain version, its xs bit for bit
    the composition's round(f32(xa) * scale), two calls bit-identical."""
    y = _randn(dev, dtype, N, d_out, seed=41)
    xa = _randn(dev, dtype, N, r, seed=42)
    b = _randn(dev, dtype, r, d_out, seed=43)
    s = torch.tensor(0.37, device=dev)
    n0 = lf.lora_epilogue.launches
    out, xs = lf.lora_epilogue(y, xa, b, s)
    out2, _ = lf.lora_epilogue(y, xa, b, s)
    assert lf.lora_epilogue.launches == n0 + 2
    ref = lf.lora_epilogue_reference(y, xa, b, s)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-2
    assert torch.equal(xs, (xa.float() * s).to(dtype))
    assert torch.equal(out, out2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_lora_epilogue_add_grads_match_the_composition(dev, dtype):
    """lora_epilogue_add on the card: the output within the kernel's
    tolerance of the unfolded composition (scale folded by torch, then the
    plain epilogue), dy = g bit for bit and dxa, dB within 1e-5."""
    y = _randn(dev, dtype, 2, 64, 768, seed=44)
    xa = _randn(dev, dtype, 2, 64, 8, seed=45)
    b = _randn(dev, dtype, 8, 768, seed=46)
    g = _randn(dev, dtype, 2, 64, 768, seed=47)
    s = torch.tensor(2.0, device=dev)
    res = []
    for fold in (True, False):
        leaves = [t.clone().requires_grad_(True) for t in (y, xa, b)]
        if fold:
            out = lf.lora_epilogue_add(*leaves, s)
        else:
            xs = (leaves[1].float() * s).to(dtype)
            out = (leaves[0].float() + xs.float() @ leaves[2].float()) \
                .to(dtype)
        res.append([out.detach(), *torch.autograd.grad(out, leaves, g)])
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel_err(res[0][0], res[1][0]) <= tol
    assert torch.equal(res[0][1], res[1][1])                  # dy = g
    for a, w in zip(res[0][2:], res[1][2:]):                  # dxa, dB
        assert _rel_err(a, w) <= 1e-5


def test_epilogue_and_decode_are_chosen_by_dtype(dev, monkeypatch):
    """bf16 / f16 load lora_epilogue_vec.cu, decode_attention_mma.cu and
    paged_decode_attention_vec.cu, f32 lora_epilogue_vec_f32.cu,
    decode_attention_split_f32.cu and paged_decode_attention_vec_f32.cu
    (the first versions of rows 12 and 13 on no path)."""
    loaded = []
    real = build.load

    def record(name):
        loaded.append(name)
        return real(name)
    monkeypatch.setattr(build, "load", record)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        mma = dtype != torch.float32
        y = _randn(dev, dtype, 16, 64, seed=1)
        xa = _randn(dev, dtype, 16, 4, seed=2)
        b = _randn(dev, dtype, 4, 64, seed=3)
        loaded.clear()
        lf.lora_epilogue(y, xa, b, torch.tensor(2.0, device=dev))
        assert loaded == ["lora_epilogue_vec" if mma
                          else "lora_epilogue_vec_f32"]
        q, kc, vc, ok = _decode_case(dev, dtype, 2, 1, 4, 70, 64, 5)
        loaded.clear()
        da.decode_attention(q, kc, vc, ok, 0.125)
        assert loaded == ["decode_attention_mma" if mma
                          else "decode_attention_split_f32"]
        pq = _randn(dev, dtype, 2, 1, 4, 256, seed=6)
        pk = _randn(dev, dtype, 3, 1, 1, 16, 256, seed=7)
        tbl = torch.ones(2, 1, dtype=torch.int32, device=dev)
        loaded.clear()
        da.paged_decode_attention(pq, pk, pk, tbl, 0,
                                  ok[:, :16].contiguous(), 0.0625)
        assert loaded == ["paged_decode_attention_vec" if mma
                          else "paged_decode_attention_vec_f32"]
    torch.cuda.synchronize()


def test_backward_and_epilogue_wrappers_raise(dev):
    """A CUDA tensor the new kernels do not take raises: the backward at
    D = 32, the epilogue at rank 200, and impl="auto" at a LoRA site of
    rank 200 (never the naive order on the card)."""
    q = torch.zeros(1, 2, 8, 32, device=dev)
    lse = torch.zeros(1, 2, 8, 1, device=dev)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_bwd_merged(q, q, q, None, lse, lse, q, scale=1.0)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention_bwd_dq(q, q, q, None, lse, lse, q, scale=1.0)
    y = torch.zeros(4, 1024, device=dev)
    with pytest.raises(ValueError, match="rank"):
        lf.lora_epilogue(y, torch.zeros(4, 200, device=dev),
                         torch.zeros(200, 1024, device=dev),
                         torch.tensor(1.0, device=dev))
    entry = {"A": torch.zeros(1024, 200, device=dev),
             "B": torch.zeros(200, 1024, device=dev),
             "scale": torch.tensor(2.0, device=dev)}
    with pytest.raises(ValueError, match="rank"):
        maybe_lora(y, torch.zeros(4, 1024, device=dev), entry)
    assert maybe_lora(y, torch.zeros(4, 1024, device=dev), entry,
                      impl="naive").shape == y.shape


def test_train_step_kernel_path_matches_plain_path(dev):
    """A small GPT-2 (D = 64) with a rank-8 LoRA in f32 on the card: loss
    and LoRA grads through the flash fwd/bwd and epilogue kernels against
    the plain attention and the naive LoRA order."""
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    cfg = dataclasses.replace(GPT2Config.tiny(vocab_size=300), n_embd=128,
                              n_head=2, n_layer=2, n_positions=128)
    params = gpt2.init_params(cfg, seed=0, device=dev)
    lora = init_lora_gpt2(cfg, LoRASpec(rank=8, alpha=16.0), seed=1,
                          device=dev)
    g = torch.Generator().manual_seed(2)
    for entry in lora["blocks"].values():
        entry["B"] = (0.02 * torch.randn(entry["B"].shape,
                                         generator=g)).to(dev)
    ids = torch.randint(0, 300, (4, 96), generator=g).to(dev)
    mask = torch.ones(4, 96, device=dev)
    mask[3, 80:] = 0
    out = {}
    for attn_impl, lora_impl in (("auto", "auto"), ("plain", "naive")):
        leaves = {n: {k: t.clone().requires_grad_(k != "scale")
                      for k, t in e.items()}
                  for n, e in lora["blocks"].items()}
        n_epi = lf.lora_epilogue.launches
        logits = gpt2.forward(cfg, params, ids, mask, {"blocks": leaves},
                              attn_impl=attn_impl, lora_impl=lora_impl)
        s, w = lm_cross_entropy_sum(logits, ids)
        grads = torch.autograd.grad(
            s, [leaves[n][k] for n in sorted(leaves) for k in ("A", "B")])
        out[attn_impl] = (s / w, grads)
        launched = lf.lora_epilogue.launches - n_epi
        assert launched == (2 * cfg.n_layer if lora_impl == "auto" else 0)
    assert abs(float((out["auto"][0] - out["plain"][0]).detach())) <= 1e-4
    for a, b in zip(out["auto"][1], out["plain"][1]):
        assert float((a - b).abs().max()) <= 1e-4


def _ce_case(dev, dtype, R, V, H, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(R, H, generator=g).to(dev, dtype)
    w = (0.05 * torch.randn(V, H, generator=g)).to(dev, dtype)
    lab = torch.randint(0, V, (R,), generator=g).to(dev)
    dl, dg = (torch.randn(R, generator=g).to(dev) for _ in range(2))
    return h, w, lab, dl, dg


@pytest.mark.parametrize("dtype,R,V,H,tol,sm_tol", [
    (torch.bfloat16, 64, 5000, 640, 2e-3, 2e-3),
    (torch.float32, 37, 1001, 200, 1e-4, 1e-4),
])
def test_fused_ce_kernels_match_plain(dev, dtype, R, V, H, tol, sm_tol):
    """Rows 6-8: lse and gold (max abs error), dh and dW (over
    max(1, max |ref|)) against the plain versions; one launch each. The
    label rows dominate dh and dW, so their softmax part is held alone
    too: dgold = 0, max abs error over max |ref| (sm_tol)."""
    h, w, lab, dl, dg = _ce_case(dev, dtype, R, V, H, seed=R + V)
    n = [f.launches for f in (fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                              fc.fused_ce_bwd_dw)]
    lse, gold = fc.fused_ce_fwd(h, w, lab)
    rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
    dh = fc.fused_ce_bwd_dh(h, w, lab, rl, dl, dg)
    dw = fc.fused_ce_bwd_dw(h, w, lab, rl, dl, dg)
    torch.cuda.synchronize()
    assert [f.launches for f in (fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                                 fc.fused_ce_bwd_dw)] == [x + 1 for x in n]
    assert float((lse - rl).abs().max()) <= tol
    assert float((gold - rg).abs().max()) <= tol
    assert _rel_err(dh, fc.fused_ce_dh_reference(h, w, lab, rl, dl,
                                                 dg)) <= tol
    assert _rel_err(dw, fc.fused_ce_dw_reference(h, w, lab, rl, dl,
                                                 dg)) <= tol
    z = torch.zeros_like(dg)
    for kernel, plain in ((fc.fused_ce_bwd_dh, fc.fused_ce_dh_reference),
                          (fc.fused_ce_bwd_dw, fc.fused_ce_dw_reference)):
        ref = plain(h, w, lab, rl, dl, z)
        err = (kernel(h, w, lab, rl, dl, z) - ref).abs().max()
        assert float(err) <= sm_tol * float(ref.abs().max())


def test_fused_ce_dh_tensor_core_kernel_ragged_and_deterministic(dev):
    """Row 7 in bf16 at R = 37 (a ragged row tile), a ragged V (50,257)
    and H = 1,152 (four H parts) against the plain version, the softmax
    part alone too; two calls give identical bits (no atomics)."""
    R, V, H = 37, 50257, 1152
    h, w, lab, dl, dg = _ce_case(dev, torch.bfloat16, R, V, H, seed=5)
    lse = fc.fused_ce_fwd_reference(h, w, lab)[0]
    n0 = fc.fused_ce_bwd_dh.launches
    dh = fc.fused_ce_bwd_dh(h, w, lab, lse, dl, dg)
    again = fc.fused_ce_bwd_dh(h, w, lab, lse, dl, dg)
    torch.cuda.synchronize()
    assert fc.fused_ce_bwd_dh.launches == n0 + 2
    assert torch.equal(dh, again)
    assert _rel_err(dh, fc.fused_ce_dh_reference(h, w, lab, lse, dl,
                                                 dg)) <= 2e-3
    z = torch.zeros_like(dg)
    ref = fc.fused_ce_dh_reference(h, w, lab, lse, dl, z)
    err = (fc.fused_ce_bwd_dh(h, w, lab, lse, dl, z) - ref).abs().max()
    assert float(err) <= 2e-3 * float(ref.abs().max())


def test_fused_ce_dw_tensor_core_kernel_ragged_and_deterministic(dev):
    """Row 8 in bf16 at R = 37 (a ragged row chunk), a ragged V (50,257)
    and H = 1,152 (two H parts), and at R = 150 (two row chunks), against
    the plain version, the softmax part alone too; two calls give
    identical bits (no atomics); one launch a call."""
    for R, V, H in ((37, 50257, 1152), (150, 20011, 640)):
        h, w, lab, dl, dg = _ce_case(dev, torch.bfloat16, R, V, H, seed=R)
        lse = fc.fused_ce_fwd_reference(h, w, lab)[0]
        n0 = fc.fused_ce_bwd_dw.launches
        dw = fc.fused_ce_bwd_dw(h, w, lab, lse, dl, dg)
        again = fc.fused_ce_bwd_dw(h, w, lab, lse, dl, dg)
        torch.cuda.synchronize()
        assert fc.fused_ce_bwd_dw.launches == n0 + 2
        assert torch.equal(dw, again)
        assert _rel_err(dw, fc.fused_ce_dw_reference(h, w, lab, lse, dl,
                                                     dg)) <= 2e-3
        z = torch.zeros_like(dg)
        ref = fc.fused_ce_dw_reference(h, w, lab, lse, dl, z)
        err = (fc.fused_ce_bwd_dw(h, w, lab, lse, dl, z) - ref).abs().max()
        assert float(err) <= 2e-3 * float(ref.abs().max())


@pytest.mark.parametrize("R,V,H,r", [
    (37, 50257, 1000, 4),       # ragged R, V and H parts, r 4 by 4 bytes
    (128, 20011, 640, 128),     # the largest rank
    (37, 1001, 200, 5),         # an odd rank, copied element by element
])
def test_fused_ce_dh_lora_tensor_core_kernel(dev, R, V, H, r):
    """Row 10 in bf16 against the plain version, (dh, dxa) over
    max(1, max |ref|) and the softmax part alone (dgold = 0, over
    max |ref|); two calls give identical bits; one launch a call."""
    h, w, lab, dl, dg = _ce_case(dev, torch.bfloat16, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, torch.bfloat16, R, V, r, seed=r)
    lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
    for dgold, err in ((dg, _rel_err), (torch.zeros_like(dg), _scaled_err)):
        args = (h, w, xa, bt, lab, lse, dl, dgold)
        n0 = fc.fused_ce_bwd_dh_lora.launches
        got = fc.fused_ce_bwd_dh_lora(*args)
        again = fc.fused_ce_bwd_dh_lora(*args)
        torch.cuda.synchronize()
        assert fc.fused_ce_bwd_dh_lora.launches == n0 + 2
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got, fc.fused_ce_dh_lora_reference(*args)):
            assert err(a, b) <= 2e-3


@pytest.mark.parametrize("R,V,H", [
    (128, 262144, 640),         # the Gemma chunk: a cluster of 2 H parts
    (120, 50257, 1152),         # ragged R and V, Gemma-3-1B's width: 4
    (37, 50257, 1152),          # a ragged 64-row chunk
    (150, 20011, 640),          # three 64-row chunks reloaded a tile
    (19, 1001, 136),            # one part, a narrow last W chunk
    (40, 3001, 1520),           # a cluster of eight: the widest H taken
])
def test_fused_ce_dw_tf32_kernel(dev, R, V, H):
    """Row 8 in f32 on its 3xTF32 kernel (csrc/fused_ce_dw_tf32.cu)
    against the plain version: dW within 1e-4 of max(1, max |ref|), the
    softmax part alone (dgold = 0) within 1e-4 of max |ref|; two calls
    give identical bits; one launch a call."""
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, R, V, H, seed=R + H)
    lse = fc.fused_ce_fwd_reference(h, w, lab)[0]
    for dgold, err in ((dg, _rel_err), (torch.zeros_like(dg), _scaled_err)):
        args = (h, w, lab, lse, dl, dgold)
        n0 = fc.fused_ce_bwd_dw.launches
        got = fc.fused_ce_bwd_dw(*args)
        again = fc.fused_ce_bwd_dw(*args)
        want = fc.fused_ce_dw_reference(*args)
        torch.cuda.synchronize()
        assert fc.fused_ce_bwd_dw.launches == n0 + 2
        assert torch.equal(got, again)
        assert err(got, want) <= 1e-4
        del got, again, want


@pytest.mark.parametrize("N,d_out,r,offset,vec,rows", [
    (1024, 2304, 8, 0, 4, 1),   # GPT-2's attn_qkv
    (1000, 770, 8, 0, 2, 1),    # 8-byte vectors
    (5, 301, 3, 0, 1, 1),       # 4-byte vectors, an odd rank
    (64, 512, 8, 1, 1, 1),      # y, out and B 4 bytes off 16
    (4, 262144, 8, 0, 4, 4),    # the head adapter's lm_head: 4 rows a
    (3, 2048, 20, 0, 4, 1),     # thread; N <= 4 on too few CTAs: 1
])
def test_lora_epilogue_vec_f32_kernel(dev, N, d_out, r, offset, vec, rows):
    """Row 5 in f32 on its vector kernel (csrc/lora_epilogue_vec_f32.cu)
    at the plan's vector widths and rows a thread, the scale read from
    the device: within 1e-5 of the plain version, xs bit for bit f32(xa)
    * scale, two calls bit-identical, one launch a call."""
    def buf(n, seed):
        return _randn(dev, torch.float32, n + offset, seed=seed)[offset:]
    y = buf(N * d_out, 51).view(N, d_out)
    xa = _randn(dev, torch.float32, N, r, seed=52)
    b = buf(r * d_out, 53).view(r, d_out)
    s = torch.tensor(0.37, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out0 = torch.empty(N * d_out + offset, device=dev)[offset:]
    plan = lf.epilogue_vec_plan(N, d_out, n_sm,
                                lf._addr_align(y, out0, b), 4)
    assert (plan["vec"], plan["rows"]) == (vec, rows)
    n0 = lf.lora_epilogue.launches
    out, xs = lf.lora_epilogue(y, xa, b, s)
    out2, _ = lf.lora_epilogue(y, xa, b, s)
    assert lf.lora_epilogue.launches == n0 + 2
    ref = lf.lora_epilogue_reference(y, xa, b, s)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(xs, xa * s)
    assert torch.equal(out, out2)


def test_f32_rows_5_and_8_reach_their_new_symbols_only(dev, monkeypatch):
    """An f32 dW and an f32 epilogue on CUDA tensors call
    mft_fused_ce_dw_tf32 and mft_lora_epilogue_vec_f32, load no other
    library and never run their plain versions."""
    def refuse(*_a, **_k):
        raise AssertionError("a CUDA call ran the plain version")
    monkeypatch.setattr(fc, "fused_ce_dw_reference", refuse)
    monkeypatch.setattr(fc, "fused_ce_dw_lora_reference", refuse)
    monkeypatch.setattr(lf, "lora_epilogue_reference", refuse)
    monkeypatch.setattr(lf, "scaled_bottleneck", refuse)
    called, loaded = [], []
    real_fn, real_load = fc._fn, build.load

    def record_fn(sym, n_ptrs, n_ints, lib="fused_ce"):
        called.append((lib, sym))
        return real_fn(sym, n_ptrs, n_ints, lib)

    def record_load(name):
        loaded.append(name)
        return real_load(name)
    monkeypatch.setattr(fc, "_fn", record_fn)
    monkeypatch.setattr(build, "load", record_load)
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, 40, 3000, 640, 6)
    fc.fused_ce_bwd_dw(h, w, lab, dl, dl, dg)
    y = _randn(dev, torch.float32, 64, 2304, seed=7)
    xa = _randn(dev, torch.float32, 64, 8, seed=8)
    b = _randn(dev, torch.float32, 8, 2304, seed=9)
    lf.lora_epilogue(y, xa, b, torch.tensor(2.0, device=dev))
    torch.cuda.synchronize()
    assert called == [("fused_ce_dw_tf32", "mft_fused_ce_dw_tf32")]
    assert loaded == ["fused_ce_dw_tf32", "lora_epilogue_vec_f32"]
    assert lf._kernel(torch.float32).__name__ == "mft_lora_epilogue_vec_f32"


@pytest.mark.parametrize("R,V,H,r", [
    (128, 262144, 640, 8),      # the Gemma chunk, the default-dtype path's
    (128, 262144, 640, 0),
    (37, 50257, 1152, 0),       # ragged R and V, Gemma-3-1B's width
    (37, 50257, 1000, 4),       # ragged R and V, r 4
    (37, 50257, 1000, 3),       # an odd rank
    (128, 20011, 640, 128),     # the largest rank: two W tiles
])
def test_fused_ce_dh_tf32_kernels(dev, R, V, H, r):
    """Rows 7 (r 0) and 10 in f32 on their 3xTF32 kernels against the
    plain versions: dh (and dxa) within 1e-4 of max(1, max |ref|), the
    softmax part alone (dgold = 0) within 1e-4 of max |ref|; two calls
    give identical bits; one launch a call."""
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, R, V, H, seed=R + r)
    xa, bt = (_lora_case(dev, torch.float32, R, V, r, seed=r) if r
              else (None, None))
    lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
    for dgold, err in ((dg, _rel_err), (torch.zeros_like(dg), _scaled_err)):
        if r:
            args = (h, w, xa, bt, lab, lse, dl, dgold)
            kernel, plain = fc.fused_ce_bwd_dh_lora, \
                fc.fused_ce_dh_lora_reference
        else:
            args = (h, w, lab, lse, dl, dgold)
            kernel = fc.fused_ce_bwd_dh
            plain = fc.fused_ce_dh_reference
        n0 = kernel.launches
        got, again = kernel(*args), kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 2
        if not r:
            got, again, want = (got,), (again,), (want,)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for a, b in zip(got, want):
            assert err(a, b) <= 1e-4


def test_f32_dh_kernels_refuse_h_not_a_multiple_of_8(dev):
    """Rows 6, 7, 8, 9, 10 and 11 (dbt only) in f32 refuse H 1,004 before
    any launch, as bf16 does (the first versions took it; no model has
    such a width)."""
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, 8, 100, 1004, 2)
    xa, bt = _lora_case(dev, torch.float32, 8, 100, 8, 2)
    for kernel, args, kw in (
            (fc.fused_ce_bwd_dh, (h, w, lab, dl, dl, dg), {}),
            (fc.fused_ce_bwd_dw, (h, w, lab, dl, dl, dg), {}),
            (fc.fused_ce_bwd_dh_lora, (h, w, xa, bt, lab, dl, dl, dg), {}),
            (fc.fused_ce_fwd, (h, w, lab), {}),
            (fc.fused_ce_fwd_lora, (h, w, xa, bt, lab), {}),
            (fc.fused_ce_bwd_dw_lora, (h, w, xa, bt, lab, dl, dl, dg),
             {"want_dw": False})):
        n0 = kernel.launches
        with pytest.raises(ValueError, match="H % 8"):
            kernel(*args, **kw)
        assert kernel.launches == n0


@pytest.mark.parametrize("R,V,H,r", [
    (128, 262144, 640, 8),      # the Gemma chunk, the default-dtype path's
    (37, 50257, 1152, 3),       # ragged R and V, Gemma-3-1B's width, odd r
    (70, 20011, 640, 1),        # two row tiles, a ragged V, rank 1
    (100, 5003, 640, 128),      # the largest rank: 32-row tiles
    (120, 50257, 768, 5),       # GPT-2's width: 32-row tiles
])
def test_fused_ce_fwd_and_dbt_tf32_kernels(dev, R, V, H, r):
    """Rows 6 and 11 (dbt only) in f32 on their 3xTF32 kernels against
    the plain versions: lse and gold within 1e-4; dbt within 1e-4 of
    max(1, max |ref|), its softmax part alone (dgold = 0) within 1e-4 of
    max |ref|; two calls give identical bits; one launch a call."""
    h, w, lab, dl, dg = _ce_case(dev, torch.float32, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, torch.float32, R, V, r, seed=r)
    n0 = fc.fused_ce_fwd.launches
    lse, gold = fc.fused_ce_fwd(h, w, lab)
    lse2, gold2 = fc.fused_ce_fwd(h, w, lab)
    rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
    torch.cuda.synchronize()
    assert fc.fused_ce_fwd.launches == n0 + 2
    assert torch.equal(lse, lse2) and torch.equal(gold, gold2)
    assert float((lse - rl).abs().max()) <= 1e-4
    assert float((gold - rg).abs().max()) <= 1e-4
    lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
    for dgold, err in ((dg, _rel_err), (torch.zeros_like(dg), _scaled_err)):
        args = (h, w, xa, bt, lab, lse, dl, dgold)
        n0 = fc.fused_ce_bwd_dw_lora.launches
        no_dw, dbt = fc.fused_ce_bwd_dw_lora(*args, want_dw=False)
        _, again = fc.fused_ce_bwd_dw_lora(*args, want_dw=False)
        torch.cuda.synchronize()
        assert fc.fused_ce_bwd_dw_lora.launches == n0 + 2
        assert no_dw is None and torch.equal(dbt, again)
        ref = fc.fused_ce_dw_lora_reference(*args, want_dw=False)[1]
        assert err(dbt, ref) <= 1e-4


@pytest.mark.parametrize("R,V,H,r", [
    (128, 262144, 640, 8),      # the Gemma chunk, the default-dtype path's
    (37, 50257, 1152, 3),       # ragged R and V, Gemma-3-1B's width, odd r
    (70, 20011, 640, 1),        # two row tiles, a ragged V, rank 1
    (100, 5003, 640, 128),      # the largest rank: 32-row tiles
    (120, 50257, 1000, 5),      # ragged R and V, an odd rank, 64-row tiles
])
def test_fused_ce_fwd_lora_tf32_kernel(dev, R, V, H, r):
    """Row 9 in f32 on its 3xTF32 kernel (fused_ce_fwd_lora_tf32.cu)
    against the plain version: lse and gold within 1e-4; two calls give
    identical bits; one launch a call."""
    h, w, lab, _, _ = _ce_case(dev, torch.float32, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, torch.float32, R, V, r, seed=r)
    n0 = fc.fused_ce_fwd_lora.launches
    lse, gold = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    lse2, gold2 = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    rl, rg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    torch.cuda.synchronize()
    assert fc.fused_ce_fwd_lora.launches == n0 + 2
    assert torch.equal(lse, lse2) and torch.equal(gold, gold2)
    assert float((lse - rl).abs().max()) <= 1e-4
    assert float((gold - rg).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [0, 8])
def test_wide_h_chunked_loss_takes_the_plain_chunk(dev, dtype, r):
    """Gemma-3-4B's width (H 2,560), which no fused CE layout takes: the
    chunked loss under impl "auto" launches no fused CE kernel, and its
    sum, count and gradients (hidden states, and A, B of a head adapter)
    are the plain chunk's (impl "plain") to 1e-6 of their size, for a
    frozen head and a trained one."""
    g = torch.Generator().manual_seed(r + 1)
    B, S, H, V = 2, 65, 2560, 4096
    hid = torch.randn(B, S, H, generator=g).to(dev, dtype)
    w = (0.02 * torch.randn(V, H, generator=g)).to(dev, dtype)
    labels = torch.randint(0, V, (B, S), generator=g).to(dev)
    A = (0.02 * torch.randn(H, max(r, 1), generator=g)).to(dev, dtype)
    Bm = (0.1 * torch.randn(max(r, 1), V, generator=g)).to(dev, dtype)
    kernels = (fc.fused_ce_fwd, fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dw,
               fc.fused_ce_fwd_lora, fc.fused_ce_bwd_dh_lora,
               fc.fused_ce_bwd_dw_lora)
    for head_grad in (False, True):
        out = {}
        for impl in ("plain", "auto"):
            leaves = [t.clone().requires_grad_(True) for t in (hid, A, Bm)]
            wl = w.clone().requires_grad_(head_grad)
            head = ({"A": leaves[1], "B": leaves[2],
                     "scale": torch.tensor(2.0, device=dev)} if r else None)
            n = [f.launches for f in kernels]
            s, c = loss.chunked_lm_cross_entropy_sum(
                leaves[0], wl, labels, num_chunks=4, impl=impl,
                lora_head=head)
            grads = torch.autograd.grad(
                s, (leaves if r else leaves[:1]) + [wl] * head_grad)
            torch.cuda.synchronize()
            assert [f.launches for f in kernels] == n
            out[impl] = (s.detach(), int(c), grads)
        assert out["auto"][1] == out["plain"][1] == B * (S - 1)
        assert _rel_err(out["auto"][0], out["plain"][0]) <= 1e-6
        for a, b in zip(out["auto"][2], out["plain"][2]):
            assert bool(torch.isfinite(a).all()) and _rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("R,V,H,r", [
    (128, 20011, 640, 8),       # the path's width and rank, ragged V
    (37, 50257, 1000, 1),       # ragged R and V, rank 1 element by element
    (37, 1001, 200, 3),         # an odd rank
    (100, 5003, 640, 128),      # the largest rank: two W buffers
])
def test_fused_ce_fwd_lora_tensor_core_kernel(dev, R, V, H, r):
    """Row 9 in bf16 against the plain version (lse and gold, max abs
    error <= 2e-3); two calls give identical bits; one launch a call."""
    h, w, lab, _, _ = _ce_case(dev, torch.bfloat16, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, torch.bfloat16, R, V, r, seed=r)
    n0 = fc.fused_ce_fwd_lora.launches
    lse, gold = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    lse2, gold2 = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    rl, rg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    torch.cuda.synchronize()
    assert fc.fused_ce_fwd_lora.launches == n0 + 2
    assert torch.equal(lse, lse2) and torch.equal(gold, gold2)
    assert float((lse - rl).abs().max()) <= 2e-3
    assert float((gold - rg).abs().max()) <= 2e-3


@pytest.mark.parametrize("R,V,H,r", [
    (128, 20011, 640, 8),       # two row-tile partials, ragged V
    (37, 50257, 1000, 1),       # one row tile (no reduce pass), rank 1
    (37, 1001, 200, 3),         # an odd rank, copied element by element
    (100, 5003, 640, 128),      # the largest rank: every warp's pairs
])
def test_fused_ce_dbt_tensor_core_kernel(dev, R, V, H, r):
    """Row 11's dbt-only mode in bf16 against the plain version, dbt over
    max(1, max |ref|) and the softmax part alone (dgold = 0, over
    max |ref|), tolerance 2e-3; no dW; two calls give identical bits; one
    launch a call."""
    h, w, lab, dl, dg = _ce_case(dev, torch.bfloat16, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, torch.bfloat16, R, V, r, seed=r)
    lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
    for dgold, err in ((dg, _rel_err), (torch.zeros_like(dg), _scaled_err)):
        args = (h, w, xa, bt, lab, lse, dl, dgold)
        n0 = fc.fused_ce_bwd_dw_lora.launches
        no_dw, dbt = fc.fused_ce_bwd_dw_lora(*args, want_dw=False)
        _, again = fc.fused_ce_bwd_dw_lora(*args, want_dw=False)
        torch.cuda.synchronize()
        assert fc.fused_ce_bwd_dw_lora.launches == n0 + 2
        assert no_dw is None and torch.equal(dbt, again)
        ref = fc.fused_ce_dw_lora_reference(*args, want_dw=False)[1]
        assert err(dbt, ref) <= 2e-3


def test_fused_ce_skips_dw_for_a_frozen_head_and_never_runs_plain(
        dev, monkeypatch):
    """A CUDA tensor goes to the kernels only: the plain versions and the
    plain chunk body are made to raise; a frozen head launches fwd and dh
    but no dW; a trained one launches dW on the tensor-core kernel (bf16:
    the libraries loaded are recorded) with a finite gradient; a dtype
    the kernels do not take raises."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    for name in ("fused_ce_fwd_reference", "fused_ce_dh_reference",
                 "fused_ce_dw_reference"):
        monkeypatch.setattr(fc, name, boom)
    monkeypatch.setattr(loss, "_plain_chunk", boom)
    loaded = []
    real = build.load

    def record(name):
        loaded.append(name)
        return real(name)
    monkeypatch.setattr(build, "load", record)
    h, w, lab, _, _ = _ce_case(dev, torch.bfloat16, 2 * 31, 3000, 128, 1)
    hid = h.reshape(2, 31, 128).requires_grad_(True)
    labels = lab.reshape(2, 31)
    n = [f.launches for f in (fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                              fc.fused_ce_bwd_dw)]
    s, c = loss.chunked_lm_cross_entropy_sum(hid, w, labels, num_chunks=3)
    s.backward()
    assert [f.launches for f in (fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                                 fc.fused_ce_bwd_dw)] == \
        [n[0] + 3, n[1] + 3, n[2]]
    assert int(c) == 2 * 30 and bool(torch.isfinite(hid.grad).all())
    wt = w.clone().requires_grad_(True)
    loaded.clear()
    s, _ = loss.chunked_lm_cross_entropy_sum(hid.detach(), wt, labels,
                                             num_chunks=3)
    s.backward()
    assert fc.fused_ce_bwd_dw.launches == n[2] + 3
    assert loaded.count("fused_ce_dw_mma") == 3
    assert bool(torch.isfinite(wt.grad).all())
    with pytest.raises(ValueError, match="dtype"):
        fc.fused_ce_fwd(h.double(), w.double(), lab)


def _lora_case(dev, dtype, R, V, r, seed):
    g = torch.Generator().manual_seed(seed)
    xa = torch.randn(R, r, generator=g).to(dev, dtype)
    bt = (0.05 * torch.randn(V, r, generator=g)).to(dev, dtype)
    return xa, bt


@pytest.mark.parametrize("dtype,R,V,H,r,tol,sm_tol", [
    (torch.bfloat16, 128, 20000, 640, 8, 2e-3, 2e-3),
    (torch.float32, 37, 1001, 200, 5, 1e-4, 1e-4),
])
def test_fused_ce_lora_kernels_match_plain(dev, dtype, R, V, H, r, tol,
                                           sm_tol):
    """Rows 9-11: lse and gold (max abs error); dh, dxa, dW and dbt (over
    max(1, max |ref|)), row 11 in its dW mode and its dbt-only mode; one
    launch each. The softmax part alone too: dgold = 0, max abs error
    over max |ref| (sm_tol)."""
    h, w, lab, dl, dg = _ce_case(dev, dtype, R, V, H, seed=R + r)
    xa, bt = _lora_case(dev, dtype, R, V, r, seed=r)
    kernels = (fc.fused_ce_fwd_lora, fc.fused_ce_bwd_dh_lora,
               fc.fused_ce_bwd_dw_lora)
    n = [f.launches for f in kernels]
    lse, gold = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
    rl, rg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [n[0] + 1, n[1], n[2]]
    assert float((lse - rl).abs().max()) <= tol
    assert float((gold - rg).abs().max()) <= tol
    for dgold, err, t in ((dg, _rel_err, tol), (torch.zeros_like(dg),
                                                 _scaled_err, sm_tol)):
        args = (h, w, xa, bt, lab, rl, dl, dgold)
        got = (*fc.fused_ce_bwd_dh_lora(*args),
               *fc.fused_ce_bwd_dw_lora(*args),
               fc.fused_ce_bwd_dw_lora(*args, want_dw=False)[1])
        ref = (*fc.fused_ce_dh_lora_reference(*args),
               *fc.fused_ce_dw_lora_reference(*args))
        ref = ref + (ref[3],)
        for a, b in zip(got, ref):
            assert err(a, b) <= t
    assert fc.fused_ce_bwd_dw_lora(*args, want_dw=False)[0] is None


def _scaled_err(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def test_head_adapter_loss_launches_its_kernels_only(dev, monkeypatch):
    """The chunked loss with an lm_head adapter on a CUDA tensor launches
    rows 9-11 in every chunk (row 11 dbt-only: the head is frozen) and
    none of the base kernels or plain versions; its loss and the A / B
    gradients agree with the plain path (f32). In bf16 the same launches,
    rows 9, 10 and 11 on their tensor-core kernels, with finite
    gradients."""
    g = torch.Generator().manual_seed(7)
    R2, V, H, r = 31, 3000, 128, 4
    hid = torch.randn(2, R2, H, generator=g).to(dev)
    w = (0.05 * torch.randn(V, H, generator=g)).to(dev)
    labels = torch.randint(0, V, (2, R2), generator=g).to(dev)
    A = (0.1 * torch.randn(H, r, generator=g)).to(dev)
    B = (0.1 * torch.randn(r, V, generator=g)).to(dev)
    out = {}
    for impl in ("plain", "auto"):
        leaves = [hid.clone().requires_grad_(True),
                  A.clone().requires_grad_(True),
                  B.clone().requires_grad_(True)]
        head = {"A": leaves[1], "B": leaves[2],
                "scale": torch.tensor(2.0, device=dev)}
        if impl == "auto":
            def boom(*a, **k):
                raise AssertionError("a plain version ran on CUDA")
            for name in ("fused_ce_fwd_lora_reference",
                         "fused_ce_dh_lora_reference",
                         "fused_ce_dw_lora_reference"):
                monkeypatch.setattr(fc, name, boom)
            monkeypatch.setattr(loss, "_plain_chunk", boom)
            kernels = (fc.fused_ce_fwd_lora, fc.fused_ce_bwd_dh_lora,
                       fc.fused_ce_bwd_dw_lora, fc.fused_ce_fwd,
                       fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dw)
            n = [f.launches for f in kernels]
        s, c = loss.chunked_lm_cross_entropy_sum(
            leaves[0], w, labels, num_chunks=3, impl=impl, lora_head=head)
        out[impl] = (float(s.detach()), torch.autograd.grad(s, leaves))
    assert [f.launches - x for f, x in zip(kernels, n)] == [3, 3, 3, 0, 0, 0]
    assert int(c) == 2 * 30
    assert abs(out["auto"][0] - out["plain"][0]) <= 1e-4 * abs(
        out["plain"][0])
    for a, b in zip(out["auto"][1], out["plain"][1]):
        assert _rel_err(a, b) <= 1e-4
    loaded = []
    real = build.load

    def record(name):
        loaded.append(name)
        return real(name)
    monkeypatch.setattr(build, "load", record)
    leaves = [t.to(torch.bfloat16).requires_grad_(True) for t in (hid, A, B)]
    head = {"A": leaves[1], "B": leaves[2],
            "scale": torch.tensor(2.0, device=dev)}
    n = [f.launches for f in kernels]
    s, _ = loss.chunked_lm_cross_entropy_sum(
        leaves[0], w.to(torch.bfloat16), labels, num_chunks=3, impl="auto",
        lora_head=head)
    grads = torch.autograd.grad(s, leaves)
    assert [f.launches - x for f, x in zip(kernels, n)] == [3, 3, 3, 0, 0, 0]
    for lib in ("fused_ce_fwd_lora_mma", "fused_ce_dh_lora_mma",
                "fused_ce_dbt_mma"):
        assert loaded.count(lib) == 3
    assert "fused_ce" not in loaded
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_gemma_kernel_path_matches_plain_path(dev):
    """A small Gemma-3 (head_dim 64, GQA 4:1, window 16 on 2 of 3 layers)
    in f32 at S = 48: loss and LoRA grads through the flash, epilogue and
    fused CE kernels against the plain path."""
    cfg = Gemma3TextConfig(vocab_size=3000, hidden_size=128,
                           intermediate_size=256, num_hidden_layers=3,
                           num_attention_heads=4, num_key_value_heads=1,
                           head_dim=64, sliding_window=16,
                           sliding_window_pattern=3,
                           query_pre_attn_scalar=64.0)
    params = gemma3.init_params(cfg, seed=0, device=dev)
    lora = init_lora_gemma3(cfg, LoRASpec(rank=4, alpha=8.0, init="peft"),
                            seed=1, device=dev)
    g = torch.Generator().manual_seed(2)
    for e in lora["blocks"].values():
        e["B"] = (0.05 * torch.randn(e["B"].shape, generator=g)).to(dev)
    ids = torch.randint(0, 3000, (2, 48), generator=g).to(dev)
    mask = torch.ones(2, 48, device=dev)
    mask[1, 40:] = 0
    labels = torch.where(mask > 0, ids, -100)
    out = []
    for attn_impl, lora_impl, loss_impl in (("auto", "auto", "auto"),
                                            ("plain", "naive", "plain")):
        leaves = [e[k].detach().clone().requires_grad_(True)
                  for e in lora["blocks"].values() for k in ("A", "B")]
        it = iter(leaves)
        tree = {"blocks": {n: {"A": next(it), "B": next(it),
                               "scale": e["scale"]}
                           for n, e in lora["blocks"].items()}}
        h = gemma3.hidden_states(cfg, params, ids, mask, tree,
                                 attn_impl=attn_impl, lora_impl=lora_impl)
        v = loss.chunked_lm_cross_entropy(h, params["embed"], labels,
                                          num_chunks=4, impl=loss_impl)
        out.append((float(v.detach()), torch.autograd.grad(v, leaves)))
    assert abs(out[0][0] - out[1][0]) <= 1e-4
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) <= 1e-4


def _decode_case(dev, dtype, B, KV, G, T, D, seed, poison=True):
    """q, caches and a left-pad + tail mask whose masked columns hold
    +-1e6 (+-6e4 in f16, its largest finite magnitude is 65504)."""
    q = _randn(dev, dtype, B, KV, G, D, seed=seed)
    kc = _randn(dev, dtype, B, KV, T, D, seed=seed + 1)
    vc = _randn(dev, dtype, B, KV, T, D, seed=seed + 2)
    cols = torch.arange(T, device=dev)
    start = torch.arange(B, device=dev) * 5 % max(T // 3, 1)
    end = torch.maximum(T - 1 - torch.arange(B, device=dev) % 3, start)
    ok = (cols[None] >= start[:, None]) & (cols[None] <= end[:, None])
    if poison:
        big = 6e4 if dtype == torch.float16 else 1e6
        kc.masked_fill_(~ok[:, None, :, None], big)
        vc.masked_fill_(~ok[:, None, :, None], -big)
    return q, kc, vc, ok


@pytest.mark.parametrize("dtype,B,KV,G,T,D,tol", [
    (torch.bfloat16, 8, 12, 1, 192, 64, 2e-2),     # GPT-2 microbench
    (torch.bfloat16, 8, 1, 4, 192, 256, 2e-2),     # Gemma microbench
    (torch.float32, 4, 1, 4, 663, 256, 1e-5),      # ragged T, f32 D 256
    (torch.float16, 3, 2, 2, 37, 32, 2e-2),
    (torch.float32, 2, 3, 1, 1, 128, 1e-5),        # T = 1
])
def test_decode_kernel_matches_plain(dev, dtype, B, KV, G, T, D, tol):
    q, kc, vc, ok = _decode_case(dev, dtype, B, KV, G, T, D, seed=T + D)
    n0 = da.decode_attention.launches
    ctx = da.decode_attention(q, kc, vc, ok, D ** -0.5)
    assert da.decode_attention.launches == n0 + 1
    ref = da.xla_reference(q, kc, vc, ok, D ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ctx).all())
    assert float((ctx - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype,B,KV,G,T,D", [
    (torch.bfloat16, 8, 12, 1, 192, 64),     # GPT-2: 2 chunks and a merge
    (torch.bfloat16, 4, 1, 4, 665, 256),     # Gemma's last step: 21 chunks
    (torch.float16, 3, 2, 2, 37, 32),        # two warps a CTA
    (torch.bfloat16, 2, 2, 18, 100, 128),    # two groups of query heads
    (torch.bfloat16, 3, 1, 4, 1, 256),       # T 1: one chunk, no merge
    (torch.bfloat16, 1, 1, 4, 4096, 256),    # long T: chunks of tiles
    (torch.float32, 8, 12, 1, 144, 64),      # GPT-2 f32: one chunk
    (torch.float32, 4, 1, 4, 617, 256),      # Gemma f32: 13 chunks
    (torch.float32, 2, 2, 18, 100, 128),     # five groups of query heads
    (torch.float32, 3, 2, 2, 37, 32),
    (torch.float32, 3, 1, 4, 1, 256),        # T 1: one chunk, no merge
    (torch.float32, 1, 1, 4, 4096, 256),     # chunks of several rounds
])
def test_decode_tensor_core_kernel_poisoned_and_deterministic(
        dev, dtype, B, KV, G, T, D):
    """Row 13's flash-decoding kernels (bf16 / f16 on the tensor cores,
    csrc/decode_attention_mma.cu; f32 on csrc/decode_attention_split_f32.cu):
    masked columns holding Inf in K and NaN in V get exactly 0 weight (the
    ctx equals the unpoisoned call's bit for bit, and the plain version's
    on the unpoisoned cache within 2e-2, 1e-5 in f32), and two calls are
    bit-identical."""
    q, kc, vc, ok = _decode_case(dev, dtype, B, KV, G, T, D, seed=T + G,
                                 poison=False)
    if T > 1:
        ok[:, : T // 3] = False              # whole chunks masked too
        ok[:, -1] = True
    scale = D ** -0.5
    n0 = da.decode_attention.launches
    clean = da.decode_attention(q, kc, vc, ok, scale)
    masked = ~ok[:, None, :, None]
    kp = kc.masked_fill(masked, float("inf"))
    vp = vc.masked_fill(masked, float("nan"))
    got = da.decode_attention(q, kp, vp, ok, scale)
    again = da.decode_attention(q, kp, vp, ok, scale)
    assert da.decode_attention.launches == n0 + 3
    ref = da.xla_reference(q, kc, vc, ok, scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean) and torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((clean - ref).abs().max()) <= tol


def _paged_f32_case(dev, S, KV, G, D, bT, M, L, window, seed):
    """f32 pools and a table whose slots hold 1 to M pages (the last slot
    idle on the trash page), ok the occupancy and any window over each
    slot's last column; the rows no slot attends poisoned with Inf in K
    and NaN in V."""
    g = torch.Generator().manual_seed(seed)
    NB = S * M + 1
    pk = torch.randn(NB, L, KV, bT, D, generator=g)
    pv = torch.randn(NB, L, KV, bT, D, generator=g)
    q = torch.randn(S, KV, G, D, generator=g)
    pos = torch.randint(0, M * bT, (S,), generator=g)
    pos[0], pos[-1] = M * bT - 1, 0
    tbl = torch.zeros(S, M, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s in range(S - 1):
        n = int(pos[s]) // bT + 1
        tbl[s, :n] = perm[s * M:s * M + n].int()
    cols = torch.arange(M * bT)
    ok = cols[None] <= pos[:, None]
    if window is not None:
        ok &= cols[None] > pos[:, None] - window
    attended = torch.zeros(NB, bT, dtype=torch.bool)
    for s in range(S):
        c = torch.nonzero(ok[s]).flatten()
        attended[tbl[s, c // bT].long(), c % bT] = True
    dead = ~attended[:, None, None, :, None]
    pk.masked_fill_(dead, float("inf"))
    pv.masked_fill_(dead, float("nan"))
    return (q.to(dev), pk.to(dev), pv.to(dev), tbl.to(dev), ok.to(dev))


@pytest.mark.parametrize("S,KV,G,D,bT,M,window", [
    (8, 1, 4, 256, 16, 42, 512),     # gemma_serve_f32's pool
    (8, 12, 1, 64, 16, 12, None),    # GPT-2's serve step
    (3, 2, 6, 128, 64, 3, 30),       # chunks end inside a page, 2 groups
])
def test_paged_f32_split_kernel_at_the_path_shapes(dev, S, KV, G, D, bT, M,
                                                   window):
    """Row 12 in f32 on csrc/paged_decode_attention_vec_f32.cu at the
    serving pools: within 1e-5 of paged_attention (the rows no slot
    attends hold Inf / NaN), one launch a call, two calls bit-identical,
    the split of paged_f32_plan."""
    q, pk, pv, tbl, ok = _paged_f32_case(dev, S, KV, G, D, bT, M, 2, window,
                                         seed=S + D)
    scale = D ** -0.5
    n0 = da.paged_decode_attention.launches
    ctx = da.paged_decode_attention(q, pk, pv, tbl, 1, ok, scale)
    again = da.paged_decode_attention(q, pk, pv, tbl, 1, ok, scale)
    assert da.paged_decode_attention.launches == n0 + 2
    clean = [t.nan_to_num(0.0, 0.0, 0.0) for t in (pk, pv)]
    ref = da.paged_attention(q, *clean, tbl, 1, ok, scale)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ctx).all()) and torch.equal(ctx, again)
    assert float((ctx - ref).abs().max()) <= 1e-5
    assert da.paged_library(torch.float32)[0] == \
        "paged_decode_attention_vec_f32"


@pytest.mark.parametrize("B,KV,G,T,D,window", [
    (8, 12, 1, 144, 64, None),       # generate's GPT-2 f32 last step
    (4, 1, 4, 617, 256, 512),        # generate's Gemma f32 last step
    (4, 1, 4, 663, 256, 512),        # a ragged T
    (5, 3, 2, 1000, 32, None),       # D 32, several rounds a chunk
])
def test_decode_f32_split_kernel_at_the_path_shapes(dev, B, KV, G, T, D,
                                                    window):
    """Row 13 in f32 on csrc/decode_attention_split_f32.cu at generate's
    last steps and a ragged T, left padding and the window in ok, the
    masked columns holding +-1e6: within 1e-5 of xla_reference, one
    launch a call."""
    q, kc, vc, ok = _decode_case(dev, torch.float32, B, KV, G, T, D,
                                 seed=T + D)
    if window is not None:
        ok &= torch.arange(T, device=dev)[None] > T - 1 - window
        ok[:, -1] = True
    n0 = da.decode_attention.launches
    ctx = da.decode_attention(q, kc, vc, ok, D ** -0.5)
    assert da.decode_attention.launches == n0 + 1
    ref = da.xla_reference(q, kc, vc, ok, D ** -0.5)
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max()) <= 1e-5


def test_f32_split_wrappers_raise_on_what_the_kernels_do_not_take(
        dev, monkeypatch):
    """A CUDA f32 tensor the split kernels do not take raises, and a
    launch the kernel refuses raises too: no route to the plain version or
    the first versions."""
    f32 = torch.float32
    pk = torch.zeros(3, 1, 1, 8, 32, device=dev)
    with pytest.raises(ValueError, match="does not take"):      # D 32
        da.paged_decode_attention(
            torch.zeros(1, 1, 1, 32, device=dev), pk, pk,
            torch.zeros(1, 1, dtype=torch.int32, device=dev), 0,
            torch.ones(1, 8, dtype=torch.bool, device=dev), 1.0)
    pk = torch.zeros(3, 1, 1, 2048, 64, device=dev)
    with pytest.raises(ValueError, match="does not take"):      # bT
        da.paged_decode_attention(
            torch.zeros(1, 1, 1, 64, device=dev), pk, pk,
            torch.zeros(1, 1, dtype=torch.int32, device=dev), 0,
            torch.ones(1, 2048, dtype=torch.bool, device=dev), 1.0)
    q, kc, vc, ok = _decode_case(dev, f32, 2, 2, 1, 16, 64, 0)
    n0 = da.decode_attention.launches
    shifted = torch.empty(kc.numel() + 1, device=dev)[1:].view_as(kc)
    with pytest.raises(ValueError, match="aligned"):   # 4 bytes off
        da.decode_attention(q, shifted, vc, ok, 0.125)

    class Refusing:                       # a launch the card refuses
        argtypes = ()

        def __call__(self, *args):
            return 1                      # cudaErrorInvalidValue
    libs = types.SimpleNamespace(**{da.decode_library(f32)[1]: Refusing(),
                                    da.paged_library(f32)[1]: Refusing()})
    monkeypatch.setattr(build, "load", lambda name: libs)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        da.decode_attention(q, kc, vc, ok, 0.125)
    pk = torch.zeros(3, 1, 1, 16, 64, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        da.paged_decode_attention(
            torch.zeros(1, 1, 1, 64, device=dev), pk, pk,
            torch.zeros(1, 1, dtype=torch.int32, device=dev), 0,
            torch.ones(1, 16, dtype=torch.bool, device=dev), 1.0)
    assert da.decode_attention.launches == n0


def test_decode_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, kc, vc, ok = _decode_case(dev, torch.float32, 2, 2, 1, 16, 16, 0)
    n0 = da.decode_attention.launches
    with pytest.raises(ValueError, match="does not take"):
        da.decode_attention(q, kc, vc, ok, 0.25)                 # D 16
    q, kc, vc, ok = _decode_case(dev, torch.float32, 2, 2, 1, 16, 64, 0)
    with pytest.raises(ValueError, match="dtype"):
        da.decode_attention(q.bfloat16(), kc, vc, ok, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, kc.transpose(2, 3).contiguous()
                            .transpose(2, 3), vc, ok, 0.125)
    assert da.decode_attention.launches == n0


def _tiny_gpt2_d64(dev):
    cfg = dataclasses.replace(GPT2Config.tiny(vocab_size=300), n_embd=128,
                              n_head=2, n_layer=2, n_positions=128)
    return cfg, gpt2.init_params(cfg, seed=0, device=dev)


def test_generate_kernel_path_matches_plain_path(dev, monkeypatch):
    """gpt2_generate (D = 64) in f32 on the card: the kernel path launches
    row 13 L x (N - 1) times and gives the plain path's greedy ids; under
    attn_impl="auto" no CUDA cache reaches xla_reference."""
    cfg, params = _tiny_gpt2_d64(dev)
    ids, mask = (torch.as_tensor(a, device=dev) for a in generate.left_pad(
        [[5, 6, 7, 8, 9, 10, 11], [12, 13], [14, 15, 16, 17]], 0))
    N = 12
    scfg = generate.SampleConfig(max_new_tokens=N, greedy=True)
    plain = generate.gpt2_generate(cfg, params, ids, mask, scfg,
                                   attn_impl="plain")

    def refuse(*a, **k):
        raise AssertionError("xla_reference reached under attn_impl=auto")

    monkeypatch.setattr(generate, "xla_reference", refuse)
    monkeypatch.setattr(da, "xla_reference", refuse)
    da.decode_attention.launches = 0
    fa.flash_attention_fwd.launches = 0
    auto = generate.gpt2_generate(cfg, params, ids, mask, scfg)
    assert da.decode_attention.launches == cfg.n_layer * (N - 1)
    assert fa.flash_attention_fwd.launches == cfg.n_layer
    assert torch.equal(auto.cpu(), plain.cpu())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_gemma_paged_step_kernel_matches_plain(dev, dtype, tol):
    """gemma3_decode_step_paged at Gemma-3-270M's attention shape (4 query
    heads over 1 kv head of 256) in 3 layers, a window of 40 on the local
    ones, 8 slots (one idle) over a table of 50 pages of 16: the row-12
    kernel against paged_attention on the same pools, logits within `tol`
    (relative to max(1, |logits|) in bf16, absolute in f32), layer 0's
    K/V writes identical, one launch a layer."""
    cfg = Gemma3TextConfig(vocab_size=3000, hidden_size=128,
                           intermediate_size=256, num_hidden_layers=3,
                           num_attention_heads=4, num_key_value_heads=1,
                           head_dim=256, sliding_window=40,
                           sliding_window_pattern=3)
    params = gemma3.init_params(cfg, seed=0, dtype=dtype, device=dev)
    S, M, bT, NB = 8, 50, 16, 8 * 50 + 1
    g = torch.Generator().manual_seed(3)
    pk0 = torch.randn(NB, 3, 1, bT, 256, generator=g).to(dev, dtype)
    pv0 = torch.randn(NB, 3, 1, bT, 256, generator=g).to(dev, dtype)
    pos = torch.tensor([799, 512, 41, 300, 7, 650, 95, 0])
    tbl = torch.zeros(S, M, dtype=torch.int32)
    perm = torch.randperm(NB - 1, generator=g) + 1
    for s in range(S - 1):
        n = int(pos[s]) // bT + 1
        tbl[s, :n] = perm[s * M:s * M + n].int()
    tok = torch.randint(0, 3000, (S,), generator=g)
    out = {}
    for impl in ("auto", "plain"):
        pk, pv = pk0.clone(), pv0.clone()
        n0 = da.paged_decode_attention.launches
        logits, _, _ = generate.gemma3_decode_step_paged(
            cfg, params, pk, pv, tok.to(dev), pos.to(dev), tbl.to(dev),
            compute_dtype=dtype, attn_impl=impl)
        n = da.paged_decode_attention.launches - n0
        assert n == (3 if impl == "auto" else 0)
        out[impl] = (logits, pk, pv)
    (a, ak, av), (b, bk, bv) = out["auto"], out["plain"]
    assert bool(torch.isfinite(a).all())
    err = _rel_err(a, b) if dtype == torch.bfloat16 \
        else float((a - b).abs().max())
    assert err <= tol
    # layer 0's writes precede any attention: identical on both paths
    assert torch.equal(ak[1:, 0], bk[1:, 0])
    assert torch.equal(av[1:, 0], bv[1:, 0])


def test_tiny_gemma_engine_drains_on_the_card_with_launch_counts(dev):
    """build_engine("tiny-gemma") in f32 on the card with 2 tenants, the
    prefix cache, chunked admission and sampling: the flash kernel runs
    once a layer a one-shot prefill, the paged kernel once a layer a
    decode step, and the tokens are those of the same engine on the
    CPU (the plain versions)."""
    from mobilefinetuner_tpu_torch.serve.bench import build_engine
    kw = dict(num_slots=3, block_T=16, num_blocks=64, max_prompt=32,
              max_new=8, adapters=2, dtype="float32", prefix_cache=True,
              max_prompt_chunked=96, sampling=True)
    g = torch.Generator().manual_seed(4)
    common = torch.randint(0, 300, (32,), generator=g).tolist()
    prompts = [common + [5, 6], torch.randint(0, 300, (20,), generator=g)
               .tolist(), list(common), torch.randint(0, 300, (90,),
                                                      generator=g).tolist(),
               list(common)]
    routes = [None, "tenant0", None, "tenant1", None]
    out = []
    for device in (dev, "cpu"):
        eng, _ = build_engine("tiny-gemma", device=device, **kw)
        fa.flash_attention_fwd.launches = 0
        da.paged_decode_attention.launches = 0
        reqs = [eng.submit(p, adapter=a, temperature=0.8 * (i % 2),
                           seed=i) for i, (p, a) in
                enumerate(zip(prompts, routes))]
        eng.drain()
        assert all(r.state == "finished" for r in reqs)
        assert eng.alloc.in_use == 0
        eng.prefix.check_consistent()
        out.append([r.tokens for r in reqs])
        L = eng.config.num_hidden_layers
        if device == dev:
            assert eng.prefills > 0 and eng.chunks > 0
            assert fa.flash_attention_fwd.launches == L * eng.prefills
            assert da.paged_decode_attention.launches \
                == L * eng.decode_steps
    assert out[0] == out[1]


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
def test_mmlu_logits_kernel_path_matches_plain_at_bf16(dev, family):
    """cli/eval_mmlu.make_batched_logits_fn at bf16 on one bucket (16 x
    64, right-padded rows, a partial batch padded with row 0): the flash
    kernel path's last-token logits against the plain attention's within
    2e-2 of max(1, max |ref|); GPT-2 with a dynamic attn_qkv adapter,
    Gemma (GQA 4:1, window 16) with a dynamic lm_head adapter, whose
    epilogue runs at [16, V]; the kernels launch once a layer and once a
    site."""
    from mobilefinetuner_tpu_torch.cli.eval_mmlu import \
        make_batched_logits_fn
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(31)
    if family == "gpt2":
        cfg, params = _tiny_gpt2_d64(dev)
        model, head_key, L, V = gpt2, "wte", cfg.n_layer, cfg.vocab_size
        lora = init_lora_gpt2(cfg, LoRASpec(rank=8, alpha=16.0,
                                            targets=["attn_qkv"]),
                              seed=1, device=dev)
    else:
        cfg = Gemma3TextConfig(vocab_size=3000, hidden_size=128,
                               intermediate_size=256, num_hidden_layers=3,
                               num_attention_heads=4, num_key_value_heads=1,
                               head_dim=64, sliding_window=16,
                               sliding_window_pattern=3,
                               query_pre_attn_scalar=64.0)
        params = gemma3.init_params(cfg, seed=0, device=dev)
        model, head_key, L, V = gemma3, "embed", 3, cfg.vocab_size
        lora = init_lora_gemma3(cfg, LoRASpec(rank=8, alpha=16.0,
                                              init="peft",
                                              targets=["lm_head"]),
                                seed=1, device=dev)
    for e in lora["blocks"].values():
        e["B"] = (0.05 * torch.randn(e["B"].shape, generator=g)).to(dev)
    B, S, n = 16, 64, 11
    lens = torch.randint(20, S + 1, (n,), generator=g)
    ids = torch.zeros(B, S, dtype=torch.int32)
    last = torch.zeros(B, dtype=torch.int32)
    for r in range(n):
        ids[r, :lens[r]] = torch.randint(0, V, (int(lens[r]),), generator=g)
        last[r] = lens[r] - 1
    ids[n:], last[n:] = ids[0], last[0]
    out = {}
    for impl in ("auto", "plain"):
        n_fa, n_epi = fa.flash_attention_fwd.launches, \
            lf.lora_epilogue.launches

        def hidden_fn(p, lo, x, impl=impl):
            return model.hidden_states(cfg, p, x, lora=lo,
                                       compute_dtype=bf, attn_impl=impl)

        fn = make_batched_logits_fn(hidden_fn, head_key, bf, params, lora)
        out[impl] = torch.from_numpy(fn(ids.numpy(), last.numpy()))
        assert fa.flash_attention_fwd.launches - n_fa == (
            L if impl == "auto" else 0)
        assert lf.lora_epilogue.launches - n_epi == (
            L if family == "gpt2" else 1)
    ref = out["plain"]
    err = float((out["auto"] - ref).abs().max()) / max(
        1.0, float(ref.abs().max()))
    assert out["auto"].shape == (B, V) and bool(
        torch.isfinite(out["auto"]).all())
    assert err <= 2e-2, err


def test_gpt2_full_ft_step_kernel_path_matches_plain_path(dev):
    """One GPT-2 full fine-tuning step (D = 64, bf16 compute, every
    parameter trainable, the tied wte's gradients summed by autograd)
    through the flash forward and merged backward kernels against the
    plain attention: loss within 1e-2 and global grad norm within 2%
    (bf16), one forward and one backward launch a layer."""
    from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
    from mobilefinetuner_tpu_torch.optim.adam import tree_map
    from mobilefinetuner_tpu_torch.train.trainer import (TrainConfig,
                                                         init_optimizer,
                                                         make_train_step)
    cfg, params = _tiny_gpt2_d64(dev)
    g = torch.Generator().manual_seed(41)
    ids = torch.randint(0, cfg.vocab_size, (4, 96), generator=g).to(dev)
    mask = torch.ones(4, 96, device=dev)
    mask[2, 70:] = 0
    labels = torch.where(mask > 0, ids, -100)
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels}
    tc = TrainConfig(total_steps=4, lr=1e-3)
    metrics = {}
    for impl in ("auto", "plain"):
        def loss_fn(p, _f, mb, impl=impl):
            logits = gpt2.forward(cfg, p, mb["input_ids"],
                                  attention_mask=mb["attention_mask"],
                                  compute_dtype=torch.bfloat16,
                                  attn_impl=impl)
            return lm_cross_entropy_sum(logits, mb["labels"])

        p = tree_map(lambda t: t.clone(), params)
        n_f, n_b = fa.flash_attention_fwd.launches, \
            fa.flash_attention_bwd_merged.launches
        step_fn = make_train_step(loss_fn, tc, None)
        _, _, m = step_fn(p, None, init_optimizer(p, tc, None), batch, 0)
        metrics[impl] = (float(m["loss"]), float(m["grad_norm"]))
        launched = (fa.flash_attention_fwd.launches - n_f,
                    fa.flash_attention_bwd_merged.launches - n_b)
        assert launched == ((cfg.n_layer, cfg.n_layer) if impl == "auto"
                            else (0, 0))
    (lk, gk), (lp, gp) = metrics["auto"], metrics["plain"]
    assert abs(lk - lp) <= 1e-2, (lk, lp)
    assert abs(gk - gp) <= 2e-2 * gp, (gk, gp)


def test_snapshot_of_cuda_trees_is_pinned_and_never_aliased(dev):
    """io/async_ckpt.snapshot of a CUDA tree: every leaf lands in its own
    pinned host buffer with its dtype (bf16 kept), two snapshots share no
    buffer, and a later in-place change of the card's tensors reaches
    neither."""
    from mobilefinetuner_tpu_torch.io.async_ckpt import snapshot
    tree = ({"w": _randn(dev, torch.float32, 64, 33, seed=3)},
            {"b": [_randn(dev, torch.bfloat16, 1000, seed=4)],
             "step": torch.tensor(7, dtype=torch.int32, device=dev)})
    want = [t.cpu().clone() for t in (tree[0]["w"], tree[1]["b"][0],
                                      tree[1]["step"])]
    one, two = snapshot(tree), snapshot(tree)
    tree[0]["w"].mul_(3.0)
    tree[1]["b"][0].zero_()
    torch.cuda.synchronize()
    for snap in (one, two):
        leaves = (snap[0]["w"], snap[1]["b"][0], snap[1]["step"])
        for got, ref in zip(leaves, want):
            assert got.device.type == "cpu" and got.is_pinned()
            assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert one[0]["w"].data_ptr() != two[0]["w"].data_ptr()
    assert one[1]["b"][0].data_ptr() != two[1]["b"][0].data_ptr()


def test_a_real_cuda_oom_is_resource_exhausted(dev):
    """The degradation ladder takes the caching allocator's own
    out-of-memory error: an allocation of twice the card's memory."""
    from mobilefinetuner_tpu_torch.core import memory_guard as mg
    _, total = torch.cuda.mem_get_info(dev)
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
    assert mg.is_resource_exhausted(ei.value)
    check = mg.preflight(1.0, device=dev)
    assert check.cap_source == "mem_get_info" and check.verdict == "ok"
    assert abs(check.cap_mb - total / 2 ** 20) < 1.0


@pytest.mark.parametrize("rows,tpr,d_in,d_out,r,k", [
    (8, 1, 768, 2304, 4, 3),        # the serving decode step
    (16, 128, 768, 2304, 8, 8),     # the multi-tenant training step
    (4, 16, 640, 1024, 8, 2),       # a Gemma q_proj site
])
def test_routed_lora_takes_the_gather_under_every_impl(dev, rows, tpr,
                                                       d_in, d_out, r, k):
    """The ids-routed site on the card in bf16: naive, fused and auto give
    the same bits, and agree with the per-row products in f32 on the CPU
    within one bf16 ulp of the largest output."""
    from mobilefinetuner_tpu_torch.models import lora_apply as la
    bf = torch.bfloat16
    shape = (rows, tpr) if tpr > 1 else (rows,)
    x = _randn(dev, bf, *shape, d_in, seed=1)
    y = _randn(dev, bf, *shape, d_out, seed=2)
    entry = {"A": _randn(dev, torch.float32, k, d_in, r, seed=4)
             * d_in ** -0.5,
             "B": _randn(dev, torch.float32, k, r, d_out, seed=5) * 0.05,
             "scale": torch.linspace(0.5, 2.0, k, device=dev),
             "ids": torch.arange(rows, device=dev) % k}
    outs = [la.maybe_lora(y, x, entry, impl=impl).float()
            for impl in la.LORA_IMPLS]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = []
    for b in range(rows):
        j = int(entry["ids"][b])
        xa = (x[b].float().cpu() @ entry["A"][j].to(bf).float().cpu()
              ).to(bf).float()
        d = xa @ entry["B"][j].to(bf).float().cpu()
        ref.append(y[b].float().cpu()
                   + (float(entry["scale"][j]) * d).to(bf).float())
    ref = torch.stack(ref)
    ulp = 2.0 ** (int(torch.floor(torch.log2(ref.abs().max()))) - 7)
    assert float((outs[0].cpu() - ref).abs().max()) <= ulp
