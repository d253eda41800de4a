"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same CUDA inputs. Marked `cuda`: without an NVIDIA card and
nvcc every test here skips (the CPU run cannot build or launch a kernel).
On a machine with a card: `python -m pytest tests/test_torch_cuda.py`.
`chip_smoke.py` runs the same comparisons at the serving shapes."""

import dataclasses

import pytest
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.kernels import build
from mobilefinetuner_tpu_torch.models import generate, gpt2
from mobilefinetuner_tpu_torch.ops import attention as attn
from mobilefinetuner_tpu_torch.ops import decode_attention as da
from mobilefinetuner_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.parametrize("dtype,G,D,tol", [
    (torch.float32, 2, 64, 1e-4), (torch.bfloat16, 1, 64, 2e-2),
    (torch.bfloat16, 4, 256, 2e-2)])
def test_paged_kernel_matches_plain(dev, dtype, G, D, tol):
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
    tbl, ok = tbl.to(dev), ok.to(dev)
    n0 = da.paged_decode_attention.launches
    ctx = da.paged_decode_attention(q, pk, pv, tbl, 2, ok, D ** -0.5)
    assert da.paged_decode_attention.launches == n0 + 1
    ref = da.paged_attention(q, pk, pv, tbl, 2, ok, D ** -0.5)
    torch.cuda.synchronize()
    assert float((ctx - ref).abs().max()) <= tol


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
