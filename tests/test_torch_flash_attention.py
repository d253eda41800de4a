"""Port flash-attention forward (mobilefinetuner_tpu_torch/ops/
flash_attention.py) against the JAX package's Pallas kernel run in
interpret mode on the CPU: the same numpy inputs through both, out and
lse, f32 max abs error <= 1e-5.

On the CPU the port's wrapper runs its plain version (the kernel's blocked
online softmax in torch); the CUDA kernel itself is held against that
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.ops.attention import \
    dot_product_attention as jax_dot_product_attention
from mobilefinetuner_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_partial as jax_flash_attention_partial)
from mobilefinetuner_tpu_torch.ops import attention as port_attention
from mobilefinetuner_tpu_torch.ops import flash_attention as port_flash

TOL = 1e-5


def _inputs(seed, B, Hq, Hkv, S, D, n_real):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    pad = np.zeros((B, S), np.float32)
    for b, n in enumerate(n_real):
        pad[b, :n] = 1.0               # right padding, as serving pads
    return q, k, v, pad


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


@pytest.mark.parametrize("S", [64, 128])
@pytest.mark.parametrize("Hkv", [4, 2])
def test_flash_forward_matches_jax_kernel(S, Hkv):
    """Causal + right padding + a 24-key sliding window: the window lifts
    the key-block lower bound and, past the padding, leaves rows fully
    masked (out 0, as in the TPU kernel)."""
    B, Hq, D = 2, 4, 64
    q, k, v, pad = _inputs(S + Hkv, B, Hq, Hkv, S, D,
                           n_real=(S, S - 40))
    kw = dict(is_causal=True, sliding_window=24)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        padding_mask=jnp.asarray(pad), block_q=64, block_k=64, **kw))
    _, want_lse = jax_flash_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pad),
        block_q=64, block_k=64, **kw)
    out, lse = port_flash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pad), **kw)
    assert out.shape == (B, Hq, S, D) and lse.shape == (B, Hq, S, 1)
    assert _max_err(out, want) <= TOL
    assert _max_err(lse, want_lse) <= TOL
    # the drop-in returns the same out
    same = port_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        padding_mask=torch.from_numpy(pad), **kw)
    assert torch.equal(same, out)


def test_flash_reference_ragged_edge_matches_dense_oracle():
    """S not a multiple of the 64-row tile: the plain version masks the
    ragged edge, and agrees with the port's and the JAX dense oracle on
    every row that is not fully masked (causal, GQA, no window)."""
    B, Hq, Hkv, S, D = 1, 4, 2, 100, 64
    q, k, v, pad = _inputs(7, B, Hq, Hkv, S, D, n_real=(90,))
    out, _ = port_flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pad))
    dense = port_attention.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        padding_mask=torch.from_numpy(pad))
    jax_dense = np.asarray(jax_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        padding_mask=jnp.asarray(pad)))
    assert _max_err(out, dense) <= TOL
    assert _max_err(dense, jax_dense) <= TOL


def test_dispatch_and_wrapper_rules():
    q = torch.zeros(1, 2, 8, 16)
    assert not port_flash.flash_eligible(16, torch.float32)
    assert port_flash.flash_eligible(64, torch.bfloat16)
    # CPU tensors of any head dim take the plain version, never a kernel:
    # through the dispatch ("auto" and "plain", with or without an
    # attn_mask matrix) and through the wrapper itself
    port_flash.flash_attention_fwd.launches = 0
    x = torch.from_numpy(_inputs(3, 1, 2, 2, 8, 16, n_real=(8,))[0])
    dense = port_attention.dot_product_attention(x, x, x)
    for impl in ("auto", "plain"):
        assert torch.equal(port_attention.attention(x, x, x, impl=impl),
                           dense)
        port_attention.attention(x, x, x, impl=impl,
                                 attn_mask=torch.ones(8, 8, dtype=bool))
    out, lse = port_flash.flash_attention_fwd(q, q, q)
    assert port_flash.flash_attention_fwd.launches == 0
    assert out.shape == q.shape and lse.shape == (1, 2, 8, 1)
    # train-mode dropout needs a seed; without one it is eval (no dropout)
    x64 = torch.from_numpy(_inputs(4, 1, 2, 2, 64, 64, n_real=(64,))[0])
    plain = port_flash.flash_attention(x64, x64, x64)
    assert torch.equal(port_flash.flash_attention(x64, x64, x64,
                                                  attn_dropout=0.1), plain)
    dropped = port_flash.flash_attention(x64, x64, x64, attn_dropout=0.1,
                                         dropout_seed=5)
    assert not torch.equal(dropped, plain)
    assert torch.equal(dropped, port_flash.flash_attention(
        x64, x64, x64, attn_dropout=0.1, dropout_seed=5))
    # "flash" runs the kernels' plain versions on the CPU
    assert torch.equal(port_attention.attention(x64, x64, x64,
                                                impl="flash"), plain)
    for impl in ("xla", "kernel"):
        with pytest.raises(ValueError, match="impl"):
            port_attention.attention(q, q, q, impl=impl)


def test_kernel_build_raises_on_failure_and_reuses_a_build(tmp_path,
                                                          monkeypatch):
    """kernels/build.py with a stand-in nvcc: a failed compile raises with
    the compiler's output; a finished one is reused without compiling."""
    import os
    import stat

    from mobilefinetuner_tpu_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))

    def fake_nvcc(name, body):
        path = tmp_path / name
        path.write_text("#!/bin/sh\n" + body)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
        return str(path)

    bad = fake_nvcc("bad", "echo 'error: no sm_90a here'; exit 3\n")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.build_all(["k"], nvcc=bad)
    good = fake_nvcc("good", 'while [ "$1" != "-o" ]; do shift; done\n'
                             'touch "$2"; echo ok\n')
    out = build.build_all(["k"], nvcc=good)
    assert os.path.exists(out["k"][0]) and out["k"][1].strip() == "ok"
    again = build.build_all(["k"], nvcc=bad)     # cached: nvcc not run
    assert again["k"] == (out["k"][0], "")
