#!/usr/bin/env python3
"""How far the GPT-2 LoRA training path's result moves under a last-bit
change of the flash-attention forward, on one NVIDIA card.

    python3 rounding_sensitivity.py [--alt_fwd_source PATH.cu]
                                    [--alt_bwd_source PATH.cu]

Runs chip_smoke.py's `train` phase (GPT-2 small, random weights from seed
0, LoRA r 8 on attn_qkv + attn_proj, 30 steps of 8 x 2 x 128 tokens,
bf16) with the flash forward as the port runs it, and again with its
softmax scale moved by 2^-22 (a change in the last bit of the scores).
With --alt_fwd_source, also with the bf16 forward built from that source
(a C entry `mft_flash_attention_fwd` with the port's arguments that takes
dtype 1, e.g. an earlier version of csrc/flash_attention_fwd.cu), plain
and with the scale moved. With --alt_bwd_source, also with the bf16
merged backward built from that source (a C entry
`mft_flash_attention_bwd_merged_mma` with the port's arguments, e.g. a
variant of csrc/flash_attention_bwd_merged_mma.cu), plain and with the
forward's scale moved. Prints one JSON line a run (first-5 and last-5
mean loss, last loss, eval PPL after training) and the card's name and
power limit. The spread across the runs is the path's sensitivity to
rounding: a kernel change whose result lies within it has not changed
what the path learns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

SCALE_ARG = 12          # position of `scale` in the forward's C arguments


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alt_fwd_source", default=None)
    ap.add_argument("--alt_bwd_source", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rounding_sensitivity: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from mobilefinetuner_tpu_torch.kernels import build
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    from mobilefinetuner_tpu_torch.ops import flash_attention as fa
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc
    from mobilefinetuner_tpu_torch.ops import lora_fused as lf

    print(cs.card_line(), flush=True)
    build.build_all()
    runs = [("port", False, 0.0), ("port, scale x (1 + 2^-22)", False,
                                   2.0 ** -22)]
    if args.alt_fwd_source:
        so = os.path.join(build.BUILD_DIR, "libalt_fwd.so")
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        build.CSRC_DIR, "-o", so, args.alt_fwd_source],
                       check=True)
        build._LIBS["alt_fwd"] = ctypes.CDLL(so)
        runs += [("alt", True, 0.0),
                 ("alt, scale x (1 + 2^-22)", True, 2.0 ** -22)]
    if args.alt_bwd_source:
        so = os.path.join(build.BUILD_DIR, "libalt_bwd.so")
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        build.CSRC_DIR, "-o", so, args.alt_bwd_source],
                       check=True)
        build._LIBS["alt_bwd"] = ctypes.CDLL(so)
        runs += [("alt bwd", "bwd", 0.0),
                 ("alt bwd, scale x (1 + 2^-22)", "bwd", 2.0 ** -22)]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"flash_fwd": fa.flash_attention_fwd,
               "bwd_merged": fa.flash_attention_bwd_merged,
               "bwd_dq": fa.flash_attention_bwd_dq,
               "bwd_dkv": fa.flash_attention_bwd_dkv,
               "lora_epilogue": lf.lora_epilogue,
               "paged": da.paged_decode_attention,
               "decode": da.decode_attention,
               "fused_ce_fwd": fc.fused_ce_fwd,
               "fused_ce_dh": fc.fused_ce_bwd_dh,
               "fused_ce_dw": fc.fused_ce_bwd_dw,
               "fused_ce_fwd_lora": fc.fused_ce_fwd_lora,
               "fused_ce_dh_lora": fc.fused_ce_bwd_dh_lora,
               "fused_ce_dw_lora": fc.fused_ce_bwd_dw_lora}
    port_library, port_fn = fa.fwd_library, fa._fn
    port_bwd_library = fa.bwd_library

    def library(alt):
        def pick(dtype):
            if alt is True and dtype == torch.bfloat16:
                return "alt_fwd", "mft_flash_attention_fwd"
            return port_library(dtype)
        return pick

    def bwd_library(alt):
        def pick(dtype):
            if alt == "bwd" and dtype == torch.bfloat16:
                return "alt_bwd", "mft_flash_attention_bwd_merged_mma"
            return port_bwd_library(dtype)
        return pick

    def entry(eps):
        def get(lib, sym, n_ptrs):
            fn = port_fn(lib, sym, n_ptrs)
            if not eps or "bwd" in sym:
                return fn

            def moved(*a):
                a = list(a)
                a[SCALE_ARG] *= 1.0 + eps
                return fn(*a)
            return moved
        return get

    for name, alt, eps in runs:
        fa.fwd_library, fa._fn = library(alt), entry(eps)
        fa.bwd_library = bwd_library(alt)
        with tempfile.TemporaryDirectory() as work:
            stats, _, _, model = cs.train(torch, dev, work, kernels)
        del model
        torch.cuda.empty_cache()
        print(json.dumps({"run": name, **{k: stats[k] for k in (
            "first5_mean_loss", "last5_mean_loss", "last_loss",
            "eval_ppl_after")}}), flush=True)
    fa.fwd_library, fa._fn = port_library, port_fn
    fa.bwd_library = port_bwd_library
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
