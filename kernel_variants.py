"""Time variants of the port's kernels against the sources.

    python3 kernel_variants.py [--fwd NAME=PATH.cu ...]
                               [--dbt NAME=PATH.cu ...] [--profile]
                               [--iters N]
    python3 kernel_variants.py --rows5_13 [--epi NAME=PATH.cu ...]
                               [--decode NAME=PATH.cu ...]
    python3 kernel_variants.py --row12 [--paged NAME=PATH.cu ...]
    python3 kernel_variants.py --f32_ce_plans
    python3 kernel_variants.py --f32_decode [--paged_f32 NAME=PATH.cu ...]
                               [--decode_f32 NAME=PATH.cu ...]
                               [--split_variant lastcta|cpasync ...]
    python3 kernel_variants.py --mma_rate

Card only. Builds each variant source by hand (nvcc with the port's flags
and the csrc headers, into build/variants/) beside the repo's own
`csrc/fused_ce_fwd_lora_mma.cu` (row 9, `--fwd`) and
`csrc/fused_ce_dbt_mma.cu` (row 11's dbt-only mode, `--dbt`); a variant
exports the same C entry as the source it replaces and takes the same
launch plan (`ops/fused_ce.fwd_lora_mma_plan`, `dbt_mma_plan`). At the
Gemma-3-270M chunk (R 128, V 262,144, H 640, r 8, bf16) and at rank 128
(R 128, V 50,257, H 640), on chip_smoke.py's inputs for those cases, it
prints each variant's largest difference from the source's output; the
error of row 9's lse and gold (source and variants) against an f64
computation, and of row 11's dbt against its plain version, over
max(1, max |ref|) and, with dgold = 0 (the softmax part),
over max |ref| as chip_smoke.py holds it; then the device time of one
call with the host queued ahead, source and variants called in turns
(s, v.., v.., s), and with `--profile` torch.profiler's per-kernel
device time of the two sources at the Gemma chunk (with --row12, of
each timed function at each shape). Each build's ptxas
registers and spills are printed too. The last line is one JSON object
of the times and errors.

With --rows5_13 it times rows 5 and 13 instead (bf16, chip_smoke.py's
inputs): `csrc/lora_epilogue_vec.cu` at the training sites, generate's
decode shapes and the head adapter's lm_head with one row a thread and
with four (a runtime argument of the source), beside torch.addmm and the
`--epi` variants; `csrc/decode_attention_mma.cu` at GPT-2's and Gemma's
generate shapes, at its plan's chunk split and at 1, 2 and 3 tiles a
chunk, beside SDPA and the `--decode` variants. A variant exports the
source's C entry, or the first version's (`mft_lora_epilogue`, which
takes xa already scaled: it is timed with and without the three
elementwise passes that fold the scale; `mft_decode_attention`). Each
variant's output is held against the source's (bit for bit for the
epilogue, within 2e-2 for the decode), and times are taken in turns.

With --row12 it times row 12 instead (bf16, chip_smoke.py's inputs of
its `serving` and `gemma_serve` cases): `csrc/paged_decode_attention_vec.cu`
at its plan's chunk split and at other columns a chunk, beside the
library chain (the pages gathered, then SDPA) and the `--paged`
variants. A variant exports the source's C entry (run at the plan's
split) or the first version's, `mft_paged_decode_attention` (e.g. the
parent commit's csrc/paged_decode_attention.cu, which took bf16: the
first version in turns with the new source). Each output is held
against the source's within 2e-2, and times are taken in turns.

With --f32_ce_plans it times rows 6, 9 and 11 (dbt only) in f32 on their
3xTF32 sources (`csrc/fused_ce_fwd_tf32.cu`, `csrc/fused_ce_fwd_lora_tf32.cu`,
`csrc/fused_ce_dbt_tf32.cu`) at the Gemma chunk (chip_smoke.py's f32
inputs: R 128, V 262,144, H 640, r 8) under each launch plan of
`PLAN_SWEEP` (rows a CTA, columns of a W chunk, chunks in the ring;
`ops/fused_ce.LOGITS_PLANS` set to it alone), in turns (the plans in
order, then in reverse), with each plan's largest difference from the
plain version (lse and gold of rows 6 and 9; dbt over max(1, |ref|)).
Then row 8 (dW) in f32 on `csrc/fused_ce_dw_tf32.cu` under its two
layouts that fit, in turns (in order, then in reverse) with its first
version (`csrc/fused_ce.cu`'s FMA dw_kernel): the plan's (`DW_LAYOUTS`
"cluster": a thread-block cluster over H's halves, h held for the CTA's
life, the partial logits exchanged through distributed shared memory)
and "one_cta" (one CTA, 32 vocab rows a tile,
h's 640 columns in 64-row chunks reloaded from L2 for every tile), each
with its dW's largest difference from the plain version over max(1,
|ref|). Then two probes of row 6 at its own plan, in turns with the source: a
variant with the W chunks' copies after the first ones left out (its
output is wrong; the time of the loop without them), at the Gemma chunk
and at R 4,096, V 8,192 (the same chunks and the same L2 traffic a CTA,
W resident in L2, so no DRAM traffic).

With --f32_decode it times rows 12 and 13 in f32 instead, on
chip_smoke.py's inputs at the default-dtype paths' shapes (row 12 at
`gemma_serve_f32`'s 8 slots x 42 pages of 16, window 512; row 13 at
`generate`'s f32 last steps, GPT-2 8 x 12 x 1 x 64 at T 144 and Gemma
4 x 1 x 4 x 256 at T 617 with the window): the flash-decoding splits
(`csrc/paged_decode_attention_vec_f32.cu`,
`csrc/decode_attention_split_f32.cu`) at their plans' chunk counts
(`ops/decode_attention.paged_f32_plan`, `decode_f32_plan`) and at others
from one chunk to twice a wave, in turns with their first versions
(`csrc/paged_decode_attention.cu`, `csrc/decode_attention.cu`), the
library call (row 12: the pages gathered, then SDPA; row 13: SDPA) and
the `--paged_f32` / `--decode_f32` variants, which export the source's C
entry and run at its plan's split; `--split_variant` adds both sources
rebuilt on an alternative of csrc/decode_split_f32.cuh derived from it
(`SPLIT_VARIANT_EDITS`: "lastcta", the merge in each unit's last CTA
behind a counter; "cpasync", each round staged in shared memory by
cp.async). Each output is held against the plain version within 1e-5.

With --mma_rate it measures the card's tensor-core rates instead: a
kernel of independent mma.sync products (TF32 m16n8k8, bf16 m16n8k16)
and one of wgmma m64n32k8 TF32 products (A from registers, B from shared
memory by a descriptor, no swizzle) at 4, 8 and 16 warps a CTA, one CTA
an SM, in TFLOP/s; and it checks the wgmma fragment and descriptor
layout that a kernel would rely on (A as mma.sync's m16n8k8 A fragment a
warp, B K-major in 8-row x 16-byte core matrices, D as mma.sync's C
fragment an n-tile) against a host product of exact TF32 values, for
both orders of the core matrices (LBO and SBO).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"gemma_chunk": (128, 262144, 640, 8), "rank128": (128, 50257, 640,
                                                            128)}


def build_variants(build, variants, out_dir, sources):
    """Build each (kind, name, path) variant by hand, all at once, beside
    the named sources (ptxas -v); print every build's registers and
    spills. Returns {name: (kind, CDLL)}."""
    procs = {}
    for kind, name, path in variants:
        so = os.path.join(out_dir, f"lib{kind}_{name}.so")
        procs[name] = (kind, so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             build.CSRC_DIR, "-o", so, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = build.build_all(sources, verbose=True)
    logs = {name: log for name, (_, log) in built.items()}
    libs = {}
    for name, (kind, so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        logs[name] = log
        libs[name] = (kind, ctypes.CDLL(so))
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line and "registers" in line or \
                    "spill" in line and " 0 bytes spill stores" not in line:
                print(f"  {name}: {line.strip()}")
    return libs


def in_turns(fns, queued):
    """{name: [us, us]}: each fn timed in the order given, then in the
    reverse order."""
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(round(queued(fns[k]), 2))
    return times


def rows_5_13(args, torch, build, out_dir) -> int:
    """Rows 5 and 13: the sources at their runtime alternatives, beside
    the library call and the --epi / --decode variants (module
    docstring)."""
    import chip_smoke as cs
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    from mobilefinetuner_tpu_torch.ops import lora_fused as lf
    variants = [(kind, f"{kind}_{name}", path)
                for kind, specs in (("epi", args.epi),
                                    ("decode", args.decode))
                for name, path in (v.split("=", 1) for v in specs)]
    libs = build_variants(build, variants, out_dir,
                          ["lora_epilogue_vec", "decode_attention_mma"])
    dev = torch.device("cuda", 0)
    torch.cuda._sleep(int(2e9))          # the card's clocks up
    stream = torch.cuda.current_stream().cuda_stream

    def queued(fn):
        return cs.queued_ms(fn, args.iters) * 1e3

    def entry(lib, sym, n_ptrs, n_ints):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    src = build.load("lora_epilogue_vec").mft_lora_epilogue_vec
    result = {"epilogue": {}, "decode": {}}
    for site, N, d_out in (("attn_qkv", 1024, 2304), ("attn_proj", 1024, 768),
                           ("gate_proj", 1024, 2048), ("k_proj", 1024, 256),
                           ("decode_attn_qkv", 8, 2304),
                           ("decode_gate_proj", 4, 2048),
                           ("decode_lm_head", 4, 262144)):
        g = torch.Generator().manual_seed(N + d_out)
        y, xa, b = (torch.randn(s, generator=g).to(dev, torch.bfloat16)
                    for s in ((N, d_out), (N, 8), (8, d_out)))
        scale = torch.tensor(cs.EPI_SCALE, device=dev)
        want, _ = lf.lora_epilogue(y, xa, b, scale)
        out, xs_out = torch.empty_like(y), torch.empty_like(xa)

        def run(fn, rows):
            def call():
                build.check_launch("epilogue", fn(
                    y.data_ptr(), xa.data_ptr(), b.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), xs_out.data_ptr(), N,
                    d_out, 8, 8, rows, 1, stream))
                return out
            return call
        fns = {"source": lambda: lf.lora_epilogue(y, xa, b, scale)[0],
               "rows1": run(src, 1)}
        if N > 4:
            fns["rows4"] = run(src, 4)
        for name, (kind, lib) in libs.items():
            if kind != "epi":
                continue
            if hasattr(lib, "mft_lora_epilogue_vec"):
                fns[name] = run(entry(lib, "mft_lora_epilogue_vec", 6, 6), 1)
                continue
            first = entry(lib, "mft_lora_epilogue", 4, 4)
            xs = (xa.float() * scale).to(torch.bfloat16)

            def first_call(fn=first, fold=False):
                x = (xa.float() * scale).to(torch.bfloat16) if fold else xs
                build.check_launch("epilogue", fn(
                    y.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(),
                    N, d_out, 8, 1, stream))
                return out
            fns[name] = first_call
            fns[f"{name}+fold"] = lambda f=first_call: f(fold=True)
        for name, fn in fns.items():
            check = fn()
            torch.cuda.synchronize()
            if not torch.equal(check, want):
                raise RuntimeError(f"epilogue {site}: {name} differs from "
                                   f"the source")
        fns["addmm"] = lambda: torch.addmm(y, xa, b, alpha=cs.EPI_SCALE)
        result["epilogue"][site] = in_turns(fns, queued)
        print(f"epilogue {site} (y {N}x{d_out}, r 8, bf16): device us, in "
              f"turns: {result['epilogue'][site]}", flush=True)

    src = entry(build.load("decode_attention_mma"),
                "mft_decode_attention_mma", 6, 8)
    src.argtypes = src.argtypes[:-1] + [ctypes.c_float, ctypes.c_void_p]
    T_gemma = max(cs.GEN["gemma_words"]) + 1 + cs.GEN["new"]
    pads = [max(cs.GEN["gemma_words"]) - n for n in cs.GEN["gemma_words"]]
    for case, (B, KV, G, T, D, n_pad, window) in {
            "gpt2_bench": (8, 12, 1, 192, 64,
                           (0, 17, 40, 64, 90, 100, 120, 3), None),
            "gemma_path": (4, 1, 4, T_gemma, 256, pads,
                           cs.GEN["window"])}.items():
        q, kc, vc, ok = cs.decode_inputs(torch, dev, torch.bfloat16, B, KV,
                                         G, T, D, seed=T + D, n_pad=n_pad,
                                         window=window)
        scale = D ** -0.5
        want = da.decode_attention(q, kc, vc, ok, scale)
        plan = da.decode_mma_plan(B, KV, G, T, D, torch.bfloat16)
        n_tiles = -(-T // 32)
        ctx = torch.empty_like(want)
        ptrs = (q, kc, vc, ok, ctx)

        def split(fn, tpc):
            nc = -(-n_tiles // tpc)
            ws = torch.empty(nc * B * KV * G * (D + 2), device=dev)

            def call():
                build.check_launch("decode", fn(
                    *(t.data_ptr() for t in ptrs), ws.data_ptr(), B, KV, G,
                    D, T, tpc, nc, 1, scale, stream))
                return ctx
            return call
        fns = {f"source (plan: {plan['n_chunks']} chunks of "
               f"{plan['tiles_per_chunk']})":
               lambda: da.decode_attention(q, kc, vc, ok, scale)}
        for tpc in (1, 2, 3):
            fns[f"tiles_per_chunk {tpc}"] = split(src, tpc)
        for name, (kind, lib) in libs.items():
            if kind != "decode":
                continue
            if hasattr(lib, "mft_decode_attention_mma"):
                fn = entry(lib, "mft_decode_attention_mma", 6, 8)
                fn.argtypes = fn.argtypes[:-1] + [ctypes.c_float,
                                                  ctypes.c_void_p]
                fns[name] = split(fn, plan["tiles_per_chunk"])
                continue
            first = entry(lib, "mft_decode_attention", 5, 6)
            first.argtypes = first.argtypes[:-1] + [ctypes.c_float,
                                                    ctypes.c_void_p]

            def first_call(fn=first):
                build.check_launch("decode", fn(
                    *(t.data_ptr() for t in ptrs), B, KV, G, D, T, 1, scale,
                    stream))
                return ctx
            fns[name] = first_call
        for name, fn in fns.items():
            err = cs.max_err(fn(), want)
            torch.cuda.synchronize()
            if not err <= 2e-2:
                raise RuntimeError(f"decode {case}: {name} is {err} from "
                                   f"the source")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, mask = q.reshape(B, KV * G, 1, D), ok[:, None, None, :]
        fns["sdpa"] = lambda: sdpa(qh, kc, vc, attn_mask=mask, scale=scale,
                                   enable_gqa=True)
        result["decode"][case] = in_turns(fns, queued)
        print(f"decode {case} (q {B}x{KV}x{G}x{D}, T {T}, bf16): device "
              f"us, in turns: {result['decode'][case]}", flush=True)
    print(json.dumps({"kernel_variants": result}))
    return 0


def profiled(torch, fn, calls=10):
    """[(kernel, device us a call)] of fn from torch.profiler: each
    kernel's own time on the card, launch gaps left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    return [(e.key[:60], e.device_time_total / calls)
            for e in prof.key_averages() if e.device_time_total > 0]


def row_12(args, torch, build, out_dir) -> int:
    """Row 12: the source at its plan's split and at other chunk sizes,
    beside the library chain and the --paged variants (module
    docstring)."""
    import chip_smoke as cs
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    variants = [("paged", f"paged_{name}", path) for name, path in
                (v.split("=", 1) for v in args.paged)]
    libs = build_variants(build, variants, out_dir,
                          ["paged_decode_attention_vec"])
    dev = torch.device("cuda", 0)
    torch.cuda._sleep(int(2e9))          # the card's clocks up
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def entry(lib, sym, n_ptrs, n_ints):
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    src = entry(build.load("paged_decode_attention_vec"),
                "mft_paged_decode_attention_vec", 7, 12)
    cases = {c[0]: c for c in cs.PAGED_CASES}
    result = {}
    for case in ("serving", "gemma_serve"):
        _, _, S, KV, G, D, bT, M, L, window, _ = cases[case]
        q, pk, pv, tbl, ok = cs.paged_inputs(
            torch, dev, torch.bfloat16, S, KV, G, D, bT, M, L, seed=S * D,
            window=window)
        layer, scale = L - 1, D ** -0.5
        NB = pk.shape[0]
        want = da.paged_decode_attention(q, pk, pv, tbl, layer, ok, scale)
        plan = da.paged_plan(S, KV, G, M, bT, D, torch.bfloat16, n_sm)
        ctx = torch.empty_like(want)
        ptrs = (q, pk, pv, tbl, ok, ctx)

        def split(fn, cpc):
            nc = -(-M * bT // cpc)
            ws = torch.empty(max(1, nc * S * KV * G * (D + 2)), device=dev)

            def call():
                build.check_launch("paged", fn(
                    *(t.data_ptr() for t in ptrs), ws.data_ptr(), S, KV, G,
                    D, NB, L, layer, bT, M, cpc, nc, 1, scale, stream))
                return ctx
            return call
        fns = {f"source (plan: {plan['n_chunks']} chunks of {plan['cpc']} "
               f"columns)": lambda: da.paged_decode_attention(
                   q, pk, pv, tbl, layer, ok, scale)}
        max_cpc = da.PAGED_VEC_ROW_SLOTS * 256 // D
        for cpc in sorted({bT, 2 * bT, 4 * bT, M * bT // 2, M * bT,
                           max_cpc - max_cpc % bT}):
            if cpc != plan["cpc"] and cpc <= max_cpc:
                fns[f"cpc {cpc} ({-(-M * bT // cpc)} chunks)"] = split(src,
                                                                      cpc)
        for name, (kind, lib) in libs.items():
            if hasattr(lib, "mft_paged_decode_attention_vec"):
                fns[name] = split(entry(lib, "mft_paged_decode_attention_vec",
                                        7, 12), plan["cpc"])
                continue
            first = entry(lib, "mft_paged_decode_attention", 6, 10)

            def first_call(fn=first):
                build.check_launch("paged", fn(
                    *(t.data_ptr() for t in ptrs), S, KV, G, D, NB, L, layer,
                    bT, M, 1, scale, stream))
                return ctx
            fns[name] = first_call
        for name, fn in fns.items():
            err = cs.max_err(fn(), want)
            torch.cuda.synchronize()
            if not err <= 2e-2:
                raise RuntimeError(f"paged {case}: {name} is {err} from "
                                   f"the source")
        fns["library chain"] = cs.paged_library_chain(
            torch, q, pk, pv, tbl, layer, ok, scale)
        result[case] = in_turns(
            fns, lambda fn: cs.queued_ms(fn, args.iters) * 1e3)
        print(f"paged {case} (q {S}x{KV}x{G}x{D}, {M} pages of {bT}, "
              f"{int(ok.sum())} columns attendable, bf16): device us, in "
              f"turns: {result[case]}", flush=True)
        if args.profile:
            for name, fn in fns.items():
                for kernel, us in profiled(torch, fn):
                    print(f"paged {case}: profile {name}: {kernel} "
                          f"{us:.2f} us", flush=True)
    print(json.dumps({"kernel_variants": {"paged": result}}))
    return 0


MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// independent products: kind 0 mma.sync TF32 m16n8k8, kind 1 bf16
// m16n8k16, 8 accumulators a warp
template <int KIND>
__global__ void sync_rate(float* out, int iters) {
  uint32_t a0 = 0x3f800000u ^ (threadIdx.x << 13), a1 = 0x3f800000u;
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a1), "r"(a0), "r"(a1), "r"(a0));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a1), "r"(a0), "r"(a1), "r"(a0));
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// descriptor of a K-major, unswizzled operand at p: LBO between core
// matrices adjacent in K, SBO between 8-row groups
__device__ __forceinline__ uint64_t desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#define WG_N32(D, A, DESC, ACC)                                            \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "               \
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "          \
      "{%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"                              \
      : "+f"(D[0]), "+f"(D[1]), "+f"(D[2]), "+f"(D[3]), "+f"(D[4]),        \
        "+f"(D[5]), "+f"(D[6]), "+f"(D[7]), "+f"(D[8]), "+f"(D[9]),        \
        "+f"(D[10]), "+f"(D[11]), "+f"(D[12]), "+f"(D[13]), "+f"(D[14]),   \
        "+f"(D[15])                                                        \
      : "r"(A[0]), "r"(A[1]), "r"(A[2]), "r"(A[3]), "l"(DESC), "r"(ACC))

// wgmma m64n32k8 TF32, A from registers, B [32 n][8 k] in shared memory,
// two accumulator sets a warpgroup
__global__ void wgmma_rate(float* out, int iters) {
  __shared__ __align__(128) float b[32 * 8];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) b[i] = 1.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t d = desc(b, 128, 256);
  uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  float c0[16] = {}, c1[16] = {};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int i = 0; i < iters; ++i) {
    WG_N32(c0, a, d, 1);
    WG_N32(c1, a, d, 1);
    WG_N32(c0, a, d, 1);
    WG_N32(c1, a, d, 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) sum += c0[j] + c1[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

// one warpgroup: d [64][32] = a [64][8] b [32][8]^T, a by mma.sync's A
// fragment a warp, b staged as core matrices in `order` 0 (K-adjacent
// core matrices 128 bytes apart, 8-row groups 256) or 1 (8-row groups
// 128 apart, K-adjacent 512), d read back as mma.sync's C fragment an
// n-tile
__global__ void wgmma_check(const float* a, const float* b, float* d,
                            int order) {
  __shared__ __align__(128) float bs[32 * 8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  for (int i = tid; i < 256; i += 128) {
    const int n = i / 8, k = i % 8;
    const int cm = order == 0 ? (n / 8) * 2 + k / 4 : (k / 4) * 4 + n / 8;
    bs[cm * 32 + (n % 8) * 4 + k % 4] = b[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t ds = order == 0 ? desc(bs, 128, 256) : desc(bs, 512, 128);
  const int m0 = warp * 16;
  uint32_t af[4] = {__float_as_uint(a[(m0 + g) * 8 + t]),
                    __float_as_uint(a[(m0 + g + 8) * 8 + t]),
                    __float_as_uint(a[(m0 + g) * 8 + t + 4]),
                    __float_as_uint(a[(m0 + g + 8) * 8 + t + 4])};
  float c[16] = {};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  WG_N32(c, af, ds, 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 4; ++e)
      d[(m0 + g + 8 * (e / 2)) * 32 + 8 * j + 2 * t + e % 2] = c[4 * j + e];
}

extern "C" int mft_rate(int kind, int warps, int blocks, int iters,
                        float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    sync_rate<0><<<blocks, warps * 32, 0, st>>>(out, iters);
  else if (kind == 1)
    sync_rate<1><<<blocks, warps * 32, 0, st>>>(out, iters);
  else
    wgmma_rate<<<blocks, warps * 32, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" int mft_wgmma_check(const float* a, const float* b, float* d,
                               int order, void* stream) {
  wgmma_check<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(a, b, d,
                                                                order);
  return (int)cudaGetLastError();
}
"""


# Two alternatives to csrc/decode_split_f32.cuh's design, derived from it
# by the edits below (each (anchor, replacement) must match once): "lastcta"
# merges the chunks in the last CTA of each (kv group, slot) behind a
# counter the kernel resets, instead of the PDL merge kernel; "cpasync"
# copies each round's K/V rows into shared memory by cp.async (masked rows
# zero-filled), instead of loading them into registers.
SPLIT_VARIANT_EDITS = {
    "lastcta": [
        ("#pragma once",
         "#pragma once\n__device__ unsigned split_counters[1 << 16];"),
        ('asm volatile("griddepcontrol.launch_dependents;");', ""),
        ("""      if (d == 0) {
        ws[rc * 2] = mg;
        ws[rc * 2 + 1] = den;
      }
    }
  }
}""", """      if (d == 0) {
        ws[rc * 2] = mg;
        ws[rc * 2 + 1] = den;
      }
    }
  }
  if (n_chunks == 1) return;
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  const unsigned unit = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0)
    last = atomicAdd(&split_counters[unit], 1u) == (unsigned)n_chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* accw = ws + (size_t)n_chunks * rows_total * 2;
  for (int i = tid; i < nq * D; i += THREADS) {
    const int g = i / D, d = i % D;
    const size_t row = qrow0 + g;
    float mmax = NEG_INF;
    for (int c = 0; c < n_chunks; ++c) {
      const size_t rc = (size_t)c * rows_total + row;
      if (__ldcg(ws + rc * 2 + 1) > 0.f)
        mmax = fmaxf(mmax, __ldcg(ws + rc * 2));
    }
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_chunks; ++c) {
      const size_t rc = (size_t)c * rows_total + row;
      const float lc = __ldcg(ws + rc * 2 + 1);
      const float a = __ldcg(accw + rc * D + d);
      if (lc > 0.f) {
        const float f = expf(__ldcg(ws + rc * 2) - mmax);
        num = fmaf(f, a, num);
        den = fmaf(f, lc, den);
      }
    }
    ctx[row * D + d] = den > 0.f ? num / den : 0.f;
  }
  if (tid == 0) split_counters[unit] = 0;
}"""),
        ("if (e != cudaSuccess || n_chunks == 1) return (int)e;",
         "return (int)e;")],
    "cpasync": [
        ("""          (size_t)warps_for(QG) * QG * D) * 4;
}""", """          (size_t)warps_for(QG) * QG * D) * 4 +
         (size_t)2 * ROW_SLOTS * 256 * 4;   // the round's K and V
}
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(a),
               "l"(src), "r"(valid ? 16 : 0));
}"""),
        ("""  float* acc_s = l_s + WARPS * QG;                    // [WARPS][QG][D]""",
         """  float* acc_s = l_s + WARPS * QG;                    // [WARPS][QG][D]
  float* kst = acc_s + WARPS * QG * D;                 // [RND][D]
  float* vst = kst + RND * D;"""),
        ("""    float4 kr[PASSES][2], vr[PASSES][2];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      kr[p][0] = kr[p][1] = vr[p][0] = vr[p][1] =
          make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[p]) {
        const size_t off =
            rows_of.row(s, kv, c0 + base + r0 + p * ROWS, ent[p]) * D +
            cl * 4;
        kr[p][0] = *reinterpret_cast<const float4*>(kc + off);
        kr[p][1] = *reinterpret_cast<const float4*>(kc + off + HALF);
        vr[p][0] = *reinterpret_cast<const float4*>(vc + off);
        vr[p][1] = *reinterpret_cast<const float4*>(vc + off + HALF);
      }
    }""", """#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const size_t off = live[p] ?
          rows_of.row(s, kv, c0 + base + r0 + p * ROWS, ent[p]) * D +
          cl * 4 : 0;
      const int j = (r0 + p * ROWS) * D + cl * 4;
      cp16(kst + j, kc + off, live[p]);
      cp16(kst + j + HALF, kc + off + HALF, live[p]);
      cp16(vst + j, vc + off, live[p]);
      cp16(vst + j + HALF, vc + off + HALF, live[p]);
    }
    asm volatile("cp.async.commit_group;\\n" ::);
    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");"""),
        ("""        const float kf = comp(kr[p][i >> 2], i & 3);""",
         """        const int j = (r0 + p * ROWS) * D + cl * 4 + (i >> 2) * HALF;
        const float kf = comp(*reinterpret_cast<const float4*>(kst + j),
                              i & 3);"""),
        ("""          acc[g][i] = fmaf(pv, comp(vr[p][i >> 2], i & 3), acc[g][i]);""",
         """          acc[g][i] = fmaf(pv, comp(*reinterpret_cast<const float4*>(
              vst + (r0 + p * ROWS) * D + cl * 4 + (i >> 2) * HALF),
              i & 3), acc[g][i]);"""),
        ("""  dim3 grid(KV * n_qg, n_chunks, S);""",
         """  dim3 grid(KV * n_qg, n_chunks, S);
  cudaFuncSetAttribute(split_kernel<D, QG, Rows>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes(D, QG));""")]}


def split_variant_sources(build, name, out_dir):
    """[(kind, name, path)]: the two f32 split sources with
    csrc/decode_split_f32.cuh replaced by its `name` variant
    (SPLIT_VARIANT_EDITS), written into out_dir."""
    with open(os.path.join(build.CSRC_DIR, "decode_split_f32.cuh")) as f:
        header = f.read()
    for old, new in SPLIT_VARIANT_EDITS[name]:
        if header.count(old) != 1:
            raise RuntimeError(f"split variant {name}: an edit's anchor is "
                               f"not in decode_split_f32.cuh once")
        header = header.replace(old, new)
    with open(os.path.join(out_dir, f"split_{name}.cuh"), "w") as f:
        f.write(header)
    out = []
    for kind, src in (("paged", "paged_decode_attention_vec_f32"),
                      ("decode", "decode_attention_split_f32")):
        with open(os.path.join(build.CSRC_DIR, f"{src}.cu")) as f:
            text = f.read().replace('#include "decode_split_f32.cuh"',
                                    f'#include "split_{name}.cuh"')
        path = os.path.join(out_dir, f"{src}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        out.append((kind, f"{kind}_{name}", path))
    return out


def f32_decode(args, torch, build, out_dir) -> int:
    """Rows 12 and 13 in f32: the splits at their plans' chunk counts and
    at others, beside their first versions, the library call and the
    --paged_f32 / --decode_f32 variants (module docstring)."""
    import chip_smoke as cs
    from mobilefinetuner_tpu_torch.ops import decode_attention as da
    variants = [(kind, f"{kind}_{name}", path)
                for kind, given in (("paged", args.paged_f32),
                                    ("decode", args.decode_f32))
                for name, path in (v.split("=", 1) for v in given)]
    for name in args.split_variant:
        variants += split_variant_sources(build, name, out_dir)
    libs = build_variants(build, variants, out_dir,
                          ["paged_decode_attention_vec_f32",
                           "decode_attention_split_f32",
                           "paged_decode_attention", "decode_attention"])
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    torch.cuda._sleep(int(2e9))          # the card's clocks up
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    syms = {"paged": ("paged_decode_attention_vec_f32",
                      "mft_paged_decode_attention_vec_f32", 7, 12),
            "decode": ("decode_attention_split_f32",
                       "mft_decode_attention_split_f32", 6, 8)}

    def entry(lib, kind):
        _, sym, n_ptrs, n_ints = syms[kind]
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def sweep(kind, cols, plan, units, split, first, library, want):
        """The functions to time: the source at its plan, at other chunk
        counts, the variants, the first version and the library call,
        each output held against `want` within 1e-5."""
        src = entry(build.load(syms[kind][0]), kind)
        fns = {f"source (plan: {plan['n_chunks']} chunks of "
               f"{plan['cpc']})": split(src, plan["cpc"])}
        wave = max(1, n_sm // units)          # chunks a unit in a wave
        rnd = plan["round_rows"]
        cpcs = {-(-cols // max(1, n)) for n in (1, 2, 4, 8, wave // 4,
                                               wave // 2, 3 * wave // 4,
                                               wave, 2 * wave)}
        cpcs |= {min(cols, c) for c in (rnd // 2, 3 * rnd // 4, rnd)}
        for cpc in sorted(cpcs - {plan["cpc"]}, reverse=True):
            fns[f"{-(-cols // cpc)} chunks of {cpc}"] = split(src, cpc)
        for name, (k, lib) in libs.items():
            if k == kind:
                fns[name] = split(entry(lib, kind), plan["cpc"])
        fns["first version"] = first
        for name, fn in fns.items():
            err = cs.max_err(fn(), want)
            torch.cuda.synchronize()
            if not err <= 1e-5:
                raise RuntimeError(f"{kind}: {name} is {err} from the "
                                   f"plain version")
        fns["library"] = library
        if args.profile:
            for name in list(fns)[:1]:
                for kernel, us in profiled(torch, fns[name]):
                    print(f"{kind}: profile {name}: {kernel} {us:.2f} us",
                          flush=True)
        return in_turns(fns, lambda fn: cs.queued_ms(fn, args.iters) * 1e3)

    result = {}
    case = {c[0]: c for c in cs.PAGED_CASES}["gemma_serve_f32"]
    _, _, S, KV, G, D, bT, M, L, window, _ = case
    q, pk, pv, tbl, ok = cs.paged_inputs(torch, dev, f32, S, KV, G, D, bT,
                                         M, L, seed=S * D, window=window)
    layer, scale, NB = L - 1, D ** -0.5, pk.shape[0]
    want = da.paged_attention(q, pk, pv, tbl, layer, ok, scale)
    ctx = torch.empty_like(want)

    def paged_split(fn, cpc):
        nc = -(-M * bT // cpc)
        ws = torch.empty(max(1, nc * S * KV * G * (D + 2)), device=dev)

        def call():
            build.check_launch("paged f32", fn(
                *(t.data_ptr() for t in (q, pk, pv, tbl, ok, ctx, ws)), S,
                KV, G, D, NB, L, layer, bT, M, cpc, nc, 0, scale, stream))
            return ctx
        return call
    result["paged_gemma_serve_f32"] = sweep(
        "paged", M * bT, da.paged_f32_plan(S, KV, G, M, bT, D, f32, n_sm),
        S * KV, paged_split,
        lambda: cs.fma_paged(q, pk, pv, tbl, layer, ok, scale),
        cs.paged_library_chain(torch, q, pk, pv, tbl, layer, ok, scale),
        want)
    print(f"paged f32 gemma_serve_f32 (q {S}x{KV}x{G}x{D}, {M} pages of "
          f"{bT}, {int(ok.sum())} columns attendable): device us, in "
          f"turns: {result['paged_gemma_serve_f32']}", flush=True)
    del pk, pv
    lens = {"gpt2": [8, 26, 45, 64, 83, 102, 121, cs.GEN["gpt2_max"]],
            "gemma": [1 + n for n in cs.GEN["gemma_words"]]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for fam, (KV, G, D, window) in (("gpt2", (12, 1, 64, None)),
                                    ("gemma", (1, 4, 256,
                                               cs.GEN["window"]))):
        P = max(lens[fam])
        T, B = P + cs.GEN["tf_new"], len(lens[fam])
        q, kc, vc, ok = cs.decode_inputs(
            torch, dev, f32, B, KV, G, T, D, seed=T + D,
            n_pad=[P - n for n in lens[fam]], window=window)
        scale = D ** -0.5
        want = da.xla_reference(q, kc, vc, ok, scale)
        ctx = torch.empty_like(want)

        def decode_split(fn, cpc, q=q, kc=kc, vc=vc, ok=ok, ctx=ctx, B=B,
                         KV=KV, G=G, D=D, T=T, scale=scale):
            nc = -(-T // cpc)
            ws = torch.empty(max(1, nc * B * KV * G * (D + 2)), device=dev)

            def call():
                build.check_launch("decode f32", fn(
                    *(t.data_ptr() for t in (q, kc, vc, ok, ctx, ws)), B,
                    KV, G, D, T, cpc, nc, 0, scale, stream))
                return ctx
            return call
        qh, mask = q.reshape(B, KV * G, 1, D), ok[:, None, None, :]
        result[f"decode_{fam}"] = sweep(
            "decode", T, da.decode_f32_plan(B, KV, G, T, D, f32, n_sm),
            B * KV, decode_split,
            lambda q=q, kc=kc, vc=vc, ok=ok, s=scale: cs.fma_decode(
                q, kc, vc, ok, s),
            lambda qh=qh, kc=kc, vc=vc, mask=mask, s=scale: sdpa(
                qh, kc, vc, attn_mask=mask, scale=s, enable_gqa=True),
            want)
        print(f"decode f32 {fam} (q {B}x{KV}x{G}x{D}, T {T}, "
              f"{int(ok.sum())} of {B * T} attendable): device us, in "
              f"turns: {result[f'decode_{fam}']}", flush=True)
    print(json.dumps({"kernel_variants": {"f32_decode": result}}))
    return 0


def mma_rate(torch, build, out_dir) -> int:
    """--mma_rate (module docstring)."""
    path = os.path.join(out_dir, "mma_rate.cu")
    with open(path, "w") as f:
        f.write(MMA_RATE_SRC)
    so = os.path.join(out_dir, "libmma_rate.so")
    log = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas",
                          "-v", "-o", so, path], capture_output=True,
                         text=True)
    print(log.stdout + log.stderr)
    if log.returncode:
        return 1
    lib = ctypes.CDLL(so)
    lib.mft_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.mft_wgmma_check.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                            ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    # exact TF32 values: integers in [-8, 8] over 4
    a = (torch.randint(-8, 9, (64, 8), generator=g) / 4).to(dev)
    b = (torch.randint(-8, 9, (32, 8), generator=g) / 4).to(dev)
    want = a.double() @ b.double().T
    result = {"card": torch.cuda.get_device_name(0)}
    for order in (0, 1):
        d = torch.full((64, 32), float("nan"), device=dev)
        code = lib.mft_wgmma_check(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                   order, stream)
        torch.cuda.synchronize()
        result[f"wgmma_check_order{order}"] = (
            code, float((d.double() - want).abs().max()))
    flops = {0: 16 * 8 * 8 * 2 * 8, 1: 16 * 8 * 16 * 2 * 8,
             2: 64 * 32 * 8 * 2 * 4}      # a loop iteration, a warp(group)
    names = {0: "mma.sync tf32 m16n8k8", 1: "mma.sync bf16 m16n8k16",
             2: "wgmma tf32 m64n32k8 (A in registers)"}
    torch.cuda._sleep(int(2e9))
    for kind in (0, 1, 2):
        for warps in (4, 8, 16):
            iters = 20000
            out = torch.empty(n_sm * warps * 32, device=dev)
            lib.mft_rate(kind, warps, n_sm, iters, out.data_ptr(), stream)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            code = lib.mft_rate(kind, warps, n_sm, iters, out.data_ptr(),
                                stream)
            end.record()
            torch.cuda.synchronize()
            units = warps if kind < 2 else warps // 4
            tf = flops[kind] * iters * units * n_sm / (
                start.elapsed_time(end) * 1e-3) / 1e12
            result[f"{names[kind]}, {warps} warps"] = (code, round(tf, 1))
    for k, v in result.items():
        print(f"{k}: {v}")
    print(json.dumps(result))
    return 0


PLAN_SWEEP = ((64, 32, 3), (64, 32, 2), (32, 64, 4), (32, 64, 2),
              (32, 32, 4), (32, 32, 3), (16, 64, 4), (16, 64, 2))
# row 8's f32 layouts at the Gemma chunk: changes to dw_tf32_plan's
DW_LAYOUTS = {"cluster": {},
              "one_cta": {"vocab_groups": 2, "row_chunk": 64, "hp": 640,
                          "n_parts": 1}}


def f32_ce_plans(torch, build) -> int:
    """--f32_ce_plans (module docstring)."""
    import chip_smoke as cs
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc
    built = build.build_all(["fused_ce_fwd_tf32", "fused_ce_dbt_tf32",
                             "fused_ce_fwd_lora_tf32", "fused_ce_dw_tf32",
                             "fused_ce"], verbose=True)
    for name, (_, log) in built.items():
        print(name, cs.ptxas_summary(log))
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    h, w, lab, dl, dg = cs.fused_ce_inputs(torch, dev, f32, 128, 262144,
                                           640, seed=43)
    g = torch.Generator(device=dev).manual_seed(44)
    xa = torch.randn(128, 8, generator=g, device=dev)
    bt = 0.05 * torch.randn(262144, 8, generator=g, device=dev)
    rl, rg = fc.fused_ce_fwd_reference(h, w, lab)
    rll, rlg = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)
    lora = (h, w, xa, bt, lab, rll, dl, dg)
    ref_dbt = fc.fused_ce_dw_lora_reference(*lora, want_dw=False)[1]
    saved = fc.LOGITS_PLANS
    errs, fns = {}, {}
    for plan in PLAN_SWEEP:
        fc.LOGITS_PLANS = (plan,)
        lse, gold = fc.fused_ce_fwd(h, w, lab)
        dbt = fc.fused_ce_bwd_dw_lora(*lora, want_dw=False)[1]
        lse_l, gold_l = fc.fused_ce_fwd_lora(h, w, xa, bt, lab)
        errs[str(plan)] = (max(cs.max_err(lse, rl), cs.max_err(gold, rg)),
                           cs.rel_err(dbt, ref_dbt),
                           max(cs.max_err(lse_l, rll),
                               cs.max_err(gold_l, rlg)))

        def run(plan=plan, fn=None):
            fc.LOGITS_PLANS = (plan,)
            return fn()
        fns[f"fwd {plan}"] = lambda plan=plan: run(
            plan, lambda: fc.fused_ce_fwd(h, w, lab))
        fns[f"dbt {plan}"] = lambda plan=plan: run(
            plan, lambda: fc.fused_ce_bwd_dw_lora(*lora, want_dw=False))
        fns[f"fwd_lora {plan}"] = lambda plan=plan: run(
            plan, lambda: fc.fused_ce_fwd_lora(h, w, xa, bt, lab))
    torch.cuda._sleep(int(2e9))
    times = in_turns(fns, lambda fn: cs.queued_ms(fn, 10) * 1e3)
    fc.LOGITS_PLANS = saved
    for k, v in times.items():
        plan = k.split(" ", 1)[1]
        print(f"{k}: {v} us, max err (lse/gold, dbt, row 9's lse/gold) "
              f"{errs[plan]}")
    dw_times, dw_errs = dw_layouts(torch, cs, fc, h, w, lab, rl, dl, dg)
    probes = fwd_copy_probes(torch, build, cs, fc, dev)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "times_us": times, "errors": errs,
                      "dw_times_us": dw_times, "dw_errors": dw_errs,
                      "fwd_probes_us": probes}))
    return 0


def dw_layouts(torch, cs, fc, h, w, lab, lse, dl, dg):
    """Row 8 in f32 under each of DW_LAYOUTS and its FMA first version, in
    turns; ({name: [us, us]}, {name: dW error over max(1, |ref|)})."""
    R, H = h.shape
    V = w.shape[0]
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    rows = (lse, dl, dg)
    ref = fc.fused_ce_dw_reference(h, w, lab, *rows)
    fns, errs = {}, {}
    for name, change in DW_LAYOUTS.items():
        plan = dict(fc.dw_tf32_plan(R, V, H, n_sm), **change)
        plan["n_clusters"] = min(n_sm // plan["n_parts"],
                                 -(-V // (16 * plan["vocab_groups"])))

        def call(plan=plan):
            code, dw = fc._launch_dw_tf32(h, w, lab, rows, plan)
            fc.build.check_launch(f"row 8 f32 {plan}", code)
            return dw
        errs[name] = cs.rel_err(call(), ref)
        fns[name] = call
    fns["fused_ce.cu"] = lambda: cs.fma_dw(torch, fc, h, w, lab, rows)
    errs["fused_ce.cu"] = cs.rel_err(fns["fused_ce.cu"](), ref)
    del ref
    times = in_turns(fns, lambda fn: cs.queued_ms(fn, 10) * 1e3)
    for k, v in times.items():
        print(f"row 8 f32 {k}: {v} us, dW error over max(1, |ref|) "
              f"{errs[k]:.3e}")
    return times, errs


def fwd_copy_probes(torch, build, cs, fc, dev):
    """Row 6 at its plan, the source and a variant without the W copies
    of the loop (output wrong), in turns, at the Gemma chunk and with W
    resident in L2 (R 4,096, V 8,192); {case: {name: [us, us]}}."""
    text = open(os.path.join(build.CSRC_DIR, "fused_ce_fwd_tf32.cu")).read()
    copy = ("      if (q + stages - 1 < n_q)\n"
            "        stage(q + stages - 1, (buf + stages - 1) % stages);")
    assert copy in text
    out_dir = os.path.join(ROOT, "build", "variants")
    path = os.path.join(out_dir, "fwd_no_copies.cu")
    with open(path, "w") as f:
        f.write(text.replace(copy, ""))
    libs = build_variants(build, [("fwd32", "no_copies", path)], out_dir,
                          ["fused_ce_fwd_tf32"])
    entries = {"source": build.load("fused_ce_fwd_tf32")
               .mft_fused_ce_fwd_tf32,
               "no_copies": libs["no_copies"][1].mft_fused_ce_fwd_tf32}
    for fn in entries.values():
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
            [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for R, V in ((128, 262144), (4096, 8192)):
        h, w, lab, _, _ = cs.fused_ce_inputs(torch, dev, torch.float32, R,
                                             V, 640, seed=43)
        lab = lab.int()
        p = fc.fwd_tf32_plan(R, V, 640, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        part = torch.empty(p["n_slabs"], R, 3, device=dev)
        lse, gold = torch.empty(R, device=dev), torch.empty(R, device=dev)

        def call(fn):
            return lambda: build.check_launch("fwd probe", fn(
                h.data_ptr(), w.data_ptr(), lab.data_ptr(), part.data_ptr(),
                lse.data_ptr(), gold.data_ptr(), R, V, 640, p["row_tile"],
                p["chunk"], p["stages"], p["n_slabs"], p["tiles_per_slab"],
                0, stream))
        result[f"R {R}, V {V}"] = in_turns(
            {k: call(fn) for k, fn in entries.items()},
            lambda fn: cs.queued_ms(fn, 10) * 1e3)
        print(f"row 6 at R {R}, V {V} ({p['row_tile']} rows, "
              f"{p['chunk']} columns a chunk): {result[f'R {R}, V {V}']}")
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mobilefinetuner_tpu_torch.kernels import build
    from mobilefinetuner_tpu_torch.ops import fused_ce as fc

    ap = argparse.ArgumentParser()
    ap.add_argument("--fwd", action="append", default=[])
    ap.add_argument("--dbt", action="append", default=[])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rows5_13", action="store_true")
    ap.add_argument("--epi", action="append", default=[])
    ap.add_argument("--decode", action="append", default=[])
    ap.add_argument("--row12", action="store_true")
    ap.add_argument("--paged", action="append", default=[])
    ap.add_argument("--mma_rate", action="store_true")
    ap.add_argument("--f32_ce_plans", action="store_true")
    ap.add_argument("--f32_decode", action="store_true")
    ap.add_argument("--paged_f32", action="append", default=[])
    ap.add_argument("--decode_f32", action="append", default=[])
    ap.add_argument("--split_variant", action="append", default=[],
                    choices=sorted(SPLIT_VARIANT_EDITS))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    out_dir = os.path.join(ROOT, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    if args.rows5_13:
        return rows_5_13(args, torch, build, out_dir)
    if args.row12:
        return row_12(args, torch, build, out_dir)
    if args.mma_rate:
        return mma_rate(torch, build, out_dir)
    if args.f32_ce_plans:
        return f32_ce_plans(torch, build)
    if args.f32_decode:
        return f32_decode(args, torch, build, out_dir)
    variants = [("fwd", *v.split("=", 1)) for v in args.fwd] + \
        [("dbt", *v.split("=", 1)) for v in args.dbt]
    procs = {}
    libs = build_variants(build, variants, out_dir,
                          ["fused_ce_fwd_lora_mma", "fused_ce_dbt_mma"])

    dev = torch.device("cuda", 0)

    def inputs(R, V, H, r):
        """chip_smoke.check_fused_ce_lora's inputs for this case."""
        import chip_smoke
        h, w, lab, dl, dg = chip_smoke.fused_ce_inputs(
            torch, dev, torch.bfloat16, R, V, H, seed=R + H + r)
        g = torch.Generator(device=dev).manual_seed(r)
        xa = torch.randn(R, r, generator=g, device=dev).to(torch.bfloat16)
        bt = (0.05 * torch.randn(V, r, generator=g, device=dev)).to(
            torch.bfloat16)
        return h, w, xa, bt, lab, dl, dg

    def errors(kind, fn, h, w, xa, bt, lab, lse, dl, dg):
        """Row 9: max |lse - f64|, max |gold - f64|; row 11: dbt's error
        over max(1, max |ref|), and over max |ref| with dgold = 0."""
        if kind == "fwd":
            logits = (h.double() @ w.double().T
                      + xa.double() @ bt.double().T)
            want = (torch.logsumexp(logits, -1),
                    logits.gather(1, lab[:, None])[:, 0])
            del logits
            return [float((a.double() - b).abs().max())
                    for a, b in zip(fn(dg), want)]
        out = []
        for d in (dg, torch.zeros_like(dg)):
            ref = fc.fused_ce_dw_lora_reference(h, w, xa, bt, lab, lse, dl,
                                                d, want_dw=False)[1]
            scale = max(1.0, float(ref.abs().max())) if d is dg \
                else float(ref.abs().max())
            out.append(float((fn(d)[0] - ref).abs().max()) / scale)
        return out

    def queued(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e8))   # the host enqueues ahead of the card
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters * 1e3

    def variant_call(kind, lib, h, w, xa, bt, lab, lse, dl, dg):
        """The variant's C entry with the source's plan and arguments."""
        R, H = h.shape
        V, r = bt.shape
        lab32 = lab.to(torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "fwd":
            plan = fc.fwd_lora_mma_plan(R, V, H, r, fc._n_sm(h), 2)
            part = torch.empty(plan["n_slabs"], R, 3, device=dev)
            outs = (torch.empty(R, device=dev), torch.empty(R, device=dev))
            fn = lib.mft_fused_ce_fwd_lora_mma
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + \
                [ctypes.c_void_p]
            ptrs = (h, w, xa, bt, lab32, part, *outs)
        else:
            plan = fc.dbt_mma_plan(R, V, H, r, fc._n_sm(h), 2)
            part = torch.empty(plan["row_tiles"], V, r, device=dev)
            outs = (torch.empty(V, r, device=dev),)
            fn = lib.mft_fused_ce_dbt_mma
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
                [ctypes.c_void_p]
            ptrs = (h, w, xa, bt, lab32, lse, dl, dg, part, *outs)
        fn.restype = ctypes.c_int

        def call(dgold=dg):
            args = ptrs if kind == "fwd" else (*ptrs[:7], dgold, *ptrs[8:])
            code = fn(*(t.data_ptr() for t in args), R, V, H, r,
                      plan["row_groups"], plan["stages"], plan["n_slabs"],
                      plan["tiles_per_slab"], 1, stream)
            build.check_launch(f"variant {kind}", code)
            return outs
        return call

    result = {}
    for shape, (R, V, H, r) in SHAPES.items():
        h, w, xa, bt, lab, dl, dg = inputs(R, V, H, r)
        lse = fc.fused_ce_fwd_lora_reference(h, w, xa, bt, lab)[0]
        fns = {"fwd": lambda dgold=dg: fc.fused_ce_fwd_lora(h, w, xa, bt,
                                                            lab),
               "dbt": lambda dgold=dg: fc.fused_ce_bwd_dw_lora(
                   h, w, xa, bt, lab, lse, dl, dgold, want_dw=False)[1:]}
        kinds = {"fwd": "fwd", "dbt": "dbt"}
        for name, (kind, lib) in libs.items():
            kinds[name] = kind
            fns[name] = variant_call(kind, lib, h, w, xa, bt, lab, lse, dl,
                                     dg)
            diff = max(float((a - b).abs().max())
                       for a, b in zip(fns[name](), fns[kind]()))
            print(f"{shape}: {name} ({kind}) max |variant - source| "
                  f"{diff:.3e}")
        errs = {name: errors(kinds[name], fn, h, w, xa, bt, lab, lse, dl,
                             dg) for name, fn in fns.items()}
        for name, e in errs.items():
            what = ("lse, gold vs f64" if kinds[name] == "fwd" else
                    "dbt over max(1, |ref|), softmax part over max |ref|")
            print(f"{shape}: {name} error ({what}) "
                  f"{', '.join(f'{x:.3e}' for x in e)}")
        order = list(fns) + list(fns)[::-1]
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(queued(fns[k]))
        result[shape] = {"us": times, "errors": errs}
        print(f"{shape}: device us, in turns: " + ", ".join(
            f"{k} {' / '.join(f'{x:.2f}' for x in v)}"
            for k, v in times.items()), flush=True)
        if args.profile and shape == "gemma_chunk":
            for kind in ("fwd", "dbt"):
                for kernel, us in profiled(torch, fns[kind]):
                    print(f"{shape}: profile {kind}: {kernel} {us:.2f} us")
    print(json.dumps({"kernel_variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
