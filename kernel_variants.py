"""Time variants of the port's kernels against the sources.

    python3 kernel_variants.py [--fwd NAME=PATH.cu ...]
                               [--dbt NAME=PATH.cu ...] [--profile]
                               [--iters N]
    python3 kernel_variants.py --rows5_13 [--epi NAME=PATH.cu ...]
                               [--decode NAME=PATH.cu ...]
    python3 kernel_variants.py --row12 [--paged NAME=PATH.cu ...]

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
