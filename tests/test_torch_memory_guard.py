"""The memory-admission preflight and degradation ladder in the port
(core/memory_guard.py, cli/common.run_training), held to the contracts of
the JAX package's tests/test_memory_guard.py on the port's CLIs:
`--on_oom_risk fail` raises before the data stream starts; `degrade`
walks remat then accum_x2 with strictly falling estimates, verdicts
over, over, ok, and losses within 1e-5 of a run launched at the degraded
config (f32); an out-of-memory error at dispatch retries the same batch
on the next rung with the lineage untouched; the eval preflight fails or
warns. The analytic estimate falls at every rung of both families."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.core import memory_guard as jax_mg  # noqa: E402
from mobilefinetuner_tpu.core.telemetry import validate_event  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.core import memory_guard as mg  # noqa: E402
from mobilefinetuner_tpu_torch.core.config import (  # noqa: E402
    GPT2Config, Gemma3TextConfig)


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def assert_stream_valid(evs):
    for e in evs:
        assert validate_event(e) is None, (e, validate_event(e))
    seqs = [e["seq"] for e in evs]
    assert all(a < b for a, b in zip(seqs, seqs[1:]))


# --------------------------- unit -------------------------------------------

def test_capacity_sources_and_verdicts_match_the_jax_rules():
    assert mg.device_capacity_mb(512) == (512.0, "flag")
    assert mg.device_capacity_mb(0, "cpu") == (None, "unknown")
    assert mg.LADDER == jax_mg.LADDER
    for est, cap, head in ((80.0, 100, 0.1), (95.0, 100, 0.1),
                           (95.0, 100, 0.0), (None, 100, 0.1),
                           (50.0, 0, 0.1)):
        port = mg.analytic_check(est, cap_mb=cap, headroom=head,
                                 device="cpu", phase="preflight") \
            if est else mg.MemCheck(None, cap or None, "unknown")
        ref = jax_mg.analytic_check(est, cap_mb=cap, headroom=head,
                                    phase="preflight") \
            if est and cap else None
        if ref is not None:
            assert port.verdict == ref.verdict
            assert port.event() == ref.event() | {"cap_source": "flag"}
        ev = dict(event="mem_check", seq=0, t=1.0, **port.event())
        assert validate_event(ev) is None
    assert mg.preflight(10.0, cap_mb=100, device="cpu").verdict == "ok"
    assert mg.preflight(95.0, cap_mb=100, device="cpu").verdict == "over"
    assert mg.preflight(95.0, device="cpu").verdict == "unknown"


def test_resource_exhausted_is_the_card_error_or_the_status_text():
    assert mg.is_resource_exhausted(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    sim = RuntimeError("RESOURCE_EXHAUSTED: simulated OOM at dispatch")
    assert mg.is_resource_exhausted(sim) and \
        jax_mg.is_resource_exhausted(sim)
    assert not mg.is_resource_exhausted(RuntimeError("shape mismatch"))


def _trees(n_train, n_frozen):
    """Trees of the sizes only (meta tensors: nothing is allocated)."""
    def z(n, dtype=torch.float32):
        return torch.empty(n, dtype=dtype, device="meta")
    return ({"w": z(n_train)}, {"f": z(n_frozen)},
            {"step": z((), torch.int32), "m": {"w": z(n_train)},
             "v": {"w": z(n_train)}})


@pytest.mark.parametrize("family", ["gpt2", "gemma"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full_ft", [False, True])
def test_the_estimate_falls_strictly_at_each_rung(family, dtype, full_ft):
    """remat (every layer's input plus one layer's activations instead of
    every layer's) and then a halved micro-batch lower the estimate, at
    the full widths of GPT-2 small and Gemma-3-270M."""
    if family == "gpt2":
        cfg, S = GPT2Config.gpt2_small(), 128
        fp = mg.gpt2_footprint(cfg, dtype, S)
        n = 124_439_808
    else:
        cfg, S = Gemma3TextConfig.gemma3_270m(), 256
        fp = mg.gemma3_footprint(cfg, dtype, S, 8, head_trains=full_ft)
        n = 268_098_176
    train, frozen, opt = _trees(n if full_ft else 800_000,
                                0 if full_ft else n)
    ests = [mg.train_step_estimate_mb(
        fp, trainable=train, frozen=frozen, opt_state=opt, micro_batch=mb,
        seq_len=S, remat=remat, compute_dtype=dtype)
        for remat, mb in ((False, 8), (True, 8), (True, 4))]
    assert ests[0] > ests[1] > ests[2] > 0
    resident = (mg.tree_bytes(train) + mg.tree_bytes(frozen)
                + mg.tree_bytes(opt)) / 2 ** 20
    assert ests[2] > resident


# --------------------------- the CLI, end to end ------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_memguard")
    gdir, wiki, big = (str(root / n) for n in ("gpt2", "wiki", "big"))
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    # four times the text: the degraded and the direct run take the same
    # rows for 6 steps of 8 (no epoch wraps inside)
    os.makedirs(big)
    for split in ("train", "valid", "test"):
        with open(os.path.join(wiki, f"wiki.{split}.tokens")) as f:
            txt = f.read()
        with open(os.path.join(big, f"wiki.{split}.tokens"), "w") as f:
            f.write(txt * 4)
    return {"gpt2": gdir, "wiki": wiki, "big": big, "root": root}


def _argv(dirs, name, steps=6, data="wiki"):
    root = dirs["root"]
    return ["--pretrained_dir", dirs["gpt2"], "--data_dir", dirs[data],
            "--steps", str(steps), "--seq_len", "64", "--device", "cpu",
            "--lora_out", str(root / f"{name}.safetensors"),
            "--telemetry_out", str(root / f"{name}.jsonl")]


def _events(dirs, name):
    return read_events(str(dirs["root"] / f"{name}.jsonl"))


def test_fail_raises_before_the_data_stream(dirs):
    with pytest.raises(mg.MemoryAdmissionError):
        cli.main(_argv(dirs, "fail") + ["--batch_size", "8",
                                        "--hbm_cap_mb", "3",
                                        "--on_oom_risk", "fail"])
    evs = _events(dirs, "fail")
    assert_stream_valid(evs)
    assert [e["event"] for e in evs] == ["run_start", "mem_check", "run_end"]
    assert evs[1]["verdict"] == "over" and evs[1]["phase"] == "preflight"
    assert evs[-1]["exit"] == "MemoryAdmissionError"
    # warn proceeds past the same verdict
    assert cli.main(_argv(dirs, "warn", steps=1) + [
        "--batch_size", "8", "--hbm_cap_mb", "3",
        "--on_oom_risk", "warn"]) == 0
    evs = _events(dirs, "warn")
    assert [e["verdict"] for e in evs if e["event"] == "mem_check"] == \
        ["over"]
    assert not [e for e in evs if e["event"] == "degrade"]
    assert evs[-1]["exit"] == "ok"


@pytest.fixture(scope="module")
def ladder(dirs):
    """The three estimates from an exhausted ladder, then the degraded
    run at a capacity between the last two, then the oracle launched
    directly at the degraded config."""
    with pytest.raises(mg.MemoryAdmissionError) as ei:
        cli.main(_argv(dirs, "exh", data="big") + [
            "--batch_size", "8", "--hbm_cap_mb", "1",
            "--on_oom_risk", "degrade"])
    exh = _events(dirs, "exh")
    ests = [e["est_mb"] for e in exh if e["event"] == "mem_check"]
    # a capacity whose admitted share falls between the 2nd and 3rd rung
    threshold = (ests[1] + ests[2]) / 2
    cap = math.ceil(ests[0]) + 1
    headroom = 1.0 - threshold / cap
    assert cli.main(_argv(dirs, "deg", data="big") + [
        "--batch_size", "8", "--hbm_cap_mb", str(cap),
        "--hbm_headroom", repr(headroom), "--on_oom_risk", "degrade"]) == 0
    assert cli.main(_argv(dirs, "direct", data="big") + [
        "--batch_size", "4", "--grad_accum_steps", "2", "--remat"]) == 0
    return ei.value, exh, _events(dirs, "deg"), _events(dirs, "direct")


def test_ladder_exhausted_names_the_rungs_tried(dirs, ladder):
    err, exh, _, _ = ladder
    assert err.ladder == ("remat", "accum_x2")
    assert_stream_valid(exh)
    assert [e["rung"] for e in exh if e["event"] == "degrade"] == \
        ["remat", "accum_x2"]
    assert all(m["verdict"] == "over" for m in exh
               if m["event"] == "mem_check")
    assert exh[-1]["event"] == "run_end" \
        and exh[-1]["exit"] == "MemoryAdmissionError"
    # a run already at --remat skips that rung
    with pytest.raises(mg.MemoryAdmissionError) as ei:
        cli.main(_argv(dirs, "exh_remat") + ["--batch_size", "8", "--remat",
                                             "--hbm_cap_mb", "1"])
    assert ei.value.ladder == ("accum_x2",)


def test_degrade_walks_remat_then_accum_with_loss_parity(ladder):
    _, _, evs, direct = ladder
    assert_stream_valid(evs)
    mcs = [e for e in evs if e["event"] == "mem_check"]
    assert [m["verdict"] for m in mcs] == ["over", "over", "ok"]
    rungs = [e for e in evs if e["event"] == "degrade"]
    assert [(r["rung"], r["from"], r["to"]) for r in rungs] == [
        ("remat", "remat=off", "remat=on"),
        ("accum_x2", "accum=1", "accum=2")]
    ests = [m["est_mb"] for m in mcs]
    assert ests[0] > ests[1] > ests[2]
    assert [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"]
    deg = [e["loss"] for e in evs if e["event"] == "step_stats"]
    ref = [e["loss"] for e in direct if e["event"] == "step_stats"]
    assert len(deg) == len(ref) == 6
    np.testing.assert_allclose(deg, ref, atol=1e-5, rtol=0)


def test_dispatch_oom_retries_the_next_rung_lineage_untouched(dirs):
    """An out-of-memory error at the first dispatch (simulated on the CPU,
    the card's own on the card): mem_check{phase=dispatch} and a remat
    degrade at step 0 land in the stream, every step trains once, no
    rollback fires, and the lineage verifies end to end."""
    from mobilefinetuner_tpu_torch.io.checkpoints import resolve_checkpoint
    out = str(dirs["root"] / "oom.safetensors")
    assert cli.main(_argv(dirs, "oom", steps=4) + [
        "--batch_size", "8", "--save_every", "2",
        "--inject", "hbm_pressure:8"]) == 0
    evs = _events(dirs, "oom")
    assert_stream_valid(evs)
    dispatch = [e for e in evs if e["event"] == "mem_check"
                and e["phase"] == "dispatch"]
    assert len(dispatch) == 1 and dispatch[0]["verdict"] == "over"
    rungs = [e for e in evs if e["event"] == "degrade"]
    assert [(r["rung"], r["step"]) for r in rungs] == [("remat", 0)]
    assert not [e for e in evs if e["event"] == "rollback"]
    assert [e["step"] for e in evs if e["event"] == "step_stats"] == \
        [1, 2, 3, 4]
    assert [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"]
    resolved, step, verdicts = resolve_checkpoint(out, verify=True)
    assert resolved == out and all(v["ok"] for v in verdicts)


def test_eval_ppl_preflight_fails_or_warns(dirs):
    from mobilefinetuner_tpu_torch.cli import eval_ppl
    argv = ["--pretrained_dir", dirs["gpt2"], "--data_root", dirs["wiki"],
            "--split", "valid", "--batch_size", "32", "--seq_len", "64",
            "--max_batches", "2", "--device", "cpu"]
    telem = str(dirs["root"] / "evalfail.jsonl")
    with pytest.raises(mg.MemoryAdmissionError):
        eval_ppl.main(argv + ["--hbm_cap_mb", "1", "--on_oom_risk", "fail",
                              "--telemetry_out", telem])
    evs = read_events(telem)
    assert_stream_valid(evs)
    assert [e["event"] for e in evs] == ["run_start", "mem_check", "run_end"]
    assert evs[1]["verdict"] == "over"
    assert evs[-1]["exit"] == "MemoryAdmissionError"
    for mode in ("warn", "degrade"):      # eval has no ladder
        telem = str(dirs["root"] / f"eval{mode}.jsonl")
        assert eval_ppl.main(argv + ["--hbm_cap_mb", "1",
                                     "--on_oom_risk", mode,
                                     "--telemetry_out", telem]) == 0
        evs = read_events(telem)
        assert_stream_valid(evs)
        assert not [e for e in evs if e["event"] == "degrade"]
        assert evs[-1]["event"] == "run_end" and evs[-1]["exit"] == "ok"
