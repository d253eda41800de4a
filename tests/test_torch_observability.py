"""The port's observability plane (core/telemetry.py's goodput meter,
step clock, hang watchdog and MFU, core/trace.py, core/metrics_http.py,
the kernel-build watcher and cli/common.run_training's wiring) held
against the JAX package's on the same inputs: the copied pure-Python
parts exactly (the OpenMetrics render byte for byte, partial_goodput,
transformer_flops, the step clock, the watchdog's hang payload), the
flight recorder's state machine with injected start and stop, and the
port's GPT-2 LoRA CLI end to end on the tiny fixtures: the goodput
identity, the span reconciliation through tools/trace_export.py, the JAX
CLI's sequence of events on the same arguments, bit-identical losses
with every instrument on or off, and a `--watchdog 2` child that exits
113 with a complete hang record."""

import gzip
import json
import os
import socket
import stat
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402
from test_telemetry import REPRESENTATIVE  # noqa: E402

from mobilefinetuner_tpu.core import metrics_http as jm  # noqa: E402
from mobilefinetuner_tpu.core import telemetry as jt  # noqa: E402
from mobilefinetuner_tpu_torch.cli import common  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.core import metrics_http as pm  # noqa: E402
from mobilefinetuner_tpu_torch.core import telemetry as pt  # noqa: E402
from mobilefinetuner_tpu_torch.core.trace import (AutoProfiler,  # noqa: E402
                                                  Tracer)
from mobilefinetuner_tpu_torch.kernels import build as kbuild  # noqa: E402
from mobilefinetuner_tpu_torch.train import trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import trace_export  # noqa: E402


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# --------------------------- the copied pure-Python parts --------------------

def _serve_like_events():
    """A stream a serving run and a training run would write: request
    phases, serve_stats, step_stats, a hang, a run_end with goodput."""
    evs = [dict(event=ev, seq=i, t=1.0 + i, **fields)
           for i, (ev, fields) in enumerate(REPRESENTATIVE.items())]
    base = len(evs)
    for k, (phase, ttft) in enumerate([("enqueue", None), ("admit", None),
                                       ("first_token", 12.5),
                                       ("finish", 12.5)]):
        evs.append(dict(event="request", seq=base + k, t=50.0 + k, id=7,
                        phase=phase, prompt_tokens=9, adapter=None,
                        queue_ms=0.5, new_tokens=3, ttft_ms=ttft,
                        tpot_ms=2.25 if phase == "finish" else None,
                        reason=None, rid=None))
    evs.append(dict(event="step_stats", seq=base + 9, t=60.0, step=9,
                    loss=2.5, ema=2.6, lr=1e-4, grad_norm=0.4,
                    step_time_ms=31.25, host_wait_ms=0.125, slept_ms=0.0,
                    tok_s=4096.0, mfu=0.3125, param_norm=None,
                    update_ratio=None, nonfinite_count=0, skipped=0,
                    hbm_mb=512.0, queue_depth=2, host_step_ms=None))
    evs.append(dict(event="run_end", seq=base + 10, t=61.0, steps=9,
                    wall_s=60.0, exit="ok", reason=None,
                    goodput={"init_s": 1.0, "compile_s": 2.0, "step_s": 50.0,
                             "input_wait_s": 1.0, "eval_s": 3.0,
                             "checkpoint_s": 1.5, "governor_sleep_s": 0.5,
                             "shutdown_s": 1.0, "total_s": 60.0,
                             "productive_frac": 0.8333}))
    return evs


def test_metrics_registry_renders_the_jax_bytes():
    """The same event list through both registries: the OpenMetrics text
    is byte for byte the JAX package's (timing-dependent families
    aside: the last-event age is read at render time)."""
    regs = [pm.MetricsRegistry(), jm.MetricsRegistry()]
    for rec in _serve_like_events():
        for reg in regs:
            reg.observe(dict(rec))
    renders = [reg.render() for reg in regs]
    assert renders[0] == renders[1]
    assert renders[0].endswith("# EOF\n")
    assert "mft_steps_total" in renders[0]
    h = [reg.health() for reg in regs]
    for d in h:
        d.pop("last_event_age_s", None)
    assert h[0] == h[1]


def test_partial_goodput_transformer_flops_and_step_clock_equal_jax():
    evs = _serve_like_events()
    assert pt.partial_goodput(evs) == jt.partial_goodput(evs)
    assert pt.partial_goodput([]) == jt.partial_goodput([])
    for args in [(1_000, 124_000_000, 8, 128, 12, 12, 64, False),
                 (268_000_000, 0, 4, 1024, 18, 4, 256, True),
                 (0, 7, 1, 1, 1, 1, 1, False)]:
        assert pt.transformer_flops(*args) == jt.transformer_flops(*args)
    clocks = [pt.StepClock(window=5), jt.StepClock(window=5),
              trainer.StepClock(window=5)]
    assert trainer.StepClock is pt.StepClock
    for x in [0.5, -1.0, 0.25, 3.0, 0.125, 0.75, 1.5]:
        for c in clocks:
            c.record(x)
        assert len({(c.n, c.median_s(), c.median_ms()) for c in clocks}) == 1
    for c in clocks:
        c.reset()
        assert c.n == 0 and c.median_ms() == 0.0
    assert pt.mfu_from(1e12, 0.5, 989e12) == jt.mfu_from(1e12, 0.5, 989e12)
    assert pt.mfu_from(None, 0.5, 989e12) is None
    assert pt.mfu_from(1e12, 0.5, 0.0) is None


def test_device_peak_flops_knows_no_tpu_and_no_cpu():
    assert pt.device_peak_flops("cpu") == 0.0
    assert pt.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert pt.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert pt.device_peak_flops("NVIDIA A100-SXM4-80GB") == 0.0
    for kind in ("TPU v5 lite", "TPU v4", "TPU v6e", "v5p"):
        assert pt.device_peak_flops(kind) == 0.0
    assert not set(pt.DEVICE_PEAK_FLOPS) & set(jt.DEVICE_PEAK_FLOPS)
    if not torch.cuda.is_available():
        assert pt.device_peak_flops() == 0.0


def _stalled_payload(mod, tmp_path, tag):
    events, aborted = [], []
    wd = mod.HangWatchdog(mult=2.0, min_deadline_s=0.5, grace_s=0.5,
                          on_hang=events.append, abort=True,
                          stacks_file=str(tmp_path / f"{tag}.stacks"),
                          probe_fn=lambda: None, probe_timeout_s=1.0,
                          abort_fn=aborted.append)
    wd.start()
    for i in range(3):
        wd.pet(i, 0.01)
        time.sleep(0.01)
    time.sleep(1.5)     # the stall: >> max(2 x 10 ms, 0.5 s)
    wd.stop()
    assert aborted == [113] and wd.fired == 1
    return events[0]


def test_hang_watchdog_payload_is_the_jax_payload(tmp_path):
    port = _stalled_payload(pt, tmp_path, "port")
    jax_ = _stalled_payload(jt, tmp_path, "jax")
    assert set(port) == set(jax_)
    for k in ("step", "deadline_s", "device_probe", "action"):
        assert port[k] == jax_[k], k
    assert port["step"] == 2 and port["action"] == "abort"
    assert port["stall_s"] >= port["deadline_s"]
    assert "Thread" in open(port["stacks_file"]).read()
    ev = dict(event="hang", seq=0, t=1.0, last_seq=0, **port)
    assert jt.validate_event(ev) is None and pt.validate_event(ev) is None


def test_hang_watchdog_pause_and_clean_cadence():
    fired = []
    wd = pt.HangWatchdog(mult=2.0, min_deadline_s=1.0, grace_s=1.0,
                         on_hang=fired.append)
    wd.start()
    wd.pet(0, 0.01)
    with wd.paused():
        time.sleep(1.5)     # a pause past the deadline does not fire
    for i in range(1, 10):
        wd.pet(i, 0.02)
        time.sleep(0.02)
    wd.stop()
    assert wd.fired == 0 and not fired
    assert pt.device_probe("cpu")() is not None


def test_telemetry_sink_verbs(tmp_path):
    path = str(tmp_path / "t.jsonl")
    seen = []
    tel = pt.Telemetry(path)
    assert tel.last_seq == -1
    tel.add_observer(seen.append)
    tel.add_observer(lambda r: 1 / 0)      # a broken observer is ignored
    tel.emit("eval", step=1, loss=1.0, ppl=2.0, tokens=3)
    assert tel.last_seq == 0 and seen[0]["step"] == 1
    tel._f.write('{"truncated": ')       # a writer killed mid-line
    tel.flush_tail()
    assert open(path, "rb").read().endswith(b"\n")
    tel.close()
    tel.emit("eval", step=2, loss=1.0, ppl=2.0, tokens=3)
    assert len(seen) == 1                 # closed: observers muted too
    # observers without a file: the record is observed, not written
    seen2 = []
    tel2 = pt.Telemetry("")
    tel2.add_observer(seen2.append)
    assert tel2.emit("eval", step=1, loss=1.0, ppl=2.0, tokens=3) is None
    assert seen2 and seen2[0]["step"] == 1
    # the process shards: process 0 the path, process k `.host<k>`
    t0 = pt.Telemetry.for_process(str(tmp_path / "s.jsonl"))
    t3 = pt.Telemetry.for_process(str(tmp_path / "s.jsonl"), 3)
    assert (t0.path, t0.host) == (str(tmp_path / "s.jsonl"), 0)
    assert (t3.path, t3.host) == (str(tmp_path / "s.jsonl.host3"), 3)
    assert not pt.Telemetry.for_process("").enabled
    t0.close()
    t3.close()


def test_goodput_meter_identity_and_phase_spans(tmp_path):
    path = str(tmp_path / "g.jsonl")
    with pt.Telemetry(path) as tel:
        meter = pt.GoodputMeter(tracer=Tracer(tel.emit))
        for ph in ("compile", "step", "eval", "step", "shutdown"):
            time.sleep(0.005)
            meter.enter(ph)
        g = meter.summary()
    assert set(g) == {f"{b}_s" for b in pt.GOODPUT_BUCKETS} | {
        "total_s", "productive_frac"}
    assert pt.GOODPUT_BUCKETS == jt.GOODPUT_BUCKETS
    assert abs(sum(g[f"{b}_s"] for b in pt.GOODPUT_BUCKETS)
               - g["total_s"]) < 1e-9
    spans = read_events(path)
    assert [s["name"] for s in spans] == ["init", "compile", "step", "eval",
                                          "step", "shutdown"]
    for s in spans:
        assert jt.validate_event(s) is None


# --------------------------- the flight recorder -----------------------------

def test_autoprofiler_budget_cooldown_state_machine(tmp_path):
    starts, stops = [], []
    now = {"t": 0.0}
    path = str(tmp_path / "t.jsonl")
    with pt.Telemetry(path) as tel:
        ap = AutoProfiler(str(tmp_path / "prof"), sink=tel.emit,
                          steps=2, cooldown_s=100.0, budget=2,
                          profiler_start=starts.append,
                          profiler_stop=lambda: stops.append(1),
                          clock=lambda: now["t"])
        assert ap.trigger("slow_step", 5)
        assert ap.active and len(starts) == 1
        assert not ap.trigger("slow_step", 6)   # already capturing
        assert not ap.tick(6)                   # 1 of 2
        assert ap.tick(7)                       # capture completes
        assert ap.captured == 1 and ap.budget == 1 and stops
        assert not ap.trigger("divergence", 8)  # cooldown holds
        now["t"] = 200.0
        assert ap.trigger("divergence", 9)      # cooldown elapsed
        ap.tick(10)
        assert ap.tick(11) and ap.budget == 0
        now["t"] = 999.0
        assert not ap.trigger("slow_step", 12)  # budget exhausted
        ap2 = AutoProfiler(str(tmp_path / "prof2"), sink=tel.emit,
                           steps=2, cooldown_s=0.0, budget=1,
                           profiler_start=starts.append,
                           profiler_stop=lambda: stops.append(1))
        assert ap2.capture_now("hang", 42, hold_s=0.0)
        assert ap2.captured == 1
    caps = [r for r in read_events(path) if r["event"] == "profile_capture"]
    assert [c["trigger"] for c in caps] == ["slow_step", "divergence",
                                           "hang"]
    for c in caps:
        assert jt.validate_event(c) is None, (c, jt.validate_event(c))
        assert os.path.isdir(c["path"])
    assert caps[0]["step"] == 7 and caps[0]["budget_left"] == 1
    assert caps[2]["steps"] is None


def test_autoprofiler_close_and_failures(tmp_path):
    starts, stops = [], []
    ap = AutoProfiler(str(tmp_path), steps=5,
                      profiler_start=starts.append,
                      profiler_stop=lambda: stops.append(1))
    ap.trigger("slow_step", 1)
    ap.close()
    assert stops and not ap.active
    ap.close()  # idempotent
    assert len(stops) == 1

    def boom(*a):
        raise RuntimeError("no profiler here")
    bad = AutoProfiler(str(tmp_path / "b"), profiler_start=boom)
    assert not bad.trigger("slow_step", 1)   # the failure is contained
    assert not bad.active and bad.captured == 0
    worse = AutoProfiler(str(tmp_path / "c"), steps=1,
                         profiler_start=starts.append, profiler_stop=boom)
    assert worse.trigger("slow_step", 1)
    assert not worse.tick(1) and not worse.active and worse.captured == 0


def test_autoprofiler_default_writes_a_gzip_chrome_trace(tmp_path):
    """The default profiler (torch.profiler, CPU activities here) leaves
    one *.trace.json.gz per capture, the name trace_export --profile
    finds."""
    path = str(tmp_path / "t.jsonl")
    with pt.Telemetry(path) as tel:
        ap = AutoProfiler(str(tmp_path / "caps"), sink=tel.emit, steps=1)
        assert ap.trigger("slow_step", 3)
        x = torch.randn(64, 64)
        (x @ x).sum()
        assert ap.tick(3)
    cap = [r for r in read_events(path)
           if r["event"] == "profile_capture"][0]
    found = trace_export.find_profiler_trace(cap["path"])
    assert found and found.endswith(".trace.json.gz")
    with gzip.open(found, "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


# --------------------------- the kernel-build watcher ------------------------

def _fake_nvcc(tmp_path, sleep_s=0.0):
    """A stand-in compiler: writes its -o file (after `sleep_s`)."""
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n"
                   f"sleep {sleep_s}\n"
                   'while [ "$1" != "-o" ]; do shift; done\n'
                   'echo fake > "$2"\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe)


def test_build_watchers_wrap_only_real_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "kernels"))
    nvcc = _fake_nvcc(tmp_path)
    entered = []

    class Watch:
        def __enter__(self):
            entered.append("in")

        def __exit__(self, *exc):
            entered.append("out")

    with kbuild.watch_builds(Watch):
        out = kbuild.build_all(["lora_epilogue", "decode_attention"],
                               nvcc=nvcc)
        assert entered == ["in", "out"]          # one build, both sources
        assert all(os.path.exists(p) for p, _ in out.values())
        kbuild.build_all(["lora_epilogue"], nvcc=nvcc)
        assert entered == ["in", "out"]          # built: no nvcc, no watch
    assert kbuild._BUILD_WATCHERS == []


# --------------------------- the train CLI end to end ------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_obs")
    gdir, wiki = str(root / "gpt2"), str(root / "wiki")
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    return gdir, wiki, root


def _argv(dirs, out, *extra, steps=4):
    gdir, wiki, _ = dirs
    return ["--pretrained_dir", gdir, "--data_dir", wiki, "--steps",
            str(steps), "--batch_size", "2", "--seq_len", "32",
            "--save_every", "2", "--eval_interval", "2", "--eval_batches",
            "1", "--async_save", "0", "--prefetch", "0",
            "--lora_out", os.path.join(out, "a.safetensors"),
            "--telemetry_out", os.path.join(out, "t.jsonl"), *extra]


def _shape(evs):
    """The event sequence, spans as (span, track, name), without what the
    JAX run's ahead-of-time compile adds (ROADMAP.md, "Differences, not
    faults"): its `compile` events and the `init` / `compile` phase spans
    its compile splits the set-up into (the port's set-up is one `init`
    span)."""
    out = []
    for e in evs:
        if e["event"] == "compile":
            continue
        if e["event"] == "span":
            key = ("span", e["track"], e["name"])
            if key[1:] in (("phase", "init"), ("phase", "compile")):
                continue
            out.append(key)
        else:
            out.append(e["event"])
    return out


@pytest.fixture(scope="module")
def instrumented(dirs):
    """The port and the JAX CLI on the same arguments with spans, the
    registry and the metrics endpoint on; the port's endpoint is scraped
    while the run is live (from the checkpoint writer's `checkpoint`
    event, through an observer on the stream)."""
    _, _, root = dirs
    from mobilefinetuner_tpu.cli import gpt2_lora_finetune as jax_cli
    out = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = str(root / f"inst_{name}")
        reg = os.path.join(d, "registry.jsonl")
        extra = ["--trace_spans", "1", "--run_registry", reg,
                 "--metrics_port", str(free_port())]
        if name == "port":
            extra += ["--device", "cpu"]
        assert main(_argv(dirs, d, *extra)) == 0
        out[name] = {"events": read_events(os.path.join(d, "t.jsonl")),
                     "stream": os.path.join(d, "t.jsonl"), "reg": reg,
                     "dir": d}
    return out


def test_port_stream_has_the_jax_sequence_and_passes_its_validator(
        instrumented):
    port, jax_ = instrumented["port"]["events"], instrumented["jax"]["events"]
    for e in port:
        assert jt.validate_event(e) is None, (e, jt.validate_event(e))
    assert _shape(port) == _shape(jax_)
    assert [e["name"] for e in port if e["event"] == "span"
            and e["name"] in ("init", "compile")] == ["init"]
    assert {e["event"] for e in jax_} - {e["event"] for e in port} == \
        {"compile"}
    end = port[-1]
    assert end["event"] == "run_end" and end["exit"] == "ok"
    assert set(end) - {"event", "seq", "t", "t_mono", "host"} == \
        set(jax_[-1]) - {"event", "seq", "t", "t_mono", "host"}
    assert end["governor_slept_ms"] == 0.0
    assert [e["mfu"] for e in port if e["event"] == "step_stats"] == \
        [None] * 4                                 # the CPU has no peak


def test_goodput_identity_and_span_reconciliation(instrumented):
    port = instrumented["port"]
    g = port["events"][-1]["goodput"]
    buckets = sum(g[f"{b}_s"] for b in pt.GOODPUT_BUCKETS)
    assert abs(buckets - g["total_s"]) < 1e-6
    assert g["compile_s"] == 0.0       # no kernel is built on the CPU
    assert 0 < g["productive_frac"] <= 1
    assert abs(g["total_s"] - port["events"][-1]["wall_s"]) < 0.05
    out = os.path.join(port["dir"], "trace.json")
    assert trace_export.main([port["stream"], "-o", out]) == 0
    with open(out) as f:
        rec = trace_export.phase_reconcile(json.load(f), g)
    assert {"init", "step", "input_wait", "eval", "checkpoint",
            "governor_sleep", "shutdown"} <= set(rec)
    assert max(d for _, _, d in rec.values()) <= 0.001 * g["total_s"] + 1e-3
    tracks = {e["track"] for e in port["events"] if e["event"] == "span"}
    assert tracks == {"phase", "ckpt"}    # --prefetch 0: no producer


def test_registries_of_both_clis_resolve_in_either_package(instrumented):
    from mobilefinetuner_tpu.core.run_registry import RunRegistry as JReg
    from mobilefinetuner_tpu_torch.core.run_registry import \
        RunRegistry as PReg
    for name in ("port", "jax"):
        path = instrumented[name]["reg"]
        for reg in (PReg(path), JReg(path)):
            (rec,) = reg.records()
            assert rec["status"] == "ok" and rec["kind"] == "train"
            assert rec["platform"] == "cpu"
            assert reg.resolve(rec["run_id"][:18])["run_id"] == \
                rec["run_id"]
    runs = [e for e in instrumented["port"]["events"] if e["event"] == "run"]
    assert [r["phase"] for r in runs] == ["start", "end"]
    assert instrumented["port"]["events"][1]["event"] == "run"


def test_every_instrument_on_leaves_the_losses_bit_identical(dirs):
    """The same run with every instrument off (the watchdog too) and on
    (spans, the registry, the metrics endpoint, the governor, the
    watchdog, the flight recorder armed): the losses are equal, bit for
    bit. One CPU thread for both, so the host's BLAS does not pick its
    thread count (and summation order) from the machine's load."""
    _, _, root = dirs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain, on = str(root / "plain"), str(root / "all_on")
        assert cli.main(_argv(dirs, plain, "--device", "cpu",
                              "--watchdog", "0")) == 0
        assert cli.main(_argv(
            dirs, on, "--device", "cpu", "--trace_spans", "1",
            "--run_registry", str(root / "all_on.registry.jsonl"),
            "--metrics_port", str(free_port()), "--auto_profile", "1",
            "--pm_schedule", "0-:1")) == 0
    finally:
        torch.set_num_threads(threads)
    losses = [[e["loss"] for e in read_events(os.path.join(d, "t.jsonl"))
               if e["event"] == "step_stats"] for d in (plain, on)]
    assert losses[0] == losses[1] and len(losses[0]) == 4


def test_metrics_endpoint_scraped_live_during_a_run(dirs, monkeypatch):
    """--metrics_port: /metrics and /healthz answer while the loop runs
    (scraped from a slowed step), and the server goes down with it."""
    _, _, root = dirs
    port = free_port()
    scraped = {}
    orig = common.FaultInjector.maybe_slow

    def scrape_then_sleep(self, step):
        if step == 2 and not scraped:
            base = f"http://127.0.0.1:{port}"
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                scraped["metrics"] = r.read().decode()
            with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
                scraped["health"] = (r.status, json.loads(r.read()))
        return orig(self, step)

    monkeypatch.setattr(common.FaultInjector, "maybe_slow",
                        scrape_then_sleep)
    d = str(root / "scrape")
    assert cli.main(_argv(dirs, d, "--device", "cpu", "--metrics_port",
                          str(port), "--inject", "slow_step:0:1:4")) == 0
    assert "mft_steps_total" in scraped["metrics"]
    assert scraped["metrics"].endswith("# EOF\n")
    assert scraped["health"][0] == 200
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=2)


def test_a_kernel_build_is_compile_time_and_not_a_hang(dirs, tmp_path,
                                                       monkeypatch):
    """A first-use kernel build inside step 0 (a stand-in nvcc that takes
    6 s, past a 4 s watchdog floor): charged to the `compile` bucket,
    left out of step_time_ms, and the watchdog stays quiet."""
    _, _, root = dirs
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "kernels"))
    nvcc = _fake_nvcc(tmp_path, sleep_s=6)
    orig = common.make_train_step

    def building_step(*a, **k):
        step = orig(*a, **k)

        def run(*args):
            kbuild.build_all(["lora_epilogue"], nvcc=nvcc)
            return step(*args)
        return run

    monkeypatch.setattr(common, "make_train_step", building_step)
    d = str(root / "build")
    assert cli.main(_argv(dirs, d, "--device", "cpu", "--watchdog", "1",
                          "--watchdog_min_s", "4", "--log_interval",
                          "1")) == 0
    evs = read_events(os.path.join(d, "t.jsonl"))
    assert not [e for e in evs if e["event"] == "hang"]
    g = evs[-1]["goodput"]
    assert 5.9 <= g["compile_s"] < g["total_s"]
    assert [e for e in evs if e["event"] == "step_stats"][0][
        "step_time_ms"] < 5000.0


def test_watchdog_abort_exits_113_with_a_complete_hang_record(dirs,
                                                             tmp_path):
    """A child run stalled 30 s before step 3 with --watchdog 2 (a 3 s
    floor, twice the median step: a loaded host's steps may take a
    second): exit 113, the stream newline-terminated and ending on the
    hang record, which every validator accepts."""
    gdir, wiki, _ = dirs
    stream = str(tmp_path / "wd.jsonl")
    cmd = [sys.executable, "-m",
           "mobilefinetuner_tpu_torch.cli.gpt2_lora_finetune",
           "--pretrained_dir", gdir, "--data_dir", wiki, "--steps", "8",
           "--batch_size", "2", "--seq_len", "32", "--device", "cpu",
           "--lora_out", str(tmp_path / "a.safetensors"),
           "--telemetry_out", stream, "--watchdog", "2",
           "--watchdog_min_s", "3", "--watchdog_mult", "2",
           "--inject", "slow_step:3:30000"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 113, (r.returncode, r.stderr[-2000:])
    raw = open(stream, "rb").read()
    assert raw.endswith(b"\n")
    evs = [json.loads(line) for line in raw.decode().splitlines()]
    hang = evs[-1]
    assert hang["event"] == "hang" and hang["action"] == "abort"
    assert hang["step"] == 2 and hang["device_probe"] == "ok"
    assert hang["stall_s"] >= hang["deadline_s"] >= 3.0
    assert "maybe_slow" in open(hang["stacks_file"]).read()
    for e in evs:
        assert jt.validate_event(e) is None
    assert not [e for e in evs if e["event"] == "run_end"]


def test_metrics_server_health_turns_503_while_draining():
    """/healthz follows the health function: 200 while "ok", 503 once it
    reports draining; /metrics serves the registry over an ephemeral
    port."""
    tel = pt.Telemetry("")
    reg = pm.MetricsRegistry()
    tel.add_observer(reg.observe)
    state = {"status": "ok"}
    srv = pm.MetricsServer(reg, port=0, health_fn=lambda: dict(state))
    try:
        tel.emit("step_stats", **REPRESENTATIVE["step_stats"])
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"] == pm.OPENMETRICS_CONTENT_TYPE
            assert "mft_steps_total 1" in r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
        state["status"] = "draining"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "draining"
    finally:
        srv.close()
    assert pm.start_metrics(tel, 0) is None


def test_observers_run_on_the_emitting_thread():
    """Observers run under the emit lock on whichever thread emitted (the
    checkpoint writer, the prefetch producer)."""
    tel = pt.Telemetry("")
    names = []
    tel.add_observer(lambda r: names.append(
        threading.current_thread().name))
    t = threading.Thread(target=lambda: tel.emit(
        "eval", step=1, loss=1.0, ppl=2.0, tokens=3), name="ckpt-writer")
    t.start()
    t.join()
    tel.emit("eval", step=2, loss=1.0, ppl=2.0, tokens=3)
    assert names == ["ckpt-writer", threading.current_thread().name]


def test_prefetch_producer_and_async_writer_emit_spans(tmp_path):
    """The producer thread's batches land on the "prefetch" track and the
    writer thread's checkpoint writes on "ckpt", through one tracer."""
    from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
    from mobilefinetuner_tpu_torch.io.async_ckpt import AsyncCheckpointer
    path = str(tmp_path / "t.jsonl")
    with pt.Telemetry(path) as tel:
        tracer = Tracer(tel.emit)
        with Prefetcher(iter(range(5)), depth=2, tracer=tracer) as it:
            assert list(it) == list(range(5))
        ck = AsyncCheckpointer(enabled=True, event_sink=tel.emit,
                               tracer=tracer)
        out = str(tmp_path / "x.bin")
        ck.save(3, lambda: (open(out, "wb").write(b"x" * 10), [out])[1],
                final=True, snapshot_ms=1.0)
        ck.close()
    evs = read_events(path)
    for e in evs:
        assert jt.validate_event(e) is None
    spans = [(e["track"], e["name"]) for e in evs if e["event"] == "span"]
    assert spans[:5] == [("prefetch", f"produce[{i}]") for i in range(5)]
    assert spans[5:] == [("ckpt", "ckpt_write(step 3)")]
    ck_ev = [e for e in evs if e["event"] == "checkpoint"][0]
    assert ck_ev["wall_s"] == 0.001 and ck_ev["bytes"] == 10
