"""The preemption drain in the port (core/preempt.py, cli/common.run_training):
the guard's handler contract, and a real SIGTERM sent to a training
subprocess (never to this test process): the run finishes its step,
writes one final checkpoint, ends its stream with preempt and
run_end{exit=preempted} and exits 75; resumed, it ends on the adapter of
the uninterrupted run, bit for bit. A stream holding a drain, a rollback
and a degrade renders with tools/telemetry_report.py."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.core import preempt as jax_preempt  # noqa: E402
from mobilefinetuner_tpu.core.telemetry import validate_event  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.core.preempt import (  # noqa: E402
    EXIT_PREEMPTED, PreemptionGuard)
from mobilefinetuner_tpu_torch.io.safetensors_io import \
    SafeTensorsReader  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_guard_flags_escalates_and_restores():
    assert EXIT_PREEMPTED == jax_preempt.EXIT_PREEMPTED == 75
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(
        signal.SIGINT)
    guard = PreemptionGuard().install()
    assert guard.installed and not guard.triggered
    assert signal.getsignal(signal.SIGTERM) == guard._handler
    guard._handler(signal.SIGTERM, None)
    assert guard.triggered and guard.signal_name == "SIGTERM"
    with pytest.raises(KeyboardInterrupt, match="second SIGINT"):
        guard._handler(signal.SIGINT, None)
    guard.uninstall()
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
    # off the main thread the guard cannot install and says so
    box = []
    t = threading.Thread(target=lambda: box.append(
        PreemptionGuard().install()))
    t.start()
    t.join(timeout=10)
    assert box and not box[0].installed
    assert signal.getsignal(signal.SIGTERM) == before[0]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_preempt")
    gdir, wiki = str(root / "gpt2"), str(root / "wiki")
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    return gdir, wiki


def _argv(dirs, out, *extra):
    gdir, wiki = dirs
    return ["--pretrained_dir", gdir, "--data_dir", wiki, "--steps", "10",
            "--batch_size", "2", "--seq_len", "32", "--lora_out", out,
            "--device", "cpu", *extra]


def _drain_in_subprocess(dirs, out, stream, after_step=3):
    """Run the CLI in a child, SIGTERM it once step `after_step`'s
    step_stats is in its stream; (rc, seconds from SIGTERM to exit)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    # steps from 3 on sleep 0.3 s each, so the signal lands mid-run
    child = subprocess.Popen(
        [sys.executable, "-m",
         "mobilefinetuner_tpu_torch.cli.gpt2_lora_finetune",
         *_argv(dirs, out, "--telemetry_out", stream,
                "--inject", "slow_step:3:300:10")],
        env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and child.poll() is None:
            if os.path.exists(stream) and any(
                    e["event"] == "step_stats" and e["step"] >= after_step
                    for e in read_events(stream)):
                break
            time.sleep(0.02)
        sent = time.time()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
        return rc, time.time() - sent
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)


def test_sigterm_drains_and_resumes_to_the_uninterrupted_run(dirs,
                                                             tmp_path):
    out = str(tmp_path / "p.safetensors")
    stream = str(tmp_path / "p.jsonl")
    rc, _ = _drain_in_subprocess(dirs, out, stream)
    assert rc == EXIT_PREEMPTED
    evs = read_events(stream)
    for e in evs:
        assert validate_event(e) is None, (e, validate_event(e))
    (pre,) = [e for e in evs if e["event"] == "preempt"]
    assert pre["signal"] == "SIGTERM" and 3 <= pre["step"] < 10
    assert evs[-1]["event"] == "run_end"
    assert evs[-1]["exit"] == "preempted" and evs[-1]["reason"] == \
        "preempted" and evs[-1]["steps"] == pre["step"]
    ck = [e for e in evs if e["event"] == "checkpoint"]
    assert ck[-1]["final"] is True and ck[-1]["step"] == pre["step"]
    md = SafeTensorsReader(out + ".opt").metadata
    assert int(md["loop_step"]) == pre["step"]
    # resumed from the drained file, the run ends where the uninterrupted
    # one does
    before = signal.getsignal(signal.SIGTERM)
    resumed = str(tmp_path / "r.safetensors")
    assert cli.main(_argv(dirs, resumed, "--resume_from", out)) == 0
    assert signal.getsignal(signal.SIGTERM) == before  # handlers back
    whole = str(tmp_path / "w.safetensors")
    assert cli.main(_argv(dirs, whole)) == 0
    a = SafeTensorsReader(resumed).load_all()
    b = SafeTensorsReader(whole).load_all()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_stream_with_drain_rollback_and_degrade_renders(dirs, tmp_path):
    """One stream over three runs: a drained one, a rollback and a
    dispatch-OOM degrade appended to it (seq continues); every line is
    valid and tools/telemetry_report.py renders it."""
    stream = str(tmp_path / "all.jsonl")
    rc, _ = _drain_in_subprocess(dirs, str(tmp_path / "d.safetensors"),
                                 stream, after_step=3)
    assert rc == EXIT_PREEMPTED
    assert cli.main(_argv(dirs, str(tmp_path / "r.safetensors"),
                          "--save_every", "2", "--skip_nonfinite", "1",
                          "--rollback_budget", "1",
                          "--rollback_skip_streak", "2",
                          "--inject", "grad_nan:5:2",
                          "--telemetry_out", stream)) == 0
    assert cli.main(_argv(dirs, str(tmp_path / "o.safetensors"),
                          "--inject", "hbm_pressure:1",
                          "--telemetry_out", stream)) == 0
    evs = read_events(stream)
    assert [e["seq"] for e in evs] == list(range(len(evs)))
    for e in evs:
        assert validate_event(e) is None, (e, validate_event(e))
    kinds = {e["event"] for e in evs}
    assert {"preempt", "rollback", "degrade", "ckpt_verify"} <= kinds
    assert [e["exit"] for e in evs if e["event"] == "run_end"] == \
        ["preempted", "ok", "ok"]
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "telemetry_report.py"),
         stream], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert "ROLLBACK" in res.stdout and "DEGRADE remat" in res.stdout
