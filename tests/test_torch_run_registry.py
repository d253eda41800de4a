"""The port's run registry (mobilefinetuner_tpu_torch/core/run_registry.py,
its own copy of the JAX module over the port's Telemetry) held against
the JAX package's: a registry file is a shared format, so a file either
package writes is read, settled and resolved by the other; the
fingerprint and git rev are the JAX functions' values; and a registered
child killed with SIGKILL is settled to `interrupted` on the next open,
by either package."""

import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest

from mobilefinetuner_tpu.core import run_registry as jr
from mobilefinetuner_tpu.core.telemetry import validate_event
from mobilefinetuner_tpu_torch.core import run_registry as pr
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("config", [
    None, {}, {"steps": 3, "lr": 1e-4, "dev": None, "flag": True},
    {"b": "x", "a": [1, 2], "c": 2.5}])
def test_fingerprint_and_git_rev_are_the_jax_values(config):
    assert pr.config_fingerprint(config) == jr.config_fingerprint(config)
    assert pr.git_rev(REPO) == jr.git_rev(REPO)
    assert pr.git_rev("/nonexistent") is None
    assert pr.REGISTRY_ENV == jr.REGISTRY_ENV
    assert pr.TERMINAL == jr.TERMINAL


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_registry_either_package_writes_the_other_resolves(
        tmp_path, writer, reader):
    W = pr.RunRegistry if writer == "port" else jr.RunRegistry
    R = pr.RunRegistry if reader == "port" else jr.RunRegistry
    path = str(tmp_path / "registry.jsonl")
    stream = str(tmp_path / "run.jsonl")
    tel = Telemetry(stream)
    ok = W(path).begin("train", "gpt2_lora_finetune",
                       config={"steps": 3}, platform="cpu",
                       artifacts=[stream, ""], telemetry=tel)
    ok.finalize("ok", artifacts=["a.safetensors"])
    with pytest.raises(ValueError):
        with W(path).begin("eval", "eval_ppl", platform="gpu"):
            raise ValueError("boom")
    tel.close()
    for line in open(path):
        assert validate_event(json.loads(line)) is None
    recs = R(path).records()
    assert [(r["kind"], r["tool"], r["status"]) for r in recs] == [
        ("train", "gpt2_lora_finetune", "ok"), ("eval", "eval_ppl",
                                                "ValueError")]
    assert recs[0]["artifacts"] == [stream, "a.safetensors"]
    assert recs[0]["config_fingerprint"] == \
        jr.config_fingerprint({"steps": 3})
    reg = R(path)
    assert reg.resolve(recs[1]["run_id"])["tool"] == "eval_ppl"
    assert reg.resolve(recs[0]["run_id"][:-2])["run_id"] == \
        recs[0]["run_id"]
    assert reg.resolve("") is None and reg.resolve("zzz") is None
    rev = recs[0]["git_rev"]
    if rev:
        assert reg.resolve(rev[:8])["run_id"] == recs[1]["run_id"]
    # the run's own stream mirrors its start and end records
    mirrored = [json.loads(line) for line in open(stream)]
    assert [(r["event"], r["phase"]) for r in mirrored] == [
        ("run", "start"), ("run", "end")]
    assert reg.artifact_for(recs[0]["run_id"], ".jsonl") == stream


def test_from_args_reads_the_flag_then_the_environment(tmp_path,
                                                       monkeypatch):
    monkeypatch.delenv(pr.REGISTRY_ENV, raising=False)
    assert pr.RunRegistry.from_args(types.SimpleNamespace()) is None
    assert pr.registry_from("") is None
    monkeypatch.setenv(pr.REGISTRY_ENV, str(tmp_path / "env.jsonl"))
    ns = types.SimpleNamespace(run_registry="")
    assert pr.RunRegistry.from_args(ns).path == str(tmp_path / "env.jsonl")
    ns.run_registry = str(tmp_path / "flag.jsonl")
    assert pr.registry_from(ns).path == str(tmp_path / "flag.jsonl")
    assert pr.registry_from(str(tmp_path / "s.jsonl")).path == \
        str(tmp_path / "s.jsonl")


_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
from mobilefinetuner_tpu_torch.core.run_registry import RunRegistry
RunRegistry({path!r}).begin("train", "child", config={{"steps": 9}},
                            platform="cpu")
print("registered", flush=True)
time.sleep(60)
"""


@pytest.mark.parametrize("settler", ["port", "jax"])
def test_a_sigkilled_run_settles_interrupted(tmp_path, settler):
    """A child registers and is killed with SIGKILL mid-run: the next open
    appends one `interrupted` end record (append-only), and both packages
    resolve the run to it."""
    path = str(tmp_path / "registry.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=REPO, path=path)],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert child.stdout.readline().strip() == "registered"
        # a live run is left alone
        live = (pr if settler == "port" else jr).RunRegistry(path)
        assert live.settle() == 0
        assert live.records(settle=False)[0]["status"] == "running"
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
        child.stdout.close()
    deadline = time.time() + 10
    while time.time() < deadline and pr._pid_alive(child.pid):
        time.sleep(0.05)
    reg = (pr if settler == "port" else jr).RunRegistry(path)
    assert reg.settle() == 1
    assert reg.settle() == 0                 # settled once
    lines = [json.loads(line) for line in open(path)]
    assert [(r["phase"], r["status"]) for r in lines] == [
        ("start", "running"), ("end", "interrupted")]
    for mod in (pr, jr):
        (rec,) = mod.RunRegistry(path).records()
        assert rec["status"] == "interrupted" and rec["tool"] == "child"
