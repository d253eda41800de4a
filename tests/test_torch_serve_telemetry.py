"""The serve engine's telemetry and drain in the port (serve/engine.py,
serve/bench.py) held against the JAX engine on the same weights and
requests, f32 on the CPU: every request emits the JAX engine's sequence
of `request` phases (enqueue, admit, first_token, one terminal phase)
and spans, with the same greedy tokens, over one-shot prefills, full
prefix hits, chunked admissions, a rejected and a cancelled request;
`serve_stats` at the JAX cadence; `ckpt_verify` on adapter files;
/metrics and /healthz scraped from a live engine, 503 once it drains;
and a child engine drained by SIGTERM: the queue rejected with reason
`shutdown`, the in-flight requests finished, run_end{exit=preempted}."""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2Config
from mobilefinetuner_tpu.core.telemetry import Telemetry as JaxTelemetry
from mobilefinetuner_tpu.core.telemetry import validate_event
from mobilefinetuner_tpu.models import gpt2 as jgpt2
from mobilefinetuner_tpu.serve import ServeConfig as JaxServeConfig
from mobilefinetuner_tpu.serve import ServeEngine as JaxServeEngine
from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.core.preempt import PreemptionGuard
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry
from mobilefinetuner_tpu_torch.io.safetensors_io import \
    CheckpointIntegrityError
from mobilefinetuner_tpu_torch.lora import peft_io
from mobilefinetuner_tpu_torch.lora.lora import LoRASpec
from mobilefinetuner_tpu_torch.serve import ServeConfig, ServeEngine
from mobilefinetuner_tpu_torch.serve.bench import (build_engine,
                                                   rand_adapters)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = dataclasses.replace(
    JaxGPT2Config.tiny(vocab_size=211), n_embd=64, n_head=4, n_positions=96,
    n_layer=3)
CFG = GPT2Config(**{f.name: getattr(JAX_CFG, f.name)
                    for f in dataclasses.fields(GPT2Config)})
SHAPE = dict(num_slots=3, block_T=8, num_blocks=64, max_prompt=16,
             max_new_tokens=12, trace_spans=True, stats_every=2)


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jgpt2.init_params(JAX_CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params(np_params):
    return convert.gpt2_params_from_numpy(np_params, device="cpu")


def ints(rng, n):
    return [int(x) for x in rng.integers(1, 200, n)]


def _timeline(evs):
    """{request id: [(kind, phase or span name, reason)]} in stream order,
    and the serve_stats steps."""
    per = {}
    for e in evs:
        if e["event"] == "request":
            per.setdefault(e["id"], []).append(
                ("request", e["phase"], e["reason"]))
        elif e["event"] == "span":
            per.setdefault(e["id"], []).append(
                ("span", e["name"], e.get("outcome")))
    return per, [e["step"] for e in evs if e["event"] == "serve_stats"]


@pytest.mark.parametrize("mode", ["one_shot", "prefix_chunked"])
def test_request_phases_and_tokens_equal_the_jax_engine(np_params, params,
                                                        tmp_path, mode):
    rng = np.random.default_rng(3)
    shape = dict(SHAPE)
    if mode == "one_shot":
        prompts = [ints(rng, n) for n in (5, 9, 2, 13, 7, 3)]
        waves = 1
    else:
        common = ints(rng, 16)
        prompts = [common + ints(rng, 5), list(common), ints(rng, 40),
                   common[:8] + ints(rng, 30)]
        shape.update(prefix_cache=True, max_prompt_chunked=48)
        waves = 2
    runs = {}
    for name in ("jax", "port"):
        path = str(tmp_path / f"{name}.jsonl")
        if name == "jax":
            eng = JaxServeEngine("gpt2", JAX_CFG, np_params,
                                 JaxServeConfig(**shape),
                                 telemetry=JaxTelemetry(path))
        else:
            eng = ServeEngine("gpt2", CFG, params, ServeConfig(**shape),
                              telemetry=Telemetry(path), device="cpu")
        toks = []
        for _ in range(waves):
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            too_long = eng.submit(ints(rng, 60))      # past the true cap
            queued = eng.submit(prompts[0], max_new_tokens=4)
            eng.cancel(queued)
            eng.drain()
            assert too_long.state == "rejected"
            toks.append([r.tokens for r in reqs])
        eng.close()
        runs[name] = (toks, read_events(path))
    assert runs["port"][0] == runs["jax"][0]
    pevs, jevs = runs["port"][1], runs["jax"][1]
    for e in pevs:
        assert validate_event(e) is None, (e, validate_event(e))
    assert _timeline(pevs) == _timeline(jevs)
    assert [e["event"] for e in pevs] == [e["event"] for e in jevs]
    per, stats = _timeline(pevs)
    phases = {k: [p for kind, p, _ in v if kind == "request"]
              for k, v in per.items()}
    assert phases[0] == ["enqueue", "admit", "first_token", "finish"]
    assert ["enqueue", "reject"] in phases.values()
    assert ["enqueue", "cancel"] in phases.values()
    assert stats and all(s % 2 == 0 for s in stats)
    pstats = [e for e in pevs if e["event"] == "serve_stats"]
    jstats = [e for e in jevs if e["event"] == "serve_stats"]
    assert set(pstats[0]) == set(jstats[0])
    for p, j in zip(pstats, jstats):
        for k in ("step", "queue_depth", "active", "free_blocks",
                  "blocks_in_use", "finished", "rejected", "cancelled",
                  "prefix_hit_rate", "cow_copies", "mesh"):
            assert p[k] == j[k], k
    end = pevs[-1]
    assert end["event"] == "run_end" and end["exit"] == "ok"
    # the timings are taken after the host has the token
    for e in pevs:
        if e["event"] == "request" and e["phase"] == "finish":
            assert e["ttft_ms"] >= e["queue_ms"] >= 0
    if mode == "prefix_chunked":
        assert any(kind == "span" and name == "prefill"
                   for v in per.values() for kind, name, _ in v)


def test_adapter_files_are_verified_into_the_stream(tmp_path):
    path = str(tmp_path / "s.jsonl")
    eng, names = build_engine("tiny-gpt2", num_slots=1, block_T=8,
                              num_blocks=16, max_prompt=16, max_new=4,
                              adapters=2, dtype="float32", device="cpu",
                              telemetry_out=path)
    ada = str(tmp_path / "a.safetensors")
    (tree,) = rand_adapters("gpt2", eng.config, 1, seed=5, device="cpu")
    peft_io.save_adapter(ada, tree, LoRASpec(rank=4, alpha=8.0))
    assert eng.load_adapter("tenant1", ada) == 1
    with open(ada, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointIntegrityError):
        eng.load_adapter("tenant1", ada)
    eng.close()
    verdicts = [(e["ok"], e["action"]) for e in read_events(path)
                if e["event"] == "ckpt_verify"]
    assert verdicts == [(True, "load"), (False, "reject")]


def test_metrics_endpoint_on_a_live_engine_and_503_while_draining(tmp_path):
    port = free_port()
    pets = []

    class Pets:
        def pet(self, step, step_s=None):
            pets.append(step)

    eng, _ = build_engine("tiny-gpt2", num_slots=2, block_T=8,
                          num_blocks=32, max_prompt=16, max_new=6,
                          adapters=0, dtype="float32", device="cpu",
                          telemetry_out=str(tmp_path / "s.jsonl"),
                          stats_every=1, trace_spans=True,
                          metrics_port=port, watchdog=Pets())
    base = f"http://127.0.0.1:{port}"
    try:
        reqs = [eng.submit([1 + i, 2, 3], max_new_tokens=6)
                for i in range(5)]
        eng.step()
        eng.step()
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'mft_requests_total{phase="first_token"} 2' in text
        assert text.endswith("# EOF\n")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            h = json.loads(r.read())
            assert r.status == 200 and h["status"] == "ok"
        rejected = eng.begin_shutdown()
        assert [r.reason for r in rejected] == ["shutdown"] * 3
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert e.value.code == 503
        assert json.loads(e.value.read())["draining"] is True
        late = eng.submit([5, 6], max_new_tokens=2)
        assert late.state == "rejected" and late.reason == "shutdown"
        eng.drain()
        assert [r.state for r in reqs[:2]] == ["finished"] * 2
    finally:
        eng.metrics_server.close()
        eng.close()
    assert pets == list(range(1, len(pets) + 1)) and pets


def test_in_process_drain_from_a_triggered_guard(params, tmp_path):
    """A guard already triggered (none installed here): the next step
    emits `preempt`, rejects the queue with reason shutdown, the
    in-flight requests finish, and close() writes run_end{preempted}."""
    path = str(tmp_path / "d.jsonl")
    eng = ServeEngine("gpt2", CFG, params,
                      ServeConfig(**dict(SHAPE, num_slots=2)),
                      telemetry=Telemetry(path), device="cpu")
    reqs = [eng.submit([1, 2, 3 + i], max_new_tokens=5) for i in range(5)]
    eng.step()
    guard = PreemptionGuard()
    guard.installed, guard.triggered, guard.signal_name = \
        True, True, "SIGTERM"
    assert eng.install_preemption(guard) is guard
    eng.drain()
    eng.close()
    assert [r.state for r in reqs] == ["finished"] * 2 + ["rejected"] * 3
    evs = read_events(path)
    kinds = [e["event"] for e in evs]
    assert kinds.count("preempt") == 1
    end = evs[-1]
    assert (end["event"], end["exit"], end["reason"]) == (
        "run_end", "preempted", "preempted")


_CHILD = """
import sys, time
sys.path.insert(0, {repo!r})
from mobilefinetuner_tpu_torch.serve.bench import (build_engine,
                                                   rand_adapters)
eng, _ = build_engine({model!r}, num_slots=2, block_T=16, num_blocks=64,
                      max_prompt=32, max_new=16, adapters=0,
                      dtype="float32", device="cpu",
                      telemetry_out={stream!r}, stats_every=4)
eng.install_preemption()
reqs = [eng.submit([1 + i, 2, 3, 4], max_new_tokens=16) for i in range(8)]
eng.step()
print("ready", flush=True)
t0 = time.time()
while not eng.guard.triggered and time.time() - t0 < 60:
    time.sleep(0.01)
eng.drain()
eng.close()
print(" ".join(r.state for r in reqs), flush=True)
"""


def drain_child(tmp_path, model="tiny-gpt2", timeout=120):
    """Run an engine in a child, SIGTERM it once it has served a step
    (the test process is never signalled); returns (request states,
    stream events)."""
    stream = str(tmp_path / "drain.jsonl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = subprocess.Popen(
        [sys.executable, "-c",
         _CHILD.format(repo=REPO, model=model, stream=stream)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        assert child.stdout.readline().strip() == "ready"
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=timeout)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, err[-2000:]
    return out.split(), read_events(stream)


def test_sigterm_drains_a_child_engine(tmp_path):
    states, evs = drain_child(tmp_path)
    assert states == ["finished"] * 2 + ["rejected"] * 6
    for e in evs:
        assert validate_event(e) is None, e
    rejects = [e for e in evs if e["event"] == "request"
               and e["phase"] == "reject"]
    assert [e["reason"] for e in rejects] == ["shutdown"] * 6
    pre = [i for i, e in enumerate(evs) if e["event"] == "preempt"]
    assert len(pre) == 1 and evs[pre[0]]["signal"] == "SIGTERM"
    # the rejects follow the preempt; the in-flight finishes follow both
    fin = [i for i, e in enumerate(evs) if e["event"] == "request"
           and e["phase"] == "finish"]
    assert len(fin) == 2 and min(fin) > pre[0]
    end = evs[-1]
    assert (end["event"], end["exit"], end["reason"]) == (
        "run_end", "preempted", "preempted")
