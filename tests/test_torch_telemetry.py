"""The port's telemetry stream (mobilefinetuner_tpu_torch/core/telemetry.py)
held against the JAX package's: the same schema, every event the port
writes passing the JAX `validate_event`, the same spike-detector
anomalies on the same loss sequences, and a port CLI's stream equal to
the JAX CLI's on the same run, except for the differences ROADMAP.md
lists under "Differences, not faults" (`DIFFERENCES` below, and no
others)."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402
from test_telemetry import REPRESENTATIVE  # noqa: E402

from mobilefinetuner_tpu.core import telemetry as jt  # noqa: E402
from mobilefinetuner_tpu_torch.core import cuda_stats  # noqa: E402
from mobilefinetuner_tpu_torch.core import telemetry as pt  # noqa: E402


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_schema_is_the_jax_schema():
    assert pt.EVENT_SCHEMA == jt.EVENT_SCHEMA
    assert pt.OPTIONAL_FIELDS == jt.OPTIONAL_FIELDS
    assert pt.REQUEST_PHASES == jt.REQUEST_PHASES
    assert pt.REQUEST_REASONS == jt.REQUEST_REASONS
    assert pt.RUN_PHASES == jt.RUN_PHASES
    assert pt.shard_path("a.jsonl", 0) == jt.shard_path("a.jsonl", 0)
    assert pt.shard_path("a.jsonl", 3) == jt.shard_path("a.jsonl", 3)


@pytest.mark.parametrize("event", sorted(REPRESENTATIVE))
def test_every_event_the_port_writes_passes_jax_validate(tmp_path, event):
    """One emit through the port's sink per event type: the line read
    back passes both validators, with the envelope the JAX sink writes."""
    path = str(tmp_path / "t.jsonl")
    with pt.Telemetry(path) as tel:
        assert tel.emit(event, **REPRESENTATIVE[event]) is not None
    (rec,) = read_events(path)
    assert jt.validate_event(rec) is None, (rec, jt.validate_event(rec))
    assert pt.validate_event(rec) is None
    assert {"event", "seq", "t", "t_mono", "host"} <= set(rec)
    assert rec["seq"] == 0 and rec["host"] == 0


@pytest.mark.parametrize("bad", [
    {"event": "nope"}, {"ppl": None, "loss": "x"}, {"tokens": "many"},
    {"seq": -1}, {"loss": True}, {"tenant": 7}, {"host": -2},
    {"t_mono": "now"}])
def test_validators_agree_on_bad_events(bad):
    ok = dict(event="eval", seq=0, t=1.0, step=1, loss=1.0, ppl=2.0,
              tokens=3)
    rec = {**ok, **bad}
    assert pt.validate_event(rec) is not None
    assert jt.validate_event(rec) is not None
    assert pt.validate_event(ok) is None


def test_strict_json_disabled_stream_and_resumed_seq(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with pt.Telemetry(path) as tel:
        tel.emit("anomaly", step=1, kind="nonfinite_loss",
                 loss=float("nan"), ema=float("inf"), zscore=None)
    raw = open(path).read()
    assert "NaN" not in raw and "Infinity" not in raw
    assert json.loads(raw)["loss"] is None
    # a partial tail line from a killed writer: the next run appends on a
    # fresh line and continues the seq
    with open(path, "a") as f:
        f.write('{"event": "step_stats", "seq": 99, "t"')
    with pt.Telemetry(path) as tel:
        assert tel.resumed
        tel.emit("run_end", steps=1, wall_s=1.0, exit="ok", goodput=None)
    recs = []
    for line in open(path).read().splitlines():
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    assert [r["seq"] for r in recs] == [0, 1]
    assert pt.Telemetry("").emit("run_end", steps=0, wall_s=0.0,
                                 exit="ok") is None
    off = pt.Telemetry(str(tmp_path / "x.jsonl"), enabled=False)
    assert off.emit("run_end", steps=0, wall_s=0.0, exit="ok") is None
    assert not os.path.exists(tmp_path / "x.jsonl")


def test_run_manifest_names_the_port():
    m = pt.run_manifest({"a": 1, "b": [1], "c": None}, device="cpu")
    assert m["jax_version"] == pt.NO_JAX
    assert m["torch_version"] == torch.__version__
    assert m["device_kind"] == "cpu" and m["device_count"] == 1
    assert m["config"] == {"a": 1, "c": None}
    rec = dict(event="run_start", seq=0, t=1.0, **m)
    assert jt.validate_event(rec) is None


def _spike_sequences():
    rng = np.random.default_rng(0)
    noise = list(3.0 + 0.01 * rng.standard_normal(60))
    spike = noise[:40] + [9.0] + noise[40:]
    shift = noise[:30] + [x + 2.0 for x in noise[30:]]
    nonfinite = noise[:25] + [float("nan")] * 3 + noise[25:]
    diverge = noise[:30] + [3.0 + 0.5 * i for i in range(1, 12)]
    return {"noise": noise, "spike": spike, "shift": shift,
            "nonfinite": nonfinite, "diverge": diverge}


@pytest.mark.parametrize("name", sorted(_spike_sequences()))
@pytest.mark.parametrize("cfg", [(8.0, 0.98, 20), (4.0, 0.9, 5)])
def test_spike_detector_gives_the_jax_anomalies(name, cfg):
    losses = _spike_sequences()[name]
    z, beta, warmup = cfg
    port = pt.SpikeDetector(pt.SpikeConfig(zscore=z, beta=beta,
                                           warmup=warmup))
    ref = jt.SpikeDetector(jt.SpikeConfig(zscore=z, beta=beta,
                                          warmup=warmup))
    assert [port.update(x) for x in losses] == \
        [ref.update(x) for x in losses]
    # a re-seed (crash / rollback) arms both alike
    assert port.seed(losses[:10], count_hint=50) == \
        ref.seed(losses[:10], count_hint=50)
    assert (port.mean, port.var, port.count) == (ref.mean, ref.var,
                                                 ref.count)


def test_cuda_stats_say_nothing_for_a_cpu_device():
    assert cuda_stats.live_hbm_mb("cpu") is None
    assert cuda_stats.peak_hbm_mb("cpu") is None
    assert cuda_stats.memory_stat("cpu", "allocated_bytes.all.current",
                                  7) == 7
    assert cuda_stats.free_and_total_mb("cpu") == (None, None)
    cuda_stats.reset_peak("cpu")


# --------------------------- one run, both CLIs -------------------------------

# The differences between the two streams of one run, as ROADMAP.md lists
# them under "Differences, not faults"; the test below allows these and
# no others.
DIFFERENCES = {
    # nothing is compiled ahead in eager PyTorch
    "jax_only_events": {"compile"},
    # run_start names the port's versions beside the schema's jax_version
    "port_only_fields": {"run_start": {"torch_version", "cuda_version"}},
    "jax_only_fields": {},
    # (event, field) whose values differ by design: no JAX, no mesh (P9),
    # the goodput buckets' seconds (measured, and the JAX run's compile
    # bucket holds its XLA compile), no live memory reading on the CPU
    # where the JAX loop reports its compiled estimate, the analytic
    # estimate in place of XLA's memory analysis
    "values": {("run_start", "jax_version"), ("run_start", "mesh_shape"),
               ("run_end", "goodput"),
               ("step_stats", "hbm_mb"), ("mem_check", "est_mb"),
               ("mem_check", "compiled_mb"), ("mem_check", "cap_frac")},
}
# values that differ run to run in both packages alike, and the device
# count (tests/conftest.py gives the JAX package 8 virtual CPU devices)
_VOLATILE = {"seq", "t", "t_mono", "wall_s", "step_time_ms",
             "host_wait_ms", "tok_s", "snapshot_ms", "write_ms", "mb_s",
             "queue_depth", "config", "device_kind", "device_count",
             "loss", "ema", "grad_norm", "param_norm", "update_ratio",
             "ppl", "live_mb"}


@pytest.fixture(scope="module")
def one_run_both_clis(tmp_path_factory):
    root = tmp_path_factory.mktemp("tel_both")
    gdir, wiki = str(root / "gpt2"), str(root / "wiki")
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    from mobilefinetuner_tpu.cli import gpt2_lora_finetune as jax_cli
    from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli
    streams = {}
    for name, main, extra in (("jax", jax_cli.main, ["--prefetch", "0"]),
                              ("port", cli.main, ["--device", "cpu"])):
        out = str(root / name)
        assert main(["--pretrained_dir", gdir, "--data_dir", wiki,
                     "--steps", "4", "--batch_size", "2", "--seq_len", "32",
                     "--save_every", "2", "--eval_interval", "2",
                     "--eval_batches", "1", "--async_save", "0",
                     "--lora_out", os.path.join(out, "a.safetensors"),
                     "--telemetry_out", os.path.join(out, "t.jsonl"),
                     *extra]) == 0
        streams[name] = read_events(os.path.join(out, "t.jsonl"))
    return streams


def test_port_stream_equals_the_jax_stream_but_for_the_listed_differences(
        one_run_both_clis):
    jax_evs = [e for e in one_run_both_clis["jax"]
               if e["event"] not in DIFFERENCES["jax_only_events"]]
    port_evs = one_run_both_clis["port"]
    for e in port_evs:
        assert jt.validate_event(e) is None, (e, jt.validate_event(e))
    assert [e["event"] for e in port_evs] == [e["event"] for e in jax_evs]
    assert {e["event"] for e in one_run_both_clis["jax"]} - \
        {e["event"] for e in port_evs} == DIFFERENCES["jax_only_events"]
    for p, j in zip(port_evs, jax_evs):
        ev = p["event"]
        extra = DIFFERENCES["port_only_fields"].get(ev, set())
        assert set(p) - set(j) == extra, ev
        assert set(j) - set(p) == \
            DIFFERENCES["jax_only_fields"].get(ev, set()), ev
        for k in set(p) & set(j):
            if k in _VOLATILE or (ev, k) in DIFFERENCES["values"]:
                continue
            assert p[k] == j[k], (ev, k, p[k], j[k])
        if ev == "step_stats":    # the losses agree to f32 parity
            assert math.isclose(p["loss"], j["loss"], rel_tol=1e-4)
