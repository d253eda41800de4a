"""The port's step governor (mobilefinetuner_tpu_torch/system/governor.py,
its own copy of the JAX module) held exactly against the JAX package's:
the schedule grammar and its errors, the sleep policy step by step, the
`throttle` events and the run-total sleep; `governor_from_args` builds
the JAX CLI's governor from the same flags; and a port training run
under `--pm_schedule` charges its sleeps to the goodput
`governor_sleep` bucket, reports them in step_stats.slept_ms and
run_end.governor_slept_ms, and leaves them out of step_time_ms."""

import argparse
import dataclasses
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.cli import common as jax_common  # noqa: E402
from mobilefinetuner_tpu.core.telemetry import validate_event  # noqa: E402
from mobilefinetuner_tpu.system import governor as jg  # noqa: E402
from mobilefinetuner_tpu_torch.cli import common  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.system import governor as pg  # noqa: E402

SPECS = ["", "0-99:300,100-199:150,200-:50", " 5 : 20 , 7-9:1.5 ",
         "0-:100", "3:0", "10-:5000.5,0-9:7"]
BAD = ["x", "1-2", "a-b:3", "-5:1", "1-2:x", "1:2:3"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_schedule_is_the_jax_grammar(spec):
    got = [dataclasses.astuple(r) for r in pg.parse_schedule(spec)]
    want = [dataclasses.astuple(r) for r in jg.parse_schedule(spec)]
    assert got == want
    assert pg.MAX_SLEEP_MS == jg.MAX_SLEEP_MS


@pytest.mark.parametrize("spec", BAD)
def test_parse_schedule_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as p:
        pg.parse_schedule(spec)
    with pytest.raises(ValueError) as j:
        jg.parse_schedule(spec)
    assert str(p.value) == str(j.value)


CONFIGS = {
    "off": dict(),
    "schedule": dict(enable=True, schedule="0-4:30,10-:7",
                     check_interval_steps=0),
    "telemetry": dict(enable=True, check_interval_steps=3,
                      manual_battery=10.0, manual_temp=50.0),
    "both": dict(enable=True, schedule="2-3:11", check_interval_steps=2,
                 manual_battery=90.0, manual_temp=45.0,
                 freq_temp_low=0.0),
    "sensors": dict(enable=True, check_interval_steps=4),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sleep_policy_and_throttle_events_equal_jax(name, monkeypatch):
    monkeypatch.setattr(pg.time, "sleep", lambda s: None)
    monkeypatch.setattr(jg.time, "sleep", lambda s: None)
    readings = iter([15.0, 50.0, 30.0, 41.0, 12.0, 44.0] * 8)
    fns = {}
    if name == "sensors":
        seq = list(readings)
        fns = {"battery_fn": lambda: seq[0], "temp_fn": lambda: seq[1]}
    out = []
    for mod in (pg, jg):
        events = []
        gov = mod.StepGovernor(mod.GovernorConfig(**CONFIGS[name]),
                               event_sink=events.append, **fns)
        sleeps = [gov.suggest_sleep_ms(s) for s in range(14)]
        gov2 = mod.StepGovernor(mod.GovernorConfig(**CONFIGS[name]),
                                event_sink=events.append, **fns)
        slept = [gov2.throttle(s) for s in range(14)]
        gov2.set_manual_telemetry(battery=5.0, temp=60.0)
        slept.append(gov2.throttle(14))
        out.append((sleeps, slept, events, gov2.total_slept_ms))
    assert out[0] == out[1]


def _pm_args(**kw):
    p = argparse.ArgumentParser()
    common.add_pm_flags(p)
    argv = []
    for k, v in kw.items():
        if v is True:
            argv.append(f"--{k}")
        else:
            argv += [f"--{k}", str(v)]
    return p.parse_args(argv)


@pytest.mark.parametrize("kw", [
    {}, {"pm_schedule": "0-:40"}, {"pm_interval": 5},
    {"pm_interval": 2, "pm_disable_batt": True, "pm_manual_temp": 50},
    {"pm_schedule": "3:9", "pm_interval": 1, "pm_disable_temp": True}])
def test_governor_from_args_builds_the_jax_governor(kw):
    args = _pm_args(**kw)
    port = common.governor_from_args(args)
    want = jax_common.governor_from_args(args)
    assert dataclasses.asdict(port.config) == \
        dataclasses.asdict(want.config)
    assert [port.suggest_sleep_ms(s) for s in range(8)] == \
        [want.suggest_sleep_ms(s) for s in range(8)]


def test_a_governed_run_charges_its_sleeps(tmp_path):
    gdir, wiki = str(tmp_path / "g"), str(tmp_path / "w")
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    stream = str(tmp_path / "t.jsonl")
    assert cli.main(["--pretrained_dir", gdir, "--data_dir", wiki,
                     "--steps", "4", "--batch_size", "2", "--seq_len", "32",
                     "--device", "cpu", "--lora_out",
                     str(tmp_path / "a.safetensors"), "--telemetry_out",
                     stream, "--pm_schedule", "0-1:150,2-:40",
                     "--log_interval", "2"]) == 0
    evs = [json.loads(line) for line in open(stream)]
    for e in evs:
        assert validate_event(e) is None
    throttles = [(e["step"], e["sleep_ms"], e["source"]) for e in evs
                 if e["event"] == "throttle"]
    assert throttles == [(0, 150.0, "schedule"), (2, 40.0, "schedule")]
    stats = [e for e in evs if e["event"] == "step_stats"]
    # a step's sleep follows its flush: the second interval holds the
    # sleeps after steps 1 and 2, the last one falls after the last flush
    assert [s["slept_ms"] for s in stats] == [150.0, 190.0]
    end = evs[-1]
    assert end["governor_slept_ms"] == 380.0
    assert 0.38 <= end["goodput"]["governor_sleep_s"] < 1.0
    # the flush interval's per-step time leaves the sleeps out: two steps
    # and 190 ms of sleep fit between the two step_stats events
    wall_ms = (stats[1]["t"] - stats[0]["t"]) * 1000.0
    assert 0 < 2 * stats[1]["step_time_ms"] <= wall_ms - 190.0 + 1.0
