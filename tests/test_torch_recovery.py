"""Checkpoint lineage, in-process rollback and fault injection in the port
(io/checkpoints.py lineage, cli/common.run_training, FaultInjector), held
against the JAX package: the same checkpoint choice and verdicts on the
same corrupted or truncated lineage directories, lineage files written by
either package read by the other, the same --inject grammar, and the
contracts of the JAX package's recovery tests on the port's CLIs: a
grad_nan rollback whose final adapter equals, bit for bit, a clean run
resumed from the rollback checkpoint; one failed rollback per episode; a
corrupt newest --resume_from falling back down the lineage with
ckpt_verify evidence after run_start."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import write_tiny_gpt2_dir, write_wikitext_dir  # noqa: E402

from mobilefinetuner_tpu.cli import common as jax_common  # noqa: E402
from mobilefinetuner_tpu.core.telemetry import validate_event  # noqa: E402
from mobilefinetuner_tpu.io import checkpoints as jax_ck  # noqa: E402
from mobilefinetuner_tpu.io import safetensors_io as jax_sio  # noqa: E402
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu.optim import adam as jax_adam  # noqa: E402
from mobilefinetuner_tpu_torch.cli import common  # noqa: E402
from mobilefinetuner_tpu_torch.cli import gpt2_lora_finetune as cli  # noqa
from mobilefinetuner_tpu_torch.io import checkpoints as ck  # noqa: E402
from mobilefinetuner_tpu_torch.io.safetensors_io import (  # noqa: E402
    CheckpointIntegrityError, SafeTensorsReader, manifest_path,
    save_safetensors)


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _bitflip(path, offset=-1):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        b = f.read(1)
        f.seek(offset, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


# --------------------------- lineage, both packages ---------------------------

def _mk_lineage(d, steps, keep=0, writer="port"):
    save = save_safetensors if writer == "port" else jax_sio.save_safetensors
    record = ck.record_checkpoint if writer == "port" \
        else jax_ck.record_checkpoint
    final = os.path.join(d, "a.safetensors")
    paths = {}
    for s in steps:
        p = os.path.join(d, f"a_step{s}.safetensors")
        save(p, {"x": np.full(4, s, np.float32)})
        save(p + ".opt", {"step": np.int32(s)})
        record(final, s, [p, p + ".opt"], keep=keep)
        paths[s] = p
    return final, paths


def _truncate(p):
    data = open(p, "rb").read()
    open(p, "wb").write(data[: len(data) // 2])


def _stale(p):
    other = p + ".other"
    save_safetensors(other, {"z": np.zeros(2, np.float32)})
    os.replace(manifest_path(other), manifest_path(p))
    os.unlink(other)


# scenario -> what it does to the lineage at steps 2, 4, 6
SCENARIOS = {
    "clean": lambda paths: None,
    "bitflip_newest": lambda paths: _bitflip(paths[6]),
    "truncate_newest": lambda paths: _truncate(paths[6]),
    "no_manifest_newest": lambda paths: os.unlink(manifest_path(paths[6])),
    "missing_sidecar": lambda paths: os.unlink(paths[6] + ".opt"),
    "missing_file": lambda paths: os.unlink(paths[6]),
    "stale_manifest": lambda paths: _stale(paths[4]),
    "two_corrupt": lambda paths: (_bitflip(paths[6]), _truncate(paths[4])),
    "no_manifests": lambda paths: [os.unlink(manifest_path(f))
                                   for s in (2, 4, 6)
                                   for f in (paths[s], paths[s] + ".opt")],
    "all_corrupt": lambda paths: [_bitflip(paths[s]) for s in (2, 4, 6)],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resolve_checkpoint_makes_the_jax_choice(tmp_path, scenario,
                                                 writer):
    """The same lineage directory, damaged the same way, resolved by both
    packages: the same checkpoint, step and ckpt_verify verdicts, for an
    explicit --resume_from of the newest file, a rollback's lineage-only
    walk below a step, and --verify_ckpt 0."""
    final, paths = _mk_lineage(str(tmp_path), [2, 4, 6], writer=writer)
    SCENARIOS[scenario](paths)
    assert ck.lineage_entries(final) == jax_ck.lineage_entries(final)
    for kwargs in ({"path": paths[6]},
                   {"path": None, "lineage_base": final},
                   {"path": None, "lineage_base": final, "max_step": 5},
                   {"path": None, "lineage_base": final, "verify": False}):
        got = want = None
        try:
            want = jax_ck.resolve_checkpoint(**kwargs)
        except jax_sio.CheckpointIntegrityError:
            with pytest.raises(CheckpointIntegrityError):
                ck.resolve_checkpoint(**kwargs)
            continue
        got = ck.resolve_checkpoint(**kwargs)
        assert got == want, (kwargs, got, want)
        for ev in got[2]:
            assert validate_event(dict(event="ckpt_verify", seq=0, t=1.0,
                                       **ev)) is None


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_lineage_gc_and_lookups_cross_packages(tmp_path, writer, reader):
    """--keep_ckpts GC written by one package, read by the other: the
    same retained entries, the pruned files gone, the same step lookups."""
    final, paths = _mk_lineage(str(tmp_path), [2, 4, 6, 8], keep=2,
                               writer=writer)
    mod = ck if reader == "port" else jax_ck
    assert [e["step"] for e in mod.lineage_entries(final)] == [8, 6]
    assert not os.path.exists(paths[2]) and not os.path.exists(paths[4])
    assert not os.path.exists(manifest_path(paths[2]))
    assert mod.lineage_step_for(paths[8]) == 8
    assert mod.lineage_base_for(paths[6]) == final
    # the other package appends to the same lineage
    other = ck if reader == "jax" else jax_ck
    p = os.path.join(str(tmp_path), "a.safetensors")
    save_safetensors(p, {"x": np.zeros(4, np.float32)})
    other.record_checkpoint(final, 10, [p], keep=2)
    assert [e["step"] for e in mod.lineage_entries(final)] == [10, 8, 6]


def test_lineage_survives_interrupted_gc(tmp_path, monkeypatch):
    """The pruned lineage is published before any file goes: a kill
    between the two leaves orphans, never a lineage naming deleted
    files."""
    final, paths = _mk_lineage(str(tmp_path), [2, 4, 6])

    def killed(path):
        raise KeyboardInterrupt("killed mid-GC")

    p8 = os.path.join(str(tmp_path), "a_step8.safetensors")
    save_safetensors(p8, {"x": np.full(4, 8, np.float32)})
    monkeypatch.setattr(os, "unlink", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.record_checkpoint(final, 8, [p8], keep=2)
    monkeypatch.undo()
    assert [e["step"] for e in ck.lineage_entries(final)] == [8, 6]
    assert os.path.exists(paths[2])            # an orphan, invisible
    r, step, _ = ck.resolve_checkpoint(None, lineage_base=final)
    assert (r, step) == (p8, 8)


@pytest.mark.parametrize("spec", [
    "", "grad_nan:5", "grad_nan:5:3", "loss_spike:2:4", "ckpt_corrupt",
    "hbm_pressure:8", "hbm_pressure:0", "slow_step:3:250", "slow_step:3:0:7",
    "hbm_pressure", "grad_nan", "slow_step:3", "slow_step:1:-5",
    "slow_step:1:nan", "slow_step:1:inf", "bogus:1", "loss_spike:2:0"])
def test_parse_train_inject_is_the_jax_grammar(spec):
    def parse(fn):
        try:
            return fn(spec)
        except SystemExit as e:
            return ("SystemExit", str(e))
    assert parse(common.parse_train_inject) == \
        parse(jax_common.parse_train_inject)


def test_fault_injector_latches():
    inj = common.FaultInjector("grad_nan:1:2")
    batch = {"input_ids": np.zeros((2, 4), np.int32),
             "labels": np.zeros((2, 4), np.int32)}
    scales = [inj.maybe_poison(s, batch)["grad_scale"][0] for s in range(5)]
    assert [np.isnan(x) for x in scales] == [False, True, True, False,
                                             False]
    # a replay of the window after a rollback runs clean
    assert not np.isnan(inj.maybe_poison(1, batch)["grad_scale"][0])
    spike = common.FaultInjector("loss_spike:0")
    labels = np.arange(8, dtype=np.int32).reshape(1, 8)
    out = spike.maybe_poison(0, {"input_ids": labels, "labels": labels})
    assert (out["labels"] == np.roll(labels, 7, axis=-1)).all()
    assert spike.maybe_poison(1, {"labels": labels})["labels"] is labels
    oom = common.FaultInjector("hbm_pressure:1")
    oom.arm_ballast(torch.device("cpu"))
    assert oom.ballast.numel() == 2 ** 20
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        oom.maybe_oom_dispatch(0, torch.device("cpu"))
    oom.maybe_oom_dispatch(0, torch.device("cpu"))   # fired once
    oom.release_ballast()
    assert oom.ballast is None


# --------------------------- the CLI, end to end ------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_recovery")
    gdir, wiki = str(root / "gpt2"), str(root / "wiki")
    write_tiny_gpt2_dir(gdir)
    write_wikitext_dir(wiki)
    return gdir, wiki


def _argv(dirs, out, steps, *extra):
    gdir, wiki = dirs
    return ["--pretrained_dir", gdir, "--data_dir", wiki, "--steps",
            str(steps), "--batch_size", "2", "--seq_len", "32",
            "--lora_out", out, "--device", "cpu", *extra]


def _adapter(path):
    return SafeTensorsReader(path).load_all()


def test_grad_nan_rollback_resumes_to_the_clean_result(dirs, tmp_path):
    """--inject grad_nan:5:3 under the skip guard: three skipped steps,
    one rollback{ok, skip_streak} to a verified lineage checkpoint, one
    run_end{ok} in one valid stream with increasing seq; the final
    adapter equals, bit for bit, a clean run resumed from the rollback's
    checkpoint over the same batches."""
    out = str(tmp_path / "a.safetensors")
    telem = str(tmp_path / "run.jsonl")
    assert cli.main(_argv(dirs, out, 12, "--save_every", "2",
                          "--keep_ckpts", "4", "--skip_nonfinite", "1",
                          "--rollback_budget", "2",
                          "--rollback_skip_streak", "3",
                          "--rollback_data_offset", "0",
                          "--inject", "grad_nan:5:3",
                          "--telemetry_out", telem)) == 0
    evs = read_events(telem)
    for e in evs:
        assert validate_event(e) is None, (e, validate_event(e))
    seqs = [e["seq"] for e in evs]
    assert all(a < b for a, b in zip(seqs, seqs[1:]))
    assert [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"]
    assert sum(e.get("skipped") or 0 for e in evs
               if e["event"] == "step_stats") == 3
    assert sum(e["nonfinite_count"] > 0 for e in evs
               if e["event"] == "step_stats") == 3
    (rb,) = [e for e in evs if e["event"] == "rollback"]
    assert rb["ok"] is True and rb["reason"] == "skip_streak"
    assert rb["to_step"] < rb["step"] and rb["data_offset"] == 0
    vfy = [e for e in evs if e["event"] == "ckpt_verify"]
    assert vfy and vfy[-1]["ok"] is True and vfy[-1]["path"] == rb["ckpt"]
    md = SafeTensorsReader(rb["ckpt"] + ".opt").metadata
    assert int(md["loop_step"]) == rb["to_step"]
    adam_step = int(SafeTensorsReader(rb["ckpt"] + ".opt")
                    .load_all()["step"])
    assert adam_step < rb["to_step"]      # Adam lags the skipped steps
    out_b = str(tmp_path / "b.safetensors")
    assert cli.main(_argv(dirs, out_b, 12, "--skip_nonfinite", "1",
                          "--resume_from", rb["ckpt"])) == 0
    a, b = _adapter(out), _adapter(out_b)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_failed_rollback_fires_once_per_episode(dirs, tmp_path):
    """A rollback wanted with no checkpoint to go back to: ONE
    rollback{ok=false} for the whole bad episode, and the run ends ok."""
    telem = str(tmp_path / "nockpt.jsonl")
    assert cli.main(_argv(dirs, str(tmp_path / "n.safetensors"), 10,
                          "--skip_nonfinite", "1", "--rollback_budget", "2",
                          "--rollback_skip_streak", "2",
                          "--inject", "grad_nan:2:6",
                          "--telemetry_out", telem)) == 0
    evs = read_events(telem)
    rbs = [e for e in evs if e["event"] == "rollback"]
    assert len(rbs) == 1 and rbs[0]["ok"] is False, rbs
    assert [e["exit"] for e in evs if e["event"] == "run_end"] == ["ok"]


def test_resume_from_a_corrupt_final_falls_back(dirs, tmp_path):
    """A corrupted newest checkpoint at --resume_from resolves to the
    previous lineage entry, its ckpt_verify verdicts land in the resumed
    run's stream after run_start, and the run completes from there."""
    out = str(tmp_path / "a.safetensors")
    assert cli.main(_argv(dirs, out, 6, "--save_every", "2",
                          "--keep_ckpts", "3")) == 0
    _bitflip(out)
    telem = str(tmp_path / "resume.jsonl")
    assert cli.main(_argv(dirs, str(tmp_path / "b.safetensors"), 8,
                          "--resume_from", out,
                          "--telemetry_out", telem)) == 0
    evs = read_events(telem)
    assert evs[0]["event"] == "run_start"
    vfy = [e for e in evs if e["event"] == "ckpt_verify"]
    assert vfy[0]["ok"] is False and vfy[0]["path"] == out
    assert "checksum_mismatch" in vfy[0]["reason"]
    accepted = [e for e in vfy if e["ok"]]
    assert accepted and accepted[0]["step"] == 4
    (end,) = [e for e in evs if e["event"] == "run_end"]
    assert end["exit"] == "ok" and end["steps"] == 4


def test_inject_ckpt_corrupt_then_resume_falls_back(dirs, tmp_path):
    """--inject ckpt_corrupt flips a byte of the first periodic save once
    it has landed; a resume from that file falls back down the lineage
    (ckpt_verify ok=false, then ok=true)."""
    out = str(tmp_path / "c.safetensors")
    assert cli.main(_argv(dirs, out, 4, "--save_every", "2",
                          "--inject", "ckpt_corrupt")) == 0
    step2 = str(tmp_path / "c_step2.safetensors")
    assert ck.verify_report(step2)[0] == "corrupt"
    telem = str(tmp_path / "c_resume.jsonl")
    assert cli.main(_argv(dirs, str(tmp_path / "d.safetensors"), 6,
                          "--resume_from", step2,
                          "--telemetry_out", telem)) == 0
    vfy = [(e["ok"], e["step"]) for e in read_events(telem)
           if e["event"] == "ckpt_verify"]
    assert vfy == [(False, 2), (True, 4)]


def _nested(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def test_checkpoints_written_by_either_package_resume_in_the_other(
        dirs, tmp_path):
    """A lineage of adapters and .opt sidecars written by the JAX
    package's writers, its newest entry corrupt, resumes in the port's
    CLI from the entry before; a port-written lineage, damaged the same
    way, resolves in the JAX package to the same entry, whose adapter and
    .opt sidecar load there."""
    seed = str(tmp_path / "seed.safetensors")
    assert cli.main(_argv(dirs, seed, 2)) == 0
    lora, spec = jax_peft_io.load_adapter(seed)
    reader = SafeTensorsReader(seed + ".opt")
    opt = _nested(reader.load_all())
    cfg = jax_adam.AdamConfig(lr=float(reader.metadata["adam_lr"]))
    out = str(tmp_path / "j.safetensors")
    for s in (2, 4):
        p = str(tmp_path / f"j_step{s}.safetensors")
        jax_peft_io.save_adapter(p, lora, spec)
        jax_adam.save_state(p + ".opt", opt, cfg,
                            extra_metadata={"loop_step": str(s)})
        jax_ck.record_checkpoint(out, s, [p, p + ".opt"])
    _bitflip(str(tmp_path / "j_step4.safetensors"))
    telem = str(tmp_path / "j.jsonl")
    assert cli.main(_argv(dirs, str(tmp_path / "k.safetensors"), 3,
                          "--resume_from",
                          str(tmp_path / "j_step4.safetensors"),
                          "--telemetry_out", telem)) == 0
    evs = read_events(telem)
    assert [(e["ok"], e["step"]) for e in evs
            if e["event"] == "ckpt_verify"] == [(False, 4), (True, 2)]
    assert [e["steps"] for e in evs if e["event"] == "run_end"] == [1]
    # the port's lineage, read by the JAX package
    pout = str(tmp_path / "p.safetensors")
    assert cli.main(_argv(dirs, pout, 4, "--save_every", "2")) == 0
    _bitflip(pout)
    resolved, step, events = jax_ck.resolve_checkpoint(pout)
    assert (resolved, step) == (str(tmp_path / "p_step2.safetensors"), 2)
    assert (resolved, step, events) == ck.resolve_checkpoint(pout)
    jlora, _ = jax_peft_io.load_adapter(resolved)
    template = {"step": np.zeros((), np.int32),
                "m": {"blocks": {n: {"A": e["A"], "B": e["B"]}
                                 for n, e in jlora["blocks"].items()}},
                "v": {"blocks": {n: {"A": e["A"], "B": e["B"]}
                                 for n, e in jlora["blocks"].items()}}}
    jopt, jcfg = jax_adam.load_state(resolved + ".opt", template,
                                     to_host=True)
    assert int(np.asarray(jopt["step"])) == 2
