"""Snapshot-then-write checkpoints in the port (io/async_ckpt.py), held to
the contracts of the JAX package's tests/test_async_ckpt.py: the snapshot
owns its buffers, the writer's depth-1 queue coalesces to the newest
snapshot with a ckpt_dropped event, write errors surface and never leak
the thread, a SIGKILL mid-write leaves the previous checkpoint loadable,
and every train CLI writes byte-identical files with --async_save 0 and 1
(the `checkpoint` events valid against the JAX schema)."""

import filecmp
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import (write_tiny_gemma3_dir, write_tiny_gpt2_dir,  # noqa
                      write_wikitext_dir)

from mobilefinetuner_tpu.core.telemetry import validate_event  # noqa: E402
from mobilefinetuner_tpu_torch.io.async_ckpt import (  # noqa: E402
    AsyncCheckpointer, CheckpointDrainTimeout, snapshot, submit,
    timed_snapshot, tree_bytes)
from mobilefinetuner_tpu_torch.io.safetensors_io import (  # noqa: E402
    SafeTensorsReader, save_safetensors)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sink(events):
    return lambda ev, **f: events.append({"event": ev, **f})


def _writer_threads():
    return [t for t in threading.enumerate() if t.name == "ckpt-writer"]


# --------------------------- snapshot ---------------------------------------

def test_snapshot_owns_its_buffers():
    """CPU leaves are cloned (a later in-place change of the loop's tensor
    cannot reach a queued write), dtypes and the tree's shape kept, numpy
    and scalars passed through; two snapshots share nothing."""
    a = torch.arange(6, dtype=torch.float32)
    b = torch.ones(3, dtype=torch.bfloat16)
    tree = ({"a": a, "n": np.arange(2), "s": 3}, {"b": [b]})
    snap, ms = timed_snapshot(tree)
    again = snapshot(tree)
    a.add_(100.0)
    b.zero_()
    assert snap[0]["a"].tolist() == list(range(6)) and ms >= 0
    assert snap[1]["b"][0].dtype == torch.bfloat16
    assert snap[1]["b"][0].float().tolist() == [1.0] * 3
    assert snap[0]["n"] is tree[0]["n"] and snap[0]["s"] == 3
    assert snap[0]["a"].data_ptr() != again[0]["a"].data_ptr()
    assert tree_bytes(snap) == 6 * 4 + 3 * 2 + 2 * 8


# --------------------------- the writer -------------------------------------

def test_sync_oracle_runs_inline(tmp_path):
    events = []
    ck = AsyncCheckpointer(enabled=False, event_sink=_sink(events))
    p = str(tmp_path / "sync.safetensors")

    def write():
        save_safetensors(p, {"x": np.arange(4, dtype=np.float32)})
        return [p]

    ck.save(3, write, snapshot_ms=1.5)
    assert os.path.exists(p) and not _writer_threads()
    ck.close()
    (ev,) = events
    assert ev["event"] == "checkpoint" and ev["async"] is False
    assert ev["wall_s"] >= ev["write_ms"] / 1000.0
    assert ev["bytes"] == os.path.getsize(p) and ev["step"] == 3
    assert validate_event(dict(ev, seq=0, t=1.0)) is None


def test_async_write_lands_with_split_telemetry(tmp_path):
    events = []
    ck = AsyncCheckpointer(enabled=True, event_sink=_sink(events))
    p = str(tmp_path / "async.safetensors")
    ck.save(7, lambda: (save_safetensors(
        p, {"x": np.ones(8, np.float32)}), [p])[1], snapshot_ms=2.0)
    ck.close()
    assert os.path.exists(p) and ck.written == 1
    (ev,) = events
    assert ev["event"] == "checkpoint" and ev["async"] is True
    assert ev["snapshot_ms"] == 2.0 and ev["wall_s"] == 0.002
    assert ev["write_ms"] > 0 and ev["bytes"] == os.path.getsize(p)
    assert validate_event(dict(ev, seq=0, t=1.0)) is None


def test_depth1_queue_coalesces_to_newest():
    events, written = [], []
    ck = AsyncCheckpointer(enabled=True, event_sink=_sink(events))
    gate = threading.Event()

    def slow_write(step):
        def write():
            gate.wait(30.0)
            written.append(step)
            return []
        return write

    ck.save(1, slow_write(1))
    deadline = time.time() + 10
    while ck._inflight is None and time.time() < deadline:
        time.sleep(0.005)
    ck.save(2, slow_write(2))           # pending
    ck.save(3, slow_write(3))           # replaces 2
    gate.set()
    ck.close()
    assert written == [1, 3] and ck.dropped == 1
    drops = [e for e in events if e["event"] == "ckpt_dropped"]
    assert drops == [{"event": "ckpt_dropped", "step": 2,
                      "superseded_by": 3}]
    assert validate_event(dict(drops[0], seq=0, t=1.0)) is None
    assert [e["step"] for e in events if e["event"] == "checkpoint"] == \
        [1, 3]
    assert not _writer_threads()


def test_write_errors_surface_and_close_stops_the_thread():
    ck = AsyncCheckpointer(enabled=True)

    def boom():
        raise IOError("disk full")

    ck.save(1, boom)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        ck.drain()
    ck.save(2, boom)
    with pytest.raises(RuntimeError):
        ck.close()
    assert ck._thread is None and not _writer_threads()


def test_drain_timeout_names_the_inflight_step():
    gate = threading.Event()
    ck = AsyncCheckpointer(enabled=True)
    ck.save(5, lambda: (gate.wait(30.0), [])[1])
    with pytest.raises(CheckpointDrainTimeout, match="step 5"):
        ck.drain(timeout=0.05)
    gate.set()
    ck.close()
    assert not _writer_threads()


def test_submit_without_checkpointer_writes_inline(tmp_path):
    p = str(tmp_path / "direct.safetensors")
    submit(None, 0, lambda: (save_safetensors(
        p, {"x": np.zeros(2, np.float32)}), [p])[1])
    assert os.path.exists(p)


_KILL_CHILD = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    from mobilefinetuner_tpu_torch.io.async_ckpt import AsyncCheckpointer
    from mobilefinetuner_tpu_torch.io.safetensors_io import save_safetensors

    path = sys.argv[1]
    fsync = os.fsync

    def stalled(fd):          # the tmp bytes are written; stall before
        fsync(fd)             # the rename that would publish them
        print("TMP_DONE", flush=True)
        time.sleep(60)

    os.fsync = stalled
    ck = AsyncCheckpointer(enabled=True)
    ck.save(9, lambda: (save_safetensors(
        path, {"x": np.full(1024, 2.0, np.float32)}), [path])[1])
    ck.drain()
""")


def test_sigkill_mid_write_leaves_previous_checkpoint_loadable(tmp_path):
    """A checkpoint v1 exists; the writer thread of another process is
    SIGKILLed while it overwrites it, after the tmp bytes and before the
    rename: v1 still loads byte for byte, and the next save publishes
    over the stale tmp."""
    p = str(tmp_path / "ckpt.safetensors")
    v1 = {"x": np.full(1024, 1.0, np.float32)}
    save_safetensors(p, v1)
    golden = open(p, "rb").read()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    child = subprocess.Popen([sys.executable, "-c", _KILL_CHILD, p],
                             stdout=subprocess.PIPE, env=env, text=True)
    try:
        assert child.stdout.readline().strip() == "TMP_DONE"
        os.kill(child.pid, signal.SIGKILL)
    finally:
        child.wait(timeout=60)
    assert open(p, "rb").read() == golden
    np.testing.assert_array_equal(SafeTensorsReader(p).load_all()["x"],
                                  v1["x"])
    assert any(f.startswith("ckpt.safetensors.tmp.")
               for f in os.listdir(tmp_path))
    save_safetensors(p, {"x": np.full(1024, 3.0, np.float32)})
    assert SafeTensorsReader(p).load_all()["x"][0] == 3.0


# --------------------------- the CLIs ---------------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_async")
    g2, gm, wiki = (str(root / n) for n in ("gpt2", "gemma", "wiki"))
    write_tiny_gpt2_dir(g2)
    write_tiny_gemma3_dir(gm)
    write_wikitext_dir(wiki)
    return {"gpt2": g2, "gemma": gm, "wiki": wiki}


def _cli_run(dirs, which, out_dir, *extra):
    """(main's rc, the files its final save wrote)."""
    common = ["--data_dir", dirs["wiki"], "--steps", "3",
              "--batch_size", "2", "--seq_len", "32", "--save_every", "2",
              "--device", "cpu", *extra]
    os.makedirs(out_dir, exist_ok=True)
    if which == "gpt2_lora":
        from mobilefinetuner_tpu_torch.cli.gpt2_lora_finetune import main
        out = os.path.join(out_dir, "a.safetensors")
        rc = main(["--pretrained_dir", dirs["gpt2"], "--lora_out", out,
                   *common])
    elif which == "gpt2_full":
        from mobilefinetuner_tpu_torch.cli.gpt2_full_finetune import main
        out = os.path.join(out_dir, "m.safetensors")
        rc = main(["--pretrained_dir", dirs["gpt2"], "--output_path", out,
                   *common])
    elif which == "gemma_lora":
        from mobilefinetuner_tpu_torch.cli.train_lora_gemma import main
        out = os.path.join(out_dir, "gemma_lora.safetensors")
        rc = main(["--model_dir", dirs["gemma"], "--output_dir", out_dir,
                   "--loss_chunks", "2", *common])
    else:
        from mobilefinetuner_tpu_torch.cli.gemma_full_finetune import main
        out = os.path.join(out_dir, "g.safetensors")
        rc = main(["--model_dir", dirs["gemma"], "--output_path", out,
                   "--loss_chunks", "2", *common])
    root, ext = os.path.splitext(out)
    return rc, [out, out + ".opt", f"{root}_step2{ext}",
                f"{root}_step2{ext}.opt"]


@pytest.mark.parametrize("which", ["gpt2_lora", "gpt2_full", "gemma_lora",
                                   "gemma_full"])
def test_sync_and_async_saves_are_byte_identical(dirs, tmp_path, which):
    """--async_save 1 against the synchronous oracle --async_save 0: the
    final and the periodic checkpoint, their .opt sidecars and lineage
    are the same bytes; the async run's checkpoint events split the
    snapshot from the write."""
    files, streams = {}, {}
    for mode in ("0", "1"):
        stream = str(tmp_path / f"{mode}.jsonl")
        rc, files[mode] = _cli_run(dirs, which, str(tmp_path / mode),
                                   "--async_save", mode,
                                   "--telemetry_out", stream)
        assert rc == 0
        streams[mode] = [json.loads(line) for line in open(stream)]
    for a, b in zip(files["0"], files["1"]):
        assert filecmp.cmp(a, b, shallow=False), a
    lineage = [json.load(open(f[0] + ".lineage.json"))
               for f in (files["0"], files["1"])]
    assert lineage[0] == lineage[1]
    for mode, is_async in (("0", False), ("1", True)):
        cks = [e for e in streams[mode] if e["event"] == "checkpoint"]
        assert [e["step"] for e in cks] == [2, 3]
        assert [e["final"] for e in cks] == [False, True]
        for e in cks:
            assert validate_event(e) is None
            assert e["async"] is is_async and e["bytes"] > 0
        if is_async:
            assert all(abs(e["wall_s"] - e["snapshot_ms"] / 1000.0) < 1e-4
                       for e in cks)
        assert streams[mode][-1]["event"] == "run_end"
    assert not _writer_threads()
