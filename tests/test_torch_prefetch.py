"""The port's input pipeline (mobilefinetuner_tpu_torch/data/prefetch.py)
with the cases of tests/test_prefetch.py: the prefetched stream equals
the synchronous one batch for batch (across epoch boundaries, on a
skip_steps resume, with placement), the queue stays bounded, a producer
exception surfaces after the batches before it, close() and a consumer
exception leave no producer thread; plus the RSS shed guard, and the
JAX package's Prefetcher over the same source gives the same stream."""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from mobilefinetuner_tpu.data.prefetch import Prefetcher as JaxPrefetcher
from mobilefinetuner_tpu_torch.cli.common import micro_batches, place_batch
from mobilefinetuner_tpu_torch.data.prefetch import Prefetcher
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)

EOS = 999


def _encode(line: str):
    return [int(w[1:]) % 900 for w in line.split()]


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("wt2pf_torch")
    path = str(d / "wiki.train.tokens")
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for _ in range(120):
            n = int(rng.integers(3, 30))
            f.write(" ".join(f"w{rng.integers(0, 500)}"
                             for _ in range(n)) + "\n")
    return path


def _mk(path, **kw):
    cfg = WT2Config(**{"seq_len": 32, "batch_size": 2, "seed": 7, **kw})
    return WikiText2Dataset(path, "train", cfg, _encode, eos_id=EOS)


def _producer_threads():
    return [t for t in threading.enumerate() if t.name == "batch-producer"]


def _wait_no_producer():
    deadline = time.time() + 5
    while _producer_threads() and time.time() < deadline:
        time.sleep(0.01)
    return not _producer_threads()


def _take(ds_factory, n, accum=2, skip_steps=0, depth=0, cls=Prefetcher):
    src = micro_batches(ds_factory(), accum, skip_steps=skip_steps)
    with cls(itertools.islice(src, n), depth=depth) as stream:
        return list(stream)


def _assert_same_stream(a, b):
    assert len(a) == len(b)
    for (ep_a, ba), (ep_b, bb) in zip(a, b):
        assert ep_a == ep_b
        assert set(ba) == set(bb)
        for k in ba:
            np.testing.assert_array_equal(np.asarray(ba[k]),
                                          np.asarray(bb[k]))


def test_same_stream_across_epoch_boundaries(corpus_file):
    mk = lambda: _mk(corpus_file)  # noqa: E731
    n = 2 * mk().num_batches() + 3
    sync = _take(mk, n, depth=0)
    pref = _take(mk, n, depth=3)
    _assert_same_stream(sync, pref)
    assert sync[-1][0] >= 2
    # and the JAX package's pipeline over the same source
    _assert_same_stream(pref, _take(mk, n, depth=3, cls=JaxPrefetcher))


def test_same_stream_on_skip_steps_resume(corpus_file):
    mk = lambda: _mk(corpus_file)  # noqa: E731
    skip = mk().num_batches() + 1
    full = _take(mk, skip + 4, depth=2)
    resumed = _take(mk, 4, skip_steps=skip, depth=2)
    _assert_same_stream(full[skip:], resumed)
    _assert_same_stream(_take(mk, 4, skip_steps=skip, depth=0), resumed)


def test_placement_lookahead_places_in_order(corpus_file):
    """place_fn runs in order, `lookahead` items ahead: the placed
    tensors carry the synchronous batches' values."""
    placed_order = []

    def place(item):
        placed_order.append(int(item["input_ids"][0, 0]))
        return place_batch(item, torch.device("cpu"))

    src = (b for _, b in micro_batches(_mk(corpus_file), 1))
    with Prefetcher(itertools.islice(src, 6), depth=2,
                    place_fn=place) as stream:
        first = next(stream)
        assert len(placed_order) == 2          # item 0 and the lookahead
        placed = [first] + list(stream)
    sync = [b for _, b in itertools.islice(
        micro_batches(_mk(corpus_file), 1), 6)]
    assert placed_order == [int(b["input_ids"][0, 0]) for b in sync]
    for p, s in zip(placed, sync):
        assert p["input_ids"].dtype == torch.int64
        np.testing.assert_array_equal(p["input_ids"].numpy(),
                                      s["input_ids"])


def test_bounded_queue_depth():
    produced = [0]

    def counting_source():
        for i in range(1000):
            produced[0] += 1
            yield i

    depth, lookahead = 3, 1
    with Prefetcher(counting_source(), depth=depth,
                    lookahead=lookahead) as stream:
        got = [next(stream) for _ in range(5)]
        time.sleep(0.3)
        assert got == list(range(5))
        assert produced[0] <= 5 + depth + lookahead + 2, produced[0]


def test_order_is_strict_and_complete():
    with Prefetcher(iter(range(257)), depth=2) as stream:
        assert list(stream) == list(range(257))


def test_kill_switch_is_threadless():
    before = len(_producer_threads())
    with Prefetcher(iter(range(10)), depth=0) as stream:
        assert len(_producer_threads()) == before
        assert list(stream) == list(range(10))
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=-1)


def test_consumer_exception_propagates_and_no_leaked_threads():
    with pytest.raises(RuntimeError, match="consumer died"):
        with Prefetcher(itertools.count(), depth=2) as stream:
            next(stream)
            next(stream)
            raise RuntimeError("consumer died")
    assert _wait_no_producer(), "producer thread leaked"


@pytest.mark.parametrize("depth", [0, 2])
def test_producer_exception_surfaces_after_prior_items(depth):
    def bad_source():
        yield from range(4)
        raise ValueError("tokenizer exploded")

    stream = Prefetcher(bad_source(), depth=depth)
    assert [next(stream) for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="tokenizer exploded"):
        next(stream)
    assert _wait_no_producer()
    with pytest.raises(StopIteration):
        next(stream)


def test_close_unblocks_full_queue_producer():
    stream = Prefetcher(itertools.count(), depth=1)
    next(stream)
    time.sleep(0.05)
    stream.close()
    assert _wait_no_producer()
    with pytest.raises(StopIteration):
        next(stream)


def test_rss_guard_holds_the_producer_and_never_starves():
    """Over the limit the producer waits while batches are queued, and
    resumes when the queue is empty: every item still arrives, in order;
    an unreadable sensor turns the guard off."""
    rss = {"mb": 10_000.0}
    with Prefetcher(iter(range(20)), depth=4, rss_limit_mb=100,
                    rss_fn=lambda: rss["mb"]) as stream:
        got = [next(stream) for _ in range(3)]
        time.sleep(0.2)
        assert stream.rss_sheds > 0
        rss["mb"] = 10.0
        got += list(stream)
    assert got == list(range(20))
    with Prefetcher(iter(range(5)), depth=2, rss_limit_mb=100,
                    rss_fn=lambda: None) as stream:
        assert list(stream) == list(range(5))
        assert stream.rss_sheds == 0


# ------------------------------------------- the train loop's pipeline ------

def _cli_losses(out):
    import csv
    import os
    with open(os.path.join(out, "m.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    return [r["loss"] for r in rows], [float(r["host_wait_ms"])
                                       for r in rows]


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """Tiny GPT-2 with dropout 0.1 at every model site, tiny Gemma-3 and
    the corpus, plus the corpus's Gemma train split pretokenized."""
    import json
    import os
    import shutil
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from fixtures import (write_tiny_gemma3_dir, write_tiny_gpt2_dir,
                          write_wikitext_dir)

    from mobilefinetuner_tpu_torch.data.tokenizer_gemma import \
        GemmaTokenizer
    from mobilefinetuner_tpu_torch.data.wikitext2 import (pretokenize,
                                                          resolve_split_file)
    root = tmp_path_factory.mktemp("pf_cli")
    g2, gm, wiki = (str(root / n) for n in ("gpt2", "gemma", "wiki"))
    write_tiny_gpt2_dir(g2)
    write_tiny_gemma3_dir(gm)
    write_wikitext_dir(wiki)
    drop = str(root / "gpt2_drop")
    shutil.copytree(g2, drop)
    with open(os.path.join(drop, "config.json")) as f:
        raw = json.load(f)
    raw.update(embd_pdrop=0.1, resid_pdrop=0.1, attn_pdrop=0.1)
    with open(os.path.join(drop, "config.json"), "w") as f:
        json.dump(raw, f)
    tok = GemmaTokenizer.from_pretrained(gm)
    bin_path = str(root / "train.bin")
    pretokenize(resolve_split_file(wiki, "train"),
                lambda s: tok.encode(s, add_bos=False), tok.eos_id, bin_path)
    return {"gpt2_drop": drop, "gemma": gm, "wiki": wiki, "bin": bin_path,
            "root": root}


@pytest.mark.parametrize("depth", ["2", "3"])
def test_run_training_same_losses_with_and_without_prefetch(cli_dirs,
                                                            depth):
    """cli.gpt2_full_finetune with the model's dropout on (the per-step
    seeds are formed in the placement lookahead), accumulation 2, an eval
    and a step save mid-run: --prefetch 0 and --prefetch N give the same
    loss column, eval records and model file, byte for byte; the RSS
    guard (--prefetch_rss_mb 1, always over) holds the producer without
    starving the loop."""
    import os

    from mobilefinetuner_tpu_torch.cli import gpt2_full_finetune as full
    outs = {}
    for name, extra in (("sync", ["--prefetch", "0"]),
                        ("async", ["--prefetch", depth]),
                        ("rss", ["--prefetch", depth,
                                 "--prefetch_rss_mb", "1"])):
        out = str(cli_dirs["root"] / f"full_{depth}_{name}")
        assert full.main([
            "--pretrained_dir", cli_dirs["gpt2_drop"],
            "--data_dir", cli_dirs["wiki"], "--steps", "5",
            "--batch_size", "2", "--grad_accum_steps", "2",
            "--seq_len", "32", "--dtype", "float32", "--lr", "1e-3",
            "--eval_interval", "2", "--eval_batches", "2",
            "--save_every", "3", "--device", "cpu",
            "--output_path", os.path.join(out, "m.safetensors"),
            "--eval_out", os.path.join(out, "e.jsonl"),
            "--metrics_csv", os.path.join(out, "m.csv"), *extra]) == 0
        outs[name] = out
    losses = {k: _cli_losses(v)[0] for k, v in outs.items()}
    assert len(losses["sync"]) == 5
    assert losses["sync"] == losses["async"] == losses["rss"]
    for f in ("m.safetensors", "m_step3.safetensors", "m.safetensors.opt"):
        blobs = [open(os.path.join(o, f), "rb").read()
                 for o in outs.values()]
        assert blobs[0] == blobs[1] == blobs[2], f
    evals = [[{k: v for k, v in r.items() if k != "time"} for r in
              map(__import__("json").loads, open(os.path.join(o, "e.jsonl")))]
             for o in outs.values()]
    assert evals[0] == evals[1] == evals[2] and len(evals[0]) == 3
    assert not _producer_threads() or _wait_no_producer()


def test_pretokenized_gemma_cli_matches_jax_with_prefetch(cli_dirs):
    """cli.train_lora_gemma on --pretokenized_path, each run resumed from
    one adapter the JAX package saved (B off zero, no .opt): the port
    with --prefetch 2 and 0 and the JAX CLI take the same losses (the
    port's two identical, the JAX one within 1e-4), and the same losses
    as the text split they were tokenized from."""
    import os

    import jax

    from mobilefinetuner_tpu.cli import train_lora_gemma as jax_lora
    from mobilefinetuner_tpu.core.config import Gemma3TextConfig
    from mobilefinetuner_tpu.lora import lora as jlora
    from mobilefinetuner_tpu.lora import peft_io as jax_peft_io
    from mobilefinetuner_tpu_torch.cli import train_lora_gemma as lora
    cfg = Gemma3TextConfig.from_pretrained(cli_dirs["gemma"])
    spec = jlora.LoRASpec(rank=4, alpha=8.0, init="peft",
                          targets=["q_proj", "v_proj"])
    tree = jax.tree.map(np.asarray, jlora.init_lora_gemma3(
        cfg, spec, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(5)
    for e in tree["blocks"].values():
        e["B"] = (rng.normal(size=e["B"].shape) * 0.05).astype(np.float32)
    src = str(cli_dirs["root"] / "gemma_src.safetensors")
    jax_peft_io.save_adapter(src, tree, spec)
    base = ["--model_dir", cli_dirs["gemma"], "--data_dir",
            cli_dirs["wiki"], "--steps", "3", "--batch_size", "2",
            "--seq_len", "40", "--dtype", "float32", "--lr", "1e-3",
            "--resume_from", src]
    runs = {}
    for name, main, extra in (
            ("jax", jax_lora.main, ["--prefetch", "0", "--async_save", "0",
                                    "--pretokenized_path", cli_dirs["bin"],
                                    "--pretokenized_meta", "unused"]),
            ("sync", lora.main, ["--device", "cpu", "--prefetch", "0",
                                 "--pretokenized_path", cli_dirs["bin"]]),
            ("async", lora.main, ["--device", "cpu",
                                  "--pretokenized_path", cli_dirs["bin"],
                                  "--pretokenized_meta", "unused"]),
            ("text", lora.main, ["--device", "cpu"])):
        out = str(cli_dirs["root"] / f"gemma_{name}")
        assert main(base + ["--output_dir", out, "--metrics_csv",
                            os.path.join(out, "m.csv"), *extra]) == 0
        runs[name] = _cli_losses(out)[0]
    assert runs["sync"] == runs["async"] == runs["text"]
    np.testing.assert_allclose([float(x) for x in runs["async"]],
                               [float(x) for x in runs["jax"]],
                               atol=1e-4, rtol=0)
