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
