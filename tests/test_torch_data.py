"""Port data path against the JAX package's: the GPT-2 BPE tokenizer
(data/tokenizer_bpe.py) gives the same ids on the tiny fixture vocab,
and the WikiText-2 step-batch stream (data/wikitext2.py +
cli/common.micro_batches) is byte-identical, resumed or not, in each of
the three modes (in-RAM, pretokenized, streaming); `pretokenize` writes
the same files; the streaming refetch retries transient I/O errors."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from fixtures import (WIKI_LINES, train_tiny_gpt2_tokenizer,  # noqa: E402
                      write_wikitext_dir)

from mobilefinetuner_tpu.cli import common as jax_common  # noqa: E402
from mobilefinetuner_tpu.data import tokenizer_bpe as jax_tok  # noqa: E402
from mobilefinetuner_tpu.data import wikitext2 as jax_wt2  # noqa: E402
from mobilefinetuner_tpu_torch.cli import common  # noqa: E402
from mobilefinetuner_tpu_torch.data import tokenizer_bpe, wikitext2  # noqa

TEXTS = WIKI_LINES[:6] + [
    "It's they're we've I'm you'll he'd 'S don't",
    "  leading  and   trailing spaces   ",
    "tabs\tand\nnewlines\n\n  then text",
    "café naïve Ünïcödé — “quotes” ½ ³ 𝟘 ٣ 漢字 カタカナ",
    "numbers 1234567 3.14159 and $5,000.00!!! ???",
    "mixed123abc ABC123 a1b2c3 <|endoftext|> after eos",
    "emoji 😀👍🏽 and symbols @#%^&*()_+-=[]{}|;':\",./<>?",
    "",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    train_tiny_gpt2_tokenizer(str(d))
    return str(d)


def test_tokenizer_ids_equal_jax(vocab_dir):
    """The port's pure-Python tokenizer (its own pre-tokenizer scanner)
    against the JAX package's Python path and its native merge engine."""
    port = tokenizer_bpe.GPT2BPETokenizer.from_pretrained(vocab_dir)
    ref = jax_tok.GPT2BPETokenizer.from_pretrained(vocab_dir,
                                                   use_native=False)
    fast = jax_tok.GPT2BPETokenizer.from_pretrained(vocab_dir)
    assert port.vocab_size == ref.vocab_size and port.eos_id == ref.eos_id
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == ref.encode(text) == fast.encode(text), text
        assert port.decode(ids) == ref.decode(ids)
    for text in TEXTS:
        assert tokenizer_bpe.pretokenize(text) == jax_tok._PAT.findall(text)


def _datasets(wiki, vocab_dir, **cfg):
    tok = tokenizer_bpe.GPT2BPETokenizer.from_pretrained(vocab_dir)
    port = wikitext2.WikiText2Dataset(wiki, "train",
                                      wikitext2.WT2Config(**cfg),
                                      tok.encode, tok.eos_id)
    ref = jax_wt2.WikiText2Dataset(wiki, "train", jax_wt2.WT2Config(**cfg),
                                   tok.encode, tok.eos_id)
    return port, ref


@pytest.mark.parametrize("cfg", [
    dict(seq_len=32, batch_size=3, seed=7),
    dict(seq_len=24, batch_size=2, stride=16, drop_last=False,
         data_fraction=0.5, seed=1)])
def test_micro_batch_stream_byte_identical(tmp_path, vocab_dir, cfg):
    """Six steps of micro_batches (accumulation 2, crossing an epoch
    boundary), then a resume with skip_steps=4: the same bytes as the
    JAX package's stream, and the resumed stream equals the tail of the
    uninterrupted one."""
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    port, ref = _datasets(wiki, vocab_dir, **cfg)
    assert port.num_chunks == ref.num_chunks
    assert np.array_equal(port.chunk_order(3), ref.chunk_order(3))
    steps = max(6, 2 * port.num_batches() // 2 + 2)
    a = common.micro_batches(port, 2)
    b = jax_common.micro_batches(ref, 2)
    stream = []
    for _ in range(steps):
        (ea, ba), (eb, bb) = next(a), next(b)
        assert ea == eb and ba.keys() == bb.keys()
        for k in ba:
            assert ba[k].dtype == bb[k].dtype
            assert ba[k].tobytes() == bb[k].tobytes(), k
        stream.append(ba)
    resumed = common.micro_batches(port, 2, skip_steps=4)
    jax_resumed = jax_common.micro_batches(ref, 2, skip_steps=4)
    for want in stream[4:]:
        got, jgot = next(resumed)[1], next(jax_resumed)[1]
        for k in want:
            assert got[k].tobytes() == want[k].tobytes() \
                == jgot[k].tobytes()
    # the eval stream (no shuffle) too
    ev = list(port.epoch(0))
    jev = list(ref.epoch(0))
    assert len(ev) == len(jev)
    for x, y in zip(ev, jev):
        assert all(x[k].tobytes() == y[k].tobytes() for k in x)


def _streams_equal(port, ref, accum=2, steps=None, skip=3):
    """micro_batches of both datasets: the same bytes over `steps` steps
    (default: past one epoch), and after a resume with skip_steps."""
    steps = steps or (port.num_batches() // accum + 3)
    a, b = common.micro_batches(port, accum), \
        jax_common.micro_batches(ref, accum)
    stream = []
    for _ in range(steps):
        (ea, ba), (eb, bb) = next(a), next(b)
        assert ea == eb
        for k in ba:
            assert ba[k].dtype == bb[k].dtype
            assert ba[k].tobytes() == bb[k].tobytes(), k
        stream.append(ba)
    resumed = common.micro_batches(port, accum, skip_steps=skip)
    for want in stream[skip:]:
        got = next(resumed)[1]
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    return stream


@pytest.mark.parametrize("cfg", [
    dict(seq_len=32, batch_size=3, seed=7),
    dict(seq_len=24, batch_size=2, stride=16, drop_last=False,
         data_fraction=0.5, seed=1)])
def test_pretokenized_mode_byte_identical(tmp_path, vocab_dir, cfg):
    """pretokenize writes the JAX package's .bin and meta bytes; both
    datasets over it give the same step batches (resumed too) as each
    other and, chunk for chunk, as the in-RAM mode; a .bin without its
    own meta finds meta.json beside it."""
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    tok = tokenizer_bpe.GPT2BPETokenizer.from_pretrained(vocab_dir)
    src = wikitext2.resolve_split_file(wiki, "train")
    n = wikitext2.pretokenize(src, tok.encode, tok.eos_id,
                              str(tmp_path / "p.bin"))
    jn = jax_wt2.pretokenize(src, tok.encode, tok.eos_id,
                             str(tmp_path / "j.bin"))
    assert n == jn > 0
    for ext in (".bin", ".bin.meta.json"):
        with open(str(tmp_path / ("p" + ext)), "rb") as fa, \
                open(str(tmp_path / ("j" + ext)), "rb") as fb:
            assert fa.read() == fb.read(), ext
    port = wikitext2.WikiText2Dataset(
        wiki, "train", wikitext2.WT2Config(**cfg), tok.encode, tok.eos_id,
        pretokenized_bin=str(tmp_path / "p.bin"))
    ref = jax_wt2.WikiText2Dataset(
        wiki, "train", jax_wt2.WT2Config(**cfg), tok.encode, tok.eos_id,
        pretokenized_bin=str(tmp_path / "j.bin"))
    ram = wikitext2.WikiText2Dataset(wiki, "train",
                                     wikitext2.WT2Config(**cfg),
                                     tok.encode, tok.eos_id)
    assert port.num_chunks == ref.num_chunks == ram.num_chunks
    assert port.total_valid_tokens() == ref.total_valid_tokens()
    for i in range(port.num_chunks):
        assert all(x.tobytes() == y.tobytes()
                   for x, y in zip(port.chunk(i), ram.chunk(i)))
    _streams_equal(port, ref)
    # meta.json beside the .bin
    d = tmp_path / "only"
    d.mkdir()
    os.replace(str(tmp_path / "p.bin"), str(d / "train.bin"))
    os.replace(str(tmp_path / "p.bin.meta.json"), str(d / "meta.json"))
    side = wikitext2.WikiText2Dataset(
        "", "train", wikitext2.WT2Config(**cfg), tok.encode, tok.eos_id,
        pretokenized_bin=str(d / "train.bin"))
    assert side.num_chunks == port.num_chunks


@pytest.mark.parametrize("cfg", [
    dict(seq_len=32, batch_size=3, seed=7, window_tokens=100),
    dict(seq_len=24, batch_size=2, stride=16, drop_last=False,
         data_fraction=0.5, seed=1, window_tokens=40),
    dict(seq_len=16, batch_size=4, seed=3, shuffle=False,
         window_tokens=1000)])
def test_streaming_mode_byte_identical(tmp_path, vocab_dir, cfg):
    """The streaming dataset (prescan + a re-tokenized resident window,
    the window-local shuffle) against the JAX one: the same chunk order
    and step batches (resumed too), every chunk equal to the in-RAM
    mode's, and the eval stream equal."""
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    port, ref = _datasets(wiki, vocab_dir, streaming=True, **cfg)
    ram_cfg = {k: v for k, v in cfg.items() if k != "window_tokens"}
    ram, _ = _datasets(wiki, vocab_dir, **ram_cfg)
    assert port.num_chunks == ref.num_chunks == ram.num_chunks
    for e in (0, 1, 4):
        assert np.array_equal(port.chunk_order(e), ref.chunk_order(e))
    for i in range(port.num_chunks):
        assert all(x.tobytes() == y.tobytes()
                   for x, y in zip(port.chunk(i), ram.chunk(i)))
    _streams_equal(port, ref)
    for x, y in zip(port.epoch(0), ref.epoch(0)):
        assert all(x[k].tobytes() == y[k].tobytes() for k in x)


class _Flaky(wikitext2.WikiText2Dataset):
    """Opens of the source file fail `fails` times after the prescan."""

    def __init__(self, *a, fails=0, **kw):
        self.fails, self.armed = fails, False
        super().__init__(*a, **kw)
        self.armed = True

    def _open_text(self, path):
        if self.armed and self.fails > 0:
            self.fails -= 1
            raise OSError(116, "Stale file handle")
        return super()._open_text(path)


def test_streaming_retries_transient_errors(tmp_path, vocab_dir):
    """A window refetch survives `retries` transient OSErrors, reporting
    each to event_sink, and returns the chunk unchanged; past the budget
    the first error raises."""
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    tok = tokenizer_bpe.GPT2BPETokenizer.from_pretrained(vocab_dir)
    cfg = dict(seq_len=32, batch_size=2, streaming=True, window_tokens=40,
               retry_backoff_s=0.0)
    clean, _ = _datasets(wiki, vocab_dir, **cfg)
    events = []
    ds = _Flaky(wiki, "train", wikitext2.WT2Config(retries=2, **cfg),
                tok.encode, tok.eos_id, fails=2)
    ds.event_sink = lambda **f: events.append(f)
    last = ds.num_chunks - 1
    assert all(x.tobytes() == y.tobytes()
               for x, y in zip(ds.chunk(last), clean.chunk(last)))
    assert [e["attempt"] for e in events] == [1, 2]
    assert events[0]["kind"] == "data_retry" and "Stale" in \
        events[0]["error"]
    ds = _Flaky(wiki, "train", wikitext2.WT2Config(retries=1, **cfg),
                tok.encode, tok.eos_id, fails=5)
    with pytest.raises(OSError, match="Stale"):
        ds.chunk(last)


def test_unported_modes_raise(tmp_path, vocab_dir):
    """Every mode is ported now; what still raises is what both packages
    refuse: a stride outside (0, seq_len] and a .bin with no meta."""
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    for mod in (wikitext2, jax_wt2):
        with pytest.raises((ValueError, AssertionError)):
            mod.WikiText2Dataset(wiki, "train",
                                 mod.WT2Config(seq_len=8, stride=9),
                                 lambda s: [1], 0)
        (tmp_path / "x.bin").write_bytes(b"\0" * 8)
        with pytest.raises(FileNotFoundError):
            mod.WikiText2Dataset(wiki, "train", mod.WT2Config(),
                                 lambda s: [1], 0,
                                 pretokenized_bin=str(tmp_path / "x.bin"))
    ds = wikitext2.WikiText2Dataset(wiki, "train",
                                    wikitext2.WT2Config(streaming=True),
                                    lambda s: [1], 0)
    assert ds.num_chunks > 0
