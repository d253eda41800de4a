"""Port data path against the JAX package's: the GPT-2 BPE tokenizer
(data/tokenizer_bpe.py) gives the same ids on the tiny fixture vocab,
and the WikiText-2 step-batch stream (data/wikitext2.py +
cli/common.micro_batches) is byte-identical, resumed or not."""

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


def test_unported_modes_raise(tmp_path, vocab_dir):
    wiki = write_wikitext_dir(str(tmp_path / "wiki"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wikitext2.WikiText2Dataset(wiki, "train",
                                   wikitext2.WT2Config(streaming=True),
                                   lambda s: [1], 0)
