"""GPT-2 byte-level BPE tokenizer (port of mobilefinetuner_tpu/data/
tokenizer_bpe.py, its pure-Python path; the native C++ merge engine comes
with a later slice, ROADMAP.md).

vocab.json / merges.txt loading, the reversible byte<->unicode table,
eos = bos = pad = unk = <|endoftext|>, special tokens matched verbatim
before BPE. The GPT-2 pre-tokenization pattern

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|
    \\s+(?!\\S)|\\s+

is matched by a small scanner over Unicode categories (letters L*,
numbers N*) instead of the third-party `regex` module, so the port needs
nothing beyond the standard library here; tests/test_torch_data.py holds
its ids equal to the JAX tokenizer's.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Tuple

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte <-> unicode-char table: printable bytes map to
    themselves, the rest to U+0100 + n."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "O"


def pretokenize(text: str) -> List[str]:
    """The GPT-2 pattern's matches, left to right (module docstring)."""
    out: List[str] = []
    n, i = len(text), 0
    kinds = [_kind(c) for c in text]
    while i < n:
        if text[i] == "'":
            c = next((c for c in _CONTRACTIONS
                      if text.startswith(c, i + 1)), None)
            if c is not None:
                out.append(text[i:i + 1 + len(c)])
                i += 1 + len(c)
                continue
        # ' ?X+' for X in letters, numbers, other: an optional leading
        # space, then a run of one kind
        j = i + 1 if text[i] == " " and i + 1 < n \
            and kinds[i + 1] != "S" else i
        if kinds[j] != "S":
            k = j + 1
            while k < n and kinds[k] == kinds[j]:
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # whitespace: '\s+(?!\S)' leaves the last space of a run that is
        # followed by a non-space to the next token; '\s+' otherwise
        k = i + 1
        while k < n and kinds[k] == "S":
            k += 1
        if k < n and k - 1 > i:
            k -= 1
        out.append(text[i:k])
        i = k
    return out


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPETokenizer:
    """Byte-level BPE with merge ranks."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.eos_token = eos_token
        self.eos_id = self.encoder.get(eos_token, len(vocab) - 1)
        self.bos_id = self.pad_id = self.unk_id = self.eos_id
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "GPT2BPETokenizer":
        with open(os.path.join(model_dir, "vocab.json"),
                  encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(model_dir, "merges.txt"),
                  encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        eos = "<|endoftext|>"
        stm = os.path.join(model_dir, "special_tokens_map.json")
        if os.path.exists(stm):
            with open(stm, encoding="utf-8") as f:
                e = json.load(f).get("eos_token", eos)
            eos = e["content"] if isinstance(e, dict) else e
        return cls(vocab, merges, eos)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(a, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                if j < len(word) - 1 and word[j + 1] == b:
                    new_word.append(a + b)
                    i = j + 2
                else:
                    new_word.append(word[j])
                    i = j + 1
            word = tuple(new_word)
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in text.split(self.eos_token):
            for piece in pretokenize(part):
                mapped = "".join(self.byte_encoder[b]
                                 for b in piece.encode("utf-8"))
                ids.extend(self.encoder.get(sub, self.unk_id)
                           for sub in self._bpe(mapped))
            ids.append(self.eos_id)
        ids.pop()  # one eos per separator, not per part
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace")
