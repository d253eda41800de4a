"""WikiText-2 data: lines tokenized and joined with an EOS after each,
cut into fixed seq_len chunks, shuffled per epoch (port of
mobilefinetuner_tpu/data/wikitext2.py, the in-RAM mode; the streaming
window and pretokenized-binary modes come with a later slice, ROADMAP.md).

The batch sequence is the JAX package's, byte for byte: the same chunks
(stride, data_fraction, drop_last, the padded tail), the same per-epoch
order (`chunk_order`: numpy's default_rng(seed + epoch) shuffle), and the
same row filling (`fill_rows`). Batches are numpy:
{input_ids i32 [B,S], attention_mask f32 [B,S], labels i32 [B,S]},
pad labels -100.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Optional

import numpy as np

IGNORE_INDEX = -100

_SPLIT_FILENAMES = {
    "train": ("wiki.train.tokens", "wiki.train.raw", "train.txt"),
    "valid": ("wiki.valid.tokens", "wiki.valid.raw", "valid.txt",
              "validation.txt"),
    "test": ("wiki.test.tokens", "wiki.test.raw", "test.txt"),
}


def resolve_split_file(path: str, split: str) -> str:
    """`path` may be a file (used directly) or a wikitext dir."""
    if os.path.isfile(path):
        return path
    for name in _SPLIT_FILENAMES[split]:
        p = os.path.join(path, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {split} split under {path}")


@dataclasses.dataclass
class WT2Config:
    seq_len: int = 128
    batch_size: int = 4
    stride: Optional[int] = None  # None -> seq_len (no overlap)
    data_fraction: float = 1.0
    drop_last: bool = True
    shuffle: bool = True
    seed: int = 42
    streaming: bool = False       # not ported: raises


class WikiText2Dataset:
    def __init__(self, path: str, split: str, config: WT2Config,
                 encode_fn: Callable[[str], List[int]], eos_id: int,
                 pad_id: Optional[int] = None,
                 pretokenized_bin: Optional[str] = None):
        if config.streaming or pretokenized_bin is not None:
            raise NotImplementedError(
                "the streaming and pretokenized WikiText-2 modes are not "
                "ported yet (ROADMAP.md port item P2 leftovers: "
                "data/prefetch.py and the native BPE come with them)")
        self.config = config
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id
        self.encode_fn = encode_fn
        self._epoch = 0
        ids: List[int] = []
        with open(resolve_split_file(path, split), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                ids.extend(encode_fn(line))
                ids.append(eos_id)
        self._tokens = np.asarray(ids, dtype=np.int32)
        self._total_tokens = len(ids)
        if config.data_fraction < 1.0:
            self._total_tokens = max(
                int(self._total_tokens * config.data_fraction),
                config.seq_len + 1)
        stride = config.stride or config.seq_len
        if not 0 < stride <= config.seq_len:
            raise ValueError(f"stride {stride} outside (0, seq_len]")
        self._stride = stride
        n_full = max((self._total_tokens - config.seq_len) // stride + 1, 0)
        has_tail = (n_full == 0 or
                    (self._total_tokens - config.seq_len) % stride != 0)
        if config.drop_last or self._total_tokens < config.seq_len:
            self.num_chunks = n_full
        else:
            self.num_chunks = n_full + (1 if has_tail else 0)
        if self.num_chunks == 0 and self._total_tokens > 1:
            self.num_chunks = 1  # single short chunk, padded

    def chunk(self, idx: int):
        """(input_ids, attention_mask, labels) of one chunk, padded to
        seq_len; an overlapping prefix (stride < seq_len) is context only."""
        S = self.config.seq_len
        start = idx * self._stride
        end = min(start + S, self._total_tokens)
        toks = self._tokens[start:end]
        n = len(toks)
        input_ids = np.full(S, self.pad_id, dtype=np.int32)
        input_ids[:n] = toks
        mask = np.zeros(S, dtype=np.float32)
        mask[:n] = 1.0
        labels = np.full(S, IGNORE_INDEX, dtype=np.int32)
        labels[:n] = toks
        if idx > 0 and self._stride < S:
            labels[:S - self._stride] = IGNORE_INDEX
        return input_ids, mask, labels

    def num_batches(self) -> int:
        b = self.config.batch_size
        if self.config.drop_last:
            return self.num_chunks // b
        return (self.num_chunks + b - 1) // b

    def chunk_order(self, epoch: int) -> np.ndarray:
        """The epoch's chunk order: a seeded per-epoch shuffle."""
        order = np.arange(self.num_chunks)
        if self.config.shuffle:
            np.random.default_rng(self.config.seed + epoch).shuffle(order)
        return order

    def fill_rows(self, idxs, input_ids: np.ndarray, mask: np.ndarray,
                  labels: np.ndarray, row0: int = 0) -> None:
        """Write chunks `idxs` into rows [row0, row0 + len(idxs))."""
        for j, ci in enumerate(idxs):
            i_row, m_row, l_row = self.chunk(int(ci))
            input_ids[row0 + j] = i_row
            mask[row0 + j] = m_row
            labels[row0 + j] = l_row

    def epoch(self, epoch: Optional[int] = None,
              start_batch: int = 0) -> Iterator[dict]:
        """The batches of one epoch, from `start_batch` on."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = self.chunk_order(epoch)
        b, S = self.config.batch_size, self.config.seq_len
        for bi in range(start_batch, self.num_batches()):
            idxs = order[bi * b:(bi + 1) * b]
            n = len(idxs)
            batch = {"input_ids": np.empty((n, S), np.int32),
                     "attention_mask": np.empty((n, S), np.float32),
                     "labels": np.empty((n, S), np.int32)}
            self.fill_rows(idxs, batch["input_ids"],
                           batch["attention_mask"], batch["labels"])
            yield batch
