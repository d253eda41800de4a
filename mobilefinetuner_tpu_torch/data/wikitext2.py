"""WikiText-2 data: lines tokenized and joined with an EOS after each,
cut into fixed seq_len chunks, shuffled per epoch (port of
mobilefinetuner_tpu/data/wikitext2.py, its three modes):

  in-RAM        the split tokenized at construction;
  streaming     (`WT2Config.streaming`) a prescan keeps each line's
                cumulative token offset and file position, and a bounded
                window of tokens (`window_tokens`) is re-tokenized on
                demand; its chunk order shuffles blocks of window-resident
                chunks, so nearly every chunk hits the resident window. A
                window read retries transient I/O errors
                (`retries`, `retry_backoff_s`: --data_retries,
                --data_backoff_s) with exponential backoff and jitter,
                reporting each survived retry to `event_sink`;
  pretokenized  (`pretokenized_bin`) a np.memmap over a .bin of token ids
                with `<bin>.meta.json` (or `meta.json` beside it), as
                `pretokenize` writes them.

The batch sequence is the JAX package's, byte for byte, in every mode:
the same chunks (stride, data_fraction, drop_last, the padded tail), the
same per-epoch order (`chunk_order`: numpy's default_rng(seed + epoch)),
and the same row filling (`fill_rows`). Batches are numpy:
{input_ids i32 [B,S], attention_mask f32 [B,S], labels i32 [B,S]},
pad labels -100.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import random
import time
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
    streaming: bool = False
    window_tokens: int = 100_000  # streaming-mode resident window
    # the streaming refetch's retry budget on transient I/O errors
    # (--data_retries / --data_backoff_s); 0 = fail fast
    retries: int = 0
    retry_backoff_s: float = 0.5


class WikiText2Dataset:
    def __init__(self, path: str, split: str, config: WT2Config,
                 encode_fn: Callable[[str], List[int]], eos_id: int,
                 pad_id: Optional[int] = None,
                 pretokenized_bin: Optional[str] = None):
        self.config = config
        self.eos_id = eos_id
        self.pad_id = eos_id if pad_id is None else pad_id
        self.encode_fn = encode_fn
        self._tokens: Optional[np.ndarray] = None
        self._epoch = 0
        # called with each survived retry's report (kind, attempt, error,
        # what, backoff_s), from whatever thread runs the fetch (the
        # prefetch producer); its exceptions are swallowed
        self.event_sink: Optional[Callable[..., None]] = None

        if pretokenized_bin is not None:
            meta_path = pretokenized_bin + ".meta.json"
            if not os.path.exists(meta_path):
                meta_path = os.path.join(
                    os.path.dirname(pretokenized_bin), "meta.json")
            with open(meta_path) as f:
                meta = json.load(f)
            dtype = np.dtype(meta.get("dtype", "int32"))
            self._tokens = np.memmap(pretokenized_bin, dtype=dtype,
                                     mode="r")
            total = int(meta.get("count", len(self._tokens)))
            self._total_tokens = min(total, len(self._tokens))
        else:
            file = resolve_split_file(path, split)
            self._file = file
            if config.streaming:
                self._prescan(file)
            else:
                ids: List[int] = []
                with open(file, encoding="utf-8") as f:
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

    # -- streaming machinery -------------------------------------------------

    def _prescan(self, file: str):
        """Token-offset prescan: cumulative token count per line, without
        keeping tokens."""
        offsets = [0]
        lines_pos: List[int] = []
        with self._open_text(file) as f:
            pos = f.tell()
            for line in iter(f.readline, ""):
                stripped = line.rstrip("\n")
                if stripped.strip():
                    lines_pos.append(pos)
                    n = len(self.encode_fn(stripped)) + 1  # +1 for EOS
                    offsets.append(offsets[-1] + n)
                pos = f.tell()
        self._line_offsets = offsets  # len = n_lines + 1
        self._line_pos = lines_pos
        self._total_tokens = offsets[-1]
        self._win_start = 0
        self._win_tokens = np.empty(0, dtype=np.int32)

    def _open_text(self, path: str):
        """Source-file open, factored so tests can inject transient I/O
        faults (and so an alternative storage layer can interpose)."""
        return open(path, encoding="utf-8")

    def _io_retry(self, fn, what: str):
        """Run `fn` under the bounded-retry policy (`config.retries`,
        exponential backoff with jitter): a transient I/O error on the
        streaming refetch path — a shared-filesystem stall under a
        whole fleet rereading the same corpus — costs a backoff and a
        report to `event_sink` instead of killing the run.
        The jitter desynchronizes a fleet whose hosts all hit the same
        hiccup at once. After the budget, the ORIGINAL error raises."""
        cfg = self.config
        first_err: Optional[OSError] = None
        for attempt in range(max(cfg.retries, 0) + 1):
            try:
                return fn()
            except OSError as e:
                # keep the FIRST error: it names the root cause (an
                # ESTALE), while later attempts often fail with
                # follow-on noise (the mount is simply gone)
                first_err = first_err or e
                if attempt >= max(cfg.retries, 0):
                    raise first_err
                delay = cfg.retry_backoff_s * (2 ** attempt)
                delay *= 1.0 + 0.25 * random.random()
                if self.event_sink is not None:
                    try:
                        self.event_sink(
                            kind="data_retry", attempt=attempt + 1,
                            error=f"{type(e).__name__}: {e}", what=what,
                            backoff_s=round(delay, 3))
                    except Exception:
                        pass  # telemetry must never break the pipeline
                time.sleep(delay)

    def _window_fetch(self, start: int, end: int) -> np.ndarray:
        """Return tokens[start:end] by re-tokenizing the covering lines,
        keeping a bounded resident window. The refetch I/O retries
        transient errors under `_io_retry` (each attempt restarts the
        window read from scratch — partial token lists never leak into
        the resident window)."""
        ws, we = self._win_start, self._win_start + len(self._win_tokens)
        if start >= ws and end <= we:
            return self._win_tokens[start - ws:end - ws]
        # recompute a window beginning at the line containing `start`
        li = bisect.bisect_right(self._line_offsets, start) - 1
        win_start_tok = self._line_offsets[li]
        want = max(end - win_start_tok, self.config.window_tokens)

        def read_window() -> List[int]:
            toks: List[int] = []
            with self._open_text(self._file) as f:
                j = li
                while j < len(self._line_pos) and len(toks) < want:
                    f.seek(self._line_pos[j])
                    line = f.readline().rstrip("\n")
                    toks.extend(self.encode_fn(line))
                    toks.append(self.eos_id)
                    j += 1
            return toks

        toks = self._io_retry(read_window, what="window_fetch")
        self._win_start = win_start_tok
        self._win_tokens = np.asarray(toks, dtype=np.int32)
        ws = self._win_start
        return self._win_tokens[start - ws:end - ws]

    # -- chunk/batch API -----------------------------------------------------

    def _chunk_tokens(self, idx: int) -> np.ndarray:
        start = idx * self._stride
        end = min(start + self.config.seq_len, self._total_tokens)
        if self._tokens is not None:
            return np.asarray(self._tokens[start:end], dtype=np.int32)
        return self._window_fetch(start, end)

    def chunk(self, idx: int):
        """(input_ids, attention_mask, labels) for one chunk, padded to
        seq_len."""
        S = self.config.seq_len
        toks = self._chunk_tokens(idx)
        n = len(toks)
        input_ids = np.full(S, self.pad_id, dtype=np.int32)
        input_ids[:n] = toks
        mask = np.zeros(S, dtype=np.float32)
        mask[:n] = 1.0
        labels = np.full(S, IGNORE_INDEX, dtype=np.int32)
        labels[:n] = toks
        if idx > 0 and self._stride < S:
            # overlapping prefix is context only — matches sliding-window
            # PPL convention
            labels[:S - self._stride] = IGNORE_INDEX
        return input_ids, mask, labels

    def num_batches(self) -> int:
        b = self.config.batch_size
        if self.config.drop_last:
            return self.num_chunks // b
        return (self.num_chunks + b - 1) // b

    def chunk_order(self, epoch: int) -> np.ndarray:
        """The epoch's chunk visitation order: seeded per-epoch shuffle.
        Code that fills multi-micro-batch step buffers directly
        (cli/common.micro_batches, run in the prefetch producer) share
        the order `epoch()` uses through this one function."""
        order = np.arange(self.num_chunks)
        if self.config.shuffle:
            rng = np.random.default_rng(self.config.seed + epoch)
            if self.config.streaming and self._tokens is None:
                # window-local shuffle: permute blocks of window-resident
                # chunks, and chunks within each block, so nearly every
                # access hits the resident window instead of re-tokenizing
                # ~window_tokens per chunk
                per_block = max(self.config.window_tokens
                                // max(self._stride, 1), 1)
                blocks = [order[i:i + per_block]
                          for i in range(0, len(order), per_block)]
                for b in blocks:
                    rng.shuffle(b)
                bidx = np.arange(len(blocks))
                rng.shuffle(bidx)
                order = np.concatenate([blocks[i] for i in bidx]) \
                    if blocks else order
            else:
                rng.shuffle(order)
        return order

    def fill_rows(self, idxs, input_ids: np.ndarray, mask: np.ndarray,
                  labels: np.ndarray, row0: int = 0) -> None:
        """Write chunks `idxs` into rows [row0, row0+len(idxs)) of
        preallocated [N, S] batch arrays — the allocation-free core of
        batch assembly (`epoch()` and `micro_batches` both build on it,
        so a step buffer is filled ONCE instead of stack-then-concat)."""
        for j, ci in enumerate(idxs):
            i_row, m_row, l_row = self.chunk(int(ci))
            input_ids[row0 + j] = i_row
            mask[row0 + j] = m_row
            labels[row0 + j] = l_row

    def epoch(self, epoch: Optional[int] = None,
              start_batch: int = 0) -> Iterator[dict]:
        """Yield batches for one epoch; chunk order reshuffled per epoch
        from (seed, epoch) (`chunk_order`). start_batch skips ahead
        without building the skipped batches (checkpoint-resume
        fast-forward)."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        order = self.chunk_order(epoch)
        b = self.config.batch_size
        S = self.config.seq_len
        nb = self.num_batches()
        for bi in range(start_batch, nb):
            idxs = order[bi * b:(bi + 1) * b]
            n = len(idxs)
            batch = {"input_ids": np.empty((n, S), np.int32),
                     "attention_mask": np.empty((n, S), np.float32),
                     "labels": np.empty((n, S), np.int32)}
            self.fill_rows(idxs, batch["input_ids"],
                           batch["attention_mask"], batch["labels"])
            yield batch

    def total_valid_tokens(self) -> int:
        return self._total_tokens


def pretokenize(input_file: str, encode_fn: Callable[[str], List[int]],
                eos_id: int, out_bin: str):
    """Offline pretokenization -> .bin + .bin.meta.json (the files of the
    pretokenized mode, --pretokenized_path); returns the token count."""
    count = 0
    with open(out_bin, "wb") as out:
        with open(input_file, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                ids = encode_fn(line) + [eos_id]
                np.asarray(ids, dtype=np.int32).tofile(out)
                count += len(ids)
    with open(out_bin + ".meta.json", "w") as f:
        json.dump({"dtype": "int32", "count": count, "eos_id": eos_id}, f)
    return count
