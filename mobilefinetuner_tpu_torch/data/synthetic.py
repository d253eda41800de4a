"""Full-size offline inputs for the training paths: random-weight HF
GPT-2 small and Gemma-3-270M directories and a WikiText-shaped corpus,
all from a seed (the port's own counterparts of tools/e2e_ppl_pipeline.py's
`write_synthetic_gpt2` / `write_synthetic_gemma270m` /
`write_synthetic_corpus`, which import jax and `tokenizers`).

    write_synthetic_gpt2(dir, seed)    config.json, model.safetensors (HF
                                       Conv1D keys), a 50257-entry
                                       byte-level vocab.json and an empty
                                       merges.txt: every byte is one token,
                                       the full vocab head is exercised.
    write_synthetic_gemma270m(dir, seed)
                                       config.json (gemma3_text),
                                       model.safetensors (HF Gemma3 keys,
                                       [out, in] linears) and a
                                       262,144-entry tokenizer.json written
                                       here (`synthetic_gemma_tokenizer`):
                                       specials, the 256 byte tokens, the
                                       pieces and merges that make each
                                       corpus word one token, then filler
                                       pieces up to the real vocab size.
    write_synthetic_corpus(dir, ...)   wiki.{train,valid,test}.tokens:
                                       Zipfian words with a deterministic
                                       bigram continuation rule, so a short
                                       LoRA run measurably lowers held-out
                                       perplexity.
    write_synthetic_mmlu(dir, n)       {dev,val,test}/<subject>_<split>.csv
                                       for all 57 MMLU subjects, n test
                                       items each, the files of
                                       `tools/mmlu_prep.py --synthetic n`
                                       byte for byte (its `synthesize` and
                                       CSV writer, copied: the port does not
                                       import tools/).
"""

from __future__ import annotations

import json
import os

import numpy as np

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.data.tokenizer_bpe import bytes_to_unicode
from mobilefinetuner_tpu_torch.io.checkpoints import (gemma3_params_to_hf,
                                                      gpt2_params_to_hf)
from mobilefinetuner_tpu_torch.io.safetensors_io import save_safetensors

_SPLIT_SEEDS = {"train": 1, "valid": 2, "test": 3}
CORPUS_WORDS = [f"w{i:03d}" for i in range(400)]
SPACE = "\u2581"        # the SentencePiece space marker


def write_synthetic_gpt2(d: str, seed: int = 0) -> GPT2Config:
    from mobilefinetuner_tpu_torch.models import gpt2
    os.makedirs(d, exist_ok=True)
    cfg = GPT2Config.gpt2_small()
    params = gpt2.init_params(cfg, seed=seed, device="cpu")
    save_safetensors(os.path.join(d, "model.safetensors"),
                     gpt2_params_to_hf(params), metadata={"format": "pt"})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": cfg.vocab_size,
                   "n_positions": cfg.n_positions, "n_embd": cfg.n_embd,
                   "n_layer": cfg.n_layer, "n_head": cfg.n_head,
                   "activation_function": "gelu_new"}, f)
    byte_tokens = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(byte_tokens)}
    for i in range(len(byte_tokens), cfg.vocab_size - 1):
        vocab[f"[unused{i}]"] = i
    vocab["<|endoftext|>"] = cfg.vocab_size - 1
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    return cfg


def synthetic_gemma_tokenizer(vocab_size: int = 262144) -> dict:
    """An HF tokenizer.json spec (BPE, byte fallback, spaces replaced by
    the marker): <pad> <eos> <bos> <unk>, <0x00>..<0xFF>, the marker, "w"
    and the digits, then the merges marker+w, +digit, +digit, +digit, so
    that every corpus word with its leading space is one token, then
    <unusedN> filler up to vocab_size."""
    pieces = (["<pad>", "<eos>", "<bos>", "<unk>"]
              + [f"<0x{b:02X}>" for b in range(256)]
              + [SPACE, "w"] + [str(d) for d in range(10)])
    merges = [[SPACE, "w"]]
    prefixes = [SPACE + "w"]
    for _ in range(3):          # one digit at a time: w0, w01, w012
        longer = sorted({p + w[len(p) - 1] for p in prefixes
                         for w in CORPUS_WORDS if w.startswith(p[1:])})
        merges += [[p[:-1], p[-1]] for p in longer]
        pieces += longer
        prefixes = longer
    if vocab_size < len(pieces) + 1:
        raise ValueError(f"vocab_size {vocab_size} < {len(pieces) + 1}")
    vocab = {p: i for i, p in enumerate(pieces)}
    for i in range(len(pieces), vocab_size):
        vocab[f"<unused{i}>"] = i
    return {
        "version": "1.0",
        "added_tokens": [{"id": i, "content": t, "special": True,
                          "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False}
                         for i, t in enumerate(pieces[:4])],
        "normalizer": {"type": "Replace", "pattern": {"String": " "},
                       "content": SPACE},
        "pre_tokenizer": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_synthetic_gemma270m(d: str, seed: int = 0) -> Gemma3TextConfig:
    from mobilefinetuner_tpu_torch.models import gemma3
    os.makedirs(d, exist_ok=True)
    cfg = Gemma3TextConfig.gemma3_270m()
    params = gemma3.init_params(cfg, seed=seed, device="cpu")
    save_safetensors(os.path.join(d, "model.safetensors"),
                     gemma3_params_to_hf(params), metadata={"format": "pt"})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "gemma3_text",
                   **{k: getattr(cfg, k) for k in (
                       "vocab_size", "hidden_size", "intermediate_size",
                       "num_hidden_layers", "num_attention_heads",
                       "num_key_value_heads", "head_dim", "sliding_window",
                       "rope_theta", "rope_local_base_freq",
                       "query_pre_attn_scalar")}}, f)
    with open(os.path.join(d, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(synthetic_gemma_tokenizer(cfg.vocab_size), f,
                  ensure_ascii=False)
    return cfg


def write_synthetic_corpus(d: str, n_train_words: int = 120_000,
                           seed: int = 0) -> str:
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = CORPUS_WORDS
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    follow = rng.integers(0, len(vocab), len(vocab))  # the bigram rule

    def gen(n_words, rng):
        words, w = [], int(rng.integers(len(vocab)))
        for _ in range(n_words):
            if rng.random() < 0.55:
                w = int(follow[w])        # the predictable continuation
            else:
                w = int(rng.choice(len(vocab), p=p))
            words.append(vocab[w])
        lines, i = [], 0
        while i < len(words):
            ln = int(rng.integers(8, 24))
            lines.append(" " + " ".join(words[i:i + ln]) + " ")
            i += ln
        return "\n".join(lines) + "\n"

    for split, n in (("train", n_train_words),
                     ("valid", n_train_words // 10),
                     ("test", n_train_words // 10)):
        with open(os.path.join(d, f"wiki.{split}.tokens"), "w") as f:
            f.write(gen(n, np.random.default_rng(seed + _SPLIT_SEEDS[split])))
    return d


def _csv_field(s: str) -> str:
    """RFC-4180 emit: quote when the field contains , " or newline."""
    if any(c in s for c in ',"\n'):
        return '"' + s.replace('"', '""') + '"'
    return s


def synthesize_mmlu(n_per_subject: int, n_dev: int = 5) -> dict:
    """{(subject, split): [MCQItem]}: a deterministic full-taxonomy set
    whose correct choice echoes a key token of the question and whose
    wrong choices echo other tokens."""
    from mobilefinetuner_tpu_torch.eval.mmlu import MCQItem
    from mobilefinetuner_tpu_torch.eval.mmlu_categories import \
        SUBJECT_TOPICS
    out = {}
    for si, subject in enumerate(sorted(SUBJECT_TOPICS)):
        for split, n in (("dev", n_dev), ("val", max(n_per_subject // 2, 1)),
                         ("test", n_per_subject)):
            items = []
            for i in range(n):
                key = f"{subject}_token_{i:03d}"
                wrong = [f"{subject}_alt_{(i + k) % (n + 7):03d}"
                         for k in (1, 2, 3)]
                gold = (si + i) % 4
                choices = wrong[:gold] + [key] + wrong[gold:]
                items.append(MCQItem(
                    subject=subject,
                    question=(f"In the study of {subject.replace('_', ' ')},"
                              f" which term matches the key \"{key}\"?"),
                    A=choices[0], B=choices[1], C=choices[2], D=choices[3],
                    answer="ABCD"[gold]))
            out[(subject, split)] = items
    return out


def write_synthetic_mmlu(d: str, n_per_subject: int, n_dev: int = 5) -> str:
    """The MMLU root `d`: <d>/<split>/<subject>_<split>.csv, headerless
    question,A,B,C,D,answer rows, for every subject and split."""
    for (subject, split), items in sorted(
            synthesize_mmlu(n_per_subject, n_dev).items()):
        sd = os.path.join(d, split)
        os.makedirs(sd, exist_ok=True)
        with open(os.path.join(sd, f"{subject}_{split}.csv"), "w",
                  encoding="utf-8") as f:
            for it in items:
                f.write(",".join(_csv_field(x) for x in (
                    it.question, it.A, it.B, it.C, it.D, it.answer)) + "\n")
    return d
