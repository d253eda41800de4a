"""Full-size offline inputs for the training path: a random-weight HF
GPT-2 small directory and a WikiText-shaped corpus, both from a seed (the
port's own counterparts of tools/e2e_ppl_pipeline.py's
`write_synthetic_gpt2` / `write_synthetic_corpus`, which import jax).

    write_synthetic_gpt2(dir, seed)    config.json, model.safetensors (HF
                                       Conv1D keys), a 50257-entry
                                       byte-level vocab.json and an empty
                                       merges.txt: every byte is one token,
                                       the full vocab head is exercised.
    write_synthetic_corpus(dir, ...)   wiki.{train,valid,test}.tokens:
                                       Zipfian words with a deterministic
                                       bigram continuation rule, so a short
                                       LoRA run measurably lowers held-out
                                       perplexity.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mobilefinetuner_tpu_torch.core.config import GPT2Config
from mobilefinetuner_tpu_torch.data.tokenizer_bpe import bytes_to_unicode
from mobilefinetuner_tpu_torch.io.checkpoints import gpt2_params_to_hf
from mobilefinetuner_tpu_torch.io.safetensors_io import save_safetensors

_SPLIT_SEEDS = {"train": 1, "valid": 2, "test": 3}


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


def write_synthetic_corpus(d: str, n_train_words: int = 120_000,
                           seed: int = 0) -> str:
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:03d}" for i in range(400)]
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
