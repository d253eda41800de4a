"""Model configuration, parsed from HF `config.json` (port of
mobilefinetuner_tpu/core/config.py; GPT-2 only in this slice —
`Gemma3TextConfig` comes with the Gemma slice)."""

from __future__ import annotations

import dataclasses
import json
import os


def _load_config_json(model_dir: str) -> dict:
    path = os.path.join(model_dir, "config.json")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


@dataclasses.dataclass
class GPT2Config:
    """GPT-2 family config; field names follow HF `config.json`."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    activation_function: str = "gelu_new"
    embd_pdrop: float = 0.0
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "GPT2Config":
        raw = _load_config_json(model_dir)
        return cls(
            vocab_size=raw.get("vocab_size", 50257),
            n_positions=raw.get("n_positions", raw.get("n_ctx", 1024)),
            n_embd=raw.get("n_embd", 768),
            n_layer=raw.get("n_layer", 12),
            n_head=raw.get("n_head", 12),
            layer_norm_epsilon=raw.get("layer_norm_epsilon", 1e-5),
            activation_function=raw.get("activation_function", "gelu_new"),
            embd_pdrop=raw.get("embd_pdrop", 0.0),
            resid_pdrop=raw.get("resid_pdrop", 0.0),
            attn_pdrop=raw.get("attn_pdrop", 0.0),
            tie_word_embeddings=raw.get("tie_word_embeddings", True),
        )

    @classmethod
    def gpt2_small(cls) -> "GPT2Config":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 257) -> "GPT2Config":
        """A tiny config for tests (fast CPU forward)."""
        return cls(vocab_size=vocab_size, n_positions=64, n_embd=32,
                   n_layer=2, n_head=2)
