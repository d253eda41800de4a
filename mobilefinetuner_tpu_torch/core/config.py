"""Model configuration, parsed from HF `config.json` (port of
mobilefinetuner_tpu/core/config.py: `GPT2Config` and
`Gemma3TextConfig`)."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional


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


@dataclasses.dataclass
class Gemma3TextConfig:
    """Gemma-3 text-decoder config; defaults are Gemma-3-270M. Field names
    follow HF `config.json`: GQA (num_key_value_heads < heads), per-head
    q/k RMSNorm, dual RoPE theta (`rope_theta` on global layers,
    `rope_local_base_freq` on sliding-window ones, per `layer_types[i]`),
    a `sliding_window` mask on local layers, (1 + w) RMSNorm, the query
    scale query_pre_attn_scalar ** -0.5 and an lm_head tied to the
    embedding table. The JAX config's `attention_impl` field is not
    here: the port's model functions take `attn_impl` as an argument, as
    models/gpt2.py does."""

    vocab_size: int = 262144
    hidden_size: int = 640
    intermediate_size: int = 2048
    num_hidden_layers: int = 18
    num_attention_heads: int = 4
    num_key_value_heads: int = 1
    head_dim: int = 256
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_local_base_freq: float = 10000.0
    sliding_window: int = 512
    # per layer: "full_attention" | "sliding_attention"; default 5 local
    # layers to 1 global
    layer_types: Optional[List[str]] = None
    query_pre_attn_scalar: float = 256.0
    hidden_activation: str = "gelu_pytorch_tanh"
    tie_word_embeddings: bool = True
    sliding_window_pattern: int = 6

    def __post_init__(self):
        if self.layer_types is None:
            p = self.sliding_window_pattern
            self.layer_types = [
                "full_attention" if (i + 1) % p == 0 else "sliding_attention"
                for i in range(self.num_hidden_layers)
            ]

    def is_global_layer(self, i: int) -> bool:
        return self.layer_types[i] == "full_attention"

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "Gemma3TextConfig":
        raw = _load_config_json(model_dir)
        if "text_config" in raw:     # multimodal checkpoints nest it
            raw = raw["text_config"]
        return cls(**{f.name: raw[f.name] for f in dataclasses.fields(cls)
                      if f.name in raw})

    @classmethod
    def gemma3_270m(cls) -> "Gemma3TextConfig":
        return cls()

    @classmethod
    def gemma3_1b(cls) -> "Gemma3TextConfig":
        return cls(hidden_size=1152, intermediate_size=6912,
                   num_hidden_layers=26, num_attention_heads=4,
                   num_key_value_heads=1, head_dim=256)

    @classmethod
    def tiny(cls, vocab_size: int = 300) -> "Gemma3TextConfig":
        """A tiny config for tests; keeps GQA and the local/global
        interleave."""
        return cls(vocab_size=vocab_size, hidden_size=32,
                   intermediate_size=64, num_hidden_layers=4,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=8,
                   max_position_embeddings=128, sliding_window=16,
                   query_pre_attn_scalar=8.0, sliding_window_pattern=3)
