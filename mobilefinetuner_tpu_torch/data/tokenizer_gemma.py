"""Gemma tokenizer: SentencePiece-style BPE parsed from HF `tokenizer.json`
(port of mobilefinetuner_tpu/data/tokenizer_gemma.py, the pure-Python
engine; the JAX package's native C++ merge engine is not ported).

Supported tokenizer.json mechanisms (the set Gemma uses):
  - normalizer: Replace / Prepend / Sequence / NFC-family;
  - model: BPE with byte_fallback (unknown pieces -> <0xXX> byte tokens);
  - no pre_tokenizer (BPE over the whole normalized string), or
    Metaspace;
  - added_tokens, matched verbatim before BPE;
  - decode: the space marker back to spaces, byte tokens fused.

The BPE merges adjacent pairs in rank order with a heap over a linked
list (O(n log n)); the ids are the JAX GemmaTokenizer's, id for id.
"""

from __future__ import annotations

import heapq
import json
import os
import re as stdre
from typing import Dict, List, Optional, Tuple


class _Normalizer:
    def __init__(self, spec: Optional[dict]):
        self.steps: List[Tuple[str, str, str]] = []
        if spec:
            self._parse(spec)

    def _parse(self, spec: dict):
        t = spec.get("type")
        if t == "Sequence":
            for sub in spec.get("normalizers", []):
                self._parse(sub)
        elif t == "Replace":
            pat = spec["pattern"]
            if "String" in pat:
                self.steps.append(("replace_str", pat["String"],
                                   spec["content"]))
            else:
                self.steps.append(("replace_re", pat["Regex"],
                                   spec["content"]))
        elif t == "Prepend":
            self.steps.append(("prepend", spec["prepend"], ""))
        elif t in ("NFC", "NFD", "NFKC", "NFKD"):
            self.steps.append(("unicode", t, ""))
        else:
            raise ValueError(f"unsupported normalizer {t}")

    def __call__(self, text: str) -> str:
        import unicodedata
        for kind, a, b in self.steps:
            if kind == "replace_str":
                text = text.replace(a, b)
            elif kind == "replace_re":
                text = stdre.sub(a, b, text)
            elif kind == "prepend":
                text = a + text if text else text
            elif kind == "unicode":
                text = unicodedata.normalize(a, text)
        return text


def _bpe_heap(symbols: List[str], ranks: Dict[Tuple[str, str], int]
              ) -> List[str]:
    """Merge adjacent symbol pairs in rank order via a heap over a
    doubly-linked list."""
    n = len(symbols)
    if n < 2:
        return symbols
    sym = list(symbols)
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n
    heap: List[Tuple[int, int, str, str]] = []
    for i in range(n - 1):
        r = ranks.get((sym[i], sym[i + 1]))
        if r is not None:
            heapq.heappush(heap, (r, i, sym[i], sym[i + 1]))
    while heap:
        r, i, a, b = heapq.heappop(heap)
        if not alive[i] or sym[i] != a:
            continue
        j = nxt[i]
        if j == -1 or not alive[j] or sym[j] != b:
            continue
        # merge j into i
        sym[i] = a + b
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] != -1:
            prv[nxt[j]] = i
        p = prv[i]
        if p != -1 and alive[p]:
            r2 = ranks.get((sym[p], sym[i]))
            if r2 is not None:
                heapq.heappush(heap, (r2, p, sym[p], sym[i]))
        q = nxt[i]
        if q != -1 and alive[q]:
            r2 = ranks.get((sym[i], sym[q]))
            if r2 is not None:
                heapq.heappush(heap, (r2, i, sym[i], sym[q]))
    out = []
    i = 0
    while i != -1:
        if alive[i]:
            out.append(sym[i])
        i = nxt[i]
    return out


class GemmaTokenizer:
    def __init__(self, path_or_spec):
        if isinstance(path_or_spec, str):
            with open(path_or_spec, encoding="utf-8") as f:
                spec = json.load(f)
        else:
            spec = path_or_spec
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"unsupported tokenizer model "
                             f"{model.get('type')!r} (BPE only)")
        self.vocab: Dict[str, int] = model["vocab"]
        self.id_to_token = {v: k for k, v in self.vocab.items()}
        merges = model.get("merges", [])
        norm_merges: List[Tuple[str, str]] = []
        for m in merges:
            if isinstance(m, str):
                a, b = m.split(" ")
            else:
                a, b = m
            norm_merges.append((a, b))
        self.ranks = {pair: i for i, pair in enumerate(norm_merges)}
        self.byte_fallback = model.get("byte_fallback", False)
        self.unk_token = model.get("unk_token")
        self.normalizer = _Normalizer(spec.get("normalizer"))
        # Space handling may live in a Metaspace pre_tokenizer instead of a
        # Replace normalizer (common in SentencePiece-converted tokenizers).
        # Anything else unsupported -> raise, never silently produce garbage.
        self.metaspace: Optional[Tuple[str, str]] = None  # (repl, scheme)
        self._parse_pre_tokenizer(spec.get("pre_tokenizer"))
        self.added_tokens = {t["content"]: t["id"]
                             for t in spec.get("added_tokens", [])}
        self._added_re = None
        if self.added_tokens:
            pat = "|".join(stdre.escape(t) for t in
                           sorted(self.added_tokens, key=len, reverse=True))
            self._added_re = stdre.compile(f"({pat})")

        def _tid(name, default=None):
            return self.added_tokens.get(name, self.vocab.get(name, default))

        self.pad_id = _tid("<pad>", 0)
        self.eos_id = _tid("<eos>", 1)
        self.bos_id = _tid("<bos>", 2)
        self.unk_id = _tid("<unk>", 3)
        self.add_bos = True  # the Gemma default

    def _parse_pre_tokenizer(self, spec: Optional[dict]):
        if spec is None:
            return
        t = spec.get("type")
        if t == "Sequence":
            for sub in spec.get("pretokenizers", []):
                self._parse_pre_tokenizer(sub)
        elif t == "Metaspace":
            self.metaspace = (spec.get("replacement", "▁"),
                              spec.get("prepend_scheme",
                                       "always" if spec.get("add_prefix_space",
                                                            True)
                                       else "never"))
        else:
            raise ValueError(f"unsupported pre_tokenizer {t}")

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "GemmaTokenizer":
        return cls(os.path.join(model_dir, "tokenizer.json"))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _encode_chunk(self, text: str, first: bool = True) -> List[int]:
        if not text:
            return []
        text = self.normalizer(text)
        if self.metaspace is not None:
            rep, scheme = self.metaspace
            text = text.replace(" ", rep)
            if (scheme == "always" or (scheme == "first" and first)) \
                    and not text.startswith(rep):
                text = rep + text
        pieces = _bpe_heap(list(text), self.ranks)
        ids: List[int] = []
        for piece in pieces:
            tid = self.vocab.get(piece)
            if tid is not None:
                ids.append(tid)
            elif self.byte_fallback:
                for byte in piece.encode("utf-8"):
                    ids.append(self.vocab[f"<0x{byte:02X}>"])
            elif self.unk_token is not None:
                ids.append(self.vocab[self.unk_token])
        return ids

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        add_bos = self.add_bos if add_bos is None else add_bos
        ids: List[int] = [self.bos_id] if add_bos else []
        if self._added_re:
            parts = self._added_re.split(text)
        else:
            parts = [text]
        # HF Metaspace prepend_scheme="first": the space marker is prepended
        # only to a part at offset 0 of the original string — a part that
        # follows a special token is NOT "first" (verified vs HF tokenizers:
        # "<bos>user" -> [bos, "user"], not [bos, "▁user"]).
        first = True
        for part in parts:
            if not part:
                continue
            if part in self.added_tokens:
                ids.append(self.added_tokens[part])
            else:
                ids.extend(self._encode_chunk(part, first=first))
            first = False
        return ids

    def decode(self, ids: List[int], skip_special: bool = True) -> str:
        special = {self.pad_id, self.eos_id, self.bos_id}
        out: List[str] = []
        byte_buf = bytearray()
        byte_re = stdre.compile(r"^<0x([0-9A-Fa-f]{2})>$")

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if skip_special and i in special:
                continue
            tok = self.id_to_token.get(i, "")
            m = byte_re.match(tok)
            if m:
                byte_buf.append(int(m.group(1), 16))
                continue
            flush()
            out.append(tok)
        flush()
        return "".join(out).replace("▁", " ")
