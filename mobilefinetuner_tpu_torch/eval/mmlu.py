"""MMLU 4-choice evaluation: CSV loading, k-shot prompt building,
letter-token argmax prediction, per-subject / macro / micro reporting
(port of mobilefinetuner_tpu/eval/mmlu.py: numpy only, the same
functions, names and results).

  - every *.csv under <mmlu_root>/<split>/ is loaded; quoted CSV fields with
    escaped double-quotes are handled (parse_csv_line);
  - both headered CSVs (subject/question/a/b/c/d/answer columns) and the
    headerless Hendrycks layout (question,A,B,C,D,answer with the subject
    taken from the filename) are accepted;
  - prompt = "Question: ...\nA. ...\nB. ...\nC. ...\nD. ...\nAnswer: "
    with k-shot examples prefixed, answered, and separated by blank lines
    (build_prompt, trailing space included);
  - few-shot examples are the first k items of the same subject, excluding
    the current item (no leakage; evaluate());
  - prediction = argmax of the LAST-token logits restricted to the token
    ids of "A"/"B"/"C"/"D" (restricted_argmax; ties go to the first
    letter, np.argmax's rule);
  - macro accuracy = mean of per-subject accuracies, micro = pooled.

Model access is through a `logits_fn(ids: np.ndarray[1,S]) -> np.ndarray[V]`
callable (last-token logits; `evaluate`), or a batched
`logits_fn(ids [B,S], last [B]) -> [B, V]` over power-of-two length buckets
(`evaluate_batched`), so the same runner drives GPT-2 and Gemma-3; the
CLI (cli/eval_mmlu.py) builds the batched one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MCQItem:
    subject: str
    question: str
    A: str
    B: str
    C: str
    D: str
    answer: str  # "A".."D"


@dataclasses.dataclass
class SubjectReport:
    subject: str
    correct: int
    total: int

    @property
    def accuracy(self) -> float:
        return self.correct / self.total if self.total else 0.0


@dataclasses.dataclass
class MMLUResult:
    per_subject: List[SubjectReport]
    macro: float
    micro: float
    total: int
    # the predicted letter of every item, in materialize_work's order
    # (subjects sorted, items in file order); not part of the report
    predictions: List[str] = dataclasses.field(default_factory=list)


def parse_csv_line(line: str) -> List[str]:
    """Minimal RFC-4180 field split: quotes + escaped double-quotes
    (mmlu_runner.cpp parse_csv_line semantics)."""
    fields, cur, in_quotes = [], [], False
    i = 0
    while i < len(line):
        c = line[i]
        if in_quotes:
            if c == '"':
                if i + 1 < len(line) and line[i + 1] == '"':
                    cur.append('"')
                    i += 1
                else:
                    in_quotes = False
            else:
                cur.append(c)
        else:
            if c == ",":
                fields.append("".join(cur))
                cur = []
            elif c == '"':
                in_quotes = True
            else:
                cur.append(c)
        i += 1
    fields.append("".join(cur))
    return fields


def _subject_from_filename(path: str) -> str:
    """abstract_algebra_test.csv -> abstract_algebra."""
    name = os.path.splitext(os.path.basename(path))[0]
    for suffix in ("_test", "_val", "_dev", "_train"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def read_mmlu_csv(path: str) -> List[MCQItem]:
    """Load one CSV; headered or headerless-Hendrycks layouts."""
    with open(path, encoding="utf-8") as f:
        return parse_mmlu_text(f.read(), _subject_from_filename(path),
                               origin=path)


def parse_mmlu_text(text: str, default_subject: str,
                    origin: str = "<text>") -> List[MCQItem]:
    """Parse MMLU CSV text (headered or headerless-Hendrycks) — the single
    parser behind read_mmlu_csv and tools/mmlu_prep.py's zip ingestion, so
    header detection cannot diverge between sources."""
    lines = [ln.rstrip("\n") for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    first = parse_csv_line(lines[0])
    lowered = [c.strip().lower() for c in first]
    required = ("question", "a", "b", "c", "d", "answer")
    # header detection needs BOTH marker columns (a lone 'answer' cell in a
    # headerless data row must not trigger it); a detected header must then
    # carry every required column or the file is malformed.
    looks_headered = "question" in lowered and "answer" in lowered
    headered = looks_headered and all(n in lowered for n in required)
    if looks_headered and not headered:
        missing = [n for n in required if n not in lowered]
        raise ValueError(
            f"{origin}: headered MMLU CSV is missing column(s) "
            f"{missing}; need all of {list(required)}")
    items: List[MCQItem] = []
    if headered:
        idx = {name: lowered.index(name) for name in required}
        subj_idx = lowered.index("subject") if "subject" in lowered else None
        rows = lines[1:]
        for line in rows:
            f2 = parse_csv_line(line)
            if len(f2) <= max(idx.values()):
                continue
            # an empty subject CELL falls back to the file-level default
            # (filename-derived), not straight to "unknown"
            subject = ((f2[subj_idx].strip() or default_subject)
                       if subj_idx is not None else default_subject) \
                or "unknown"
            ans = f2[idx["answer"]].strip()
            items.append(MCQItem(
                subject=subject, question=f2[idx["question"]].strip(),
                A=f2[idx["a"]].strip(), B=f2[idx["b"]].strip(),
                C=f2[idx["c"]].strip(), D=f2[idx["d"]].strip(),
                answer=(ans[:1].upper() or "A")))
    else:
        subject = default_subject
        for line in lines:
            f2 = parse_csv_line(line)
            if len(f2) < 6:
                continue
            items.append(MCQItem(
                subject=subject, question=f2[0].strip(), A=f2[1].strip(),
                B=f2[2].strip(), C=f2[3].strip(), D=f2[4].strip(),
                answer=(f2[5].strip()[:1].upper() or "A")))
    return items


def load_split(mmlu_root: str, split: str) -> Dict[str, List[MCQItem]]:
    """All *.csv under <root>/<split>/ grouped by subject."""
    split_dir = os.path.join(mmlu_root, split)
    by_subject: Dict[str, List[MCQItem]] = {}
    for name in sorted(os.listdir(split_dir)):
        if not name.endswith(".csv"):
            continue
        for item in read_mmlu_csv(os.path.join(split_dir, name)):
            by_subject.setdefault(item.subject, []).append(item)
    return by_subject


def build_prompt(item: MCQItem,
                 shots: Optional[Sequence[MCQItem]] = None) -> str:
    def one(q: MCQItem) -> str:
        return (f"Question: {q.question}\n"
                f"A. {q.A}\nB. {q.B}\nC. {q.C}\nD. {q.D}\nAnswer: ")

    prompt = ""
    for s in shots or ():
        prompt += one(s) + s.answer + "\n\n"
    return prompt + one(item)


LETTERS = ("A", "B", "C", "D")


def restricted_argmax(logits_row: np.ndarray,
                      letter_ids: Sequence[int]) -> str:
    """argmax over the A-D letter token ids (out-of-range ids score -inf);
    raw logits are rank-equivalent to the reference's log-softmax."""
    scores = [logits_row[i] if 0 <= i < logits_row.shape[-1] else -1e30
              for i in letter_ids]
    return LETTERS[int(np.argmax(scores))]


def finalize_reports(correct: Dict[str, int],
                     totals: Dict[str, int]) -> "MMLUResult":
    reports = [SubjectReport(s, correct[s], totals[s])
               for s in sorted(totals)]
    macro = (sum(r.accuracy for r in reports) / len(reports)
             if reports else 0.0)
    total = sum(totals.values())
    micro = sum(correct.values()) / total if total else 0.0
    return MMLUResult(reports, macro, micro, total)


def predict_letter(prompt: str, logits_fn: Callable[[np.ndarray], np.ndarray],
                   encode_fn: Callable[[str], List[int]],
                   letter_ids: Sequence[int]) -> str:
    """argmax over the last-token log-probs restricted to the A-D token ids.

    log_softmax is rank-preserving over the restricted set, so raw logits
    argmax is equivalent (the reference computes the full log_softmax first,
    predict_letter; we skip the normalization)."""
    ids = encode_fn(prompt) or [0]
    logits = logits_fn(np.asarray(ids, np.int32)[None, :])
    return restricted_argmax(logits, letter_ids)


def letter_token_ids(encode_fn: Callable[[str], List[int]]) -> List[int]:
    """First token id of each letter (predict_letter id lookup)."""
    out = []
    for fallback, letter in enumerate(LETTERS):
        ids = encode_fn(letter)
        out.append(ids[0] if ids else fallback)
    return out


def bucket_for(n_ids: int, min_bucket: int = 32,
               max_len: int = 1024) -> int:
    """The power-of-two length bucket a prompt of n_ids tokens lands in
    (clamped to [min_bucket, max_len]): the one rule of the runner and
    of any caller that sizes its work from the buckets."""
    return min(max(1 << (n_ids - 1).bit_length(), min_bucket), max_len)


def materialize_work(by_subject: Dict[str, List[MCQItem]],
                     encode_fn: Callable[[str], List[int]],
                     fewshot_k: int = 0,
                     max_items_per_subject: int = 0,
                     max_len: int = 1024):
    """(work, totals): the exact evaluate() work list — (subject,
    item_no, n_subject, item, token_ids) per item, same shot exclusion
    — encoded once, so a caller can read the buckets it lands in and
    hand the list to evaluate_batched without re-encoding a prompt."""
    work = []
    totals: Dict[str, int] = {}
    for subject in sorted(by_subject):
        items = by_subject[subject]
        if max_items_per_subject:
            items = items[:max_items_per_subject]
        shots = items[:fewshot_k] if fewshot_k > 0 else []
        totals[subject] = len(items)
        for n, item in enumerate(items):
            shots_ex = [s for s in shots if s is not item]
            ids = encode_fn(build_prompt(item, shots_ex or None)) or [0]
            work.append((subject, n, len(items), item, ids[-max_len:]))
    return work, totals


def evaluate_batched(by_subject: Dict[str, List[MCQItem]],
                     batched_logits_fn: Callable[[np.ndarray, np.ndarray],
                                                 np.ndarray],
                     encode_fn: Callable[[str], List[int]],
                     fewshot_k: int = 0,
                     progress_fn: Optional[Callable[[str, int, int],
                                                    None]] = None,
                     max_items_per_subject: int = 0,
                     letter_encode_fn: Optional[Callable[[str],
                                                         List[int]]] = None,
                     batch_size: int = 16,
                     max_len: int = 1024,
                     min_bucket: int = 32,
                     work=None) -> MMLUResult:
    """Batched runner: identical predictions/reporting to evaluate(),
    but prompts are grouped into power-of-two length buckets and fed
    batch_size at a time — a handful of [batch, bucket] shapes instead
    of a [1, S] forward per item (the reference runs per-item,
    mmlu_runner.cpp), with the batch dimension full.

    batched_logits_fn(ids [B, S], last_idx [B]) -> [B, V] last-REAL-token
    logits (right-padded rows; last_idx selects the real last token).
    Partial batches are padded by repeating the first row; padded rows'
    predictions are discarded.

    progress_fn fires in BUCKET order (items of different subjects
    interleave), unlike evaluate()'s strict per-subject order — only the
    final reports are order-identical. result.predictions holds each
    item's letter in work order, as evaluate()'s does.
    """
    letter_ids = letter_token_ids(letter_encode_fn or encode_fn)
    if work is None:
        work, totals = materialize_work(
            by_subject, encode_fn, fewshot_k=fewshot_k,
            max_items_per_subject=max_items_per_subject,
            max_len=max_len)
    else:
        totals = {}
        for subject, _n, n_sub, _item, _ids in work:
            totals[subject] = n_sub

    by_bucket: Dict[int, list] = {}
    for j, w in enumerate(work):
        by_bucket.setdefault(
            bucket_for(len(w[4]), min_bucket, max_len), []).append((j, w))

    correct: Dict[str, int] = {s: 0 for s in totals}
    predictions: List[str] = [""] * len(work)
    for bucket in sorted(by_bucket):
        ws = by_bucket[bucket]
        for i in range(0, len(ws), batch_size):
            chunk = ws[i:i + batch_size]
            B = len(chunk)
            ids = np.zeros((batch_size, bucket), np.int32)
            last = np.zeros((batch_size,), np.int32)
            for r, (_, (_, _, _, _, tok_ids)) in enumerate(chunk):
                ids[r, :len(tok_ids)] = tok_ids
                last[r] = len(tok_ids) - 1
            if B < batch_size:       # pad rows: repeat row 0, discard
                ids[B:] = ids[0]
                last[B:] = last[0]
            logits = np.asarray(batched_logits_fn(ids, last))  # [B, V]
            for r, (j, (subject, n, n_sub, item, _)) in enumerate(chunk):
                pred = restricted_argmax(logits[r], letter_ids)
                predictions[j] = pred
                correct[subject] += int(pred == item.answer)
                if progress_fn:
                    progress_fn(subject, n + 1, n_sub)

    result = finalize_reports(correct, totals)
    result.predictions = predictions
    return result


def evaluate(by_subject: Dict[str, List[MCQItem]],
             logits_fn: Callable[[np.ndarray], np.ndarray],
             encode_fn: Callable[[str], List[int]],
             fewshot_k: int = 0,
             progress_fn: Optional[Callable[[str, int, int], None]] = None,
             max_items_per_subject: int = 0,
             letter_encode_fn: Optional[Callable[[str], List[int]]] = None
             ) -> MMLUResult:
    # letter_encode_fn: encoder WITHOUT sequence-start decoration for the
    # A-D id lookup (a Gemma-style auto-BOS encoder would make every
    # letter's first token the BOS id); prompts keep using encode_fn.
    letter_ids = letter_token_ids(letter_encode_fn or encode_fn)
    correct_by: Dict[str, int] = {}
    totals: Dict[str, int] = {}
    predictions: List[str] = []
    for subject in sorted(by_subject):
        items = by_subject[subject]
        if max_items_per_subject:
            items = items[:max_items_per_subject]
        shots = items[:fewshot_k] if fewshot_k > 0 else []
        correct = 0
        for n, item in enumerate(items):
            shots_ex = [s for s in shots if s is not item]
            pred = predict_letter(build_prompt(item, shots_ex or None),
                                  logits_fn, encode_fn, letter_ids)
            predictions.append(pred)
            correct += int(pred == item.answer)
            if progress_fn:
                progress_fn(subject, n + 1, len(items))
        correct_by[subject] = correct
        totals[subject] = len(items)
    result = finalize_reports(correct_by, totals)
    result.predictions = predictions
    return result
