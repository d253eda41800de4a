"""The port's MMLU evaluation (mobilefinetuner_tpu_torch/eval/mmlu.py,
eval/mmlu_categories.py, cli/eval_mmlu.py, data/synthetic.
write_synthetic_mmlu) against the JAX package's, on the CPU in f32:
every public function of eval/mmlu on CSVs written here (headerless and
headered) and on hand-made logits (ties, out-of-range letter ids, pad
rows of a partial batch); the CLI's JSON report and summary line equal
the JAX CLI's on the tiny GPT-2 and Gemma-3 fixtures, base, with a
merged and a dynamic adapter, the Gemma lm_head target included; one
batch's last-token logits within 1e-4; the synthetic MMLU equals
tools/mmlu_prep.py --synthetic byte for byte; unported flags refuse."""

import collections
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from fixtures import (MMLU_ROWS, write_tiny_gemma3_dir,  # noqa: E402
                      write_tiny_gpt2_dir, write_tiny_mmlu_dir)

from mobilefinetuner_tpu.cli import eval_mmlu as jax_cli  # noqa: E402
from mobilefinetuner_tpu.core.config import GPT2Config as JaxGPT2  # noqa
from mobilefinetuner_tpu.core.config import \
    Gemma3TextConfig as JaxGemma  # noqa: E402
from mobilefinetuner_tpu.eval import mmlu as jmmlu  # noqa: E402
from mobilefinetuner_tpu.eval import mmlu_categories as jcat  # noqa: E402
from mobilefinetuner_tpu.lora import lora as jlora  # noqa: E402
from mobilefinetuner_tpu.lora import peft_io as jax_peft_io  # noqa: E402
from mobilefinetuner_tpu_torch.cli import eval_mmlu as cli  # noqa: E402
from mobilefinetuner_tpu_torch.data.synthetic import (  # noqa: E402
    synthesize_mmlu, write_synthetic_mmlu)
from mobilefinetuner_tpu_torch.eval import mmlu  # noqa: E402
from mobilefinetuner_tpu_torch.eval import mmlu_categories as cat  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _adapter(path, spec, tree_fn, seed):
    tree = jax.tree.map(np.asarray, tree_fn(spec, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for e in tree["blocks"].values():       # B off zero
        e["B"] = (rng.normal(size=e["B"].shape) * 0.5).astype(np.float32)
    jax_peft_io.save_adapter(path, tree, spec)
    return path


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmlu")
    g2, gm = str(root / "gpt2"), str(root / "gemma")
    write_tiny_gpt2_dir(g2)
    write_tiny_gemma3_dir(gm)
    mm = write_tiny_mmlu_dir(str(root / "mmlu"))
    syn = write_synthetic_mmlu(str(root / "mmlu_syn"), 2)
    g2cfg = JaxGPT2.tiny(vocab_size=json.load(
        open(os.path.join(g2, "config.json")))["vocab_size"])
    gmcfg = JaxGemma.from_pretrained(gm)
    adapters = {
        "gpt2": _adapter(str(root / "gpt2_lora.safetensors"),
                         jlora.LoRASpec(rank=4, alpha=8.0,
                                        targets=["attn_qkv", "attn_proj"]),
                         lambda s, k: jlora.init_lora_gpt2(g2cfg, s, k), 1),
        "gemma": _adapter(str(root / "gemma_lora.safetensors"),
                          jlora.LoRASpec(rank=4, alpha=8.0, init="peft",
                                         targets=["q_proj", "v_proj"]),
                          lambda s, k: jlora.init_lora_gemma3(gmcfg, s, k),
                          2),
        "gemma_head": _adapter(str(root / "gemma_head.safetensors"),
                               jlora.LoRASpec(rank=4, alpha=8.0,
                                              init="peft",
                                              targets=["q_proj",
                                                       "lm_head"]),
                               lambda s, k: jlora.init_lora_gemma3(
                                   gmcfg, s, k), 3)}
    return {"gpt2": g2, "gemma": gm, "mmlu": mm, "syn": syn,
            "adapters": adapters, "root": root}


# ------------------------------------------------------------ eval/mmlu ----

def _write_headered(d):
    sd = os.path.join(d, "test")
    os.makedirs(sd, exist_ok=True)
    with open(os.path.join(sd, "mixed_test.csv"), "w") as f:
        f.write("Subject,Question,A,B,C,D,Answer\n")
        f.write('alpha,"Say ""hi"", then?",x,y,z,w,b\n')
        f.write(',empty subject cell,1,2,3,4,D\n')
        f.write('beta,short row,1,2\n')
        f.write('alpha,"multi, comma",p,q,r,s,C\n')
    with open(os.path.join(sd, "broken_test.csv.txt"), "w") as f:
        f.write("ignored: not a .csv\n")
    return d


def test_parsers_and_loaders_match_jax(dirs, tmp_path):
    lines = ['a,b,c', '"q, with comma",x,"say ""hi""",z', '', ',,',
             '"unterminated,x']
    for line in lines:
        assert mmlu.parse_csv_line(line) == jmmlu.parse_csv_line(line)
    head = _write_headered(str(tmp_path / "headered"))
    for root in (dirs["mmlu"], head, dirs["syn"]):
        ours = mmlu.load_split(root, "test")
        theirs = jmmlu.load_split(root, "test")
        assert list(ours) == list(theirs) and ours
        for s in ours:
            assert [vars(i) for i in ours[s]] == [vars(i)
                                                  for i in theirs[s]]
    path = os.path.join(dirs["mmlu"], "test", "toy_math_test.csv")
    assert [vars(i) for i in mmlu.read_mmlu_csv(path)] == \
        [vars(i) for i in jmmlu.read_mmlu_csv(path)]
    assert len(mmlu.read_mmlu_csv(path)) == len(MMLU_ROWS)
    bad = "question,a,b,answer\nq,1,2,A\n"
    for mod in (mmlu, jmmlu):
        with pytest.raises(ValueError, match="missing column"):
            mod.parse_mmlu_text(bad, "x")
    assert mmlu.parse_mmlu_text("", "x") == jmmlu.parse_mmlu_text("", "x")


def test_prompts_buckets_and_letters_match_jax(dirs):
    items = mmlu.load_split(dirs["mmlu"], "test")["toy_math"]
    jitems = jmmlu.load_split(dirs["mmlu"], "test")["toy_math"]
    for k in (0, 1, 3):
        assert mmlu.build_prompt(items[-1], items[:k] or None) == \
            jmmlu.build_prompt(jitems[-1], jitems[:k] or None)
    for n in (1, 31, 32, 33, 100, 1000, 1025, 5000):
        for max_len in (1024, 4096):
            assert mmlu.bucket_for(n, max_len=max_len) == \
                jmmlu.bucket_for(n, max_len=max_len)
    enc = lambda s: [ord(c) for c in s]  # noqa: E731
    assert mmlu.letter_token_ids(enc) == jmmlu.letter_token_ids(enc) == \
        [65, 66, 67, 68]
    empty = lambda s: []  # noqa: E731
    assert mmlu.letter_token_ids(empty) == jmmlu.letter_token_ids(empty) \
        == [0, 1, 2, 3]
    rng = np.random.default_rng(0)
    row = rng.normal(size=50).astype(np.float32)
    tie = np.zeros(50, np.float32)
    for ids in ([1, 2, 3, 4], [7, 7, 9, 3], [60, 2, -1, 4], [0, 1, 2, 99]):
        for r in (row, tie):
            assert mmlu.restricted_argmax(r, ids) == \
                jmmlu.restricted_argmax(r, ids)
    assert mmlu.restricted_argmax(tie, [1, 2, 3, 4]) == "A"  # first wins
    assert mmlu.restricted_argmax(row, [60, 61, 2, 62]) == "C"


def _toy_logits(ids_row, V=128):
    """Deterministic last-token logits of a prompt's ids: the numpy
    stand-in for a model, shared by both packages' runners."""
    r = np.random.default_rng(int(np.sum(ids_row)) % (2 ** 31))
    return r.normal(size=V).astype(np.float32)


@pytest.mark.parametrize("fewshot,batch", [(0, 3), (1, 16), (2, 1)])
def test_runners_match_jax_and_each_other(dirs, fewshot, batch):
    """evaluate (item-wise) and evaluate_batched (buckets, pad rows that
    repeat row 0) in both packages: the same reports; materialize_work
    gives the same work list."""
    by = mmlu.load_split(dirs["syn"], "test")
    jby = jmmlu.load_split(dirs["syn"], "test")
    enc = lambda s: [ord(c) % 128 for c in s]  # noqa: E731
    calls = []

    def one(ids):
        return _toy_logits(ids[0])

    def batched(ids, last):
        calls.append(ids.shape)
        return np.stack([_toy_logits(ids[r, :last[r] + 1])
                         for r in range(ids.shape[0])])

    work, totals = mmlu.materialize_work(by, enc, fewshot_k=fewshot,
                                         max_items_per_subject=2,
                                         max_len=1024)
    jwork, jtotals = jmmlu.materialize_work(jby, enc, fewshot_k=fewshot,
                                            max_items_per_subject=2,
                                            max_len=1024)
    assert totals == jtotals
    assert [(w[0], w[1], w[2], vars(w[3]), w[4]) for w in work] == \
        [(w[0], w[1], w[2], vars(w[3]), w[4]) for w in jwork]
    kw = dict(fewshot_k=fewshot, max_items_per_subject=2)
    reports = [
        mmlu.evaluate(by, one, enc, **kw),
        jmmlu.evaluate(jby, one, enc, **kw),
        mmlu.evaluate_batched(by, batched, enc, batch_size=batch,
                              max_len=1024, **kw),
        jmmlu.evaluate_batched(jby, batched, enc, batch_size=batch,
                               max_len=1024, **kw),
        mmlu.evaluate_batched(by, batched, enc, batch_size=batch,
                              max_len=1024, work=work, **kw)]
    flat = [([(r.subject, r.correct, r.total) for r in res.per_subject],
             res.macro, res.micro, res.total) for res in reports]
    assert all(f == flat[0] for f in flat)
    assert flat[0][3] == 2 * len(by)
    # every runner of the port: each item's letter in work order
    ours = [reports[i].predictions for i in (0, 2, 4)]
    assert ours[0] == ours[1] == ours[2] and len(ours[0]) == len(work)
    assert sum(p == w[3].answer for p, w in zip(ours[0], work)) == \
        sum(r.correct for r in reports[0].per_subject)
    assert all(s[0] == batch for s in calls)          # pad rows filled
    assert cat.category_rollup(reports[0]) == \
        jcat.category_rollup(reports[1])
    for s in list(by) + ["custom_subject"]:
        assert cat.subject_macro_category(s) == \
            jcat.subject_macro_category(s)
    fin = mmlu.finalize_reports({"a": 1, "b": 0}, {"a": 2, "b": 0})
    jfin = jmmlu.finalize_reports({"a": 1, "b": 0}, {"a": 2, "b": 0})
    assert (fin.macro, fin.micro, fin.total) == \
        (jfin.macro, jfin.micro, jfin.total) == (0.25, 0.5, 2)
    assert mmlu.predict_letter("Answer: ", one, enc, [65, 66, 67, 68]) == \
        jmmlu.predict_letter("Answer: ", one, enc, [65, 66, 67, 68])


def test_synthetic_mmlu_equals_mmlu_prep(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "mmlu_prep", os.path.join(ROOT, "tools", "mmlu_prep.py"))
    prep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prep)
    ours = write_synthetic_mmlu(str(tmp_path / "port"), 3)
    assert prep.main(["--synthetic", "3", "--out",
                      str(tmp_path / "tool")]) == 0
    n = 0
    for split in ("dev", "val", "test"):
        names = sorted(os.listdir(os.path.join(ours, split)))
        assert names == sorted(os.listdir(str(tmp_path / "tool" / split)))
        assert len(names) == 57
        for name in names:
            with open(os.path.join(ours, split, name), "rb") as a, \
                    open(str(tmp_path / "tool" / split / name), "rb") as b:
                assert a.read() == b.read(), (split, name)
            n += 1
    assert n == 3 * 57
    items = synthesize_mmlu(3)
    assert {vars(i)["answer"] for v in items.values() for i in v} == \
        set("ABCD")


# ------------------------------------------------------------ the CLI ------

def _run(main, argv, capsys, out):
    assert main(argv + ["--out", out]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        return summary, json.loads(f.read())


@pytest.mark.parametrize("fam,adapter", [
    ("gpt2", "none"), ("gpt2", "dynamic"), ("gpt2", "merged"),
    ("gemma", "none"), ("gemma", "dynamic"), ("gemma", "merged"),
    ("gemma_head", "dynamic")])
def test_eval_mmlu_report_matches_jax(dirs, capsys, tmp_path, fam,
                                      adapter):
    model = dirs["gemma" if fam.startswith("gemma") else "gpt2"]
    argv = ["--pretrained_dir", model, "--mmlu_root", dirs["syn"],
            "--max_items", "1", "--eval_batch", "8", "--fewshot", "1",
            "--synthetic"]
    if adapter != "none":
        argv += ["--lora_path", dirs["adapters"][fam]]
    if adapter == "merged":
        argv.append("--lora_merge")
    theirs = _run(jax_cli.main, argv, capsys, str(tmp_path / "j.json"))
    ours = _run(cli.main, argv + ["--device", "cpu"], capsys,
                str(tmp_path / "p.json"))
    assert ours == theirs
    assert ours[1]["total_items"] == 57 and ours[1]["synthetic"] is True


@pytest.mark.parametrize("fam,adapter", [
    ("gpt2", "none"), ("gpt2", "dynamic"), ("gemma", "none"),
    ("gemma_head", "dynamic")])
def test_batched_logits_match_jax(dirs, fam, adapter):
    """One bucketed batch (right-padded ids, a partial batch padded with
    row 0) through both packages' make_batched_logits_fn: last-token
    logits within 1e-4; the port's column-gathered form equals its full
    rows at the letter ids."""
    model = dirs["gemma" if fam.startswith("gemma") else "gpt2"]
    argv = ["--pretrained_dir", model, "--mmlu_root", dirs["syn"]]
    if adapter != "none":
        argv += ["--lora_path", dirs["adapters"][fam]]
    jargs = jax_cli.build_parser().parse_args(argv)
    pargs = cli.build_parser().parse_args(argv + ["--device", "cpu"])
    jf = jax_cli.setup_family(jargs)
    pf = cli.setup_family(pargs, "cpu")
    tok = pf[3]
    prompts = [mmlu.build_prompt(i) for v in mmlu.load_split(
        dirs["mmlu"], "test").values() for i in v][:5]
    enc = [tok.encode(p)[-pf[5]:] for p in prompts]  # as the runner
    S = mmlu.bucket_for(max(len(e) for e in enc), max_len=pf[5])
    B = 8
    ids = np.zeros((B, S), np.int32)
    last = np.zeros(B, np.int32)
    for r, e in enumerate(enc):
        ids[r, :len(e)] = e
        last[r] = len(e) - 1
    ids[len(enc):], last[len(enc):] = ids[0], last[0]
    jfn, _ = jax_cli.make_batched_logits_fn(*jf[:3], jf[6], jf[7])
    theirs = np.asarray(jfn(ids, last))
    ours = cli.make_batched_logits_fn(*pf[:3], pf[6], pf[7])(ids, last)
    assert ours.shape == theirs.shape == (B, pf[6][pf[1]].shape[0])
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)
    letters = mmlu.letter_token_ids(pf[4] or tok.encode)
    picked = cli.make_batched_logits_fn(*pf[:3], pf[6], pf[7],
                                        columns=letters)(ids, last)
    assert np.array_equal(picked[:, letters], ours[:, letters])
    assert [mmlu.restricted_argmax(picked[r], letters) for r in range(B)] \
        == [jmmlu.restricted_argmax(theirs[r], letters) for r in range(B)]


def test_eval_mmlu_stats(dirs, capsys, tmp_path):
    """main(argv, stats=dict): the predictions it scored in work order
    (their hits add up to the report's), the batches by bucket, and the
    first batch, whose letters the logits function gives again."""
    argv = ["--pretrained_dir", dirs["gpt2"], "--mmlu_root", dirs["syn"],
            "--max_items", "1", "--eval_batch", "8", "--device", "cpu"]
    stats = {}
    _, report = _run(lambda a: cli.main(a, stats=stats), argv, capsys,
                     str(tmp_path / "p.json"))
    pf = cli.setup_family(cli.build_parser().parse_args(argv), "cpu")
    work, _ = mmlu.materialize_work(mmlu.load_split(dirs["syn"], "test"),
                                    pf[3].encode, max_items_per_subject=1,
                                    max_len=pf[5])
    preds = stats["predictions"]
    assert len(preds) == report["total_items"] == len(work) == 57
    assert sum(p == w[3].answer for p, w in zip(preds, work)) == \
        sum(v["correct"] for v in report["per_subject"].values())
    buckets = collections.Counter(mmlu.bucket_for(len(w[4]), max_len=pf[5])
                                  for w in work)
    assert stats["batches_by_bucket"] == {
        S: -(-n // 8) for S, n in sorted(buckets.items())}
    assert stats["scoring_s"] > 0 and stats["items_per_s"] > 0
    ids, last = stats["first_batch"]
    S = min(buckets)
    assert ids.shape == (8, S)
    first = [j for j, w in enumerate(work)
             if mmlu.bucket_for(len(w[4]), max_len=pf[5]) == S][:8]
    letters = mmlu.letter_token_ids(pf[3].encode)
    rows = cli.make_batched_logits_fn(*pf[:3], pf[6], pf[7],
                                      columns=letters)(ids, last)
    assert [mmlu.restricted_argmax(rows[r], letters)
            for r in range(len(first))] == [preds[j] for j in first]


def test_eval_mmlu_refuses_what_is_not_ported(dirs):
    base = ["--pretrained_dir", dirs["gpt2"], "--mmlu_root", dirs["mmlu"]]
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(base)
    # the telemetry stream, the memory preflight and the run registry are
    # ported
    stream = os.path.join(str(dirs["root"]), "mmlu_ported.jsonl")
    registry = os.path.join(str(dirs["root"]), "mmlu_reg.jsonl")
    assert cli.main(base + ["--device", "cpu", "--max_items", "1",
                            "--telemetry_out", stream,
                            "--run_registry", registry,
                            "--on_oom_risk", "fail",
                            "--hbm_cap_mb", "100000"]) == 0
    events = [json.loads(line)["event"] for line in open(stream)]
    assert events == ["run_start", "run", "mem_check", "eval", "run",
                      "run_end"]
    recs = [json.loads(line) for line in open(registry)]
    assert [(r["phase"], r["status"], r["tool"]) for r in recs] == [
        ("start", "running", "eval_mmlu"), ("end", "ok", "eval_mmlu")]
