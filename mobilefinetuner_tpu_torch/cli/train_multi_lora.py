"""Multi-tenant LoRA training CLI: k adapter jobs, one base forward
(port of mobilefinetuner_tpu/cli/train_multi_lora.py: the same flags and
defaults, plus `--device`).

Drives mobilefinetuner_tpu_torch/multitenant/ from a declarative jobs
file (multitenant/jobspec.py): every per-job quantity (LR schedule, step
budget, adapter alpha, seeds, save path and checkpoint policy) is data
the engine multiplexes through one train step, so k adapters fine-tune
against one frozen base.

Usage:
  python -m mobilefinetuner_tpu_torch.cli.train_multi_lora \
      --jobs jobs.json --pretrained_dir /path/gpt2 \
      --data_dir /path/wikitext-2 --slots 4 --out_dir out/ [--device cpu]

Jobs file (JSON or TOML):
  {"family": "gpt2",
   "defaults": {"rank": 8, "steps": 200},
   "jobs": [{"name": "alice", "lr": 1e-4, "seed": 1},
            {"name": "bob", "lr": 3e-4, "alpha": 32.0}]}
"""

from __future__ import annotations

import argparse
import sys

from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.cli.family import load_family
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.core.telemetry import Telemetry
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)
from mobilefinetuner_tpu_torch.multitenant import (EngineConfig,
                                                   MultiTenantEngine,
                                                   load_jobs_file)

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train_multi_lora",
        description="k concurrent LoRA jobs through one shared base "
                    "forward (multitenant/)")
    p.add_argument("--jobs", required=True,
                   help="jobs file (.json or .toml) — family, defaults, "
                        "and the per-job specs (multitenant/jobspec.py)")
    p.add_argument("--pretrained_dir", required=True,
                   help="HF checkpoint dir of the SHARED frozen base")
    p.add_argument("--data_dir", required=True,
                   help="WikiText-2 directory (per-job streams differ "
                        "by each job's data_seed/data_fraction)")
    p.add_argument("--out_dir", default="multi_lora_out",
                   help="save root for jobs without an explicit "
                        "save_path")
    g = p.add_argument_group("engine (fixes the shared step)")
    g.add_argument("--slots", type=int, default=4,
                   help="concurrent tenant slots; pending jobs refill "
                        "freed slots in place")
    g.add_argument("--batch_size", type=int, default=1,
                   help="micro-batch rows EACH tenant contributes per "
                        "accumulation slice")
    g.add_argument("--grad_accum_steps", "--grad_accum", type=int,
                   default=1)
    g.add_argument("--seq_len", type=int, default=128)
    g.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    g.add_argument("--lr_schedule",
                   choices=["cosine", "linear", "constant"],
                   default="cosine",
                   help="schedule SHAPE (engine-wide; per-job peak LR/"
                        "warmup/budget are data)")
    g.add_argument("--min_lr_ratio", type=float, default=0.1)
    g.add_argument("--clip_grad_norm", type=float, default=1.0,
                   help="per-tenant clip: each slot clips by ITS OWN "
                        "global norm, exactly like a solo run")
    g.add_argument("--weight_decay", type=float, default=0.0)
    g.add_argument("--lora_impl", choices=["auto", "naive", "fused"],
                   default="auto")
    g.add_argument("--skip_nonfinite", type=int, default=0,
                   help="1 = per-slot guarded update: a tenant whose "
                        "grads go non-finite skips ITS update only — "
                        "the other k-1 tenants' updates apply")
    g.add_argument("--prefetch", type=int, default=2,
                   help="per-tenant bounded input queue depth (0 = "
                        "synchronous); a stalled tenant stream cannot "
                        "starve the others or grow unbounded memory")
    g.add_argument("--log_interval", type=int, default=10,
                   help="metrics flush cadence in engine steps")
    g.add_argument("--async_save", type=int, default=1,
                   help="1 = finished adapters save through the "
                        "background writer (io/async_ckpt.py); 0 = "
                        "synchronous oracle")
    g.add_argument("--telemetry_out", default="",
                   help="JSONL event stream: tenant lifecycle events + "
                        "per-tenant step_stats sections "
                        "(tools/telemetry_report.py renders a tenants "
                        "table)")
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = common.setup_device(args)
    family, jobs = load_jobs_file(args.jobs)
    log.info(f"jobs file: {len(jobs)} {family} job(s) "
             f"({', '.join(j.name for j in jobs)})")

    bundle = load_family(args.pretrained_dir, family=family, device=device)
    config = bundle.config
    if args.seq_len > bundle.max_len:
        log.warning(f"seq_len({args.seq_len}) > model max "
                    f"({bundle.max_len}), clamped")
        args.seq_len = bundle.max_len
    tok = bundle.tok

    def make_stream(spec):
        """One tenant's step-batch stream: its OWN seeded epoch shuffle
        and data fraction over the shared corpus, assembled exactly
        like a solo run's (cli/common.micro_batches) — the per-tenant
        half of the k-vs-solo parity oracle."""
        wt2 = WT2Config(seq_len=args.seq_len,
                        batch_size=args.batch_size,
                        data_fraction=spec.data_fraction,
                        seed=spec.data_seed)
        ds = WikiText2Dataset(args.data_dir, "train", wt2, tok.encode,
                              tok.eos_id)

        def gen():
            for _epoch, batch in common.micro_batches(
                    ds, args.grad_accum_steps):
                yield batch
        return gen()

    cfg = EngineConfig(
        slots=args.slots, rows_per_tenant=args.batch_size,
        grad_accum_steps=args.grad_accum_steps, seq_len=args.seq_len,
        dtype=args.dtype, clip_grad_norm=args.clip_grad_norm,
        weight_decay=args.weight_decay, schedule=args.lr_schedule,
        min_lr_ratio=args.min_lr_ratio, lora_impl=args.lora_impl,
        skip_nonfinite=bool(args.skip_nonfinite),
        prefetch=args.prefetch, flush_every=args.log_interval,
        async_save=bool(args.async_save), out_dir=args.out_dir)

    tel = Telemetry(args.telemetry_out) if args.telemetry_out else None
    with MultiTenantEngine(family, config, bundle.params, jobs,
                           make_stream, cfg, telemetry=tel,
                           device=device) as eng:
        eng.run()
        for name, t in eng.tenants.items():
            log.info(f"  {name}: {t.status} @ step {t.steps_done} "
                     f"({t.tokens} tokens"
                     + (f", loss {t.last_loss:.4f}" if t.last_loss
                        is not None else "")
                     + f") -> {t.save_path}")
        retraces = eng.total_traces()
    log.info(f"multi-tenant run complete ({retraces} total traces)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
