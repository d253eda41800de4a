"""Declarative LoRA training-job specs: the multi-tenant engine's
admission interface (port of mobilefinetuner_tpu/multitenant/jobspec.py,
the same file format, fields, defaults and error messages; pure Python).

A jobs file describes k independent adapter fine-tuning jobs against ONE
shared frozen base — each job is pure DATA (rank/targets/alpha/dropout,
LR schedule, data stream config, save path + checkpoint policy, step
budget), which is exactly what lets a scheduler multiplex them: the
multi-tenant engine admits JobSpecs into fixed slots, and everything
that differs between jobs rides the shared step as tensors.

File format (JSON, or TOML via the stdlib tomllib):

    {
      "family": "gpt2",                  # gpt2 | gemma (one base model)
      "defaults": {"rank": 8, "steps": 200, ...},   # optional
      "jobs": [
        {"name": "alice", "lr": 1e-4, "seed": 1,
         "save_path": "out/alice.safetensors"},
        {"name": "bob",   "lr": 3e-4, "alpha": 32.0, "steps": 120}
      ]
    }

Shared-vs-per-job split (the stack_adapters constraint and the one shared
step): `rank`, `targets`, and `dropout` must agree across every
job in a file — the adapter bank stacks [k, r, d] factors, so a rank or
target-set mismatch has no slot to live in (validate_jobs raises naming
the offender). `alpha` (scale stacks to [k]), `lr`, `warmup_ratio`,
`steps`, seeds, and the save/checkpoint policy are all per-job data.
The schedule SHAPE (cosine/linear/constant) is engine-wide.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from mobilefinetuner_tpu_torch.lora.lora import LoRASpec


@dataclasses.dataclass
class JobSpec:
    """One adapter job, as data. Everything a slot needs to train,
    checkpoint, and export one tenant's adapter."""
    name: str
    # adapter shape (rank/targets/dropout must match the file's other
    # jobs — the stacked-bank constraint; alpha is per-job data)
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    targets: Optional[List[str]] = None      # None = family default
    init: str = ""                           # "" = family default
    # optimization (per-job data riding the shared step)
    lr: float = 1e-4
    warmup_ratio: float = 0.0
    steps: int = 100                         # step budget; job finishes here
    # data stream config
    seed: int = 0                            # adapter-init seed
    data_seed: int = 0                       # per-epoch shuffle seed
    data_fraction: float = 1.0
    # artifacts + checkpoint policy
    save_path: str = ""                      # "" = <out_dir>/<name>.safetensors
    save_every: int = 0                      # periodic step-tagged saves
    keep_ckpts: int = 0                      # lineage GC (0 = keep all)
    peft_export_dir: str = ""                # also export HF-PEFT layout

    def lora_spec(self, default_init: str) -> LoRASpec:
        return LoRASpec(rank=self.rank, alpha=self.alpha,
                        dropout=self.dropout, targets=self.targets,
                        init=self.init or default_init)

    def resolved_save_path(self, out_dir: str) -> str:
        if self.save_path:
            return self.save_path
        return os.path.join(out_dir or ".", f"{self.name}.safetensors")


_JOB_FIELDS = {f.name for f in dataclasses.fields(JobSpec)}


def _job_from_dict(raw: dict, defaults: dict, index: int) -> JobSpec:
    merged = {**defaults, **raw}
    unknown = sorted(set(merged) - _JOB_FIELDS)
    if unknown:
        raise ValueError(
            f"job #{index} ({merged.get('name', '?')!r}) has unknown "
            f"field(s) {unknown}; valid: {sorted(_JOB_FIELDS)}")
    if not merged.get("name"):
        raise ValueError(f"job #{index} is missing a name")
    spec = JobSpec(**merged)
    if spec.rank < 1 or spec.steps < 1:
        raise ValueError(
            f"job {spec.name!r}: rank and steps must be >= 1 "
            f"(got rank={spec.rank}, steps={spec.steps})")
    if spec.dropout < 0 or spec.dropout >= 1:
        raise ValueError(
            f"job {spec.name!r}: dropout must be in [0, 1), "
            f"got {spec.dropout}")
    return spec


def validate_jobs(jobs: List[JobSpec]) -> None:
    """The stacked-bank constraints: unique names; rank/targets/dropout
    shared across every job (a [k, r, d] bank has exactly one r and one
    target set; dropout is a constant of the shared step)."""
    if not jobs:
        raise ValueError("jobs file declares no jobs")
    seen: Dict[str, int] = {}
    for i, j in enumerate(jobs):
        if j.name in seen:
            raise ValueError(
                f"duplicate job name {j.name!r} (jobs #{seen[j.name]} "
                f"and #{i})")
        seen[j.name] = i
    ref = jobs[0]
    for j in jobs[1:]:
        for field, shared in (("rank", ref.rank),
                              ("targets", ref.targets),
                              ("dropout", ref.dropout)):
            got = getattr(j, field)
            if got != shared:
                raise ValueError(
                    f"job {j.name!r} has {field}={got!r} but job "
                    f"{ref.name!r} has {shared!r}: the stacked adapter "
                    f"bank shares one rank/target-set/dropout across "
                    f"all tenants (alpha/lr/steps are per-job) — split "
                    f"mismatched jobs into separate runs")


def parse_jobs(doc: dict) -> Tuple[str, List[JobSpec]]:
    """(family, validated jobs) from a parsed jobs document."""
    family = doc.get("family", "gpt2")
    if family not in ("gpt2", "gemma"):
        raise ValueError(f"family must be gpt2|gemma, got {family!r}")
    raw_jobs = doc.get("jobs")
    if not isinstance(raw_jobs, list) or not raw_jobs:
        raise ValueError("jobs file needs a non-empty 'jobs' list")
    defaults = doc.get("defaults", {})
    if not isinstance(defaults, dict):
        raise ValueError("'defaults' must be a table/object")
    jobs = [_job_from_dict(r, defaults, i) for i, r in enumerate(raw_jobs)]
    validate_jobs(jobs)
    return family, jobs


def load_jobs_file(path: str) -> Tuple[str, List[JobSpec]]:
    """Parse a .json or .toml jobs file -> (family, jobs)."""
    if path.endswith(".toml"):
        import tomllib
        with open(path, "rb") as f:
            doc = tomllib.load(f)
    else:
        with open(path) as f:
            doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: jobs file must be a JSON object / "
                         f"TOML document")
    return parse_jobs(doc)
