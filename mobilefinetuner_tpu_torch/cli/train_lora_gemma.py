"""Gemma-3 LoRA fine-tuning on WikiText-2 (port of
mobilefinetuner_tpu/cli/train_lora_gemma.py: the same flags, log lines,
metrics CSV, adapter, `.opt` and PEFT files, plus `--device`).

    python -m mobilefinetuner_tpu_torch.cli.train_lora_gemma \\
        --model_dir /path/gemma-3-270m --data_dir /path/wikitext-2 \\
        --max_steps 20 --batch 4 --seq_len 256 --dtype bfloat16 \\
        --output_dir out/

The 262,144-entry tied head runs through the chunked loss
(ops/loss.chunked_lm_cross_entropy_sum, `--loss_chunks` sequence chunks),
so the [B, S, V] logits never exist. On the card (the default device) a
step runs the flash-attention forward and merged backward kernels in
every layer (D = 256, GQA, the 512-token window on local layers), the
LoRA epilogue kernel at every adapter site, and the fused CE forward and
dh kernels in every loss chunk (the head is frozen, so no dW). The opt-in
`lm_head` target (`--lora_targets full,lm_head`, or a list) rides the
chunked loss as its `lora_head`: the head-adapter kernels (forward, dh
with dxa, dbt) in every chunk in place of the base ones, with
`--lora_dropout` on its branch input as at every layer site.
`--device cpu --dtype float32` runs the same loop on the host through the
kernels' plain versions. Saves are snapshot-then-write (io/async_ckpt),
recorded in `<output_dir>/gemma_lora.safetensors.lineage.json` for
`--resume_from`'s fallback and `--rollback_budget`. Flags of features
the port does not have yet raise NotImplementedError (cli/common.py).
"""

from __future__ import annotations

import argparse
import os
import sys

from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.io import async_ckpt
from mobilefinetuner_tpu_torch.io.checkpoints import load_gemma3
from mobilefinetuner_tpu_torch.lora import peft_io
from mobilefinetuner_tpu_torch.lora.lora import (GEMMA_PRESETS, LoRASpec,
                                                 init_lora_gemma3,
                                                 num_trainable,
                                                 trainable_mask)
from mobilefinetuner_tpu_torch.models import gemma3
from mobilefinetuner_tpu_torch.ops.loss import chunked_lm_cross_entropy_sum
from mobilefinetuner_tpu_torch.optim import adam as adam_mod

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train_lora_gemma",
        description="Gemma-3 LoRA fine-tuning on WikiText-2 (PyTorch port)")
    p.add_argument("--model_dir", required=True,
                   help="HF Gemma-3 checkpoint dir")
    p.add_argument("--data_dir", default="",
                   help="WikiText-2 directory (or use --pretokenized_path)")
    p.add_argument("--output_dir", default="gemma_lora_out")
    p.add_argument("--resume_from", default="",
                   help="adapter safetensors to resume from (its .opt "
                        "sidecar restores the optimizer and the step)")
    p.add_argument("--eval_out", default="")
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=32.0)
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--targets", default="full", choices=list(GEMMA_PRESETS),
                   help="target preset")
    p.add_argument("--lora_targets", default="",
                   help="comma list overriding --targets (q_proj,k_proj,"
                        "v_proj,o_proj,gate_proj,up_proj,down_proj,lm_head; "
                        "a preset name expands in place, e.g. full,lm_head)")
    p.add_argument("--pretokenized_path", default="",
                   help="pretokenized .bin (train split; "
                        "data/wikitext2.pretokenize writes one)")
    p.add_argument("--pretokenized_meta", default="",
                   help="(accepted for reference-CLI compat; the .bin's "
                        "sidecar meta.json is found automatically)")
    p.add_argument("--loss_chunks", type=int, default=8,
                   help="sequence chunks of the 262k-vocab chunked CE")
    p.add_argument("--peft_export_dir", default="")
    common.add_align_flags(p)
    p.add_argument("--max_steps", type=int, default=0,
                   help="alias of --steps")
    common.add_train_flags(p, lr=1e-4, seq_len=256, batch_size=1)
    common.add_pm_flags(p)
    common.add_shard_flags(p)
    common.add_mesh_flags(p)
    common.add_device_flag(p)
    p.add_argument("--batch", type=int, default=None,
                   help="alias of --batch_size")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch is not None:
        args.batch_size = args.batch
    if args.max_steps and not args.steps:
        args.steps = args.max_steps
    common.check_not_ported(args)
    device = common.setup_device(args)
    config, params_np = load_gemma3(args.model_dir)
    log.info(f"Gemma-3: layers={config.num_hidden_layers} "
             f"hidden={config.hidden_size} vocab={config.vocab_size} "
             f"q/kv heads={config.num_attention_heads}/"
             f"{config.num_key_value_heads}")
    params = convert.gemma3_params_from_numpy(params_np, device=device)

    if args.resume_from:
        common.resolve_resume_from(args)
        lora, spec = peft_io.load_adapter(args.resume_from, device=device)
        log.info(f"resumed adapter: r={spec.rank} targets={spec.targets}")
    else:
        # a preset name within --lora_targets expands in place
        # ("full,lm_head"); the JAX CLI takes target names only
        targets = [x for t in args.lora_targets.split(",") if t
                   for x in GEMMA_PRESETS.get(t, [t])] \
            or GEMMA_PRESETS[args.targets]
        spec = LoRASpec(rank=args.rank, alpha=args.alpha,
                        dropout=args.lora_dropout, targets=targets,
                        init="peft")
        lora = init_lora_gemma3(config, spec, seed=args.seed, device=device)
    mask = trainable_mask(lora)
    log.info(f"trainable params: {num_trainable(lora):,}")

    train_ds, valid_ds = common.gemma_datasets(args)
    steps_per_epoch = max(train_ds.num_batches() // args.grad_accum_steps, 1)
    total_steps = common.resolve_total_steps(args, steps_per_epoch)
    tc = common.train_config_from_args(args, total_steps)
    log.info(f"{train_ds.num_chunks} chunks, {total_steps} total steps")
    opt_state, start_step = common.maybe_resume_opt_state(args, lora, tc,
                                                          mask)
    compute_dtype = common.compute_dtype_from_args(args)
    attn_impl = common.attn_impl_from_args(args)
    dropout_seed = args.seed + 1 if args.lora_dropout > 0 else None

    def nll(lora_t, frozen, mb, train):
        seed = (int(mb["dropout_seed"][0])
                if train and "dropout_seed" in mb else None)
        hidden = gemma3.hidden_states(
            config, frozen, mb["input_ids"],
            attention_mask=mb["attention_mask"], lora=lora_t,
            compute_dtype=compute_dtype, remat=train and args.remat,
            lora_dropout=args.lora_dropout if train else 0.0,
            dropout_seed=seed, attn_impl=attn_impl,
            lora_impl=args.lora_impl)
        # the tied head; an "lm_head" adapter rides the chunked loss as
        # lora_head, its branch input dropped like every layer site's
        return chunked_lm_cross_entropy_sum(
            hidden, frozen["embed"], mb["labels"],
            num_chunks=args.loss_chunks,
            lora_head=lora_t["blocks"].get("lm_head"),
            lora_impl=args.lora_impl,
            lora_dropout=args.lora_dropout if train else 0.0,
            dropout_seed=seed)

    final_path = os.path.join(args.output_dir, "gemma_lora.safetensors")

    def save_hook(step, lora_t, opt_st, final, ckpt=None):
        os.makedirs(args.output_dir, exist_ok=True)
        name = ("gemma_lora.safetensors" if final
                else f"gemma_lora_step{step}.safetensors")
        path = os.path.join(args.output_dir, name)
        (lora_h, opt_h), snap_ms = async_ckpt.timed_snapshot(
            (lora_t, opt_st))

        def write():
            peft_io.save_adapter(path, lora_h, spec)
            adam_mod.save_state(path + ".opt", opt_h, tc.adam(),
                                extra_metadata={"loop_step": str(step)})
            common.record_ckpt_files(args, final_path, step,
                                     [path, path + ".opt"])
            log.info(f"saved adapter -> {path}")
            if final and args.peft_export_dir:
                peft_io.export_peft(args.peft_export_dir, lora_h, spec,
                                    "gemma", base_model_name=args.model_dir)
                log.info(f"PEFT export -> {args.peft_export_dir}")
            return [path, path + ".opt"]

        async_ckpt.submit(ckpt, step, write, final=final,
                          snapshot_ms=snap_ms)

    common.run_training(
        args, trainable=lora, frozen=params,
        loss_fn=lambda t, f, mb: nll(t, f, mb, True),
        nll_fn=lambda t, f, mb: nll(t, f, mb, False),
        train_ds=train_ds, valid_ds=valid_ds, total_steps=total_steps,
        tc=tc, mask=mask, start_step=start_step, opt_state=opt_state,
        save_hook=save_hook, dropout_seed=dropout_seed, device=device,
        load_hook=common.make_rollback_loader(
            tc, mask, lambda p: peft_io.load_adapter(p, device=device)[0]),
        ckpt_path=final_path,
        footprint=mg.gemma3_footprint(config, compute_dtype, args.seq_len,
                                      args.loss_chunks, head_trains=False),
        compute_dtype=compute_dtype,
        # in-loop MFU from the JAX CLI's estimate (core/telemetry.py)
        flops_per_step=common.step_flops(
            args, tc, lora, params, config.num_hidden_layers,
            config.num_attention_heads, config.head_dim, full_ft=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
