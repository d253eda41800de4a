"""GPT-2 LoRA fine-tuning on WikiText-2 (port of
mobilefinetuner_tpu/cli/gpt2_lora_finetune.py: the same flags, log lines,
metrics CSV, adapter and `.opt` files, plus `--device`).

    python -m mobilefinetuner_tpu_torch.cli.gpt2_lora_finetune \\
        --pretrained_dir /path/gpt2 --data_dir /path/wikitext-2 \\
        --steps 30 --batch_size 8 --grad_accum_steps 2 --dtype bfloat16 \\
        --lora_out out/adapter.safetensors

On the card (the default device) the step runs the flash-attention
forward and backward kernels at every layer and the LoRA epilogue kernel
at every adapter site. `--device cpu --dtype float32` runs the same loop
on the host through the kernels' plain versions. Saves go through
io/async_ckpt (snapshot, then the write on a background thread under
`--async_save 1`) and are recorded in `<lora_out>.lineage.json`, which
`--resume_from` falls back down and `--rollback_budget` rolls back to;
the memory ladder and the fault injection come from cli/common.py.
Flags of features the port does not have yet raise NotImplementedError
(cli/common.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from mobilefinetuner_tpu_torch import convert
from mobilefinetuner_tpu_torch.cli import common
from mobilefinetuner_tpu_torch.core import memory_guard as mg
from mobilefinetuner_tpu_torch.core.logging import get_logger
from mobilefinetuner_tpu_torch.data.tokenizer_bpe import GPT2BPETokenizer
from mobilefinetuner_tpu_torch.data.wikitext2 import (WikiText2Dataset,
                                                      WT2Config)
from mobilefinetuner_tpu_torch.io import async_ckpt
from mobilefinetuner_tpu_torch.io.checkpoints import load_gpt2
from mobilefinetuner_tpu_torch.lora import peft_io
from mobilefinetuner_tpu_torch.lora.lora import (LoRASpec, init_lora_gpt2,
                                                 num_trainable,
                                                 trainable_mask)
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
from mobilefinetuner_tpu_torch.optim import adam as adam_mod

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpt2_lora_finetune",
        description="GPT-2 LoRA fine-tuning on WikiText-2 (PyTorch port)")
    p.add_argument("--data_dir", required=True,
                   help="WikiText-2 directory (wiki.{train,valid}.tokens)")
    p.add_argument("--pretrained_dir", required=True,
                   help="HF GPT-2 checkpoint dir (config.json, "
                        "model.safetensors, vocab.json, merges.txt)")
    p.add_argument("--lora_out", default="gpt2_lora.safetensors")
    p.add_argument("--resume_from", default="",
                   help="adapter safetensors to resume from (its .opt "
                        "sidecar restores the optimizer and the step)")
    p.add_argument("--eval_out", default="", help="eval JSONL output path")
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=16.0)
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--lora_targets", default="attn_qkv,attn_proj",
                   help="comma list of attn_qkv,attn_proj,mlp_fc_in,"
                        "mlp_fc_out,attn_q,attn_k,attn_v,lm_head")
    p.add_argument("--split_qkv", action="store_true",
                   help="replace the fused attn_qkv target with separate "
                        "q/k/v column-range adapters")
    p.add_argument("--peft_export_dir", default="",
                   help="also export an HF-PEFT adapter directory")
    common.add_align_flags(p)
    common.add_train_flags(p, lr=1e-4, seq_len=128, batch_size=1)
    common.add_pm_flags(p)
    common.add_shard_flags(p)
    common.add_mesh_flags(p)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.check_not_ported(args)
    if args.split_qkv and args.peft_export_dir:
        raise SystemExit("--split_qkv adapters have no PEFT "
                         "representation; drop --peft_export_dir "
                         "(the native adapter format supports them)")
    device = common.setup_device(args)
    config, params_np = load_gpt2(args.pretrained_dir)
    if args.no_model_dropout:
        config = dataclasses.replace(config, embd_pdrop=0.0,
                                     resid_pdrop=0.0, attn_pdrop=0.0)
    if args.seq_len > config.n_positions:
        log.warning(f"seq_len({args.seq_len}) > n_positions"
                    f"({config.n_positions}), clamped")
        args.seq_len = config.n_positions
    log.info(f"GPT-2: layers={config.n_layer} hidden={config.n_embd} "
             f"heads={config.n_head}")
    params = convert.gpt2_params_from_numpy(params_np, device=device)

    if args.resume_from:
        # verified first; a corrupt file falls back down its lineage
        common.resolve_resume_from(args)
        lora, spec = peft_io.load_adapter(args.resume_from, device=device)
        log.info(f"resumed adapter: r={spec.rank} alpha={spec.alpha} "
                 f"targets={spec.targets}")
    else:
        targets = [t for t in args.lora_targets.split(",") if t]
        if args.split_qkv:
            targets = ["attn_q", "attn_k", "attn_v"] + [
                t for t in targets if t != "attn_qkv"]
        spec = LoRASpec(rank=args.rank, alpha=args.alpha,
                        dropout=args.lora_dropout, targets=targets,
                        init="gpt2")
        lora = init_lora_gpt2(config, spec, seed=args.seed, device=device)
    mask = trainable_mask(lora)
    log.info(f"trainable params: {num_trainable(lora):,}")

    tok = GPT2BPETokenizer.from_pretrained(args.pretrained_dir)
    train_ds = WikiText2Dataset(
        args.data_dir, "train",
        WT2Config(seq_len=args.seq_len, batch_size=args.batch_size,
                  data_fraction=args.data_fraction, seed=args.seed,
                  **common.data_retry_kwargs(args)),
        tok.encode, tok.eos_id)
    valid_ds = None
    if args.eval_interval:
        valid_ds = WikiText2Dataset(
            args.data_dir, "valid",
            WT2Config(seq_len=args.seq_len,
                      batch_size=args.eval_batch_size, shuffle=False,
                      **common.data_retry_kwargs(args)),
            tok.encode, tok.eos_id)

    steps_per_epoch = max(train_ds.num_batches() // args.grad_accum_steps, 1)
    total_steps = common.resolve_total_steps(args, steps_per_epoch)
    tc = common.train_config_from_args(args, total_steps)
    log.info(f"{train_ds.num_chunks} chunks, {steps_per_epoch} steps/epoch, "
             f"{total_steps} total steps")
    opt_state, start_step = common.maybe_resume_opt_state(args, lora, tc,
                                                          mask)
    compute_dtype = common.compute_dtype_from_args(args)
    attn_impl = common.attn_impl_from_args(args)
    model_pdrop = max(config.embd_pdrop, config.resid_pdrop,
                      config.attn_pdrop)
    dropout_seed = (args.seed + 1 if args.lora_dropout > 0
                    or model_pdrop > 0 else None)

    def loss_fn(lora_t, frozen, mb):
        seed = int(mb["dropout_seed"][0]) if "dropout_seed" in mb else None
        logits = gpt2.forward(config, frozen, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              lora=lora_t, compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=args.remat,
                              lora_dropout=args.lora_dropout,
                              dropout_seed=seed, lora_impl=args.lora_impl)
        return lm_cross_entropy_sum(logits, mb["labels"])

    def nll_fn(lora_t, frozen, mb):
        logits = gpt2.forward(config, frozen, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              lora=lora_t, compute_dtype=compute_dtype,
                              attn_impl=attn_impl, lora_impl=args.lora_impl)
        return lm_cross_entropy_sum(logits, mb["labels"])

    def save_hook(step, lora_t, opt_st, final, ckpt=None):
        path = args.lora_out
        if not final:  # _stepN suffix
            root, ext = os.path.splitext(path)
            path = f"{root}_step{step}{ext}"
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        # the blocking part: one batched copy of adapter + optimizer state
        # to the host; the write runs on the checkpointer's thread
        (lora_h, opt_h), snap_ms = async_ckpt.timed_snapshot(
            (lora_t, opt_st))

        def write():
            peft_io.save_adapter(path, lora_h, spec)
            adam_mod.save_state(path + ".opt", opt_h, tc.adam(),
                                extra_metadata={"loop_step": str(step)})
            common.record_ckpt_files(args, args.lora_out, step,
                                     [path, path + ".opt"])
            log.info(f"saved adapter -> {path}")
            if final and args.peft_export_dir:
                peft_io.export_peft(args.peft_export_dir, lora_h, spec,
                                    "gpt2",
                                    base_model_name=args.pretrained_dir)
                log.info(f"PEFT export -> {args.peft_export_dir}")
            return [path, path + ".opt"]

        async_ckpt.submit(ckpt, step, write, final=final,
                          snapshot_ms=snap_ms)

    common.run_training(
        args, trainable=lora, frozen=params, loss_fn=loss_fn, nll_fn=nll_fn,
        train_ds=train_ds, valid_ds=valid_ds, total_steps=total_steps,
        tc=tc, mask=mask, start_step=start_step, opt_state=opt_state,
        save_hook=save_hook, dropout_seed=dropout_seed, device=device,
        # the save hook's inverse: arms --rollback_budget against the
        # lineage at --lora_out
        load_hook=common.make_rollback_loader(
            tc, mask, lambda p: peft_io.load_adapter(p, device=device)[0]),
        ckpt_path=args.lora_out,
        footprint=mg.gpt2_footprint(config, compute_dtype, args.seq_len),
        compute_dtype=compute_dtype,
        # in-loop MFU from the JAX CLI's estimate (core/telemetry.py)
        flops_per_step=common.step_flops(
            args, tc, lora, params, config.n_layer, config.n_head,
            config.head_dim, full_ft=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
