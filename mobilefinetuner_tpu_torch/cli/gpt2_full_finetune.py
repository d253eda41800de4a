"""GPT-2 full fine-tuning on WikiText-2, every parameter trainable (port of
mobilefinetuner_tpu/cli/gpt2_full_finetune.py: the same flags, log lines,
metrics CSV, HF-keyed model file and `.opt` sidecar, plus `--device`).

    python -m mobilefinetuner_tpu_torch.cli.gpt2_full_finetune \\
        --pretrained_dir /path/gpt2 --data_dir /path/wikitext-2 \\
        --steps 10 --output_path out/model.safetensors

The parameters themselves are the trainable tree (make_train_step with
no mask and no frozen tree). The embedding table `wte` is tied to the
head, so its gradient sums the embedding gather's and the head's:
autograd adds the two. The loss is the full-logits
ops/loss.lm_cross_entropy_sum over [B, S, V]. On the card a step runs the
flash-attention forward and merged backward kernels in every layer, with
the attention-dropout hash mask when the checkpoint's attn_pdrop is on
(`--no_model_dropout` turns the embd / resid / attn dropout off). A save
writes `<root>_step<N><ext>` (every --save_every steps) or
--output_path (the last step), and its `.opt` sidecar with `loop_step`.

A save snapshots the params and the optimizer state to the host and
writes them on the checkpointer's thread (`--async_save 1`; 0 writes
inline, the same bytes), recording each file in
`<output_path>.lineage.json` (`--keep_ckpts`); `--resume_from` falls back
down that lineage past a corrupt file, and `--rollback_budget` rolls back
to it in process. The memory ladder has the remat and accum_x2 rungs.
Not here: the JAX CLI's in-loop MFU estimate
(core/telemetry.transformer_flops, ROADMAP.md port item P6); the mesh
raises NotImplementedError (cli/common.py).
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
from mobilefinetuner_tpu_torch.io.checkpoints import (gpt2_params_from_hf,
                                                      load_gpt2, save_gpt2)
from mobilefinetuner_tpu_torch.models import gpt2
from mobilefinetuner_tpu_torch.ops.loss import lm_cross_entropy_sum
from mobilefinetuner_tpu_torch.optim import adam as adam_mod

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpt2_full_finetune",
        description="GPT-2 full fine-tuning on WikiText-2 (PyTorch port)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--pretrained_dir", required=True)
    p.add_argument("--output_path", default="gpt2_full_ft.safetensors")
    p.add_argument("--resume_from", default="",
                   help="full-model safetensors to resume from")
    p.add_argument("--eval_out", default="")
    common.add_train_flags(p, lr=5e-5, seq_len=128, batch_size=1)
    common.add_pm_flags(p)
    common.add_mesh_flags(p)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.check_not_ported(args)
    device = common.setup_device(args)
    config, params_np = load_gpt2(args.pretrained_dir)
    if args.no_model_dropout:
        config = dataclasses.replace(config, embd_pdrop=0.0,
                                     resid_pdrop=0.0, attn_pdrop=0.0)
    if args.resume_from:
        common.resolve_resume_from(args)
        params_np = gpt2_params_from_hf(
            common.load_full_resume(args.resume_from), config)
        log.info(f"resumed full model from {args.resume_from}")
    if args.seq_len > config.n_positions:
        args.seq_len = config.n_positions
    params = convert.gpt2_params_from_numpy(params_np, device=device)

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
    n_params = sum(t.numel() for t in adam_mod.flatten(params).values())
    log.info(f"full FT: {n_params:,} trainable params, "
             f"{total_steps} steps")
    opt_state, start_step = common.maybe_resume_opt_state(args, params, tc,
                                                          None)
    compute_dtype = common.compute_dtype_from_args(args)
    attn_impl = common.attn_impl_from_args(args)
    model_pdrop = max(config.embd_pdrop, config.resid_pdrop,
                      config.attn_pdrop)
    dropout_seed = args.seed + 1 if model_pdrop > 0 else None

    def loss_fn(params_t, _unused, mb):
        seed = int(mb["dropout_seed"][0]) if "dropout_seed" in mb else None
        logits = gpt2.forward(config, params_t, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=args.remat,
                              dropout_seed=seed)
        return lm_cross_entropy_sum(logits, mb["labels"])

    def nll_fn(params_t, _unused, mb):
        logits = gpt2.forward(config, params_t, mb["input_ids"],
                              attention_mask=mb["attention_mask"],
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl)
        return lm_cross_entropy_sum(logits, mb["labels"])

    def save_hook(step, params_t, opt_st, final, ckpt=None):
        path = args.output_path
        if not final:
            root, ext = os.path.splitext(path)
            path = f"{root}_step{step}{ext}"
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        # the loop's only stall is the batched copy to the host; the key
        # map and the writes of the model and its 2x-params .opt run on
        # the checkpointer's thread
        (params_h, opt_h), snap_ms = async_ckpt.timed_snapshot(
            (params_t, opt_st))

        def write():
            save_gpt2(path, params_h)
            adam_mod.save_state(path + ".opt", opt_h, tc.adam(),
                                extra_metadata={"loop_step": str(step)})
            common.record_ckpt_files(args, args.output_path, step,
                                     [path, path + ".opt"])
            log.info(f"saved full model -> {path}")
            return [path, path + ".opt"]

        async_ckpt.submit(ckpt, step, write, final=final,
                          snapshot_ms=snap_ms)

    def load_trainable(path):
        """The rollback's inverse of save_hook: the HF-keyed model file
        -> the stacked tree on the run's device."""
        return convert.gpt2_params_from_numpy(
            gpt2_params_from_hf(common.load_full_resume(path), config),
            device=device)

    common.run_training(
        args, trainable=params, frozen=None, loss_fn=loss_fn,
        nll_fn=nll_fn, train_ds=train_ds, valid_ds=valid_ds,
        total_steps=total_steps, tc=tc, mask=None, start_step=start_step,
        opt_state=opt_state, save_hook=save_hook, dropout_seed=dropout_seed,
        device=device,
        load_hook=common.make_rollback_loader(tc, None, load_trainable),
        ckpt_path=args.output_path,
        footprint=mg.gpt2_footprint(config, compute_dtype, args.seq_len),
        compute_dtype=compute_dtype,
        # in-loop MFU from the JAX CLI's estimate (core/telemetry.py)
        flops_per_step=common.step_flops(
            args, tc, params, None, config.n_layer, config.n_head,
            config.head_dim, full_ft=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
