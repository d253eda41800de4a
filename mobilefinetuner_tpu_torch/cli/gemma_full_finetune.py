"""Gemma-3 full fine-tuning on WikiText-2, every parameter trainable (port
of mobilefinetuner_tpu/cli/gemma_full_finetune.py: the same flags, log
lines, metrics CSV, HF-keyed model file and `.opt` sidecar, plus
`--device`).

    python -m mobilefinetuner_tpu_torch.cli.gemma_full_finetune \\
        --model_dir /path/gemma-3-270m --data_dir /path/wikitext-2 \\
        --steps 10 --output_path out/gemma_full_ft.safetensors

The parameters themselves are the trainable tree (make_train_step with
no mask and no frozen tree). The embedding table is tied to the head, so
its gradient sums the embedding gather's and the head's: autograd adds
the two. On the card the chunked loss runs the fused CE forward, dh and
dW kernels in every chunk. Saves are snapshot-then-write
(io/async_ckpt), recorded in `<output_path>.lineage.json` for
`--resume_from`'s fallback and `--rollback_budget`; the memory ladder
has the remat and accum_x2 rungs (offload targets a frozen base, and
here every parameter trains). `--opt_offload*` and the mesh raise
NotImplementedError (cli/common.py).
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
from mobilefinetuner_tpu_torch.io.checkpoints import (gemma3_params_from_hf,
                                                      load_gemma3,
                                                      save_gemma3)
from mobilefinetuner_tpu_torch.models import gemma3
from mobilefinetuner_tpu_torch.ops.loss import chunked_lm_cross_entropy_sum
from mobilefinetuner_tpu_torch.optim import adam as adam_mod

log = get_logger()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gemma_full_finetune",
        description="Gemma-3 full fine-tuning on WikiText-2 (PyTorch port)")
    p.add_argument("--model_dir", required=True,
                   help="HF Gemma-3 checkpoint dir")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_path", default="gemma_full_ft.safetensors")
    p.add_argument("--resume_from", default="",
                   help="full-model safetensors (or HF dir) to resume from")
    p.add_argument("--eval_out", default="")
    p.add_argument("--loss_chunks", type=int, default=8,
                   help="sequence chunks of the 262k-vocab chunked CE")
    p.add_argument("--opt_offload", action="store_true",
                   help="not ported yet")
    p.add_argument("--opt_offload_state_dtype", default="float32",
                   choices=["float32", "bfloat16", "float16"],
                   help="not ported yet")
    p.add_argument("--opt_offload_master_dtype", default="float32",
                   choices=["float32", "bfloat16"], help="not ported yet")
    common.add_train_flags(p, lr=2e-5, seq_len=256, batch_size=1)
    common.add_pm_flags(p)
    common.add_mesh_flags(p)
    common.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    common.check_not_ported(args)
    device = common.setup_device(args)
    config, params_np = load_gemma3(args.model_dir)
    log.info(f"Gemma-3 full FT: layers={config.num_hidden_layers} "
             f"hidden={config.hidden_size} vocab={config.vocab_size}")
    if args.no_model_dropout:
        log.warning("--no_model_dropout is a no-op for Gemma-3 "
                    "(the config has no dropout fields)")
    if args.resume_from:
        common.resolve_resume_from(args)
        params_np = gemma3_params_from_hf(
            common.load_full_resume(args.resume_from), config)
        log.info(f"resumed full model from {args.resume_from}")
    if args.seq_len > config.max_position_embeddings:
        args.seq_len = config.max_position_embeddings
    params = convert.gemma3_params_from_numpy(params_np, device=device)

    train_ds, valid_ds = common.gemma_datasets(args)
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

    def nll(params_t, _unused, mb, train):
        hidden = gemma3.hidden_states(
            config, params_t, mb["input_ids"],
            attention_mask=mb["attention_mask"],
            compute_dtype=compute_dtype, remat=train and args.remat,
            attn_impl=attn_impl)
        return chunked_lm_cross_entropy_sum(
            hidden, params_t["embed"], mb["labels"],
            num_chunks=args.loss_chunks)

    def save_hook(step, params_t, opt_st, final, ckpt=None):
        path = args.output_path
        if not final:
            root, ext = os.path.splitext(path)
            path = f"{root}_step{step}{ext}"
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        (params_h, opt_h), snap_ms = async_ckpt.timed_snapshot(
            (params_t, opt_st))

        def write():
            save_gemma3(path, params_h)
            adam_mod.save_state(path + ".opt", opt_h, tc.adam(),
                                extra_metadata={"loop_step": str(step)})
            common.record_ckpt_files(args, args.output_path, step,
                                     [path, path + ".opt"])
            log.info(f"saved full model -> {path}")
            return [path, path + ".opt"]

        async_ckpt.submit(ckpt, step, write, final=final,
                          snapshot_ms=snap_ms)

    def load_trainable(path):
        """The rollback's inverse of save_hook."""
        return convert.gemma3_params_from_numpy(
            gemma3_params_from_hf(common.load_full_resume(path), config),
            device=device)

    common.run_training(
        args, trainable=params, frozen=None,
        loss_fn=lambda t, f, mb: nll(t, f, mb, True),
        nll_fn=lambda t, f, mb: nll(t, f, mb, False),
        train_ds=train_ds, valid_ds=valid_ds, total_steps=total_steps,
        tc=tc, mask=None, start_step=start_step, opt_state=opt_state,
        save_hook=save_hook, device=device,
        load_hook=common.make_rollback_loader(tc, None, load_trainable),
        ckpt_path=args.output_path,
        footprint=mg.gemma3_footprint(config, compute_dtype, args.seq_len,
                                      args.loss_chunks, head_trains=True),
        compute_dtype=compute_dtype,
        # in-loop MFU from the JAX CLI's estimate (core/telemetry.py)
        flops_per_step=common.step_flops(
            args, tc, params, None, config.num_hidden_layers,
            config.num_attention_heads, config.head_dim, full_ft=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
