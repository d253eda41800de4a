"""mobilefinetuner_tpu_torch: the PyTorch + CUDA port of mobilefinetuner_tpu.

The JAX package (`mobilefinetuner_tpu/`) stays the reference; this package
mirrors its module paths and public names so every function has an obvious
counterpart, and it never imports jax or anything of the JAX package.

Slices land one at a time (ROADMAP.md). Landed: serving GPT-2
(`serve.bench.build_engine` -> `serve.engine.ServeEngine` ->
`models.generate`: flash-attention forward and paged decode kernels),
GPT-2 LoRA training (`cli.gpt2_lora_finetune` -> `cli.common.run_training`
-> `train.trainer.make_train_step`: flash backward and LoRA epilogue
kernels), and Gemma-3 LoRA and full fine-tuning (`cli.train_lora_gemma`,
`cli.gemma_full_finetune` -> `models.gemma3` ->
`ops.loss.chunked_lm_cross_entropy_sum`: the fused cross-entropy
kernels). Each hand-written Hopper kernel in `csrc/` sits beside its
plain PyTorch version in `ops/`.

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (core/device.py); with no card and no explicit device they
raise instead of carrying on on the CPU.
"""
