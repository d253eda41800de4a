"""mobilefinetuner_tpu_torch: the PyTorch + CUDA port of mobilefinetuner_tpu.

The JAX package (`mobilefinetuner_tpu/`) stays the reference; this package
mirrors its module paths and public names so every function has an obvious
counterpart, and it never imports jax or anything of the JAX package.

Slices land one at a time (ROADMAP.md "Port"). The first slice is serving
GPT-2: `serve.bench.build_engine` -> `serve.engine.ServeEngine` ->
`models.generate` prefill / paged decode step -> the two hand-written
Hopper kernels in `csrc/` (flash-attention forward, paged decode), each
beside its plain PyTorch version in `ops/`.

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (core/device.py); with no card and no explicit device they
raise instead of carrying on on the CPU.
"""
