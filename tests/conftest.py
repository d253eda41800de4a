"""Test harness setup: force an 8-device virtual CPU platform so mesh/FSDP
code paths run without a TPU pod (the analog of the reference's mocked
telemetry testing culture, SURVEY.md §4.6). The subtle platform-forcing
recipe lives in parallel/host_devices.py, shared with __graft_entry__."""

from mobilefinetuner_tpu.parallel.host_devices import force_host_devices

force_host_devices(8)

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: excluded from the budgeted tier-1 run (-m 'not slow'); "
        "run explicitly for the full acceptance matrices")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the port's hand-written "
        "kernels); skips without one")
