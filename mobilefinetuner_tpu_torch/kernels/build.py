"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and is compiled
on its own into `build/kernels/lib<name>-<digest>.so` at the repo root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>-<digest>.so <name>.cu

The digest covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused within a checkout. `build_all`
starts one nvcc per source, all at once, and waits for them; a failed
build raises with nvcc's output. `load(name)` builds at first use, so a
fresh checkout needs nothing but its sources and the CUDA toolkit. Nothing
here runs at import time: the CPU tests import every module.

A build that starts nvcc runs inside the context managers registered with
`watch_builds` (none when every library is built already): the training
loop charges that wall time to its goodput `compile` bucket and pauses
its hang watchdog there, so a cold checkout's first step is not a hang.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import (Callable, ContextManager, Dict, Iterable, List,
                    Optional, Tuple)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SOURCES = ("flash_attention_fwd", "flash_attention_fwd_mma",
           "flash_attention_fwd_tf32", "flash_attention_bwd_merged",
           "flash_attention_bwd_merged_mma",
           "flash_attention_bwd_merged_tf32", "flash_attention_bwd_split",
           "fused_ce", "fused_ce_fwd_mma", "fused_ce_dh_mma",
           "fused_ce_dw_mma", "fused_ce_dh_lora_mma", "fused_ce_fwd_lora_mma",
           "fused_ce_dbt_mma", "fused_ce_dh_tf32", "fused_ce_dh_lora_tf32",
           "fused_ce_fwd_tf32", "fused_ce_dbt_tf32", "fused_ce_fwd_lora_tf32",
           "fused_ce_dw_tf32", "lora_epilogue", "lora_epilogue_vec",
           "lora_epilogue_vec_f32",
           "paged_decode_attention",
           "paged_decode_attention_vec", "paged_decode_attention_vec_f32",
           "decode_attention", "decode_attention_mma",
           "decode_attention_split_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_WATCHERS: List[Callable[[], ContextManager]] = []


@contextlib.contextmanager
def watch_builds(watcher: Callable[[], ContextManager]):
    """Register `watcher` (a context-manager factory) for the duration of
    the with-block: every build that starts nvcc runs inside
    `watcher()`."""
    _BUILD_WATCHERS.append(watcher)
    try:
        yield
    finally:
        _BUILD_WATCHERS.remove(watcher)


@contextlib.contextmanager
def _building():
    with contextlib.ExitStack() as stack:
        for watcher in list(_BUILD_WATCHERS):
            stack.enter_context(watcher())
        yield


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda, else RuntimeError."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH, "
        "/usr/local/cuda/bin): the port's kernels are built from "
        "mobilefinetuner_tpu_torch/csrc with the CUDA toolkit")


def lib_path(name: str, flags: Tuple[str, ...] = NVCC_FLAGS) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES, verbose: bool = False,
              nvcc: Optional[str] = None) -> Dict[str, Tuple[str, str]]:
    """Build every named kernel library that is not built yet, one nvcc
    process per source, all started together. Returns
    {name: (path, compiler output)}; `verbose` adds `-Xptxas -v` so the
    output of a build lists each kernel's registers, shared memory and
    spills (a library already built is reused, with no output)."""
    names = list(names)
    extra = ("-Xptxas", "-v") if verbose else ()
    flags = NVCC_FLAGS + extra
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: Dict[str, Tuple[str, str]] = {}
    todo = []
    for name in names:
        path = lib_path(name)   # -Xptxas -v does not change the binary
        if os.path.exists(path):
            out[name] = (path, "")
        else:
            todo.append((name, path))
    if not todo:
        return out
    exe = nvcc or find_nvcc()
    failed = []
    with _building():
        procs = {}
        for name, path in todo:
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [exe, *flags, "-o", tmp,
                   os.path.join(CSRC_DIR, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}) "
                              f"---\n{log}")
                continue
            os.replace(tmp, path)
            out[name] = (path, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (building it on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build_all([name])[name]
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def check_launch(fn_name: str, code: int) -> None:
    """Raise on a non-zero CUDA error code returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"{fn_name} launch failed with CUDA error {code}")
