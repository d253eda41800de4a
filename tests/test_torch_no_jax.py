"""The port never imports jax nor the JAX package: a subprocess imports
every module of mobilefinetuner_tpu_torch, chip_smoke.py and
rounding_sensitivity.py (this test process cannot tell, since
tests/conftest.py imports jax for every test), and an AST scan checks
every import statement of those files, the serving modules (the prefix
cache, the engine, the serving model functions), the MMLU, GPT-2 full
fine-tuning and data-mode modules, the fault-tolerance modules
(telemetry, device-memory readings, preemption, the memory guard, async
checkpoints, the lineage) and the observability modules (trace spans and
captures, the metrics endpoint, the run registry, the step governor) and
the multi-tenant training modules (the jobs file, the engine, its CLI)
named among them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "mobilefinetuner_tpu_torch"


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "rounding_sensitivity.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, PKG)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "mobilefinetuner_tpu"
            or name.startswith("mobilefinetuner_tpu."))


def test_subprocess_imports_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {ROOT!r})
import {PKG}
mods = [m.name for m in pkgutil.walk_packages({PKG}.__path__, "{PKG}.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import rounding_sensitivity
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "mobilefinetuner_tpu"
             or m.startswith("mobilefinetuner_tpu."))
print(len(mods), bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 15, res.stdout
    assert bad == "[]", res.stdout


@pytest.mark.parametrize("module", [
    "serve/prefix_cache.py", "serve/paged_kv.py", "serve/engine.py",
    "serve/bench.py", "serve/adapters.py", "models/generate.py",
    "models/lora_apply.py", "ops/dropout.py"])
def test_serving_modules_are_scanned(module):
    """The Gemma serving slice's modules are among the files scanned."""
    assert os.path.join(ROOT, PKG, module) in _port_files()


@pytest.mark.parametrize("module", [
    "eval/__init__.py", "eval/mmlu.py", "eval/mmlu_categories.py",
    "cli/eval_mmlu.py", "cli/gpt2_full_finetune.py", "cli/common.py",
    "data/wikitext2.py", "data/prefetch.py", "data/synthetic.py"])
def test_evaluation_and_full_ft_modules_are_scanned(module):
    """The MMLU, GPT-2 full fine-tuning and data-mode modules are among
    the files scanned, and the subprocess imports them too."""
    assert os.path.join(ROOT, PKG, module) in _port_files()
    name = f"{PKG}." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {name}; "
            f"print(sorted(m for m in sys.modules if m in ('jax', "
            f"'mobilefinetuner_tpu') or "
            f"m.startswith(('jax.', 'mobilefinetuner_tpu.'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


@pytest.mark.parametrize("module", [
    "core/telemetry.py", "core/cuda_stats.py", "core/preempt.py",
    "core/memory_guard.py", "io/async_ckpt.py", "io/checkpoints.py",
    "train/trainer.py"])
def test_fault_tolerance_modules_are_scanned(module):
    """The telemetry, memory, preemption and checkpoint modules are among
    the files scanned, and a subprocess imports each without jax."""
    assert os.path.join(ROOT, PKG, module) in _port_files()
    name = f"{PKG}." + module[:-3].replace("/", ".")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {name}; "
            f"print(sorted(m for m in sys.modules if m in ('jax', "
            f"'mobilefinetuner_tpu') or "
            f"m.startswith(('jax.', 'mobilefinetuner_tpu.'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


@pytest.mark.parametrize("module", [
    "core/trace.py", "core/metrics_http.py", "core/run_registry.py",
    "system/governor.py", "system/__init__.py", "kernels/build.py"])
def test_observability_modules_are_scanned(module):
    """The observability plane's modules are among the files scanned, and
    a subprocess imports each without jax or the JAX package (the copied
    pure-Python modules keep their own code)."""
    assert os.path.join(ROOT, PKG, module) in _port_files()
    name = f"{PKG}." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {name}; "
            f"print(sorted(m for m in sys.modules if m in ('jax', "
            f"'mobilefinetuner_tpu') or "
            f"m.startswith(('jax.', 'mobilefinetuner_tpu.'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


@pytest.mark.parametrize("module", [
    "multitenant/__init__.py", "multitenant/jobspec.py",
    "multitenant/engine.py", "cli/train_multi_lora.py"])
def test_multitenant_modules_are_scanned(module):
    """The multi-tenant training modules are among the files scanned, and
    a subprocess imports each without jax or the JAX package (jobspec.py
    is the port's own copy of the pure-Python jobs-file parser)."""
    assert os.path.join(ROOT, PKG, module) in _port_files()
    name = f"{PKG}." + module[:-3].replace("/", ".").replace(
        ".__init__", "")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import {name}; "
            f"print(sorted(m for m in sys.modules if m in ('jax', "
            f"'mobilefinetuner_tpu') or "
            f"m.startswith(('jax.', 'mobilefinetuner_tpu.'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_ast_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], (path, names)
