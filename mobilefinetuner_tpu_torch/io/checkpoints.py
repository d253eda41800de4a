"""HF GPT-2 and Gemma-3 checkpoints <-> the port's stacked parameter
trees, and the checkpoint lineage (port of
mobilefinetuner_tpu/io/checkpoints.py: `load_gpt2`, `save_gpt2`,
`load_gemma3`, `save_gemma3` and their key maps; `lineage_path` to
`resolve_checkpoint`). The `<final>.lineage.json` files are the JAX
package's format: each package reads and writes the other's.

The stacked layout ([L, ...] leaves, models/gpt2.py, models/gemma3.py) is
a gather + stack of the HF per-layer keys. HF GPT-2 linears are Conv1D
[in, out], which is what y = x @ W computes, so no transpose is applied;
Gemma-3 linears are nn.Linear [out, in] and are transposed to [in, out]
at load (and back at save). Trees here are numpy (float32), as in the JAX
package; the `convert` functions put them on a device.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mobilefinetuner_tpu_torch.core.config import GPT2Config, Gemma3TextConfig
from mobilefinetuner_tpu_torch.io.safetensors_io import (
    CheckpointIntegrityError, SafeTensorsReader, atomic_publish,
    manifest_path, save_safetensors, verify_report)

# (HF per-layer key, stacked group, leaf)
_GPT2_LAYER_KEYS = (
    ("h.{}.ln_1.weight", "ln_1", "g"), ("h.{}.ln_1.bias", "ln_1", "b"),
    ("h.{}.attn.c_attn.weight", "attn", "qkv_w"),
    ("h.{}.attn.c_attn.bias", "attn", "qkv_b"),
    ("h.{}.attn.c_proj.weight", "attn", "proj_w"),
    ("h.{}.attn.c_proj.bias", "attn", "proj_b"),
    ("h.{}.ln_2.weight", "ln_2", "g"), ("h.{}.ln_2.bias", "ln_2", "b"),
    ("h.{}.mlp.c_fc.weight", "mlp", "fc_w"),
    ("h.{}.mlp.c_fc.bias", "mlp", "fc_b"),
    ("h.{}.mlp.c_proj.weight", "mlp", "proj_w"),
    ("h.{}.mlp.c_proj.bias", "mlp", "proj_b"),
)


def load_hf_state_dict(model_dir: str,
                       promote_to_f32: bool = True) -> Dict[str, np.ndarray]:
    """An HF checkpoint dir's state dict, single-file or sharded
    (model.safetensors.index.json)."""
    index = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        out = {}
        for shard in sorted(set(weight_map.values())):
            out.update(SafeTensorsReader(os.path.join(model_dir, shard))
                       .load_all(promote_to_f32))
        return out
    return SafeTensorsReader(
        _find_weights_file(model_dir)).load_all(promote_to_f32)


def _find_weights_file(model_dir: str) -> str:
    for name in ("model.safetensors", "pytorch_model.safetensors"):
        p = os.path.join(model_dir, name)
        if os.path.exists(p):
            return p
    cands = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")]
    if len(cands) == 1:
        return os.path.join(model_dir, cands[0])
    if cands:
        raise FileNotFoundError(
            f"multiple safetensors shards in {model_dir} but no "
            "model.safetensors.index.json")
    raise FileNotFoundError(f"no safetensors weights in {model_dir}")


def _strip_prefix(tensors, prefixes=("transformer.", "model.")):
    out = {}
    for k, v in tensors.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def gpt2_params_from_hf(tensors: Dict[str, np.ndarray],
                        config: GPT2Config) -> dict:
    """HF GPT2LMHeadModel state dict -> the stacked tree (numpy)."""
    t = _strip_prefix(tensors)
    blocks: dict = {}
    for fmt, group, leaf in _GPT2_LAYER_KEYS:
        blocks.setdefault(group, {})[leaf] = np.stack(
            [t[fmt.format(i)] for i in range(config.n_layer)])
    return {"wte": t["wte.weight"], "wpe": t["wpe.weight"],
            "blocks": blocks,
            "ln_f": {"g": t["ln_f.weight"], "b": t["ln_f.bias"]}}


def _arr(x) -> np.ndarray:
    """A numpy or torch leaf as numpy (bf16 tensors as float32)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def gpt2_params_to_hf(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """The stacked tree (numpy or torch) -> HF GPT2LMHeadModel keys, in the
    JAX package's key order."""
    arr = _arr
    p = {"wte.weight": arr(params["wte"]), "wpe.weight": arr(params["wpe"]),
         "ln_f.weight": arr(params["ln_f"]["g"]),
         "ln_f.bias": arr(params["ln_f"]["b"])}
    b = params["blocks"]
    for fmt, group, leaf in _GPT2_LAYER_KEYS:
        stacked = arr(b[group][leaf])
        for i in range(stacked.shape[0]):
            p[fmt.format(i)] = stacked[i]
    if prefix:
        p = {prefix + k: v for k, v in p.items()}
    return p


def load_gpt2(model_dir: str, config: Optional[GPT2Config] = None):
    """(config, numpy params) from an HF GPT-2 checkpoint directory."""
    if config is None:
        config = GPT2Config.from_pretrained(model_dir)
    return config, gpt2_params_from_hf(load_hf_state_dict(model_dir), config)


def save_gpt2(path: str, params, metadata: Optional[dict] = None):
    """A full-model GPT-2 file in the HF key scheme (the GPT-2 full-FT
    CLI's checkpoint; loads back through load_gpt2's key map)."""
    save_safetensors(path, gpt2_params_to_hf(params),
                     metadata=metadata or {"format": "pt"})


# (HF per-layer key, stacked path, is an nn.Linear weight), in the JAX
# package's key order
_GEMMA_LAYER_KEYS = (
    ("model.layers.{}.input_layernorm.weight", ("input_ln",), False),
    ("model.layers.{}.self_attn.q_proj.weight", ("attn", "q_w"), True),
    ("model.layers.{}.self_attn.k_proj.weight", ("attn", "k_w"), True),
    ("model.layers.{}.self_attn.v_proj.weight", ("attn", "v_w"), True),
    ("model.layers.{}.self_attn.o_proj.weight", ("attn", "o_w"), True),
    ("model.layers.{}.self_attn.q_norm.weight", ("attn", "q_norm"), False),
    ("model.layers.{}.self_attn.k_norm.weight", ("attn", "k_norm"), False),
    ("model.layers.{}.post_attention_layernorm.weight", ("post_attn_ln",),
     False),
    ("model.layers.{}.pre_feedforward_layernorm.weight", ("pre_ffn_ln",),
     False),
    ("model.layers.{}.mlp.gate_proj.weight", ("mlp", "gate_w"), True),
    ("model.layers.{}.mlp.up_proj.weight", ("mlp", "up_w"), True),
    ("model.layers.{}.mlp.down_proj.weight", ("mlp", "down_w"), True),
    ("model.layers.{}.post_feedforward_layernorm.weight", ("post_ffn_ln",),
     False),
)


def gemma3_params_from_hf(tensors: Dict[str, np.ndarray],
                          config: Gemma3TextConfig) -> dict:
    """HF Gemma3ForCausalLM (text) state dict -> the stacked tree (numpy),
    linear weights transposed to [in, out]."""
    t = {("model." + k if not k.startswith("model.") else k): v
         for k, v in tensors.items()}
    blocks: dict = {}
    for fmt, path, linear in _GEMMA_LAYER_KEYS:
        stacked = np.stack([t[fmt.format(i)].T if linear
                            else t[fmt.format(i)]
                            for i in range(config.num_hidden_layers)])
        if len(path) == 1:
            blocks[path[0]] = stacked
        else:
            blocks.setdefault(path[0], {})[path[1]] = stacked
    return {"embed": t["model.embed_tokens.weight"], "blocks": blocks,
            "final_norm": t["model.norm.weight"]}


def gemma3_params_to_hf(params) -> Dict[str, np.ndarray]:
    """The stacked tree (numpy or torch) -> HF Gemma3 text keys, linear
    weights back to [out, in], in the JAX package's key order."""
    p = {"model.embed_tokens.weight": _arr(params["embed"])}
    b = params["blocks"]
    for fmt, path, linear in _GEMMA_LAYER_KEYS:
        stacked = _arr(b[path[0]] if len(path) == 1 else b[path[0]][path[1]])
        for i in range(stacked.shape[0]):
            p[fmt.format(i)] = stacked[i].T if linear else stacked[i]
    p["model.norm.weight"] = _arr(params["final_norm"])
    return p


def load_gemma3(model_dir: str, config: Optional[Gemma3TextConfig] = None):
    """(config, numpy params) from an HF Gemma-3 checkpoint directory."""
    if config is None:
        config = Gemma3TextConfig.from_pretrained(model_dir)
    return config, gemma3_params_from_hf(load_hf_state_dict(model_dir),
                                         config)


def save_gemma3(path: str, params, metadata: Optional[dict] = None):
    """A full-model Gemma-3 file in the HF key scheme (the Gemma full-FT
    CLI's checkpoint; loads back through load_gemma3's key map)."""
    save_safetensors(path, gemma3_params_to_hf(params),
                     metadata=metadata or {"format": "pt"})


# --------------------------- checkpoint lineage ------------------------------
#
# Step-tagged last-known-good checkpoints with GC and verify-on-load
# fallback (DESIGN.md §20). Every train CLI's write hook records each
# completed save into `<final_path>.lineage.json` (atomic publish),
# newest-first: [{"step": S, "files": [basenames...]}, ...] where
# files[0] is the loadable checkpoint and the rest are sidecars (.opt).
# `--keep_ckpts K` prunes the list to the K newest step-tagged entries
# BEFORE unlinking the pruned files — a SIGKILL between the two leaves
# orphan files (harmless), never a lineage that names deleted
# checkpoints as retained. Load paths (`--resume_from`, in-process
# rollback, serve hot-swap) walk the lineage through
# `resolve_checkpoint`, verifying each candidate's manifest and falling
# back down the chain on mismatch instead of crashing on — or silently
# loading — the newest file.

def lineage_path(final_path: str) -> str:
    return final_path + ".lineage.json"


def _load_lineage(final_path: str) -> List[dict]:
    try:
        with open(lineage_path(final_path), "r", encoding="utf-8") as f:
            entries = json.load(f)["entries"]
        return [e for e in entries
                if isinstance(e.get("step"), int) and e.get("files")]
    except (OSError, ValueError, KeyError, TypeError):
        return []


def lineage_entries(final_path: str) -> List[dict]:
    """Newest-first [{step, files: [abs paths]}] from the lineage json
    next to `final_path`; [] when absent/unreadable. Paths are made
    absolute against the checkpoint directory (the lineage stores
    basenames so a checkpoint directory can be moved wholesale)."""
    d = os.path.dirname(os.path.abspath(final_path))
    out = []
    for e in sorted(_load_lineage(final_path),
                    key=lambda e: e["step"], reverse=True):
        out.append({"step": e["step"],
                    "files": [os.path.join(d, os.path.basename(f))
                              for f in e["files"]]})
    return out


def record_checkpoint(final_path: str, step: int, files: List[str],
                      keep: int = 0) -> List[str]:
    """Record one completed save into the lineage and GC old entries.
    `files`: the paths this save wrote (files[0] = the loadable
    checkpoint). `keep` > 0 retains only the `keep` newest STEP-TAGGED
    entries (an entry whose checkpoint is `final_path` itself — the
    run's final artifact — is never pruned); 0 keeps everything.
    Returns the pruned files it unlinked. Kill-safe ordering: the
    pruned lineage publishes atomically FIRST, then files are unlinked
    — dying between the two leaves orphans, not a lineage pointing at
    deleted checkpoints (tests/test_torch_recovery.py holds this)."""
    d = os.path.dirname(os.path.abspath(final_path))
    final_base = os.path.basename(final_path)
    bases = [os.path.basename(f) for f in files]
    entries = [e for e in _load_lineage(final_path)
               if e["step"] != step and e["files"][0] != bases[0]]
    entries.append({"step": int(step), "files": bases})
    entries.sort(key=lambda e: e["step"], reverse=True)
    pruned: List[dict] = []
    if keep and keep > 0:
        kept, tagged = [], 0
        for e in entries:
            if e["files"][0] == final_base:
                kept.append(e)  # the final artifact is never GC'd
            elif tagged < keep:
                kept.append(e)
                tagged += 1
            else:
                pruned.append(e)
        entries = kept
    with atomic_publish(lineage_path(final_path)) as tmp:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "entries": entries}, f,
                      separators=(",", ":"))
    removed = []
    keep_set = {b for e in entries for b in e["files"]}
    for e in pruned:
        for b in e["files"]:
            if b in keep_set:
                continue  # shared file (should not happen; be safe)
            p = os.path.join(d, b)
            for victim in (p, manifest_path(p)):
                with contextlib.suppress(OSError):
                    os.unlink(victim)
                removed.append(victim)
    return removed


def lineage_base_for(path: str) -> Optional[str]:
    """The FINAL-artifact path whose lineage json lists `path` as a
    checkpoint — found by scanning `*.lineage.json` next to it. A
    step-tagged file (`a_step6.safetensors`) carries no lineage of its
    own; its chain lives at `a.safetensors.lineage.json`."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    if os.path.exists(lineage_path(path)):
        return path
    for lp in _glob.glob(os.path.join(_glob.escape(d), "*.lineage.json")):
        final = lp[: -len(".lineage.json")]
        for e in _load_lineage(final):
            if e["files"] and os.path.basename(e["files"][0]) == base:
                return final
    return None


def lineage_step_for(path: str) -> Optional[int]:
    """The LOOP step a checkpoint file was saved at, looked up from the
    lineage that lists it (lineage_base_for). Needed because a
    `--skip_nonfinite` run's Adam step counter lags the loop step by
    the skipped updates — the .opt sidecar's `step` tensor is the wrong
    resume point then (the sidecar's `loop_step` metadata is the
    primary source; this is the fallback for sidecars written before
    it existed)."""
    base = lineage_base_for(path)
    if base is None:
        return None
    name = os.path.basename(path)
    for e in lineage_entries(base):
        if os.path.basename(e["files"][0]) == name:
            return e["step"]
    return None


def _verify_entry(files: List[str]) -> Tuple[str, Optional[str]]:
    """Aggregate verify_report over an entry's file set: 'corrupt'
    dominates, then 'unverified', else 'ok'. A missing SIDECAR is
    corruption of the entry (the checkpoint alone cannot resume the
    optimizer); reasons are prefixed with the offending basename."""
    worst, why = "ok", None
    for f in files:
        status, reason = verify_report(f)
        tagged = f"{os.path.basename(f)}:{reason}" if reason else None
        if status == "corrupt":
            return "corrupt", tagged
        if status == "unverified" and worst == "ok":
            worst, why = "unverified", tagged
    return worst, why


def resolve_checkpoint(path: Optional[str], verify: bool = True,
                       lineage_base: Optional[str] = None,
                       max_step: Optional[int] = None):
    """Resolve the checkpoint a load should actually use, walking the
    integrity lineage: returns (resolved_path, step_or_None, events)
    where events is a list of `ckpt_verify` telemetry payloads
    ({path, ok, reason, step, action}) in visit order.

    Candidates: the explicit `path` first (when given), then the
    lineage entries next to `lineage_base` (default: `path`) newest-
    first, skipping entries newer than `max_step` (the rollback caller
    must not "resume" into the future). The first candidate whose
    manifest fully verifies wins; if NONE verifies, the newest
    'unverified' candidate (parseable file, no manifest — a
    pre-manifest checkpoint) is accepted with ok=false so legacy
    resumes keep working; if nothing is loadable at all, an explicit
    `path` raises CheckpointIntegrityError and a lineage-only walk
    (rollback) returns (None, None, events). verify=False short-
    circuits to the explicit path unchanged (--verify_ckpt 0)."""
    if not verify:
        # trust-the-newest mode (--verify_ckpt 0): no checksum walk,
        # but a lineage-only call (rollback's path=None) must still
        # resolve the newest EXISTING entry — "don't verify" must not
        # mean "can't roll back"
        if path:
            return path, lineage_step_for(path), []
        for e in (lineage_entries(lineage_base) if lineage_base else []):
            if max_step is not None and e["step"] > max_step:
                continue
            if os.path.exists(e["files"][0]):
                return e["files"][0], e["step"], []
        return None, None, []
    base = lineage_base or (lineage_base_for(path) if path else None)
    candidates: List[Tuple[str, Optional[int], List[str]]] = []
    seen = set()
    if path:
        files = [path] + ([path + ".opt"]
                          if os.path.exists(path + ".opt") else [])
        candidates.append((path, lineage_step_for(path), files))
        seen.add(os.path.abspath(path))
    if base:
        for e in lineage_entries(base):
            main = e["files"][0]
            if os.path.abspath(main) in seen:
                continue
            if max_step is not None and e["step"] > max_step:
                continue
            seen.add(os.path.abspath(main))
            candidates.append((main, e["step"], e["files"]))
    events: List[dict] = []
    fallback: Optional[Tuple[str, Optional[int]]] = None
    for main, step, files in candidates:
        status, reason = _verify_entry(files)
        ok = status == "ok"
        events.append({"path": main, "ok": ok, "reason": reason,
                       "step": step,
                       "action": "load" if ok else "reject"})
        if ok:
            return main, step, events
        if status == "unverified" and fallback is None:
            fallback = (main, step)
    if fallback is not None:
        main, step = fallback
        events.append({"path": main, "ok": False,
                       "reason": "loaded_unverified", "step": step,
                       "action": "load"})
        return main, step, events
    if path:
        raise CheckpointIntegrityError(
            f"{path}: no loadable checkpoint in its lineage "
            f"({len(candidates)} candidate(s) rejected: "
            f"{[e['reason'] for e in events]})")
    return None, None, events
