"""Append-only, crash-safe run registry (the port's own copy of
mobilefinetuner_tpu/core/run_registry.py, over the port's Telemetry and
validate_event: a registry file is a shared format, so either package's
`RunRegistry` reads, settles and resolves the other's records).

Every train/eval/serve/bench entrypoint registers here: one `run` event
(core/telemetry.py EVENT_SCHEMA) at start (status "running"), one at
finalize (terminal status), both written through the SAME Telemetry
machinery the run streams use — per-record flush, truncated-tail repair
on append, strict-JSON lines — so a SIGKILL between the two leaves a
durable start record instead of nothing. Each record is self-contained
(run id, git rev, config fingerprint, platform, mesh, artifact paths):
a registry line never needs a join to interpret, which is what lets
tools/observatory.py and the report tools resolve runs by id/rev
instead of raw file paths.

Crash repair: a "start" with no matching "end" whose pid is no longer
alive is settled on the next registry open — an `interrupted` end
record is APPENDED (the registry stays append-only; nothing is ever
rewritten), so every run converges to exactly one finalized record:
normal exit, SIGKILL mid-run, or admission-reject alike.

Zero-sync: this module never touches a device. The platform/mesh facts are
passed in by the caller (which already holds them), and the git rev is
read from .git/HEAD directly — no subprocess, no device touch.

Concurrency: records are identified by run_id, not seq — two processes
appending concurrently may interleave seq numbers (each write reopens
the stream and continues the numbering it observed), which the readers
here deliberately ignore.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

from mobilefinetuner_tpu_torch.core.telemetry import (Telemetry,
                                                      validate_event)

#: environment fallback for the --run_registry flag: one exported path
#: makes every entrypoint in a shell session register without per-CLI
#: plumbing (the flag, when passed, wins).
REGISTRY_ENV = "MFT_RUN_REGISTRY"

#: terminal statuses the settle pass never rewrites; anything else on a
#: start record ("running") is a candidate for interrupted-repair.
TERMINAL = ("ok", "interrupted", "preempted")


def config_fingerprint(config: Optional[dict]) -> Optional[str]:
    """12-hex sha256 over the JSON-scalar subset of `config`, sorted —
    the same filter run_manifest applies, so the fingerprint is stable
    across flag ordering and ignores unserializable handles."""
    if not config:
        return None
    scalars = {k: v for k, v in sorted(config.items())
               if isinstance(v, (str, int, float, bool, type(None)))}
    blob = json.dumps(scalars, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def git_rev(root: str = ".") -> Optional[str]:
    """The checkout's HEAD commit (12 hex chars) read straight from
    .git — no subprocess (a registry write must stay cheap and work in
    sandboxes without a git binary). None outside a git checkout."""
    try:
        git_dir = os.path.join(root, ".git")
        if os.path.isfile(git_dir):  # worktree: "gitdir: <path>"
            with open(git_dir) as f:
                git_dir = f.read().split(":", 1)[1].strip()
        with open(os.path.join(git_dir, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head[:12] or None
        ref = head.split(None, 1)[1]
        ref_path = os.path.join(git_dir, ref)
        if os.path.exists(ref_path):
            with open(ref_path) as f:
                return f.read().strip()[:12] or None
        packed = os.path.join(git_dir, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2 and parts[1] == ref:
                        return parts[0][:12]
    except (OSError, IndexError, ValueError):
        pass
    return None


def _pid_alive(pid: int) -> bool:
    """Liveness probe behind the interrupted-repair: signal 0 touches
    nothing but reports existence. PermissionError means alive (someone
    else's process)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class RunHandle:
    """One registered run: `finalize` appends the end record (idempotent
    — end_run-style nested handlers may race a crash path) and mirrors
    it into the run's own telemetry stream when one is attached."""

    def __init__(self, registry: "RunRegistry", payload: dict,
                 telemetry=None):
        self.registry = registry
        self.run_id = payload["run_id"]
        self._payload = payload
        self._telemetry = telemetry
        self._t0 = time.time()
        self._finalized = False

    def finalize(self, status: str = "ok",
                 artifacts: Optional[Iterable[str]] = None) -> None:
        if self._finalized:
            return
        self._finalized = True
        rec = dict(self._payload)
        rec["phase"] = "end"
        rec["status"] = str(status)
        rec["wall_s"] = round(time.time() - self._t0, 3)
        if artifacts is not None:
            merged = list(rec.get("artifacts") or [])
            merged += [a for a in artifacts if a and a not in merged]
            rec["artifacts"] = merged
        self.registry._append(rec)
        if self._telemetry is not None:
            self._telemetry.emit("run", **rec)

    def __enter__(self) -> "RunHandle":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # exception type name as the terminal status, matching the
        # run_end `exit` convention (cli/common.py end_run)
        self.finalize("ok" if exc_type is None else exc_type.__name__)


class RunRegistry:
    """The registry file: a Telemetry-written JSONL stream of `run`
    events. Construct with a path; a falsy path disables every method
    (the no-op convention Telemetry itself uses)."""

    def __init__(self, path: str):
        self.path = path or ""

    @classmethod
    def from_args(cls, args) -> Optional["RunRegistry"]:
        """--run_registry flag first, then the MFT_RUN_REGISTRY env
        var; None when neither is set (registration stays opt-in — no
        behavior change for existing callers)."""
        path = getattr(args, "run_registry", "") or \
            os.environ.get(REGISTRY_ENV, "")
        return cls(path) if path else None

    # -- write path ----------------------------------------------------------

    def _append(self, payload: dict) -> None:
        """One record through the existing telemetry flush path: open
        (append mode repairs a truncated tail and continues seq), emit
        (per-event flush), close. Short-lived handles keep concurrent
        writers from holding the file across a whole run."""
        with Telemetry(self.path) as tel:
            tel.emit("run", **payload)

    def begin(self, kind: str, tool: str, config: Optional[dict] = None,
              mesh: Optional[dict] = None, platform: Optional[str] = None,
              artifacts: Iterable[str] = (), telemetry=None,
              root: str = ".") -> RunHandle:
        """Register a run: append the start record (status "running"),
        mirror it into `telemetry` (the run's own stream) as the
        observatory's join key, and settle any dead predecessors while
        the file is open anyway. Returns the handle finalize rides."""
        run_id = (time.strftime("%Y%m%dT%H%M%S")
                  + f"-{os.getpid()}-{os.urandom(3).hex()}")
        payload = {
            "run_id": run_id,
            "phase": "start",
            "kind": str(kind),
            "tool": str(tool),
            "status": "running",
            "git_rev": git_rev(root),
            "config_fingerprint": config_fingerprint(config),
            "platform": platform,
            "mesh": dict(mesh) if mesh else None,
            "pid": os.getpid(),
            "artifacts": [a for a in artifacts if a] or None,
            "wall_s": None,
        }
        self.settle()
        self._append(payload)
        if telemetry is not None:
            telemetry.emit("run", **payload)
        return RunHandle(self, payload, telemetry=telemetry)

    # -- read path -----------------------------------------------------------

    def _raw_records(self) -> List[dict]:
        out: List[dict] = []
        try:
            with open(self.path, "rb") as f:
                lines = f.read().splitlines()
        except OSError:
            return out
        for raw in lines:
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # truncated tail from a killed writer
            if isinstance(rec, dict) and rec.get("event") == "run" \
                    and validate_event(rec) is None:
                out.append(rec)
        return out

    def records(self, settle: bool = True) -> List[dict]:
        """One RESOLVED record per run_id, in first-seen order: the
        start record's identity block, overlaid with its end record's
        terminal status/wall_s/artifacts when one landed. With
        settle=True (default), dead "running" records are repaired to
        "interrupted" first — so a reader never sees a zombie."""
        if settle:
            self.settle()
        runs: Dict[str, dict] = {}
        for rec in self._raw_records():
            rid = rec["run_id"]
            if rec["phase"] == "start":
                runs.setdefault(rid, dict(rec))
            else:
                base = runs.setdefault(rid, dict(rec))
                for k in ("status", "wall_s", "artifacts"):
                    if rec.get(k) is not None:
                        base[k] = rec[k]
                base["phase"] = "end"
        return list(runs.values())

    def settle(self) -> int:
        """Append `interrupted` end records for every start whose run
        never finalized and whose pid is dead — the kill-safe
        contract, at registry granularity: a SIGKILLed run is marked,
        not lost, not forever "running". Returns the repair count.
        This process's own live registrations are left alone."""
        if not self.path or not os.path.exists(self.path):
            return 0
        runs: Dict[str, dict] = {}
        ended = set()
        for rec in self._raw_records():
            if rec["phase"] == "start":
                runs.setdefault(rec["run_id"], rec)
            else:
                ended.add(rec["run_id"])
        repaired = 0
        for rid, rec in runs.items():
            if rid in ended or _pid_alive(rec.get("pid", -1)):
                continue
            # drop the stream envelope (event/seq/t) — _append stamps a
            # fresh one; only the run payload is carried forward
            end = {k: v for k, v in rec.items()
                   if k not in ("event", "seq", "t")}
            end["phase"] = "end"
            end["status"] = "interrupted"
            self._append(end)
            repaired += 1
        return repaired

    def resolve(self, token: str) -> Optional[dict]:
        """A record by run_id, unique run_id prefix, or git rev (the
        LATEST run at that rev — "compare me against what main built"
        wants the newest artifact). None when nothing matches."""
        if not token:
            return None
        recs = self.records()
        for r in recs:
            if r["run_id"] == token:
                return r
        prefix = [r for r in recs if r["run_id"].startswith(token)]
        if len(prefix) == 1:
            return prefix[0]
        by_rev = [r for r in recs
                  if r.get("git_rev") and r["git_rev"].startswith(token)]
        return by_rev[-1] if by_rev else None

    def artifact_for(self, token: str,
                     suffix: str = ".json") -> Optional[str]:
        """The resolved run's first on-disk artifact with `suffix` —
        what bench_compare feeds to load_rows, byte-identical to the
        path invocation because it IS a path invocation after this."""
        rec = self.resolve(token)
        for p in (rec or {}).get("artifacts") or []:
            if p.endswith(suffix) and os.path.exists(p):
                return p
        return None


def registry_from(path_or_args: Any) -> Optional[RunRegistry]:
    """Convenience for tools: accept a raw path string or an argparse
    namespace with a run_registry attribute (env fallback either way)."""
    if isinstance(path_or_args, str):
        path = path_or_args or os.environ.get(REGISTRY_ENV, "")
        return RunRegistry(path) if path else None
    return RunRegistry.from_args(path_or_args)
