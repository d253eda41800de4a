"""Live OpenMetrics endpoint over the telemetry emit path (the port's own
copy of mobilefinetuner_tpu/core/metrics_http.py: the same registry, the
same exposition, byte for byte on the same events).

Production fleets are watched by scrapers, not by tailing JSONL: this
module turns the run's own event stream into a Prometheus/OpenMetrics
`/metrics` endpoint plus a `/healthz` probe, WITHOUT a second
instrumentation layer — `MetricsRegistry.observe` attaches as a
`Telemetry` observer (core/telemetry.py `add_observer`), so every
number a scraper reads came through the exact emit call the JSONL sink
wrote. One measurement, three consumers (stream, report tools,
scraper); nothing here can drift from the stream because nothing here
measures anything.

Zero-sync invariant, extended: this module imports nothing but the
standard library and never touches a device — it folds host-side
floats that already exist into counters/gauges/histograms under its own
lock. A scrape can therefore never add a device sync to the hot path it
observes.

Server: stdlib ThreadingHTTPServer on a daemon thread, bound to
127.0.0.1 by default — the endpoint exposes operational detail (paths,
config, loss curves), so exposing it beyond the host is an explicit
`--metrics_addr 0.0.0.0` decision, not a default. `port=0` binds an
ephemeral port (the `port` property reports it; tests use this), the
CLI flags treat 0 as "off".

Exposition format: OpenMetrics text (the `# TYPE` blocks, counters
with the `_total` suffix, terminated by `# EOF`), served with the
OpenMetrics content type. Prometheus scrapes it as-is.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

# observe() runs under the Telemetry emit lock on whatever thread
# emitted; render()/health() on HTTP handler threads: the registry's own
# _lock serializes them (the fold helpers expect the caller to hold it).

# default histogram bucket edges (ms): wide enough for a 20 ms LoRA
# step and a 2 s governor-throttled one, for TTFT under load and for
# checkpoint writes — one ladder, log-spaced
_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
               1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _fmt_val(v: float) -> str:
    """OpenMetrics float rendering: integers without the trailing .0
    noise, everything finite as repr (full precision round-trips)."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Histogram:
    """Fixed-bucket cumulative histogram (the OpenMetrics shape)."""

    def __init__(self, buckets=_MS_BUCKETS):
        self.edges = tuple(sorted(buckets))
        self.counts = [0] * (len(self.edges) + 1)  # +1: the +Inf bucket
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.total += 1
        self.sum += v
        for i, edge in enumerate(self.edges):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def render(self, name: str) -> List[str]:
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{_fmt_val(edge)}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.total}')
        lines.append(f"{name}_count {self.total}")
        lines.append(f"{name}_sum {_fmt_val(round(self.sum, 6))}")
        return lines


class MetricsRegistry:
    """Event records in, OpenMetrics text out.

    `observe(rec)` dispatches on `rec["event"]` and folds the payload
    into counters (monotonic, `_total`-suffixed), gauges (last value
    wins; None clears), and histograms (step time, TTFT, TPOT). All
    metric names carry the `mft_` prefix. Unknown event types are
    ignored — the registry must keep working as the taxonomy grows.

    Thread-safe: `observe` runs under the Telemetry emit lock on
    whatever thread emitted (step loop, checkpoint writer, watchdog),
    `render`/`health` on HTTP handler threads — one internal lock
    serializes them all.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], Optional[float]] = {}
        self._hists: Dict[str, Histogram] = {}
        self._last_rec_t: Optional[float] = None
        self._last_step: Optional[int] = None
        self._last_exit: Optional[str] = None
        self.observed = 0  # records seen (test observable)

    # -- folding helpers (call under self._lock) -----------------------------

    def _count(self, name: str, inc: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        self._counters[key] = self._counters.get(key, 0.0) + inc

    def _count_to(self, name: str, value: float, **labels) -> None:
        """Monotonic set-to-max (step counters arrive as absolutes; a
        rollback rewinds the loop step but a counter may never go
        down)."""
        key = (name, tuple(sorted(labels.items())))
        self._counters[key] = max(self._counters.get(key, 0.0), value)

    def _gauge(self, name: str, value, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        self._gauges[key] = None if value is None else float(value)

    def _hist(self, name: str, value) -> None:
        if value is None:
            return
        self._hists.setdefault(name, Histogram()).observe(float(value))

    # -- the observer ---------------------------------------------------------

    def observe(self, rec: dict) -> None:
        if not isinstance(rec, dict):
            return
        ev = rec.get("event")
        g = rec.get
        with self._lock:
            self.observed += 1
            self._last_rec_t = time.time()
            if isinstance(g("step"), int):
                self._last_step = g("step")
            if ev == "step_stats":
                self._count_to("mft_steps", g("step") or 0)
                self._hist("mft_step_time_ms", g("step_time_ms"))
                for f in ("loss", "ema", "lr", "grad_norm", "tok_s",
                          "mfu", "host_wait_ms", "hbm_mb", "queue_depth",
                          "param_norm", "update_ratio"):
                    self._gauge(f"mft_{f}", g(f))
                if g("skipped"):
                    self._count("mft_skipped_steps", g("skipped"))
            elif ev == "request":
                self._count("mft_requests", phase=g("phase", "?"))
                if g("phase") == "finish":
                    self._hist("mft_ttft_ms", g("ttft_ms"))
                    self._hist("mft_tpot_ms", g("tpot_ms"))
                    self._hist("mft_queue_ms", g("queue_ms"))
                    if g("new_tokens"):
                        self._count("mft_generated_tokens",
                                    g("new_tokens"))
            elif ev == "serve_stats":
                for f in ("queue_depth", "active", "occupancy",
                          "free_blocks", "p95_step_ms", "hbm_mb",
                          "pool_mb",
                          # cache vitals: the prefix-cache counters the
                          # registry used to drop — the router's
                          # affinity scoring and the fleet report read
                          # them off /metrics, not the JSONL
                          "prefix_hit_rate", "cow_copies",
                          "blocks_in_use"):
                    self._gauge(f"mft_serve_{f}", g(f))
                # page-pool occupancy: fraction of allocatable pages
                # held by live requests (parked cache pages count free)
                in_use, free = g("blocks_in_use"), g("free_blocks")
                if isinstance(in_use, (int, float)) \
                        and isinstance(free, (int, float)) \
                        and in_use + free > 0:
                    self._gauge("mft_serve_pool_occupancy",
                                round(in_use / (in_use + free), 4))
                self._count_to("mft_decode_steps", g("step") or 0)
                for s in ("finished", "cancelled", "rejected", "timeout",
                          "error"):
                    if isinstance(g(s), int):
                        self._count_to("mft_serve_terminal", g(s),
                                       state=s)
            elif ev == "route":
                # router decisions: the histogram over
                # (policy, replica) IS the routing-decision report, and
                # scrape age tells the operator how stale the snapshots
                # behind those decisions ran
                self._count("mft_route_decisions",
                            policy=g("policy", "?"),
                            replica=str(g("replica")))
                self._hist("mft_route_scrape_age_ms",
                           g("scrape_age_ms"))
            elif ev == "anomaly":
                self._count("mft_anomalies", kind=g("kind", "?"))
            elif ev == "throttle":
                self._count("mft_throttle_decisions")
            elif ev == "straggler":
                self._count("mft_stragglers")
            elif ev == "hang":
                self._count("mft_hangs")
            elif ev == "checkpoint":
                self._count("mft_checkpoints")
                self._hist("mft_ckpt_write_ms", g("write_ms"))
                if g("bytes"):
                    self._count("mft_ckpt_bytes", g("bytes"))
            elif ev == "ckpt_dropped":
                self._count("mft_ckpt_dropped")
            elif ev == "rollback":
                self._count("mft_rollbacks",
                            ok=str(bool(g("ok"))).lower())
            elif ev == "degrade":
                self._count("mft_degrades", rung=g("rung", "?"))
            elif ev == "mem_check":
                self._gauge("mft_mem_est_mb", g("est_mb"))
                self._gauge("mft_mem_cap_mb", g("cap_mb"))
                if g("verdict") == "over":
                    self._count("mft_mem_over")
            elif ev == "ckpt_verify":
                self._count("mft_ckpt_verify",
                            ok=str(bool(g("ok"))).lower())
            elif ev == "profile_capture":
                self._count("mft_profile_captures",
                            trigger=g("trigger", "?"))
            elif ev == "eval":
                self._gauge("mft_eval_loss", g("loss"))
                self._gauge("mft_eval_ppl", g("ppl"))
            elif ev == "compile":
                self._count("mft_compiles")
                self._gauge("mft_compile_peak_hbm_mb", g("peak_hbm_mb"))
            elif ev == "preempt":
                self._count("mft_preempts")
            elif ev == "run":
                # run registry (core/run_registry.py): count
                # finalized registrations by kind/terminal status —
                # start records are in-flight, not a terminal tally
                if g("phase") == "end":
                    self._count("mft_registered_runs",
                                kind=g("kind", "?"),
                                status=g("status", "?"))
            elif ev == "trend":
                # longitudinal sentinel (tools/observatory.py):
                # the newest sample, its rolling median and robust z per
                # gated series — a dashboard reads the regression story
                # off the SAME record the verdict JSON carries
                labels = dict(metric=g("metric", "?"),
                              config=g("config", "?"),
                              platform=g("platform", "?"))
                self._gauge("mft_trend_value", g("value"), **labels)
                self._gauge("mft_trend_median", g("median"), **labels)
                self._gauge("mft_trend_z", g("z"), **labels)
                if g("regressed"):
                    self._count("mft_trend_regressions", **labels)
            elif ev == "run_end":
                self._count("mft_runs", exit=g("exit", "?"))
                self._last_exit = g("exit")
                gp = g("goodput") or {}
                if isinstance(gp, dict) and "productive_frac" in gp:
                    self._gauge("mft_goodput_productive_frac",
                                gp.get("productive_frac"))
                    for k, v in gp.items():
                        if k.endswith("_s") and k != "total_s":
                            self._gauge("mft_goodput_seconds",
                                        v, bucket=k[:-2])

    def set_gauge(self, name: str, value, **labels) -> None:
        """Public labeled-gauge setter for numbers that do NOT arrive
        through the telemetry emit path — the serve router folds
        each replica's scraped vitals in as
        `mft_fleet_*{replica="k"}` gauges (None clears)."""
        with self._lock:
            self._gauge(name, value, **labels)

    def observe_hist(self, name: str, value) -> None:
        """Public histogram feed for the same out-of-band callers
        (router-side TTFT/TPOT/queue-wait over collected results)."""
        with self._lock:
            self._hist(name, value)

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Public labeled-counter increment for out-of-band callers
        (router-side fleet request terminals by state)."""
        with self._lock:
            self._count(name, value, **labels)

    # -- exposition -----------------------------------------------------------

    def render(self) -> str:
        """The /metrics body: one `# TYPE` block per metric family,
        `# EOF` terminated (the OpenMetrics framing scrapers check)."""
        with self._lock:
            lines: List[str] = []
            for name in sorted({n for (n, _l) in self._counters}):
                lines.append(f"# TYPE {name} counter")
                for (n, labels), v in sorted(self._counters.items()):
                    if n == name:
                        lines.append(
                            f"{name}_total{_labels_str(labels)} "
                            f"{_fmt_val(v)}")
            for name in sorted({n for (n, _l) in self._gauges}):
                samples = [(labels, v) for (n, labels), v
                           in sorted(self._gauges.items())
                           if n == name and v is not None]
                if not samples:
                    continue
                lines.append(f"# TYPE {name} gauge")
                for labels, v in samples:
                    lines.append(
                        f"{name}{_labels_str(labels)} {_fmt_val(v)}")
            for name in sorted(self._hists):
                lines.extend(self._hists[name].render(name))
            lines.append("# EOF")
            return "\n".join(lines) + "\n"

    def health(self) -> dict:
        """Generic /healthz payload for entry points without a richer
        health source (the serve engine passes its own health())."""
        with self._lock:
            now = time.time()
            return {
                "status": "ok",
                "last_step": self._last_step,
                "last_event_age_s": (round(now - self._last_rec_t, 3)
                                     if self._last_rec_t else None),
                "events_observed": self.observed,
                "last_exit": self._last_exit,
            }


class MetricsServer:
    """ThreadingHTTPServer wrapper: /metrics (OpenMetrics), /healthz
    (JSON from `health_fn`), plus optional JSON `routes` — the
    serve-fleet data plane (a replica's /submit and /collect) rides
    the same server instead of opening a second port. Daemon threads
    throughout — a live scrape can never hold the process open past
    the run.

    `routes`: {path: fn(payload) -> (code, obj)} — fn receives the
    parsed JSON body on POST (None on GET) and returns an HTTP status
    plus a JSON-serializable object. Route exceptions surface as 500s,
    same as a scrape bug."""

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 addr: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], dict]] = None,
                 routes: Optional[Dict[str, Callable]] = None):
        self.registry = registry
        self._health_fn = health_fn or registry.health
        self._routes = dict(routes or {})
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self, payload):
                path = self.path.split("?")[0]
                try:
                    if path == "/metrics" and payload is None:
                        return self._respond(
                            200, OPENMETRICS_CONTENT_TYPE,
                            server.registry.render().encode())
                    if path == "/healthz" and payload is None:
                        h = server._health_fn()
                        code = 200 if h.get("status", "ok") == "ok" \
                            else 503
                        return self._respond(
                            code, "application/json",
                            (json.dumps(h) + "\n").encode())
                    fn = server._routes.get(path)
                    if fn is None:
                        return self._respond(404, "text/plain",
                                             b"not found\n")
                    code, obj = fn(payload)
                    body = (json.dumps(obj) + "\n").encode()
                    return self._respond(code, "application/json", body)
                except Exception as e:  # a scrape bug must stay a 500
                    return self._respond(
                        500, "text/plain",
                        f"error: {type(e).__name__}\n".encode())

            def do_GET(self):  # noqa: N802 — stdlib API
                self._dispatch(None)

            def do_POST(self):  # noqa: N802 — stdlib API
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, UnicodeDecodeError):
                    return self._respond(400, "text/plain",
                                         b"bad json\n")
                self._dispatch(payload)

            def log_message(self, *a):  # scrapes are not log lines
                pass

        self._httpd = ThreadingHTTPServer((addr, max(port, 0)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="metrics-http", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        """The BOUND port (differs from the requested one under
        port=0 — ephemeral bind, the test path)."""
        return self._httpd.server_address[1]

    @property
    def addr(self) -> str:
        return self._httpd.server_address[0]

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)


def start_metrics(telemetry, port: int, addr: str = "127.0.0.1",
                  health_fn: Optional[Callable[[], dict]] = None
                  ) -> Optional[MetricsServer]:
    """The one-call wiring every entry point uses: build a registry,
    attach it as a telemetry observer, serve it. Returns None when
    `port` is falsy/negative (the CLI's 0 = off convention; tests that
    want an ephemeral bind construct MetricsServer directly)."""
    if not port or port < 0:
        return None
    registry = MetricsRegistry()
    telemetry.add_observer(registry.observe)
    return MetricsServer(registry, port=port, addr=addr,
                         health_fn=health_fn)
