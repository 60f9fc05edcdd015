"""Opt-in HTTP scrape surface for the telemetry plane (stdlib-only).

Counterpart of ``mlsl_tpu.obs.serve``, by adapted copy.

``MLSL_METRICS_PORT=<port>`` (or :func:`start_server`) runs one daemon
``ThreadingHTTPServer`` thread serving:

- ``/metrics`` — the registry in Prometheus text exposition format
  (``obs/metrics.py to_prometheus``); scrape it with any Prometheus-
  compatible collector.
- ``/healthz`` — ``supervisor.status()`` rendered VERBATIM as JSON: breaker
  states, sentinel/analysis verdicts, elastic world state, straggler state,
  registry summary. tests/test_metrics.py pins JSON round-trip
  serializability so a non-serializable field fails in tier-1, not in a
  production scrape.
- ``/statusz`` — human one-screen summary (plain text): world/health header
  plus the per-series table the trace_view ``--metrics`` mode renders.

Design constraints (why this is not a web framework):

- The handler thread only READS process-wide Python values (registry
  snapshots, breaker status dicts, counters) -- it never touches a CUDA
  tensor (no ``.item()``, no ``.cpu()``: a read would synchronize with the
  training loop's stream and launch work from a second thread) and never
  blocks the training loop.
- Port 0 binds an ephemeral port (tests); the bound port is on
  ``MetricsServer.port``.
- Serving failures return 500 with the error text instead of killing the
  thread; request logging routes to log_debug (a scrape every few seconds
  must not spam stderr).
- The server is process-wide like the tracer: ``Environment.finalize`` does
  NOT stop it (a recovery teardown/rebuild cycle must not drop the scrape
  surface mid-incident); :func:`stop_server` stops it explicitly.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mlsl_tpu_torch.log import log_debug, log_warning
from mlsl_tpu_torch.obs import metrics as metrics_mod

ENV_PORT = "MLSL_METRICS_PORT"
ENV_ADDR = "MLSL_METRICS_ADDR"
DEFAULT_ADDR = ""  # all interfaces: the scrape surface is for remote collectors


def healthz_doc() -> dict:
    """The /healthz body: ``supervisor.status()`` (lazy import -- supervisor
    sits above obs in the import graph), plus, on the pod leader only, a
    ``pod`` key merging every member's last pushed status and heartbeat age
    (``control``): one scrape of the leader answers for the whole pod."""
    from mlsl_tpu_torch import control as control_mod
    from mlsl_tpu_torch import supervisor

    doc = supervisor.status()
    plane = control_mod.get_active()
    if plane is not None and plane.is_leader():
        doc["pod"] = plane.pod_status()
    return doc


def statusz_text() -> str:
    """The /statusz body: one screen of human-readable health."""
    lines = ["mlsl_tpu_torch statusz", "======================", ""]
    try:
        doc = healthz_doc()
        elastic = doc.get("elastic", {})
        lines.append(
            f"world: {elastic.get('active_size')}/{elastic.get('world_size')}"
            f" devices ({elastic.get('state', '?')})"
        )
        breakers = ", ".join(
            f"{name}:{st['state']}"
            for name, st in sorted(doc.items())
            # breaker-shaped entries only: elastic is on the world line,
            # straggler and control have their own lines below — listing
            # 'watching'/'member' here would read a healthy sentinel as a
            # degraded subsystem
            if isinstance(st, dict) and "state" in st
            and name not in ("elastic", "straggler", "control")
        )
        if breakers:
            lines.append(f"subsystems: {breakers}")
        ctl = doc.get("control", {})
        if ctl.get("state", "off") != "off":
            lines.append(
                f"pod: {ctl.get('state')} rank={ctl.get('rank')} "
                f"epoch={ctl.get('epoch')} leader={ctl.get('leader')} "
                f"alive={ctl.get('alive')} dead={ctl.get('dead')}"
            )
        strag = doc.get("straggler", {})
        if strag.get("state", "off") != "off":
            lines.append(
                f"straggler: {strag.get('state')} "
                f"(flagged={strag.get('flagged')}, "
                f"audits={strag.get('audits')})"
            )
        mets = doc.get("metrics", {})
        lines.append(
            f"metrics: {'armed' if mets.get('armed') else 'off'}"
            + (f" ({mets.get('series')} series, "
               f"{mets.get('samples_taken')} samples)"
               if mets.get("armed") else "")
        )
    except Exception as e:  # the summary must render even half-initialized
        lines.append(f"status unavailable: {type(e).__name__}: {e}")
    reg = metrics_mod._registry
    if reg is not None:
        lines += ["", "series:",
                  metrics_mod.render_summary(
                      metrics_mod.summarize_jsonl(
                          reg.jsonl_snapshot().splitlines()))]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "mlsl-metrics/1"

    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                reg = metrics_mod._registry
                body = reg.to_prometheus() if reg is not None else ""
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body = json.dumps(healthz_doc())
                ctype = "application/json"
            elif path in ("/", "/statusz"):
                body = statusz_text()
                ctype = "text/plain; charset=utf-8"
            else:
                self._respond(404, "text/plain", f"no such endpoint: {path}\n")
                return
            self._respond(200, ctype, body)
        except Exception as e:
            self._respond(500, "text/plain",
                          f"{type(e).__name__}: {e}\n")

    def _respond(self, code: int, ctype: str, body: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up mid-body; nothing to recover

    def log_message(self, fmt, *args):  # noqa: A003 - handler API
        log_debug("metrics server: " + fmt, *args)


class MetricsServer:
    """One ThreadingHTTPServer on a daemon thread."""

    def __init__(self, port: int, addr: Optional[str] = None):
        if addr is None:
            addr = os.environ.get(ENV_ADDR, DEFAULT_ADDR)
        self._httpd = ThreadingHTTPServer((addr, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.addr = addr
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mlsl-metrics-http",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if self._thread.is_alive():  # pragma: no cover - defensive
            log_warning("metrics server thread did not stop within 5s")


#: the process-wide server (one scrape surface per process, like the tracer)
_server: Optional[MetricsServer] = None


def get_server() -> Optional[MetricsServer]:
    return _server


def start_server(port: Optional[int] = None,
                 addr: Optional[str] = None) -> Optional[MetricsServer]:
    """Start the scrape surface (idempotent; the first successful start
    wins). ``port`` defaults to MLSL_METRICS_PORT (unset/0 there = do not
    serve); an EXPLICIT ``port=0`` binds an ephemeral port (tests read it
    back from ``MetricsServer.port``). The registry is armed alongside — a
    scrape surface over a disabled registry would answer every /metrics
    with an empty document. Failures (port in use) log a warning and return
    None: telemetry must never take the training job down."""
    global _server
    if _server is not None:
        return _server
    if port is None:
        env_port = os.environ.get(ENV_PORT)
        if not env_port:
            return None
        try:
            port = int(env_port)
        except ValueError:
            log_warning("invalid %s=%r; metrics server not started",
                        ENV_PORT, env_port)
            return None
        if port <= 0:
            return None
    if int(port) < 0:
        return None
    metrics_mod.enable()
    try:
        _server = MetricsServer(int(port), addr=addr)
    except OSError as e:
        log_warning("metrics server failed to bind port %s: %s — telemetry "
                    "endpoints disabled for this run", port, e)
        return None
    log_debug("metrics server listening on %s:%d", _server.addr or "0.0.0.0",
              _server.port)
    return _server


def stop_server() -> None:
    global _server
    if _server is not None:
        _server.stop()
        _server = None
