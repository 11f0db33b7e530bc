"""Metric exporters (a copy of ``paddle_tpu/observability/exporters.py``):
Prometheus text format, the ``/metrics`` and ``/healthz`` HTTP endpoint,
JSON snapshot dump — stdlib only, ``http.server`` on a background thread.

Usage::

    from paddle_tpu_torch.observability import start_metrics_server
    srv = start_metrics_server()          # port from PADDLE_TPU_METRICS_PORT
    ...                                   # GET :port/metrics  /healthz
    srv.stop()                            # clean shutdown (joins thread)
"""
from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import (MetricsRegistry, _HistogramChild, default_registry)

__all__ = ["generate_latest", "json_snapshot", "dump_json",
           "MetricsServer", "start_metrics_server", "METRICS_PORT_ENV",
           "set_health_provider", "healthz_payload"]

METRICS_PORT_ENV = "PADDLE_TPU_METRICS_PORT"

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

# process-wide /healthz payload provider (e.g. a serving engine's
# ``health_payload`` bound method): its dict is merged into the healthz
# JSON body so an admission plane scrapes load (occupancy, free pages,
# chunk-queue depth, engine id) without parsing Prometheus text
_health_provider = None


def set_health_provider(provider) -> None:
    """Install (or clear, with ``None``) the process-wide callable whose
    dict enriches every ``/healthz`` response.  Typical use::

        set_health_provider(engine.health_payload)
    """
    global _health_provider
    _health_provider = provider


def healthz_payload(provider=None) -> dict:
    """The ``/healthz`` JSON body.  Always contains ``status: "ok"`` —
    the bare 200-with-"ok" contract existing callers probe — plus the
    provider's load fields when one is installed.  A raising or
    non-dict provider degrades to the bare payload: a liveness probe
    must never 500 because a stats callback broke."""
    payload = {"status": "ok"}
    provider = provider or _health_provider
    if provider is not None:
        try:
            extra = provider()
            if isinstance(extra, dict):
                extra = dict(extra)         # never mutate the
                extra.pop("status", None)   # provider's own dict;
                payload.update(extra)       # liveness field is ours
        except Exception:                             # noqa: BLE001
            pass
    return payload


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(text: str) -> str:
    return (text.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:
        return "NaN"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in items.items())
    return "{" + inner + "}"


def generate_latest(registry: Optional[MetricsRegistry] = None) -> bytes:
    """The registry rendered in the Prometheus text exposition format
    (version 0.0.4) — what ``GET /metrics`` serves."""
    registry = registry or default_registry()
    lines = []
    for metric in registry.collect():
        if metric.help:
            lines.append(f"# HELP {metric.name} "
                         f"{_escape_help(metric.help)}")
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        for child in metric.children():
            if isinstance(child, _HistogramChild):
                cum = child.cumulative()
                for bound, acc in zip(metric.buckets, cum):
                    lines.append(
                        f"{metric.name}_bucket"
                        f"{_labels_str(child.labels, {'le': '%g' % bound})}"
                        f" {acc}")
                lines.append(
                    f"{metric.name}_bucket"
                    f"{_labels_str(child.labels, {'le': '+Inf'})}"
                    f" {cum[-1]}")
                lines.append(f"{metric.name}_sum"
                             f"{_labels_str(child.labels)} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{metric.name}_count"
                             f"{_labels_str(child.labels)} {child.count}")
            else:
                lines.append(f"{metric.name}{_labels_str(child.labels)} "
                             f"{_fmt_value(child.value)}")
    return ("\n".join(lines) + "\n").encode("utf-8")


def json_snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-able snapshot of every series (the machine-readable twin of
    :func:`generate_latest`; ``bench.py --emit-metrics`` dumps this)."""
    return (registry or default_registry()).snapshot()


def dump_json(path: str,
              registry: Optional[MetricsRegistry] = None) -> str:
    """Atomically write the JSON snapshot to ``path`` (temp + rename, so
    a concurrent scraper never reads a half-written file)."""
    snap = json_snapshot(registry)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snap, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


class _Handler(BaseHTTPRequestHandler):
    # the server thread must never block scraping on a slow reverse DNS
    # lookup, and per-request stderr chatter is noise in a train log
    def log_message(self, fmt, *args):                # noqa: A002
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                                 # noqa: N802
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            try:
                body = generate_latest(self.server._registry)
            except Exception as e:                    # noqa: BLE001
                self._send(500, repr(e).encode(), "text/plain")
                return
            self._send(200, body, CONTENT_TYPE_LATEST)
        elif path == "/healthz":
            try:
                # default=str: numpy scalars (this codebase's natural
                # numeric type) serialize as digit strings, which
                # scrapers int()/float() fine
                body = json.dumps(
                    healthz_payload(
                        getattr(self.server, "_health_provider", None)),
                    default=str) + "\n"
            except Exception:                         # noqa: BLE001
                # the liveness contract outranks the stats payload
                body = '{"status": "ok"}\n'
            self._send(200, body.encode("utf-8"), "application/json")
        else:
            self._send(404, b"not found\n", "text/plain")


class MetricsServer:
    """Background-thread HTTP endpoint serving ``/metrics`` (Prometheus
    text format) and ``/healthz``.

    Port resolution: explicit ``port`` arg, else the
    ``PADDLE_TPU_METRICS_PORT`` env var, else 0 (OS-assigned ephemeral —
    read the bound port back from ``.port``).  ``stop()`` shuts the
    listener down cleanly and joins the serving thread.
    """

    def __init__(self, port: Optional[int] = None, addr: str = "0.0.0.0",
                 registry: Optional[MetricsRegistry] = None,
                 health_provider=None):
        if port is None:
            port = int(os.environ.get(METRICS_PORT_ENV, "0") or 0)
        self.addr = addr
        self._requested_port = int(port)
        self.registry = registry or default_registry()
        # per-server /healthz enrichment (falls back to the
        # process-wide set_health_provider when None)
        self.health_provider = health_provider
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.addr, self._requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        httpd._registry = self.registry
        httpd._health_provider = self.health_provider
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="pdtpu-metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()           # stops serve_forever
            httpd.server_close()       # releases the listening socket
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_metrics_server(port: Optional[int] = None,
                         addr: str = "0.0.0.0",
                         registry: Optional[MetricsRegistry] = None,
                         health_provider=None) -> MetricsServer:
    """Convenience: construct + start a :class:`MetricsServer`."""
    return MetricsServer(port=port, addr=addr, registry=registry,
                         health_provider=health_provider).start()
