"""Stdlib-only Prometheus scrape endpoint (counterpart of
elasticdl_tpu/observability/exporter.py).

One daemonized ThreadingHTTPServer per process serving:

    /metrics        the registry in text-exposition format
    /healthz        "ok" — a liveness probe target for k8s pod specs
    /api/summary    job-level JSON summary (master only — present when a
                    TelemetryAggregator installed a summary provider)
    /debug/profile  on-demand profiler capture of this process
                    (?seconds=N; present when a profile provider is
                    installed: the port's setup() installs none yet, so
                    the route answers 404)

GET and HEAD are both answered (k8s http probes default to HEAD; a 501
there flaps the pod). No third-party dependency: the exposition format is
plain text and the stdlib HTTP server is enough for a scraper that polls
every few seconds.

Binds ELASTICDL_METRICS_HOST (default 0.0.0.0 — a scrape endpoint is only
useful off-host; CI runs set 127.0.0.1) on the requested port;
port 0 picks an ephemeral port, published via `.port` and the endpoints/
advertisement written by observability.setup().
"""

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from elasticdl_tpu_torch.common import knobs

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

METRICS_HOST_ENV = "ELASTICDL_METRICS_HOST"


class _Handler(BaseHTTPRequestHandler):
    registry = None
    exporter = None

    def _respond(self, code, body, content_type, send_body=True):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if send_body:
            self.wfile.write(body)

    def _serve(self, send_body):
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = self.registry.expose().encode()
            self._respond(200, body, CONTENT_TYPE, send_body)
        elif path == "/healthz":
            self._respond(200, b"ok\n", "text/plain", send_body)
        elif path == "/api/summary":
            provider = self.exporter.summary_provider
            if provider is None:
                self.send_error(404)
                return
            t0 = time.perf_counter()
            try:
                body = json.dumps(provider()).encode()
            except Exception:
                # A half-updated summary must not kill the probe endpoint.
                self.send_error(500)
                return
            # Only the master carries a summary provider, so this series
            # appears exactly where it is meaningful: the cost of
            # rendering /api/summary grows with fleet size and `edl
            # dash` polls it every interval.
            self.registry.histogram(
                "edl_master_summary_render_seconds",
                "Time to render the /api/summary JSON body",
            ).observe(time.perf_counter() - t0)
            self._respond(200, body, "application/json", send_body)
        elif path == "/debug/profile":
            # On-demand profiler capture of THIS process
            # (?seconds=N, default 2): blocks the requesting connection
            # for the capture duration — the server is threaded, so
            # concurrent /metrics scrapes keep answering. 409 when a
            # capture is already running, 404 when the role has no
            # provider.
            provider = getattr(self.exporter, "profile_provider", None)
            if provider is None:
                self.send_error(404)
                return
            if not send_body:
                # A HEAD must not burn an N-second capture (and a
                # profile directory) just to answer headers.
                self.send_error(405)
                return
            query = urllib.parse.parse_qs(
                urllib.parse.urlparse(self.path).query
            )
            try:
                seconds = float(query.get("seconds", ["2.0"])[0])
            except ValueError:
                seconds = 2.0
            try:
                body = json.dumps(provider(seconds)).encode()
            except RuntimeError:
                self.send_error(409)  # capture already in flight
                return
            except Exception:
                self.send_error(500)
                return
            self._respond(200, body, "application/json", send_body)
        else:
            self.send_error(404)

    def do_GET(self):
        self._serve(send_body=True)

    def do_HEAD(self):
        # Same status/headers as GET, no body (k8s probes use HEAD).
        self._serve(send_body=False)

    def log_message(self, format, *args):
        # Scrapes every few seconds must not spam the training log.
        pass


class MetricsExporter:
    def __init__(self, registry, port=0, host=None):
        if host is None:
            host = knobs.get_str(METRICS_HOST_ENV) or "0.0.0.0"
        # Installed post-construction by the master's TelemetryAggregator;
        # callable returning a JSON-able dict for /api/summary.
        self.summary_provider = None
        # callable(seconds) -> dict backing /debug/profile; None (404)
        # until the port has on-demand profiling.
        self.profile_provider = None
        handler = type(
            "_BoundHandler",
            (_Handler,),
            {"registry": registry, "exporter": self},
        )
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="edl-metrics-exporter",
            daemon=True,
        )
        self._thread.start()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
