"""Live introspection plane: a small stdlib HTTP endpoint per process, the
port's own copy of ``fedtpu/obs/http.py``.

- ``/metrics``: the :class:`~fedtpu_torch.obs.MetricsRegistry` as
  Prometheus text, rendered from one ``snapshot()`` per request (a scrape
  mid-round is a consistent point-in-time view);
- ``/healthz``: 200 ``ok`` without a ``health_fn``; with one, 200 or 503
  and its one-line reason (a fenced coordinator, quorum unmet);
- ``/statusz``: JSON from ``status_fn`` (the owner's ``status_snapshot``);
- ``/flightz``: the flight recorder's ring, readable before a crash.

``http.server`` on daemon threads: no cost until a request arrives, and the
handler only reads snapshots, so a scrape cannot stall a round; a scrape
never raises into the process.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class StatusBoard:
    """Thread-safe last-write-wins status dict, the producer side of
    ``/statusz``. Round loops ``update(round=..., phase=...)`` as they move
    through phases; ``snapshot()`` is what the endpoint (or any poller)
    reads. One dict merge under a lock per update, cheap enough to run
    unconditionally."""

    def __init__(self, **initial):
        self._data = dict(initial)
        self._lock = threading.Lock()

    def update(self, **fields) -> None:
        with self._lock:
            self._data.update(fields)
            self._data["updated_at"] = time.time()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._data)


class _Handler(BaseHTTPRequestHandler):
    # Set by ObsServer on the server object; read via self.server.
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence per-request stderr lines
        return

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                health_fn = self.server.obs_health_fn
                if health_fn is None:
                    self._send(200, b"ok\n", "text/plain; charset=utf-8")
                else:
                    ok, reason = health_fn()
                    self._send(
                        200 if ok else 503,
                        (reason + "\n").encode(),
                        "text/plain; charset=utf-8",
                    )
            elif path == "/metrics":
                registry = self.server.obs_registry
                if registry is None:
                    self._send(404, b"no metrics registry\n", "text/plain")
                    return
                from fedtpu_torch.obs.exporters import prometheus_text

                self._send(
                    200, prometheus_text(registry).encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/statusz":
                status_fn = self.server.obs_status_fn
                status = status_fn() if status_fn is not None else {}
                self._send(
                    200, (json.dumps(status) + "\n").encode(),
                    "application/json",
                )
            elif path == "/flightz":
                flight = self.server.obs_flight
                if flight is None:
                    self._send(404, b"no flight recorder\n", "text/plain")
                    return
                self._send(
                    200, (json.dumps(flight.snapshot()) + "\n").encode(),
                    "application/json",
                )
            else:
                self._send(404, b"have: /metrics /healthz /statusz "
                                b"/flightz\n", "text/plain")
        except BrokenPipeError:
            pass
        except Exception as exc:  # a scrape must never kill the process
            try:
                self._send(500, f"{exc}\n".encode(), "text/plain")
            except Exception:
                pass


class ObsServer:
    """Owns the listening socket + serve thread. ``port=0`` binds an
    ephemeral port (tests); ``port`` after :meth:`start` is the real one."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry=None,
        status_fn: Optional[Callable[[], dict]] = None,
        flight=None,
        health_fn: Optional[Callable[[], tuple]] = None,
    ):
        """``health_fn``: () -> (ok, reason) — the owning component's
        honest liveness verdict (e.g. ``PrimaryServer.health``); None
        keeps the legacy unconditional 200."""
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.obs_registry = registry
        self._httpd.obs_status_fn = status_fn
        self._httpd.obs_flight = flight
        self._httpd.obs_health_fn = health_fn
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "ObsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()
