"""Live telemetry: an in-process HTTP endpoint for scrapers.

The port of ``distributed_training_tpu/observability/exporter.py``, on
the standard library's ``http.server`` alone:

- ``GET /metrics``: Prometheus text of the live flight snapshot, rendered
  by ``prometheus.prometheus_text``, which ``tools/flight_report.py
  --prometheus`` also uses, so a scrape and a report of one run agree;
- ``GET /healthz``: a small JSON object: status, the run's phase (the
  wall clock's open phase, or init/train/done), uptime, scrape count;
- ``GET /vars``: the whole snapshot as strict JSON;
- ``GET /timeseries`` and ``GET /alerts``: the serving control room's
  sample ring and SLO alert log as strict JSON, where the owner registered
  their providers (:func:`attach_engine` does); 404 otherwise, so the
  trainers' exporter serves what it always did.

Any other path answers 404 with the list of endpoints; a provider that
raises answers 500, and the server goes on.

**Scrapes read host values only.** The handler thread calls the providers
its owner registered, and ``TrainObservability.scrape_snapshot`` reads
what the meter's flush already fetched (the flight recorder's ring, the
flushed metrics, the cached cross-rank summary, counters): a scrape never
touches the card, never synchronises it and never waits for the step
loop. The server's threads are daemons, so a scraper that hangs cannot
keep the process alive.

``TrainObservability`` owns one on rank 0 when
``ObservabilityConfig.metrics_port`` is set (both trainers, both CLIs'
``--metrics-port``); the serving CLIs and ``tools/serve_bench.py`` attach
one to an ``Engine`` through :func:`attach_engine`, and the front door
(``serving/frontend.py``) answers its GETs through one.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable

from distributed_training_tpu_torch.observability.prometheus import (
    TEXT_CONTENT_TYPE,
    prometheus_text,
)

ENDPOINTS = ("/metrics", "/healthz", "/vars")


class MetricsExporter:
    """One background HTTP server over a live flight snapshot.

    >>> exp = MetricsExporter(obs.scrape_snapshot, port=9090).start()
    >>> # ... scrapers poll http://127.0.0.1:9090/metrics ...
    >>> exp.close()

    ``snapshot_provider`` returns the flight-snapshot dict;
    ``phase_provider`` the phase for ``/healthz``, ``health_provider`` the
    owner's extras there (the engine's weights epoch and counters), and
    ``timeseries_provider`` / ``alerts_provider`` the bodies of
    ``/timeseries`` and ``/alerts``. All are called on the handler's
    thread and read host values only (see the module docstring).

    ``port=0`` binds a free port (:attr:`port` says which). A port in use
    raises ``OSError`` here, before the run starts. ``host`` defaults to
    loopback: serving beyond the host is the operator's choice.
    """

    def __init__(self, snapshot_provider: Callable[[], dict], *,
                 port: int, host: str = "127.0.0.1",
                 phase_provider: Callable[[], str] | None = None,
                 health_provider: Callable[[], dict] | None = None,
                 timeseries_provider: Callable[[], dict] | None = None,
                 alerts_provider: Callable[[], dict] | None = None):
        self._provider = snapshot_provider
        self._phase = phase_provider or (lambda: "running")
        self._health_extra = health_provider
        self._timeseries = timeseries_provider
        self._alerts = alerts_provider
        self._t0 = time.perf_counter()
        self.scrapes = 0  # /metrics requests served (in /healthz)
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:
                pass  # a scrape every few seconds is no news

            def do_GET(self) -> None:
                exporter._handle(self)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host = self._server.server_address[0]
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="metrics-exporter", daemon=True)
        self._started = False
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MetricsExporter":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving and release the port (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            self._server.shutdown()
            self._thread.join(timeout=5.0)
        self._server.server_close()

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- requests ------------------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self.scrapes += 1
                body = prometheus_text(self._provider())
                ctype = TEXT_CONTENT_TYPE
            elif path == "/healthz":
                payload = {
                    "status": "ok",
                    "phase": str(self._phase()),
                    "uptime_seconds": time.perf_counter() - self._t0,
                    "scrapes": self.scrapes,
                }
                if self._health_extra is not None:
                    payload |= self._health_extra()
                body = json.dumps(payload, allow_nan=False) + "\n"
                ctype = "application/json"
            elif path == "/vars":
                # Non-finite metrics are already strings in the snapshot,
                # as in a flight dump.
                body = json.dumps(self._provider(), allow_nan=False) + "\n"
                ctype = "application/json"
            elif path == "/timeseries" and self._timeseries is not None:
                body = json.dumps(self._timeseries(), allow_nan=False) + "\n"
                ctype = "application/json"
            elif path == "/alerts" and self._alerts is not None:
                body = json.dumps(self._alerts(), allow_nan=False) + "\n"
                ctype = "application/json"
            else:
                endpoints = list(ENDPOINTS)
                if self._timeseries is not None:
                    endpoints.append("/timeseries")
                if self._alerts is not None:
                    endpoints.append("/alerts")
                self._send(req, 404, "application/json", json.dumps(
                    {"error": "not found", "endpoints": endpoints}) + "\n")
                return
        except Exception as e:  # a bad snapshot must not stop the server
            self._send(req, 500, "text/plain; charset=utf-8",
                       f"snapshot failed: {type(e).__name__}: {e}\n")
            return
        self._send(req, 200, ctype, body)

    @staticmethod
    def _send(req: BaseHTTPRequestHandler, code: int, ctype: str,
              body: str) -> None:
        data = body.encode("utf-8")
        try:
            req.send_response(code)
            req.send_header("Content-Type", ctype)
            req.send_header("Content-Length", str(len(data)))
            req.end_headers()
            req.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper hung up mid-response


def attach_engine(engine, port: int, *, component: str = "serve",
                  host: str = "127.0.0.1",
                  printer: Callable[[str], None] = print) -> MetricsExporter:
    """A started exporter over a serving ``Engine`` (JAX's wiring, which
    both serving CLIs share): snapshots from ``engine.flight_snapshot``
    (no flush, no read of the card), the ``/healthz`` phase from
    ``engine.phase`` and its extras from ``engine.health``, and the
    control room's ``/timeseries`` and ``/alerts``."""
    exporter = MetricsExporter(
        engine.flight_snapshot, port=port, host=host,
        phase_provider=lambda: engine.phase,
        health_provider=engine.health,
        timeseries_provider=engine.timeseries_snapshot,
        alerts_provider=engine.alerts_snapshot).start()
    printer(f"[{component}] live metrics: {exporter.url('')} "
            f"(/metrics /healthz /vars /timeseries /alerts)")
    return exporter
