"""MetricsExporter: a pure-stdlib HTTP endpoint over a MetricsRegistry (the port's own
copy of ``skycomputing_tpu/telemetry/exporter.py``).

The serving fleet's counters were only reachable by holding a Python
reference to the process and calling ``snapshot()`` — nothing an
operator (or a Prometheus scraper) can point at.  This exporter serves
three endpoints from a background ``http.server`` thread:

- ``GET /metrics`` — Prometheus **text exposition format** (version
  0.0.4): one ``# TYPE`` line per metric (counter/gauge from the
  registry's ``field_types()`` classification), flat numeric fields as
  ``skytpu_<source>_<field>``, one-level nested dicts (per-reason
  rejection counters) as labels, with full label-value escaping.  When
  a time-series is attached, counter rates ride along as derived
  ``..._per_s`` gauges.
- ``GET /metrics.json`` — the registry's nested ``snapshot()`` verbatim
  (plus time-series meta), for dashboards that prefer structure.
- ``GET /healthz`` — the wired subsystem's lifecycle view (fleet
  replica states, engine queue depth, runner progress) via an optional
  ``health`` callable; 200 with ``{"status": "ok"}`` by default.
- ``GET /incidents`` — the incident plane's open + recently closed
  incidents via an optional ``incidents`` callable; 200 with an empty
  ledger by default, so scrapers can probe the route unconditionally.

Cost contract: **zero when not started** — constructing an exporter
binds nothing; ``start()`` binds the socket and spawns one daemon
thread; ``stop()`` tears both down.  Both are idempotent.  Handler
threads format whatever ``registry.snapshot()`` returns and MUST NOT
touch torch (this module is pure stdlib by contract, loadable by file
path on a bare runner); a raising source is already
isolated by the registry into ``__errors__``, which the text format
surfaces as ``skytpu_metric_source_errors``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

_ERRORS_KEY = "__errors__"  # telemetry.metrics.ERRORS_KEY, standalone copy

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

#: Prometheus types this exporter will emit in # TYPE lines; anything
#: else (or unclassified) degrades to untyped (no TYPE line)
_PROM_TYPES = ("counter", "gauge")


def sanitize_metric_name(name: str) -> str:
    """A legal Prometheus metric name: bad chars -> ``_``, and a
    leading digit gets an underscore prefix."""
    cleaned = _NAME_OK.sub("_", name)
    if cleaned and cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return cleaned


def escape_label_value(value: str) -> str:
    """Backslash, double-quote and newline escaping per the text
    exposition format."""
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _numeric(value: Any) -> Optional[float]:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return None


def _render_with_retry(render: Callable[[], bytes],
                       attempts: int = 3) -> bytes:
    """Run a snapshot render, retrying iteration races.

    Handler threads format registry snapshots while the owner's tick
    loop mutates the underlying stats objects; the time-series locks
    its own structures, but arbitrary registered sources are read
    lock-free by design (the exporter must never be able to stall a
    tick).  A dict/deque/list mutated mid-iteration raises RuntimeError
    — transient by construction — so the scrape retries instead of
    flapping to 500 exactly when load is interesting.
    """
    for attempt in range(attempts):
        try:
            return render()
        except RuntimeError:
            if attempt == attempts - 1:
                raise
    raise AssertionError("unreachable")


def _format_value(value: float) -> str:
    # integral values print without a trailing .0 (stable, diff-able)
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def prometheus_text(
    snapshot: Dict[str, Dict[str, Any]],
    types: Optional[Dict[str, str]] = None,
    *,
    prefix: str = "skytpu",
    rates: Optional[Dict[str, float]] = None,
) -> str:
    """Render one nested registry snapshot as Prometheus text.

    ``types`` is the registry's flat ``{"source.field": kind}``
    classification; ``rates`` optionally adds derived per-second gauges
    (keyed like ``types``) emitted as ``<name>_per_s``.
    """
    types = types or {}
    lines = []
    for source in sorted(snapshot):
        record = snapshot[source]
        if not isinstance(record, dict):
            continue
        if source == _ERRORS_KEY:
            name = sanitize_metric_name(f"{prefix}_metric_source_errors")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {len(record)}")
            for src in sorted(record):
                info = sanitize_metric_name(
                    f"{prefix}_metric_source_error_info")
                lines.append(
                    f'{info}{{source="{escape_label_value(src)}",'
                    f'error="{escape_label_value(record[src])}"}} 1'
                )
            continue
        for field in sorted(record):
            value = record[field]
            name = sanitize_metric_name(f"{prefix}_{source}_{field}")
            kind = types.get(f"{source}.{field}")
            got = _numeric(value)
            if got is not None:
                if kind in _PROM_TYPES:
                    lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {_format_value(got)}")
            elif isinstance(value, dict):
                # one labelled series per sub-key (per-reason counters)
                rows = [
                    (label, _numeric(sub))
                    for label, sub in sorted(value.items())
                ]
                rows = [(label, v) for label, v in rows if v is not None]
                if not rows:
                    continue
                if kind in _PROM_TYPES:
                    lines.append(f"# TYPE {name} {kind}")
                for label, v in rows:
                    lines.append(
                        f'{name}{{key="{escape_label_value(label)}"}} '
                        f"{_format_value(v)}"
                    )
            # strings/None are not exposable as samples: skipped
    for key in sorted(rates or {}):
        value = (rates or {})[key]
        if value is None:
            continue
        name = sanitize_metric_name(
            f"{prefix}_{key.replace('.', '_')}_per_s")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_format_value(float(value))}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Opt-in HTTP exporter over one registry (see module docstring).

    ``registry`` duck-types ``snapshot()`` (+ optional
    ``field_types()``); ``timeseries`` an optional
    :class:`~.timeseries.MetricsTimeseries` whose counter rates ride
    along on ``/metrics``; ``health`` a zero-arg callable returning the
    ``/healthz`` dict; ``incidents`` a zero-arg callable returning the
    ``/incidents`` dict (the incident engine's ``incidents_json``).
    """

    def __init__(
        self,
        registry: Any,
        *,
        timeseries: Any = None,
        health: Optional[Callable[[], Dict[str, Any]]] = None,
        incidents: Optional[Callable[[], Dict[str, Any]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        prefix: str = "skytpu",
    ):
        self._registry = registry
        self.timeseries = timeseries
        self._health = health
        self._incidents = incidents
        self._host = str(host)
        self._port = int(port)
        self.prefix = str(prefix)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.requests_served = 0

    # --- rendering (usable without a running server) ------------------------
    def _types(self) -> Dict[str, str]:
        field_types = getattr(self._registry, "field_types", None)
        return field_types() if callable(field_types) else {}

    def prometheus_text(self) -> str:
        ts = self.timeseries
        rates: Optional[Dict[str, float]] = None
        if ts is not None:
            rates = {
                key: ts.rate(key)
                for key in ts.keys()
                if ts.type_of(key) == "counter"
            }
        return prometheus_text(
            self._registry.snapshot(), self._types(),
            prefix=self.prefix, rates=rates,
        )

    def metrics_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"snapshot": self._registry.snapshot()}
        if self.timeseries is not None:
            out["timeseries"] = dict(
                samples=self.timeseries.samples,
                window=self.timeseries.window,
                keys=len(self.timeseries.keys()),
            )
        return out

    def health_json(self) -> Dict[str, Any]:
        if self._health is None:
            return {"status": "ok"}
        got = self._health()
        return got if isinstance(got, dict) else {"status": str(got)}

    def incidents_json(self) -> Dict[str, Any]:
        if self._incidents is None:
            return {"open": [], "closed": [],
                    "opened_total": 0, "closed_total": 0}
        got = self._incidents()
        return got if isinstance(got, dict) else {"open": [],
                                                  "closed": []}

    # --- lifecycle ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def port(self) -> int:
        """The bound port once started (resolves ``port=0``)."""
        if self._server is not None:
            return self._server.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def start(self) -> "MetricsExporter":
        """Bind the socket and serve from a daemon thread; idempotent
        (a second start returns the already-running exporter)."""
        if self._server is not None:
            return self
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:  # silence stderr
                pass

            def do_GET(self) -> None:
                route = self.path.split("?")[0]
                if route == "/metrics":
                    render, ctype = (
                        lambda: exporter.prometheus_text().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif route == "/metrics.json":
                    render, ctype = (
                        lambda: json.dumps(exporter.metrics_json())
                        .encode(),
                        "application/json",
                    )
                elif route == "/healthz":
                    render, ctype = (
                        lambda: json.dumps(exporter.health_json())
                        .encode(),
                        "application/json",
                    )
                elif route == "/incidents":
                    render, ctype = (
                        lambda: json.dumps(exporter.incidents_json())
                        .encode(),
                        "application/json",
                    )
                else:
                    self.send_error(404, "unknown endpoint")
                    return
                try:
                    body = _render_with_retry(render)
                except Exception as exc:
                    # a rendering failure is a 500, never a dead socket
                    self.send_error(500, type(exc).__name__)
                    return
                exporter.requests_served += 1
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        server = ThreadingHTTPServer((self._host, self._port), _Handler)
        server.daemon_threads = True
        thread = threading.Thread(
            target=server.serve_forever,
            name="skytpu-metrics-exporter", daemon=True,
        )
        self._server = server
        self._thread = thread
        thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down and release the port; idempotent."""
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


__all__ = [
    "MetricsExporter",
    "escape_label_value",
    "prometheus_text",
    "sanitize_metric_name",
]
