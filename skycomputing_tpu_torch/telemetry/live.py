"""LiveMetricsMixin: one opt-in observability surface, three hosts (the
port's own copy of ``skycomputing_tpu/telemetry/live.py``).

``Runner`` (training), ``ServingEngine`` (one pipeline), and
``ServingFleet`` (many) all expose the same live-observability trio —
a per-iteration/step/tick time-series, an HTTP exporter, and the
``/healthz`` callback — over their own ``MetricsRegistry``.  This
mixin is that surface, written once: hosts provide ``self.metrics``
and ``_health_snapshot()`` (plus an optional ``_timeseries_window``
class default) and inherit the rest, so a fix to the wiring lands on
all three at once instead of drifting per copy.

Cost contract (shared with the tracer): **zero until enabled** — the
attributes default to ``None`` at class level, ``enable_timeseries()``
allocates the ring buffers, ``start_exporter()`` binds the socket, and
the host's loop pays one ``is not None`` test per tick while disabled.

The exporter always serves the CURRENT time-series: enabling the
time-series after the exporter started (or vice versa) rebinds it, so
call order cannot silently drop the derived ``_per_s`` rate metrics.
"""

from __future__ import annotations

from typing import Any, Dict


class LiveMetricsMixin:
    """``enable_timeseries`` / ``start_exporter`` / ``stop_exporter``
    over a host's ``self.metrics`` registry (see module docstring)."""

    #: host-overridable default sample window (samples kept per key)
    _timeseries_window = 512

    # instance state, zero-cost defaults (shadowed on first enable)
    timeseries = None
    _exporter = None

    def enable_timeseries(self, window: int = 0, **kwargs):
        """Attach (or return) a ring-buffered time-series over the
        host's registry; the host samples it once per iteration /
        step / tick.  ``window=0`` means the host's default."""
        if self.timeseries is None:
            from .timeseries import MetricsTimeseries

            self.timeseries = MetricsTimeseries(
                self.metrics,
                window=int(window) or self._timeseries_window,
                **kwargs,
            )
            if self._exporter is not None:
                # an already-running exporter picks up the new series
                self._exporter.timeseries = self.timeseries
        return self.timeseries

    def start_exporter(self, host: str = "127.0.0.1", port: int = 0):
        """Start (or return) the HTTP metrics endpoint — ``/metrics``
        (Prometheus text, with the time-series' counter rates when one
        is enabled), ``/metrics.json``, ``/healthz`` (the host's
        ``_health_snapshot``), and ``/incidents`` (the host's incident
        engine when one is attached; an empty ledger otherwise).
        Handler threads format registry snapshots only — no torch, no
        host mutation."""
        if self._exporter is None:
            from .exporter import MetricsExporter

            self._exporter = MetricsExporter(
                self.metrics, timeseries=self.timeseries,
                health=self._health_snapshot,
                incidents=self._incidents_json,
                host=host, port=port,
            )
        else:
            self._exporter.timeseries = self.timeseries
        return self._exporter.start()

    def stop_exporter(self) -> None:
        """Shut the endpoint down and release the port; idempotent."""
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    def _health_snapshot(self) -> Dict[str, Any]:  # pragma: no cover
        """Hosts override with their lifecycle view."""
        return {"status": "ok"}

    def _incidents_json(self) -> Dict[str, Any]:
        """The ``/incidents`` body: hosts carrying an incident engine
        (``self.incidents``, set by ``ServingFleet.attach_flight``)
        serve its ledger; everyone else serves an empty one."""
        engine = getattr(self, "incidents", None)
        if engine is None:
            return {"open": [], "closed": [],
                    "opened_total": 0, "closed_total": 0}
        return engine.incidents_json()


__all__ = ["LiveMetricsMixin"]
