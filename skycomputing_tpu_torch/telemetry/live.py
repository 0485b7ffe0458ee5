"""LiveMetricsMixin: the opt-in live-observability surface of a host
(the port's own copy of ``skycomputing_tpu/telemetry/live.py``).

A host provides ``self.metrics`` (a :class:`~.metrics.MetricsRegistry`)
and ``_health_snapshot()`` (plus an optional ``_timeseries_window``
class default) and inherits :meth:`enable_timeseries`; the ``Runner``
samples the series once per iteration when it is enabled.

Cost contract (shared with the tracer): **zero until enabled** — the
attribute defaults to ``None`` at class level, ``enable_timeseries()``
allocates the ring buffers, and the host's loop pays one ``is not
None`` test per iteration while disabled.

The HTTP exporter (``/metrics``, ``/metrics.json``, ``/healthz``,
``/incidents``) belongs to the planes of queue A item 4 and is not
ported: :meth:`start_exporter` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict


class LiveMetricsMixin:
    """``enable_timeseries`` over a host's ``self.metrics`` registry
    (see module docstring)."""

    #: host-overridable default sample window (samples kept per key)
    _timeseries_window = 512

    # instance state, zero-cost default (shadowed on first enable)
    timeseries = None

    def enable_timeseries(self, window: int = 0, **kwargs):
        """Attach (or return) a ring-buffered time-series over the
        host's registry; the host samples it once per iteration.
        ``window=0`` means the host's default."""
        if self.timeseries is None:
            from .timeseries import MetricsTimeseries

            self.timeseries = MetricsTimeseries(
                self.metrics,
                window=int(window) or self._timeseries_window,
                **kwargs,
            )
        return self.timeseries

    def start_exporter(self, host: str = "127.0.0.1", port: int = 0):
        raise NotImplementedError(
            "the HTTP metrics exporter is not ported to PyTorch yet (queue "
            "A item 4: the exporter, SLO and incident planes); read "
            "self.metrics.snapshot() or enable_timeseries() instead"
        )

    def stop_exporter(self) -> None:
        """Nothing to stop: no exporter is ported."""

    def _health_snapshot(self) -> Dict[str, Any]:  # pragma: no cover
        """Hosts override with their lifecycle view."""
        return {"status": "ok"}


__all__ = ["LiveMetricsMixin"]
