"""Telemetry core (the port of ``skycomputing_tpu/telemetry``): span
tracer, metrics registry, time series, the live-metrics mixin and the
trace analysis.  Pure stdlib, importable from every layer, and cheap
enough to leave wired in permanently (disabled tracing is a ``None``
check).

- :mod:`.tracer` — span tracer + Chrome-trace export;
- :mod:`.metrics` — the one ``snapshot()`` contract over every stats
  surface, with counter/gauge field classification and per-source
  error isolation;
- :mod:`.timeseries` — bounded ring-buffered sampling with derived
  rates and windowed percentiles;
- :mod:`.live` — ``enable_timeseries`` / ``start_exporter`` for a
  host's registry;
- :mod:`.exporter` — opt-in ``http.server`` endpoint: ``/metrics``
  (Prometheus text), ``/metrics.json``, ``/healthz``, ``/incidents``;
- :mod:`.slo` — declared SLO targets evaluated as multi-window burn
  rates, emitting ``slo_alert`` trace instants and a registry source;
- :mod:`.flight` — the always-on flight recorder: one bounded ring of
  structured events every subsystem's sanctioned tap feeds, with a
  replay-deterministic log + digest;
- :mod:`.incidents` — the incident plane: detector rules over the
  recorder + time-series, postmortem bundles stamped with digests;
- :mod:`.analysis` — bubble fraction, per-stage utilisation, dispatch
  share and measured stage seconds from a trace.
"""

from . import analysis
from .exporter import MetricsExporter, prometheus_text
from .flight import FLIGHT_KINDS, FLIGHT_LANES, FlightEvent, FlightRecorder
from .incidents import (
    Incident,
    IncidentEngine,
    SEV_CRITICAL,
    SEV_INFO,
    SEV_WARNING,
    build_bundle,
    bundle_digest,
    cause_chain,
    chain_stages,
    default_rules,
    deterministic_bundle_view,
)
from .live import LiveMetricsMixin
from .metrics import MetricsRegistry
from .slo import SloAlert, SloMonitor, SloTarget
from .timeseries import MetricsTimeseries, nearest_rank
from .tracer import (
    Tracer,
    disable_tracing,
    enable_tracing,
    get_tracer,
    trace_span,
)

__all__ = [
    "analysis",
    "FLIGHT_KINDS",
    "FLIGHT_LANES",
    "FlightEvent",
    "FlightRecorder",
    "Incident",
    "IncidentEngine",
    "LiveMetricsMixin",
    "MetricsExporter",
    "MetricsRegistry",
    "MetricsTimeseries",
    "SEV_CRITICAL",
    "SEV_INFO",
    "SEV_WARNING",
    "SloAlert",
    "SloMonitor",
    "SloTarget",
    "Tracer",
    "build_bundle",
    "bundle_digest",
    "cause_chain",
    "chain_stages",
    "default_rules",
    "deterministic_bundle_view",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "nearest_rank",
    "prometheus_text",
    "trace_span",
]
