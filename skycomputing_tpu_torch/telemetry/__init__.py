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
- :mod:`.live` — ``enable_timeseries`` for a host's registry;
- :mod:`.analysis` — bubble fraction, per-stage utilisation, dispatch
  share and measured stage seconds from a trace.

The exporter, SLO, flight-recorder and incident planes of the JAX
package are queue A item 4.
"""

from . import analysis
from .live import LiveMetricsMixin
from .metrics import MetricsRegistry
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
    "LiveMetricsMixin",
    "MetricsRegistry",
    "MetricsTimeseries",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "nearest_rank",
    "trace_span",
]
