"""MetricsTimeseries: bounded ring-buffered sampling of a MetricsRegistry.

``MetricsRegistry.snapshot()`` is a point in time; nothing in the repo
could answer "what was the queue depth doing over the last 500 ticks" or
"how many tokens per second is the fleet ACTUALLY generating" without an
offline trace file.  This recorder samples any registry-shaped source at
tick/step granularity into per-key ring buffers and derives the two
quantities dashboards and the SLO monitor need:

- **rates** — for counters (cumulative fields, classified by the
  registry's ``field_types()``), the per-second rate over a window of
  samples.  Counter *resets* (a re-formed replica's fresh engine, a
  restarted run) appear as negative deltas; those are dropped rather
  than summed, so a reset reads as a momentary rate dip, never a huge
  negative spike.
- **windowed percentiles** — nearest-rank percentiles over the stored
  sample values of any key (gauges: "p95 of the queue depth over the
  last 64 ticks").

Memory is bounded twice: each key's series is a ``deque(maxlen=window)``
and the number of distinct keys is capped at ``max_keys`` (keys beyond
the cap are counted in ``skipped_keys``, never silently eaten).

The port's own copy of ``skycomputing_tpu/telemetry/timeseries.py``.
Pure stdlib: no numpy, no package-relative imports, and safe to call
from other threads.  The
registry is duck-typed: anything with ``snapshot() -> {source: {field:
value}}`` (and optionally ``field_types()``) works.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

#: reserved snapshot key carrying per-source error strings (see
#: telemetry.metrics.ERRORS_KEY; duplicated literal so this module
#: stays loadable standalone by file path)
_ERRORS_KEY = "__errors__"

_DEFAULT_WINDOW = 512


def _numeric(value: Any) -> Optional[float]:
    """The float of a sampleable value, else None (bool -> 0/1)."""
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return None


def nearest_rank(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over a value list, stdlib-only."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      round(q / 100.0 * (len(ordered) - 1))))
    return ordered[int(rank)]


class MetricsTimeseries:
    """Ring-buffered time-series over one registry's flat metric keys.

    ``window`` bounds samples kept per key; ``max_keys`` bounds distinct
    keys; ``clock`` is injectable for tests (rate math under a fake
    clock must be exact).  ``types`` overrides the counter/gauge
    classification (default: the registry's ``field_types()`` when it
    has one).
    """

    def __init__(
        self,
        registry: Any,
        *,
        window: int = _DEFAULT_WINDOW,
        max_keys: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        types: Optional[Dict[str, str]] = None,
    ):
        if window < 2:
            # a 1-sample window can never derive a rate; refuse early
            raise ValueError(f"window must be >= 2, got {window}")
        self._registry = registry
        self.window = int(window)
        self.max_keys = int(max_keys)
        self._clock = clock
        # one lock over the series structures: exporter handler threads
        # read (keys/series/rate/percentile) concurrently with the tick
        # loop's sample() — an unlocked dict/deque iterated mid-insert
        # raises RuntimeError, which would flap every scrape that races
        # a tick.  sample() is once per tick and reads are scrape-rate,
        # so the lock is uncontended in practice.
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        if types is None:
            field_types = getattr(registry, "field_types", None)
            types = field_types() if callable(field_types) else {}
        self._types: Dict[str, str] = dict(types)
        self.samples = 0
        self.skipped_keys = 0
        self.source_errors = 0

    # --- classification -----------------------------------------------------
    def type_of(self, key: str) -> str:
        """``"counter"`` / ``"gauge"`` for a flat key (label-expanded
        keys like ``fleet.rejected_by_reason.queue_full`` fall back to
        their parent field's classification); unclassified -> gauge."""
        got = self._types.get(key)
        if got is not None:
            return got
        parent = key.rsplit(".", 1)[0]
        return self._types.get(parent, "gauge")

    # --- sampling -----------------------------------------------------------
    def sample(self) -> Dict[str, float]:
        """Read one registry snapshot into the series; returns the flat
        numeric sample.  Non-numeric fields are skipped; one level of
        nested dicts (per-reason counters) flattens into dotted keys;
        ``__errors__`` records count into ``source_errors`` instead of
        becoming series."""
        t = self._clock()
        flat: Dict[str, float] = {}
        snapshot = self._registry.snapshot()
        for source, record in snapshot.items():
            if source == _ERRORS_KEY:
                self.source_errors += len(record)
                continue
            if not isinstance(record, dict):
                continue
            for field, value in record.items():
                got = _numeric(value)
                if got is not None:
                    flat[f"{source}.{field}"] = got
                elif isinstance(value, dict):
                    for label, sub in value.items():
                        sub_v = _numeric(sub)
                        if sub_v is not None:
                            flat[f"{source}.{field}.{label}"] = sub_v
        with self._lock:
            for key, value in flat.items():
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self.max_keys:
                        self.skipped_keys += 1
                        continue
                    series = self._series[key] = deque(maxlen=self.window)
                series.append((t, value))
            self.samples += 1
        return flat

    # --- access -------------------------------------------------------------
    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def key_count(self) -> int:
        """O(1) count of tracked keys — the cheap staleness check for
        consumers caching a filtered key list (detector rules)."""
        with self._lock:
            return len(self._series)

    def series(self, key: str) -> List[Tuple[float, float]]:
        """(timestamp, value) pairs for a key, oldest first."""
        with self._lock:
            return list(self._series.get(key, ()))

    def values(self, key: str,
               window: Optional[int] = None) -> List[float]:
        """The newest ``window`` sampled values of a key (all when
        ``window`` is None).  O(window), not O(series): the incident
        plane's detector rules call this every few ticks, so tail reads
        must not copy the whole ring."""
        with self._lock:
            series = self._series.get(key)
            if not series:
                return []
            if window is None or int(window) >= len(series):
                return [v for _, v in series]
            out = []
            for point in reversed(series):
                out.append(point[1])
                if len(out) == int(window):
                    break
        out.reverse()
        return out

    def latest(self, key: str) -> Optional[float]:
        """The newest sampled value of a key — O(1), the hot read the
        counter-monotonicity detector makes once per counter per
        evaluation."""
        with self._lock:
            series = self._series.get(key)
            return series[-1][1] if series else None

    def latest_sample(self) -> Dict[str, float]:
        """The most recent value of every key (one flat dict)."""
        with self._lock:
            return {k: pts[-1][1]
                    for k, pts in self._series.items() if pts}

    # --- derivations --------------------------------------------------------
    def rate(self, key: str,
             window: Optional[int] = None) -> Optional[float]:
        """Per-second rate over the newest ``window`` samples (all when
        None); None until two samples exist or while time stands still.

        Counters sum only POSITIVE deltas, so a counter reset (replica
        re-form) cannot produce a negative rate; gauges use the net
        first-to-last delta (the rate of change of the level).
        """
        pts = self.series(key)
        if len(pts) < 2:
            return None
        if window is not None:
            pts = pts[-max(int(window), 2):]
        if len(pts) < 2:
            return None
        elapsed = pts[-1][0] - pts[0][0]
        if elapsed <= 0:
            return None
        if self.type_of(key) == "counter":
            moved = sum(
                max(b[1] - a[1], 0.0) for a, b in zip(pts, pts[1:])
            )
        else:
            moved = pts[-1][1] - pts[0][1]
        return moved / elapsed

    def percentile(self, key: str, q: float,
                   window: Optional[int] = None) -> Optional[float]:
        """Nearest-rank percentile over the newest ``window`` sampled
        values of a key (all stored samples when None)."""
        return nearest_rank(self.values(key, window), q)

    def summary(self, keys: Optional[List[str]] = None,
                points: int = 64) -> Dict[str, Dict[str, Any]]:
        """JSON-able digest per key: last value, per-second rate, p50 /
        p95 over the window, and the newest ``points`` raw samples —
        the form bench artifacts embed."""
        out: Dict[str, Dict[str, Any]] = {}
        for key in (keys if keys is not None else self.keys()):
            pts = self.series(key)
            if not pts:
                continue
            out[key] = dict(
                type=self.type_of(key),
                last=pts[-1][1],
                rate_per_s=self.rate(key),
                p50=self.percentile(key, 50),
                p95=self.percentile(key, 95),
                points=[[round(t, 6), v] for t, v in pts[-points:]],
            )
        return out


__all__ = ["MetricsTimeseries", "nearest_rank"]
