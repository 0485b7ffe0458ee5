"""Online SLO monitoring: declared targets, multi-window burn rates (the port's own
copy of ``skycomputing_tpu/telemetry/slo.py``).

``bench_fleet`` can tell you an SLO was violated — after the run ends.
This module makes the violation a LIVE, machine-readable signal: targets
are declared over the flat metric keys a
:class:`~.timeseries.MetricsTimeseries` records (fleet TTFT/TPOT
percentiles, rejection rates, heal budget), and every evaluation
computes **multi-window burn rates**, the SRE alerting idiom that kills
both failure modes of naive thresholding:

- a *fast* window (~1 tick) alone pages on every blip;
- a *slow* window alone pages minutes after the fire started.

An alert fires only when BOTH windows burn:

- **gauge targets** (percentile levels): the violating fraction of the
  window's samples divided by ``budget`` (the tolerated violating
  fraction).  ``budget=0.25, slow_window=16`` reads "p95 latency may
  exceed the threshold in at most 4 of the last 16 ticks".
- **rate targets** (counter keys — rejections, reform failures): the
  observed per-second rate over each window divided by ``threshold``
  (the budgeted rate).

Burn rate >= 1.0 on both windows = the budget is being spent at or
above the rate that exhausts it -> firing.

Consumers: the monitor emits ``slo_alert`` / ``slo_clear`` trace
instants on the ``("slo", "monitor")`` lane (visible in the Chrome
timeline next to the spans that caused them), acts as a
``MetricsRegistry`` source (``snapshot()``: per-target burn rates +
firing flags + a cumulative ``alerts_total``), and exposes
:attr:`firing` — the duck-typed signal ``AdmissionController``
(tightens its pending bound) and ``FleetSupervisor`` (checks health
every tick instead of every ``check_every``) read.

PURE STDLIB BY CONTRACT, loadable by file path on bare runners (the
``router.py`` idiom): the time-series and tracer are duck-typed, no
package-relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: comparison modes: "max" = value must stay <= threshold (latencies,
#: rejection rates), "min" = value must stay >= threshold (throughput)
MAX = "max"
MIN = "min"

#: target kinds: "gauge" evaluates sampled levels against the
#: threshold; "rate" evaluates the counter's per-second rate
GAUGE = "gauge"
RATE = "rate"


@dataclass
class SloTarget:
    """One declared objective over a flat time-series key."""

    name: str
    metric: str
    threshold: float
    mode: str = MAX
    kind: str = GAUGE
    #: tolerated violating fraction of a window (gauge kind only)
    budget: float = 0.25
    fast_window: int = 1
    slow_window: int = 16
    description: str = ""

    def __post_init__(self):
        if self.mode not in (MAX, MIN):
            raise ValueError(f"mode must be 'max' or 'min', "
                             f"got {self.mode!r}")
        if self.kind not in (GAUGE, RATE):
            raise ValueError(f"kind must be 'gauge' or 'rate', "
                             f"got {self.kind!r}")
        if self.kind == RATE and self.threshold <= 0:
            raise ValueError(
                f"rate target {self.name!r} needs threshold > 0 "
                f"(the budgeted rate)"
            )
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], "
                             f"got {self.budget}")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError(
                f"need 1 <= fast_window <= slow_window, got "
                f"{self.fast_window}/{self.slow_window}"
            )

    def violates(self, value: float) -> bool:
        if self.mode == MAX:
            return value > self.threshold
        return value < self.threshold


@dataclass
class SloAlert:
    """One evaluation's verdict for one target."""

    target: str
    metric: str
    firing: bool
    burn_fast: Optional[float]
    burn_slow: Optional[float]
    value: Optional[float]
    threshold: float
    new: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dict(
            target=self.target, metric=self.metric,
            firing=self.firing, burn_fast=self.burn_fast,
            burn_slow=self.burn_slow, value=self.value,
            threshold=self.threshold, new=self.new,
        )


class SloMonitor:
    """Evaluate declared targets against a live time-series.

    ``timeseries`` may be bound later (``ServingFleet.attach_slo``
    wires its own); :meth:`evaluate` is then driven once per fleet
    tick / engine step by whoever owns the loop.
    """

    #: registry classification for the scalar snapshot fields
    FIELD_TYPES = {"alerts_total": "counter", "evaluations": "counter",
                   "firing": "gauge", "firing_streak": "gauge",
                   "quiet_streak": "gauge"}

    def __init__(self, targets: List[SloTarget],
                 timeseries: Any = None):
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO target names in {names}")
        self.targets = list(targets)
        self.timeseries = timeseries
        self.alerts_total = 0
        self.evaluations = 0
        #: names of every target that fired at least once (a post-run
        #: artifact can tell "burned during the spike" from "never
        #: burned" even after the alert cleared)
        self.fired_ever: set = set()
        #: consecutive evaluations with >= 1 firing target / with none
        #: — the SUSTAINED-burn vs SUSTAINED-slack surface the fleet
        #: autoscaler consumes (one blip never moves a replica; only a
        #: streak does).  Gauges: they saw-tooth by design.
        self.firing_streak = 0
        self.quiet_streak = 0
        self._firing: Dict[str, SloAlert] = {}
        self._last: Dict[str, SloAlert] = {}

    # --- the signal consumers read ------------------------------------------
    @property
    def firing(self) -> Tuple[str, ...]:
        """Names of currently-firing targets (empty tuple = healthy).
        This is the duck-typed attribute admission/supervisor poll."""
        return tuple(sorted(self._firing))

    def last_alerts(self) -> List[SloAlert]:
        return [self._last[t.name] for t in self.targets
                if t.name in self._last]

    # --- evaluation ---------------------------------------------------------
    def _burn(self, target: SloTarget, ts: Any,
              window: int) -> Tuple[Optional[float], Optional[float]]:
        """(burn rate, representative value) over one window."""
        if target.kind == RATE:
            # rate over N deltas needs N+1 samples
            rate = ts.rate(target.metric, window=window + 1)
            if rate is None:
                return None, None
            if target.mode == MAX:
                return rate / target.threshold, rate
            if rate <= 0:
                return float("inf"), rate
            return target.threshold / rate, rate
        values = ts.values(target.metric, window=window)
        if not values:
            return None, None
        violating = sum(1 for v in values if target.violates(v))
        return (violating / len(values)) / target.budget, values[-1]

    def evaluate(self, tracer: Any = None) -> List[SloAlert]:
        """One pass over every target; emits ``slo_alert`` /
        ``slo_clear`` instants on rising/falling edges (and re-stamps
        ``slo_alert`` each burning evaluation so the alert is visible
        for the whole burn, not one pixel of it)."""
        ts = self.timeseries
        if ts is None:
            raise RuntimeError(
                "SloMonitor has no timeseries bound; construct with one "
                "or attach via ServingFleet.attach_slo"
            )
        alerts: List[SloAlert] = []
        for target in self.targets:
            burn_fast, value = self._burn(target, ts, target.fast_window)
            burn_slow, _ = self._burn(target, ts, target.slow_window)
            firing = (burn_fast is not None and burn_fast >= 1.0
                      and burn_slow is not None and burn_slow >= 1.0)
            was = target.name in self._firing
            alert = SloAlert(
                target=target.name, metric=target.metric,
                firing=firing, burn_fast=burn_fast,
                burn_slow=burn_slow, value=value,
                threshold=target.threshold, new=firing and not was,
            )
            alerts.append(alert)
            if firing:
                self._firing[target.name] = alert
                self.fired_ever.add(target.name)
                if alert.new:
                    self.alerts_total += 1
                if tracer is not None:
                    tracer.instant(
                        "slo_alert", tracer.lane("slo", "monitor"),
                        alert.to_dict(),
                    )
            elif was:
                self._firing.pop(target.name, None)
                if tracer is not None:
                    tracer.instant(
                        "slo_clear", tracer.lane("slo", "monitor"),
                        {"target": target.name, "metric": target.metric},
                    )
            self._last[target.name] = alert
        self.evaluations += 1
        if self._firing:
            self.firing_streak += 1
            self.quiet_streak = 0
        else:
            self.quiet_streak += 1
            self.firing_streak = 0
        return alerts

    # --- MetricsRegistry source ---------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Registry-source form: cumulative alert counter, live firing
        count, and per-target burn state (dotted sub-keys flatten into
        the time-series like any nested record)."""
        out: Dict[str, Any] = dict(
            alerts_total=self.alerts_total,
            evaluations=self.evaluations,
            firing=len(self._firing),
            firing_streak=self.firing_streak,
            quiet_streak=self.quiet_streak,
        )
        for name, alert in self._last.items():
            out[name] = dict(
                firing=1 if alert.firing else 0,
                burn_fast=alert.burn_fast,
                burn_slow=alert.burn_slow,
                value=alert.value,
            )
        return out


__all__ = ["GAUGE", "MAX", "MIN", "RATE", "SloAlert", "SloMonitor",
           "SloTarget"]
