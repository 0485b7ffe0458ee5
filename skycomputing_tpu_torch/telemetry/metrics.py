"""MetricsRegistry: one ``snapshot()`` contract over every stats surface
(the port's own copy of ``skycomputing_tpu/telemetry/metrics.py``).

- a **source** is anything exposing ``snapshot() -> dict``
  (``PipelineStats`` does) or a zero-argument callable returning a dict
  — the callable form is what lets a consumer register "the pipeline's
  stats" once even though ``PipelineModel`` rebinds ``self.stats`` to a
  fresh object every step;
- :meth:`MetricsRegistry.snapshot` returns ``{source_name: {field:
  value}}`` — the nested form dashboards consume;
- :meth:`MetricsRegistry.flat` returns ``{"source.field": value}`` —
  the form counter files consume.

``Runner`` registers its pipeline stats under ``"pipeline"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

Source = Union[Callable[[], Dict[str, Any]], Any]

#: reserved source name carrying per-source exception records in a
#: snapshot (see :meth:`MetricsRegistry.snapshot`); never a real source
ERRORS_KEY = "__errors__"


class MetricsRegistry:
    """Named metric sources behind one ``snapshot()`` contract."""

    def __init__(self) -> None:
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._types: Dict[str, Dict[str, str]] = {}

    def register(self, name: str, source: Source,
                 types: Optional[Dict[str, str]] = None) -> None:
        """Register a source under ``name``.

        ``source`` is either an object with a ``snapshot()`` method or a
        zero-arg callable returning a dict.  Duplicate names are an
        error: two subsystems silently shadowing each other's counters
        is exactly the ambiguity this registry exists to remove.

        ``types`` optionally maps this source's field names to
        ``"counter"`` (cumulative, never decreasing within a source
        lifetime) or ``"gauge"`` (point-in-time).  Object sources may
        instead carry a class-level ``FIELD_TYPES`` dict; the exporter's
        Prometheus ``# TYPE`` lines and the time-series rate derivation
        both read this classification via :meth:`field_types`.
        """
        if name == ERRORS_KEY:
            raise ValueError(f"{ERRORS_KEY!r} is reserved for snapshot "
                             f"error records")
        if name in self._sources:
            raise ValueError(f"metric source {name!r} already registered")
        snap = getattr(source, "snapshot", None)
        if callable(snap):
            self._sources[name] = snap
        elif callable(source):
            self._sources[name] = source
        else:
            raise TypeError(
                f"metric source {name!r} must expose snapshot() or be "
                f"callable, got {type(source).__name__}"
            )
        if types is None:
            types = getattr(type(source), "FIELD_TYPES", None)
        if types:
            self._types[name] = dict(types)

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)
        self._types.pop(name, None)

    def names(self) -> List[str]:
        return sorted(self._sources)

    def __contains__(self, name: str) -> bool:
        return name in self._sources

    def field_types(self, sep: str = ".") -> Dict[str, str]:
        """Flat ``{"source.field": "counter"|"gauge"}`` over every
        source that declared types (unclassified fields are absent —
        consumers treat them as untyped/gauge)."""
        out: Dict[str, str] = {}
        for name, fields in self._types.items():
            for field, kind in fields.items():
                out[f"{name}{sep}{field}"] = kind
        return out

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """``{source_name: snapshot_dict}`` over every registered source.

        A source that RAISES is isolated: its exception is recorded
        under the reserved ``"__errors__"`` key (``{source: "Type:
        message"}``) and every other source still reports — one broken
        source must not hide the rest, or kill the fleet tick that
        polled it mid-heal.  A source *returning* a non-dict is a
        contract violation surfaced immediately (a silently-skipped
        source would read as "no metrics" downstream).
        """
        out: Dict[str, Dict[str, Any]] = {}
        errors: Dict[str, str] = {}
        for name, snap in self._sources.items():
            try:
                value = snap()
            except Exception as exc:
                errors[name] = f"{type(exc).__name__}: {exc}"
                continue
            if not isinstance(value, dict):
                raise TypeError(
                    f"metric source {name!r} snapshot() returned "
                    f"{type(value).__name__}, expected dict"
                )
            out[name] = value
        if errors:
            out[ERRORS_KEY] = errors
        return out

    def flat(self, sep: str = ".") -> Dict[str, Any]:
        """One flat ``{"source.field": value}`` dict (counter-file form)."""
        out: Dict[str, Any] = {}
        for name, record in self.snapshot().items():
            for key, value in record.items():
                out[f"{name}{sep}{key}"] = value
        return out


__all__ = ["ERRORS_KEY", "MetricsRegistry"]
