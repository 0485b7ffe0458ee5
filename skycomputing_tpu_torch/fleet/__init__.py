"""Fault-tolerant serving fleet (the port of ``skycomputing_tpu/fleet``):
replicated engines behind SLO-aware routing, admission control with
explicit load-shedding, and replica self-heal.

- :mod:`.router` — least-loaded + prefix-affinity dispatch over live
  replica metric snapshots (PURE stdlib: loadable by file path for the
  CI smoke);
- :mod:`.admission` — bounded intake, priority classes, deadline-aware
  rejects with ``Retry-After``-style hints (pure stdlib too);
- :mod:`.replica` — :class:`EngineReplica`, one named
  :class:`~..serving.ServingEngine` with health state, the chaos fault
  surface, and its verified rebuild path;
- :mod:`.supervisor` — :class:`FleetSupervisor`, heartbeat + EWMA
  detection and the drain -> migrate -> re-form executor (the
  verify-then-apply / guarded-rollback contract, visible as async
  ``fleet_heal`` trace arcs);
- :mod:`.fleet` — :class:`ServingFleet`, the orchestrator, with
  :class:`FleetStats` and a fleet-wide :class:`~..telemetry.
  MetricsRegistry`;
- :mod:`.autoscaler` — :class:`FleetAutoscaler`, sustained SLO burn ->
  verified replica ADD, sustained slack -> drain-then-REMOVE, with
  hysteresis + cooldown and a ``plan_check`` scale pre-flight.
"""

from __future__ import annotations

from .admission import (
    AdmissionController,
    AdmitDecision,
    BATCH,
    INTERACTIVE,
)
from .autoscaler import FleetAutoscaler
from .fleet import FleetStats, ServingFleet
from .replica import EngineReplica, ReplicaCrashed
from .router import Router, prefix_key, replica_load
from .supervisor import FleetSupervisor

__all__ = [
    "AdmissionController",
    "AdmitDecision",
    "BATCH",
    "EngineReplica",
    "FleetAutoscaler",
    "FleetStats",
    "FleetSupervisor",
    "INTERACTIVE",
    "ReplicaCrashed",
    "Router",
    "ServingFleet",
    "prefix_key",
    "replica_load",
]
