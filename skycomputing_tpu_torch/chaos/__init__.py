"""The chaos plane: seeded, replayable fault campaigns + auditing (the
port of ``skycomputing_tpu/chaos``).

- :mod:`.plan` — the PURE-STDLIB core: :class:`FaultEvent` /
  :class:`FaultPlan` declare a fault campaign; one seeded
  ``random.Random`` lowers jitter to a byte-reproducible event
  schedule, and the named catalog (``replica_crash_storm``,
  ``rolling_stragglers``, ``mid_drain_kill``, ``swap_corruption``,
  ``reform_flap``, ``overload_then_crash``,
  ``prefill_kill_mid_handoff``) gives every campaign a
  stable ``--plan`` name (it loads by file path with neither torch
  nor numpy installed);
- :mod:`.injector` — :class:`FaultInjector` fires a plan's events at
  exact fleet ticks through sanctioned hooks only, with an honest,
  replayable event log;
- :mod:`.invariants` — the whole-run auditor: token conservation,
  reasoned terminal states, token identity against a fault-free
  reference, page/refcount consistency, counter monotonicity, and the
  gated recovery budget.

The plan core loads by file path on its own; the package imports the
fleet-backed halves too.
"""

from __future__ import annotations

from .plan import (
    ADMISSION_BLIP,
    FAULT_KINDS,
    FAULT_PLANS,
    FaultEvent,
    FaultPlan,
    REFORM_FAILURE,
    REPLICA_CRASH,
    STAGE_SLOWDOWN,
    SWAP_CORRUPTION,
    fault_plan_names,
    get_fault_plan,
    register_fault_plan,
)

from .injector import FaultInjector
from .invariants import (
    AuditCheck,
    AuditReport,
    audit_run,
    fleet_settled,
    make_probe,
)

__all__ = [
    "ADMISSION_BLIP",
    "AuditCheck",
    "AuditReport",
    "FAULT_KINDS",
    "FAULT_PLANS",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "REFORM_FAILURE",
    "REPLICA_CRASH",
    "STAGE_SLOWDOWN",
    "SWAP_CORRUPTION",
    "audit_run",
    "fault_plan_names",
    "fleet_settled",
    "get_fault_plan",
    "make_probe",
    "register_fault_plan",
]
