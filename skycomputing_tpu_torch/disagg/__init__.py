"""Disaggregated prefill/decode serving: role-specialized replica
pools joined by a checksummed, ledgered KV-handoff plane (the port of
``skycomputing_tpu/disagg``).

``handoff`` is pure stdlib by contract (the record/ledger contract,
loadable by file path with neither torch nor numpy installed);
``pools`` holds :class:`DisaggFleet`, the fleet subclass that runs the
two pools and pumps handoffs between them.
"""

from .handoff import (
    DELIVERED,
    FAILED,
    HANDOFF_STATES,
    HandoffLedger,
    HandoffRecord,
    PENDING,
)
from .pools import DECODE, DisaggFleet, PREFILL

__all__ = [
    "DECODE",
    "DELIVERED",
    "DisaggFleet",
    "FAILED",
    "HANDOFF_STATES",
    "HandoffLedger",
    "HandoffRecord",
    "PENDING",
    "PREFILL",
]
