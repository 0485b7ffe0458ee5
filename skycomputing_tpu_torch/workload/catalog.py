"""The named-scenario catalog (package-facing shim).

The registry itself lives in :mod:`.scenario` so the whole scenario
plane stays ONE self-contained pure-stdlib module that loads by file
path (a pure module imports no sibling at module level).  This shim
keeps the natural import path ``workload.catalog`` for package users
and tools.
"""

from __future__ import annotations

from .scenario import (
    SCENARIOS,
    get_scenario,
    register_scenario,
    scenario_names,
)

__all__ = [
    "SCENARIOS",
    "get_scenario",
    "register_scenario",
    "scenario_names",
]
