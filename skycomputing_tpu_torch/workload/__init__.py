"""The workload plane: seeded, replayable load generation (the port of
``skycomputing_tpu/workload``).

- :mod:`.scenario` — the PURE-STDLIB core: :class:`Dist` /
  :class:`Phase` / :class:`Scenario` declare a workload; one seeded
  ``random.Random`` lowers it to a byte-reproducible arrival trace
  (it loads by file path with neither torch nor numpy installed);
- :mod:`.catalog` — the named-scenario registry (``diurnal_ramp``,
  ``flash_crowd``, ``tenant_mix``, ``rag_shared_prefix``,
  ``length_skew``, ``disagg_mix``), one ``--scenario`` flag per workload;
- :mod:`.player` — :class:`ScenarioPlayer` replays a trace against a
  duck-typed fleet/engine target, recording per-request verdicts;
- :mod:`.mixes` — the benches' pre-plane numpy workloads under stable
  names (the serving bench's ``interference``, the fleet bench's
  ``fleet_bursty`` / ``fleet_spike``), a copy of the JAX package's,
  draw for draw.

The stdlib core loads by file path on its own; the package imports the
numpy halves too.
"""

from __future__ import annotations

from .catalog import (
    SCENARIOS,
    get_scenario,
    register_scenario,
    scenario_names,
)
from .scenario import (
    Arrival,
    BATCH,
    Dist,
    INTERACTIVE,
    Phase,
    PrefixPool,
    Scenario,
)

from .mixes import MIXES, build_mix
from .player import PlayerReport, PlayerVerdict, ScenarioPlayer

__all__ = [
    "Arrival",
    "BATCH",
    "Dist",
    "INTERACTIVE",
    "MIXES",
    "Phase",
    "PlayerReport",
    "PlayerVerdict",
    "PrefixPool",
    "SCENARIOS",
    "Scenario",
    "ScenarioPlayer",
    "build_mix",
    "get_scenario",
    "register_scenario",
    "scenario_names",
]
