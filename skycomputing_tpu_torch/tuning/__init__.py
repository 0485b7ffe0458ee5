"""Closed-loop autotuning: telemetry in, faster plans out (the port of
``skycomputing_tpu/tuning``).

The tracer made bubbles, stragglers, dispatch stalls, and TTFT/TPOT
components *measurable*; this package makes them *actionable* — the
observe -> decide -> act cycle the paper's load-balanced allocation is
built around, with traces instead of startup benchmarks as the sensor
(PipeDream's profiler -> partitioner loop, extended to serving):

- :mod:`.advisor` — ``TuningAdvisor``, the pure decide step: analysis
  report in, at most one knob ``Proposal`` out;
- :mod:`.autotune` — the act step: verify-then-apply, measure-then-
  commit, guarded rollback; includes ``ServingAutotuner`` (attaches to
  a live ``ServingEngine``);
- the training-side actuator is
  :class:`~skycomputing_tpu_torch.runner.AutotuneHook`
  (``runner/hooks_collection/autotune_hook.py``), which drives the same
  contract through the Runner's hook lifecycle and the self-heal
  in-process rebuild path.

The reference's ``docs/autotuning.md`` describes the trace signatures,
the knob space and the verify/rollback semantics; the port keeps them.
"""

from .advisor import Proposal, TuningAdvisor
from .autotune import (
    ServingAutotuner,
    improved,
    restore_partition,
    snapshot_partition,
    window_events,
)

__all__ = [
    "Proposal",
    "ServingAutotuner",
    "TuningAdvisor",
    "improved",
    "restore_partition",
    "snapshot_partition",
    "window_events",
]
