"""TraceHook: record a training run's timeline and export it on exit
(the port of ``skycomputing_tpu/runner/hooks_collection/trace_hook.py``).

The tracer (``telemetry/tracer.py``) gives the engines their event
stream; this hook gives a *training run* its lifecycle on that stream —
per-iteration spans (the row a Perfetto user reads first), eval phases,
and the run's start/end markers — and owns the export: the trace file is
written from ``after_run``, which the Runner fires in a ``finally``
block, so a run that raises mid-epoch still leaves its trace behind
(usually exactly the run whose timeline someone needs to read).

If tracing is already enabled when the run starts (a bench harness
enabled it process-wide), the hook joins the existing timeline and
leaves it active on exit; otherwise it enables tracing itself and
disables it after writing.
"""

from __future__ import annotations

from typing import Optional

from ...registry import HOOKS
from ...telemetry import disable_tracing, enable_tracing, get_tracer
from ..hooks import Hook


@HOOKS.register_module
class TraceHook(Hook):
    """Write a Chrome-trace timeline of the run to ``path``.

    ``capacity`` bounds the event ring buffer (oldest events drop — a
    long run keeps its newest history).  ``every`` > 1 records only
    every N-th iteration span, for runs long enough that per-iteration
    spans alone would churn the buffer.
    """

    def __init__(self, path: str, capacity: int = 1 << 16,
                 every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self._path = path
        self._capacity = int(capacity)
        self._every = int(every)
        self._owned = False
        self._tracer = None
        self._iter_t0: Optional[float] = None
        self._eval_t0: Optional[float] = None

    # --- run lifecycle ------------------------------------------------------
    def before_run(self, runner):
        tracer = get_tracer()
        if tracer is None:
            tracer = enable_tracing(capacity=self._capacity)
            self._owned = True
        self._tracer = tracer
        tracer.instant(
            "run_start", tracer.lane("runner", "lifecycle"),
            {
                "epoch": runner.epoch,
                "iter": runner.iter,
                "max_iters": runner.max_iters,
                "world_size": runner.worker_manager.size,
            },
        )

    def after_run(self, runner):
        tracer = self._tracer
        if tracer is None:
            return
        tracer.instant(
            "run_end", tracer.lane("runner", "lifecycle"),
            {"epoch": runner.epoch, "iter": runner.iter,
             "aborted": bool(getattr(runner, "aborted", False))},
        )
        try:
            tracer.write(self._path)
            runner.logger.info(
                f"TraceHook: wrote {tracer.event_count} events "
                f"({tracer.dropped} dropped) to {self._path}"
            )
        finally:
            if self._owned:
                disable_tracing()
            self._tracer = None
            self._owned = False

    # --- iteration spans ----------------------------------------------------
    def before_iter(self, runner):
        tracer = self._tracer
        if tracer is None:
            return
        if self._every > 1 and runner.iter % self._every != 0:
            self._iter_t0 = None
            return
        self._iter_t0 = tracer.now()

    def after_iter(self, runner):
        tracer = self._tracer
        if tracer is None or self._iter_t0 is None:
            return
        stats = runner.model.stats
        tracer.complete(
            "iter", tracer.lane("runner", "iterations"), self._iter_t0,
            # iter was already incremented: this span belongs to iter-1
            {"iter": runner.iter - 1, "loss": stats.loss,
             "dispatch_s": stats.dispatch_s},
        )
        self._iter_t0 = None

    # --- eval phases --------------------------------------------------------
    def before_val_epoch(self, runner):
        if self._tracer is not None:
            self._eval_t0 = self._tracer.now()

    def after_val_epoch(self, runner):
        tracer = self._tracer
        if tracer is None or self._eval_t0 is None:
            return
        tracer.complete(
            "eval", tracer.lane("runner", "lifecycle"), self._eval_t0,
            {"iter": runner.iter},
        )
        self._eval_t0 = None


__all__ = ["TraceHook"]
