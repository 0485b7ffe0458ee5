"""Periodic peer-liveness checks for multi-process training runs (the
port of ``skycomputing_tpu/runner/hooks_collection/heartbeat_hook.py``).

Extends the failure-detection family (``watchdog_hook.py``) to the
multi-process world: every N iterations ALL processes issue one timed
global all-reduce (``parallel/heartbeat.py``).  Because the Runner drives
every process through the same iteration sequence, the hook is a safe
synchronization point for the collective.
"""

from __future__ import annotations

from ...registry import HOOKS
from ..hooks import Hook


@HOOKS.register_module
class HeartbeatHook(Hook):
    """Beat every ``interval`` iterations; on failure abort (or stop).

    ``action``: 'abort' (default) kills the process from the watchdog
    thread so a supervisor can restart the world — the ONLY action that
    works when the failure mode is a wedged collective, because
    ``beat()`` then never returns and post-beat code is unreachable.
    'stop' requests a clean Runner stop, which acts only when the
    failure surfaces as a backend exception (e.g. gloo noticed a closed
    peer connection).  ``device`` is the beat's
    (:class:`~...parallel.heartbeat.PeerHeartbeat`).
    """

    def __init__(self, interval: int = 50, timeout_s: float = 60.0,
                 action: str = "abort", device=None):
        if action not in ("stop", "abort"):
            raise ValueError(f"unknown action {action!r}")
        from ...parallel.heartbeat import PeerHeartbeat

        self._interval = int(interval)
        self._heartbeat = PeerHeartbeat(
            timeout_s=timeout_s, abort_on_failure=(action == "abort"),
            device=device,
        )
        self._action = action

    @property
    def heartbeat(self):
        return self._heartbeat

    def after_iter(self, runner):
        if not self.every_n_iters(runner, self._interval):
            return
        if getattr(runner, "fault_drop_beat", False):
            # fault-injection harness (dynamics/faults.py): this process
            # "misses" its beat window, as a wedged peer would.  Reset
            # the flag so the harness can tell a consumed drop from one
            # armed at an iteration where no beat was scheduled.
            runner.fault_drop_beat = False
            runner.logger.info(
                f"HeartbeatHook: beat at iter {runner.iter} dropped by "
                f"fault injection"
            )
            return
        if self._heartbeat.beat():
            return
        runner.logger.info(
            f"HeartbeatHook: peer failure detected at iter {runner.iter}"
        )
        if self._action == "stop":
            runner.request_stop()


__all__ = ["HeartbeatHook"]
