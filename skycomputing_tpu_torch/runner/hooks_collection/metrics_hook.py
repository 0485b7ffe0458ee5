"""Structured metrics logging, one JSON line per iteration (the port of
``skycomputing_tpu/runner/hooks_collection/metrics_hook.py``).

The file is opened for appending (restarts accumulate), so every run
opens with a ``run_start`` header carrying a fresh ``run_id``, the
world size and a ``config_hash`` of the partition and loop bounds; each
per-iteration record carries the same ``run_id`` and
``PipelineStats.snapshot()`` verbatim, so a field added to the stats
reaches the file with no edit here.  The header is flushed at once,
iteration records every ``flush_every`` lines, and the file is flushed
and closed when the run ends, also when it raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid

from ...registry import HOOKS
from ..hooks import Hook


@HOOKS.register_module
class MetricsHook(Hook):
    def __init__(self, path: str, flush_every: int = 1):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._path = path
        self._flush_every = flush_every
        self._fh = None
        self._pending = 0
        self._run_id = None

    @staticmethod
    def _config_hash(runner) -> str:
        """Stable digest of the run's shape: same allocation + loop
        bounds -> same hash, so a reader can tell a restart of the SAME
        run from a differently-configured one sharing the file."""
        signature = getattr(runner.model, "partition_signature", None)
        ident = {
            "partition": signature() if callable(signature) else None,
            "max_epochs": runner.max_epochs,
            "max_iters": runner.max_iters,
        }
        blob = json.dumps(ident, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def before_run(self, runner):
        self._fh = open(self._path, "a")
        self._run_id = uuid.uuid4().hex[:12]
        header = {
            "event": "run_start",
            "run_id": self._run_id,
            "ts": time.time(),
            "world_size": runner.worker_manager.size,
            "config_hash": self._config_hash(runner),
            "epoch": runner.epoch,
            "iter": runner.iter,
        }
        self._fh.write(json.dumps(header) + "\n")
        # the header must hit disk even if the run dies in iteration 1:
        # an unflushed header plus a flushed crash log reads as "no run"
        self._fh.flush()
        self._pending = 0

    def after_iter(self, runner):
        if self._fh is None:  # pragma: no cover - hook misuse
            return
        record = {
            "ts": time.time(),
            "run_id": self._run_id,
            "epoch": runner.epoch,
            "iter": runner.iter,
        }
        # the whole stats surface, schema-free: PipelineStats.snapshot()
        # mirrors ServingStats.snapshot(), one contract for both engines
        record.update(runner.model.stats.snapshot())
        self._fh.write(json.dumps(record) + "\n")
        self._pending += 1
        if self._pending >= self._flush_every:
            self._fh.flush()
            self._pending = 0

    def after_run(self, runner):
        # fires from the Runner's finally block, so the file is flushed
        # and closed even when training raises mid-epoch
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None


__all__ = ["MetricsHook"]
