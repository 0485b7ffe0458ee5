"""Peer liveness detection for the multi-process world (the port of
``skycomputing_tpu/parallel/heartbeat.py``).

In a world of processes the failure mode is a *collective that never
completes* because a peer died or wedged.  The detector is therefore a
tiny global all-reduce ("beat") issued at a safe synchronization point
(every process beats at the same iteration), watched by a timer thread
that never touches the device: if the beat neither completes nor
raises within ``timeout_s``, the peer world is declared failed.

Design notes:
- a beat is one all-reduce of a world-sized vector, one element per
  process (each contributes a one at its rank), on the card under NCCL
  or on the CPU under gloo; reading its sum back with ``.item()`` ends
  the window, so the watchdog times the collective itself;
- the watchdog only OBSERVES (logs + optional abort): a wedged
  collective cannot be cancelled from Python, so recovery is process
  restart (:mod:`.elastic`);
- an exception from the backend counts as detection, not a crash
  (gloo raises when a peer's connection closes; NCCL when the process
  group's timeout passes).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..utils import Logger, resolve_device
from .multihost import collective_device


class PeerHeartbeat:
    """Detect dead/stalled peers with timed global all-reduces.

    ``beat()`` is collective: EVERY process in the world must call it at
    the same logical point (e.g. the same training iteration), or the
    beat itself becomes the stall it is trying to detect.  ``device``:
    where the beat's vector lies — the process group's device when one
    is up, else the card unless ``device="cpu"``.
    """

    def __init__(
        self,
        timeout_s: float = 60.0,
        on_failure: Optional[Callable[[str], None]] = None,
        abort_on_failure: bool = False,
        abort_exit_code: int = 17,
        logger: Optional[Logger] = None,
        device=None,
    ):
        self.timeout_s = float(timeout_s)
        self.failed = False
        self.last_beat_s: Optional[float] = None
        self.beats = 0
        self._logger = logger or Logger()
        self._on_failure = on_failure
        self._abort = bool(abort_on_failure)
        self._abort_exit_code = int(abort_exit_code)
        self._device = device
        self._beat_fn = None

    def _build(self):
        if dist.is_initialized():
            world, rank = dist.get_world_size(), dist.get_rank()
            device = (torch.device(self._device) if self._device is not None
                      else collective_device())
        else:
            world, rank = 1, 0
            device = resolve_device(self._device)
        ones = torch.zeros(world, dtype=torch.float32, device=device)
        ones[rank] = 1.0

        def fn(x):
            y = x.clone()
            if dist.is_initialized():
                dist.all_reduce(y)
            return y.sum().item()

        self._expected = float(world)
        self._ones = ones
        self._beat_fn = fn
        # warm the communicator so the first timed beat measures the
        # collective, not its set-up
        fn(ones)

    def _fail(self, reason: str) -> None:
        self.failed = True
        self._logger.info(f"peer heartbeat FAILED: {reason}")
        if self._on_failure is not None:
            self._on_failure(reason)
        if self._abort:
            # a wedged collective cannot be cancelled; die so the
            # supervisor can restart the world
            os._exit(self._abort_exit_code)

    def beat(self) -> bool:
        """One timed global all-reduce; returns True when peers are live.

        The lazy first-call ``_build()`` (communicator set-up + warm-up
        collective) runs INSIDE the watchdog window too — a peer that
        died before the first beat wedges the warm-up exactly like a
        regular beat.
        """
        fired_this_beat = threading.Event()
        was_failed = self.failed

        def on_timeout():
            fired_this_beat.set()
            self._fail(
                f"collective did not complete within {self.timeout_s}s "
                f"(a peer process is dead or wedged)"
            )

        timer = threading.Timer(self.timeout_s, on_timeout)
        timer.daemon = True
        start = time.perf_counter()
        timer.start()
        try:
            if self._beat_fn is None:
                self._build()
            total = float(self._beat_fn(self._ones))
        except Exception as exc:  # the backend noticed a dead peer
            timer.cancel()
            self._fail(f"collective raised: {exc!r}")
            return False
        timer.cancel()
        self.last_beat_s = time.perf_counter() - start
        self.beats += 1
        if not was_failed and fired_this_beat.is_set() and total == self._expected:
            # THIS beat's watchdog fired but the collective then completed
            # with the right sum — transient slowness, not a dead peer.
            # Clear the latch so one blip cannot permanently poison
            # ``beat()``; ``on_failure`` has already fired once for the
            # blip (and with ``abort_on_failure`` the process never
            # reaches this line).  A failure latched by a PREVIOUS beat
            # (wrong sum, exception) is deliberately NOT cleared:
            # ``was_failed`` is snapshotted before the timer starts, so
            # only the per-beat watchdog blip is recoverable.
            self._logger.info(
                "peer heartbeat recovered: collective completed after the "
                f"watchdog fired ({self.last_beat_s:.1f}s > "
                f"{self.timeout_s}s timeout)"
            )
            self.failed = False
            return True
        if self.failed:
            return False  # a previous beat detected a real failure
        if total != self._expected:
            self._fail(
                f"beat sum {total} != world size {self._expected} "
                f"(a process dropped out of the collective?)"
            )
            return False
        return True


__all__ = ["PeerHeartbeat"]
