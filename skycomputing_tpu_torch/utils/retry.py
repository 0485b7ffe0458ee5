"""Bounded retry with exponential backoff + deterministic jitter (the
port's own copy of ``skycomputing_tpu/utils/retry.py``).

Shared by the robustness layer: rendezvous polling reads ``world.json``
over whatever filesystem the cluster shares (NFS rename visibility and
transient ``OSError`` are real there), and checkpoint I/O hits the same
class of transient faults on network storage.  One policy, one place —
instead of each call site growing its own ad-hoc ``while True`` loop.

Jitter is drawn from a seeded ``random.Random`` so retry schedules are
reproducible under the fault-injection harness (``dynamics/faults.py``):
a chaos test that passes an explicit ``seed`` sees the exact same sleep
sequence every run.  When no seed is given the process id seeds the
stream instead — N processes hammering the same shared-FS resource must
NOT back off in lockstep, or the jitter decorrelates nothing.
"""

from __future__ import annotations

import os
import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


class RetryError(RuntimeError):
    """All attempts exhausted; ``__cause__`` carries the last failure."""


def backoff_delays(
    attempts: int,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    jitter: float = 0.25,
    seed: int = 0,
):
    """The deterministic sleep schedule ``retry_call`` uses, exposed for
    tests and for callers that drive their own loop (e.g. polling with a
    deadline): ``attempts - 1`` delays, exponentially growing, capped at
    ``max_delay_s``, each stretched by up to ``jitter`` fraction."""
    rng = random.Random(seed)
    out = []
    for attempt in range(max(attempts - 1, 0)):
        delay = min(max_delay_s, base_delay_s * (2.0 ** attempt))
        out.append(delay * (1.0 + jitter * rng.random()))
    return out


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 4,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    jitter: float = 0.25,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    seed: Optional[int] = None,
    sleep: Callable[[float], None] = time.sleep,
    deadline_s: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
    logger=None,
    describe: Optional[str] = None,
) -> T:
    """Call ``fn()`` with up to ``attempts`` tries.

    Only exceptions in ``retry_on`` are retried; anything else propagates
    immediately (a corrupt checkpoint must not be re-read four times).
    The final failure re-raises the original exception unchanged so
    callers' except clauses keep working.  ``seed=None`` (default) seeds
    the jitter from the process id so concurrent processes decorrelate;
    pass an explicit seed for a reproducible schedule.

    ``deadline_s`` is a TOTAL budget for the call, measured on ``clock``
    from entry: each backoff sleep is clamped to the remaining budget and
    a failure past the deadline re-raises immediately even with attempts
    left.  Without it, per-attempt backoff can exceed any caller
    deadline (4 attempts at ``max_delay_s=2.0`` is up to ~7.5 s of
    sleeping — longer than a fleet dispatch or a rendezvous formation
    window is willing to wait).  The in-flight ``fn()`` itself is never
    interrupted; the budget bounds only the retry loop's sleeps.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if deadline_s is not None and deadline_s < 0:
        raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
    delays = backoff_delays(
        attempts, base_delay_s, max_delay_s, jitter,
        seed if seed is not None else os.getpid(),
    )
    budget_end = None if deadline_s is None else clock() + deadline_s
    last_exc: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as exc:
            last_exc = exc
            if attempt == attempts - 1:
                raise
            delay = delays[attempt]
            if budget_end is not None:
                remaining = budget_end - clock()
                if remaining <= 0.0:
                    if logger is not None:
                        what = describe or getattr(fn, "__name__", "call")
                        logger.info(
                            f"retry deadline ({deadline_s:.3f}s) exhausted "
                            f"after {attempt + 1} attempt(s) of {what}"
                        )
                    raise
                delay = min(delay, remaining)
            if logger is not None:
                what = describe or getattr(fn, "__name__", "call")
                logger.info(
                    f"retry {attempt + 1}/{attempts} of {what} after "
                    f"{exc!r}; backing off {delay:.3f}s"
                )
            sleep(delay)
    raise RetryError("unreachable") from last_exc  # pragma: no cover


__all__ = ["retry_call", "backoff_delays", "RetryError"]
