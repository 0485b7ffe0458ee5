"""Helpers shared by the port's entry points: device and dtype
resolution, and the ports of ``skycomputing_tpu/utils/logger.py``
(:class:`Logger`), ``skycomputing_tpu/utils/timer.py``
(:class:`DistributedTimer`, :class:`PhaseTimer`) and
``skycomputing_tpu/utils/retry.py`` (:func:`retry_call`,
:func:`backoff_delays`, :class:`RetryError`) and
``skycomputing_tpu/utils/fileio.py`` (:func:`atomic_write`, with
:func:`atomic_torch_save` beside it)."""

from __future__ import annotations

import os
import random
import sys
import time
from typing import (Callable, List, Optional, TextIO, Tuple, Type, TypeVar,
                    Union)

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name) -> torch.dtype:
    """A config dtype string (``"bfloat16"``, ...) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another.  With no CUDA device and no explicit request this
    raises — the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    return dev


def resolve_devices(devices=None) -> List[torch.device]:
    """Each of ``devices`` resolved, or every CUDA device when None (and
    then, as :func:`resolve_device`, raising where there is none)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


class Logger:
    """Timestamped line logger writing to a file and/or stderr
    (``filename=None``: stderr only).  ``info`` writes ``[ts] message``;
    ``warning`` and ``error`` insert their level tag after the
    timestamp; ``utc=True`` stamps ISO-8601 UTC."""

    def __init__(self, filename: Optional[str] = None, mode: str = "a",
                 echo: bool = False, utc: bool = False):
        self._filename = filename
        self._echo = echo or filename is None
        self._utc = utc
        self._fh: Optional[TextIO] = None
        if filename is not None:
            parent = os.path.dirname(filename)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(filename, mode)

    def _timestamp(self) -> str:
        if self._utc:
            return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        return time.strftime("%Y-%m-%d %H:%M:%S")

    def _emit(self, tag: str, message: str) -> None:
        line = f"[{self._timestamp()}] {tag}{message}"
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def info(self, message: str) -> None:
        self._emit("", message)

    def warning(self, message: str) -> None:
        self._emit("WARNING: ", message)

    def error(self, message: str) -> None:
        self._emit("ERROR: ", message)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class DistributedTimer:
    """In-memory timestamp list, optionally mirrored to
    ``<root>/dist_timer.txt`` (one process drives every stage, so no
    file exchange is needed)."""

    FILENAME = "dist_timer.txt"

    def __init__(self, root: Optional[str] = None):
        self._root = root
        self._stamps: List[float] = []
        if root is not None:
            os.makedirs(root, exist_ok=True)

    @property
    def _file(self) -> Optional[str]:
        if self._root is None:
            return None
        return os.path.join(self._root, self.FILENAME)

    def add_timestamp(self) -> None:
        stamp = time.perf_counter()
        self._stamps.append(stamp)
        if self._file is not None:
            with open(self._file, "a") as fh:
                fh.write(f"{stamp}\n")

    def get_prev_interval(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        return self._stamps[-1] - self._stamps[-2]

    def clean(self) -> None:
        self._stamps.clear()
        f = self._file
        if f is not None and os.path.exists(f):
            os.remove(f)


class PhaseTimer:
    """Accumulates named phase durations (forward/backward/step/...)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def record(self, phase: str, seconds: float) -> None:
        self.totals[phase] = self.totals.get(phase, 0.0) + seconds
        self.counts[phase] = self.counts.get(phase, 0) + 1

    def mean(self, phase: str) -> float:
        if self.counts.get(phase, 0) == 0:
            return 0.0
        return self.totals[phase] / self.counts[phase]

    def summary(self) -> dict:
        return {k: self.mean(k) for k in self.totals}


# --- durable atomic publication ---------------------------------------------
# Write a same-directory temporary file, flush, fsync, then ``os.replace``:
# a crash (or ``kill -9``) at any point before the rename leaves the
# previous file whole, and the fsync keeps the rename from outliving its
# data on power loss.  ``tmp_suffix`` keeps concurrent writers apart
# (per-node suffixes on a shared rendezvous directory).


def _publish(path: str, tmp_suffix: str, mode: str, write) -> None:
    tmp = path + tmp_suffix
    with open(tmp, mode) as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def atomic_write(path: str, data: Union[bytes, str],
                 tmp_suffix: str = ".tmp") -> None:
    """Write ``data`` (bytes or str) to ``path`` through a temporary
    file and an atomic rename, syncing the file before the rename."""
    mode = "wb" if isinstance(data, bytes) else "w"
    _publish(path, tmp_suffix, mode, lambda fh: fh.write(data))


def atomic_torch_save(obj, path: str, tmp_suffix: str = ".tmp") -> None:
    """:func:`atomic_write` for ``torch.save(obj)``, written through the
    open temporary file."""
    _publish(path, tmp_suffix, "wb", lambda fh: torch.save(obj, fh))


T = TypeVar("T")


# --- bounded retry with exponential backoff and deterministic jitter ------
# Checkpoint I/O on network storage sees transient OSErrors; one policy
# here instead of ad-hoc loops at each call site.  Jitter comes from a
# seeded ``random.Random`` (the process id when no seed is given, so N
# processes hammering one shared resource do not back off in lockstep).


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


__all__ = ["DistributedTimer", "Logger", "PhaseTimer", "RetryError",
           "atomic_torch_save", "atomic_write", "backoff_delays", "resolve_device", "resolve_devices",
           "retry_call", "torch_dtype"]
