"""A traced slice of the window: ``torch.profiler`` with CUDA activity.

The slice is one ``bench.slice`` user annotation.  Its trace is written
as a Chrome trace and read back: kernels, copies and sets are the
device's work; the busy time is their union inside the slice; the idle
gaps are labelled by what the host was doing at their middle, as the
harness's innermost ``bench.*`` span and the innermost operator there.
"""

from __future__ import annotations

import bisect
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from .stats import busy_and_gaps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench.slice"


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    for prefix in ("void ", "(anonymous namespace)::"):
        if name.startswith(prefix):
            name = name[len(prefix):]
    return name.split("(", 1)[0][:width]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class TraceSlice:
    """Profile from :meth:`start` to :meth:`stop`; :meth:`summary` after
    the window reads the trace written to ``path``."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._prof = None
        self._span = None
        self.t0 = self.t1 = None

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once in set-up, so the window's
        slice does not pay for initializing the tracer."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            _sync(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = record_function(SLICE)
        self._span.__enter__()
        self.t0 = time.perf_counter()

    @property
    def active(self) -> bool:
        return self._prof is not None and self.t1 is None

    def stop(self, device) -> None:
        _sync(device)
        self.t1 = time.perf_counter()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self) -> Dict:
        """Write the trace, then read it: see :func:`read_trace`."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.path))
        self._prof = None
        return read_trace(self.path)


def read_trace(path: Path) -> Dict:
    """``busy_s`` and ``window_s`` of the slice, ``kernels`` ({short name:
    [calls, seconds]}), ``device_ops`` and ``idle_gaps`` (top 10 each, by
    seconds)."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e["name"] == SLICE]
    if not spans:
        raise RuntimeError(f"no {SLICE} span in {path}")
    sl = spans[0]
    t0, t1 = float(sl["ts"]), float(sl["ts"]) + float(sl["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and t0 <= float(e["ts"]) < t1]
    busy_us, gaps = busy_and_gaps(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device),
        t0, t1)
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in device:
        entry = kernels[short_name(e["name"]) if e["cat"] == "kernel"
                        else e["cat"]]
        entry[0] += 1
        entry[1] += float(e["dur"]) * 1e-6
    thread = [e for e in events if e.get("tid") == sl.get("tid")
              and e.get("pid") == sl.get("pid")]
    label = _Labeller(
        [e for e in thread if e.get("cat") == "cpu_op"],
        [e for e in thread if e.get("cat") == "user_annotation"
         and e["name"].startswith("bench.") and e["name"] != SLICE])
    idle = defaultdict(float)
    for a, b in gaps:
        idle[label((a + b) / 2)] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    return dict(
        busy_s=busy_us * 1e-6,
        window_s=(t1 - t0) * 1e-6,
        kernels={k: v for k, v in kernels.items()},
        device_ops=[[k, v[1]] for k, v in top[:10]],
        idle_gaps=sorted(([k, v] for k, v in idle.items()),
                         key=lambda kv: -kv[1])[:10],
    )


class _Labeller:
    """What the host was doing at a time: the innermost harness span and
    the innermost operator open then on the slice's thread ("-" for
    none; "python" where no operator was open among the last
    ``WALK`` that began)."""

    WALK = 256

    def __init__(self, ops: List[dict], spans: List[dict]):
        self._ops = sorted(ops, key=lambda e: float(e["ts"]))
        self._op_starts = [float(e["ts"]) for e in self._ops]
        self._spans = sorted(spans, key=lambda e: float(e["ts"]))
        self._span_starts = [float(e["ts"]) for e in self._spans]

    @staticmethod
    def _innermost(events, starts, t, walk) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - walk, -1), -1):
            e = events[j]
            if float(e["ts"]) + float(e["dur"]) >= t:
                return e["name"]
        return None

    def __call__(self, t: float) -> str:
        span = self._innermost(self._spans, self._span_starts, t,
                               len(self._spans))
        op = self._innermost(self._ops, self._op_starts, t, self.WALK)
        return f"{span or '-'} / {op or 'python'}"
