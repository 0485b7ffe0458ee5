"""TuningAdvisor: map trace signatures onto candidate knob changes (the
port's own copy of ``skycomputing_tpu/tuning/advisor.py``).

The advisor is the *decide* third of the observe -> decide -> act loop:
it reads the analysis report (``telemetry/analysis.py`` — the same dict
``tools/trace_report.py`` renders) and returns at most one
:class:`Proposal` naming a knob the runtime already exposes:

==================  =======================================================
trace signature     proposed knob change
==================  =======================================================
straggler           one stage's busy time dominates the median stage ->
                    ``allocation``: re-solve with the measured per-stage
                    seconds folded into the DEVICE model
                    (``Allocator.refine_allocation(attribute="devices")``)
high bubble         bubble fraction above threshold on a gpipe schedule ->
                    ``schedule``: switch to 1f1b; already 1f1b (or M=1) ->
                    ``microbatches``: double the microbatch count
skewed buckets      prefill padding waste above threshold ->
                    ``buckets``: insert a bucket sized to the over-padded
                    bucket's observed mean prompt length
queue pressure      admission stalls on a large share of engine ticks ->
                    ``slots``: double the KV slot count
decode tail         per-request TPOT p95/p50 above threshold (decode
                    ticks stalling behind whole prefill waves) ->
                    ``prefill_chunk``: enable chunked prefill at the
                    largest sub-max bucket, or shrink one bucket if on
clean trace         ``None`` — a healthy run is left alone
==================  =======================================================

The advisor is PURE: report in, proposal out, no side effects and no
torch — so it unit-tests on synthetic traces in microseconds and
``python -m skycomputing_tpu_torch.tools.bench_autotune --smoke`` loads
it by file path with no torch installed (``pure_stdlib`` in
``analysis/audit.py``'s manifest).  Applying, verifying, and rolling
back proposals is the hook's job (``tuning/autotune.py``,
``runner/hooks_collection/autotune_hook.py``).

``blocked`` threading: the acting layer passes the signatures of
proposals that were rejected by the pre-flight verifier or rolled back
after failing to improve; the advisor never re-proposes those, which is
what makes the closed loop converge instead of thrash.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence

# signature ids (stable: recorded in hook events and blocked-sets)
STRAGGLER = "straggler"
PIPELINE_SCHEDULE = "pipeline_schedule"
MICROBATCH_COUNT = "microbatch_count"
SKEWED_BUCKETS = "skewed_buckets"
QUEUE_PRESSURE = "queue_pressure"
DECODE_TAIL = "decode_tail"


@dataclass(frozen=True)
class Proposal:
    """One candidate knob change, with its provenance.

    ``knob`` is the actuator (``allocation`` | ``schedule`` |
    ``microbatches`` | ``buckets`` | ``slots``), ``value`` its target
    setting, ``signature`` the stable trace-signature id that produced
    it (the unit of blocking/rollback), ``metric`` the report quantity
    the proposal promises to improve, and ``reason`` the human-readable
    diagnosis for logs and trace args.
    """

    knob: str
    value: Any
    signature: str
    metric: str
    reason: str

    def describe(self) -> Dict[str, Any]:
        """JSON-able form for trace args and event records."""
        value = self.value
        if isinstance(value, (list, tuple)):
            value = [round(v, 6) if isinstance(v, float) else v
                     for v in value]
        return dict(knob=self.knob, value=value, signature=self.signature,
                    metric=self.metric, reason=self.reason)


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    mid = len(ordered) // 2
    if len(ordered) % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


class TuningAdvisor:
    """Thresholded signature detection over analysis reports.

    Thresholds are deliberately conservative: a proposal triggers a
    solver run, a pipeline rebuild, or a serving reconfiguration, so
    borderline traces should read as clean.  ``straggler_ratio`` is the
    max/median stage-busy ratio that reads as a straggler (the
    self-heal confirm threshold's trace-side analog);
    ``bubble_threshold`` the bubble fraction that reads as a schedule
    problem; ``padding_threshold`` the prefill padding waste that reads
    as a mis-sized bucket set; ``stall_threshold`` the queue-stall
    share of engine ticks that reads as slot starvation.
    """

    def __init__(
        self,
        straggler_ratio: float = 1.6,
        bubble_threshold: float = 0.35,
        padding_threshold: float = 0.30,
        stall_threshold: float = 0.25,
        max_microbatches: int = 32,
        bucket_quantum: int = 8,
        tail_ratio_threshold: float = 3.0,
    ):
        if straggler_ratio <= 1.0:
            raise ValueError(
                f"straggler_ratio must be > 1, got {straggler_ratio}"
            )
        if tail_ratio_threshold <= 1.0:
            raise ValueError(
                f"tail_ratio_threshold must be > 1, got "
                f"{tail_ratio_threshold}"
            )
        self.straggler_ratio = float(straggler_ratio)
        self.bubble_threshold = float(bubble_threshold)
        self.padding_threshold = float(padding_threshold)
        self.stall_threshold = float(stall_threshold)
        self.max_microbatches = int(max_microbatches)
        self.bucket_quantum = int(bucket_quantum)
        self.tail_ratio_threshold = float(tail_ratio_threshold)

    # --- training ----------------------------------------------------------
    def propose_training(
        self,
        report: Dict[str, Any],
        *,
        schedule: str,
        num_microbatches: int,
        batch_size: Optional[int] = None,
        steps: Optional[int] = None,
        blocked: Iterable[str] = (),
    ) -> Optional[Proposal]:
        """One proposal for a training-pipeline trace, or None.

        ``schedule``/``num_microbatches``/``batch_size`` describe the
        CURRENT operating point (the advisor proposes deltas, not
        absolutes, so it must know where the run stands).  ``steps``
        overrides the report's iteration count when the caller measured
        it out-of-band (a hook window without TraceHook iter spans).
        """
        blocked = set(blocked)
        busy = report.get("stage_busy_ms") or {}
        n_steps = steps or (report.get("steps") or {}).get("count") or 1

        # 1. straggler: the most specific signature — one stage burning
        #    far more wall time than the median stage is a device
        #    problem, and no schedule change can fix a device problem
        if len(busy) >= 2 and STRAGGLER not in blocked:
            per_stage = [busy[k] for k in sorted(busy, key=int)]
            med = _median(per_stage)
            worst = max(per_stage)
            if med > 0 and worst / med >= self.straggler_ratio:
                stage = per_stage.index(worst)
                measured = [b / 1e3 / n_steps for b in per_stage]
                return Proposal(
                    knob="allocation",
                    value=measured,
                    signature=STRAGGLER,
                    metric="step_p50_ms",
                    reason=(
                        f"stage {stage} busy {worst / med:.2f}x the "
                        f"median stage over {n_steps} step(s)"
                    ),
                )

        # 2. schedule shape: lots of idle stage-seconds with no single
        #    straggler is a scheduling problem
        bubble = report.get("bubble_fraction", 0.0)
        if bubble >= self.bubble_threshold and len(busy) >= 2:
            if (schedule == "gpipe" and num_microbatches > 1
                    and PIPELINE_SCHEDULE not in blocked):
                return Proposal(
                    knob="schedule",
                    value="1f1b",
                    signature=PIPELINE_SCHEDULE,
                    metric="bubble_fraction",
                    reason=(
                        f"bubble fraction {bubble:.2f} >= "
                        f"{self.bubble_threshold:.2f} on gpipe with "
                        f"{num_microbatches} microbatches"
                    ),
                )
            doubled = num_microbatches * 2
            if (MICROBATCH_COUNT not in blocked
                    and doubled <= self.max_microbatches
                    and (batch_size is None or (
                        batch_size % doubled == 0))):
                return Proposal(
                    knob="microbatches",
                    value=doubled,
                    signature=MICROBATCH_COUNT,
                    metric="bubble_fraction",
                    reason=(
                        f"bubble fraction {bubble:.2f} >= "
                        f"{self.bubble_threshold:.2f}; deepening the "
                        f"pipeline fill ({num_microbatches} -> {doubled} "
                        f"microbatches)"
                    ),
                )
        return None

    # --- serving -----------------------------------------------------------
    def propose_serving(
        self,
        report: Dict[str, Any],
        *,
        buckets: Sequence[int],
        num_slots: int,
        max_len: int,
        prefill_chunk: Optional[int] = None,
        blocked: Iterable[str] = (),
    ) -> Optional[Proposal]:
        """One proposal for a serving-engine trace, or None.

        ``prefill_chunk`` describes the CURRENT chunked-prefill knob
        (None = off): the decode-tail signature proposes enabling or
        shrinking it, so the advisor must know where it stands.
        """
        blocked = set(blocked)
        serving = report.get("serving")
        if not serving:
            return None

        # 1. decode tail blowup: per-request TPOT p95 far above p50
        #    means decode ticks are stalling behind whole prefill waves
        #    (interference — the tick itself is fixed-shape and
        #    uniform).  Chunked prefill bounds that stall: enable it,
        #    or shrink the chunk if it is already on.  The TPOT
        #    percentiles ride in the serving section when the acting
        #    layer merges them from the engine's SLO stats
        #    (ServingAutotuner does); traces without them skip the
        #    signature.
        tail = self._tail_ratio(serving)
        if (DECODE_TAIL not in blocked and tail is not None
                and tail >= self.tail_ratio_threshold):
            new_chunk = self._chunk_proposal(buckets, prefill_chunk)
            if new_chunk is not None:
                action = (
                    f"enable chunked prefill at {new_chunk}"
                    if prefill_chunk is None
                    else f"shrink prefill_chunk {prefill_chunk} -> "
                         f"{new_chunk}"
                )
                return Proposal(
                    knob="prefill_chunk",
                    value=new_chunk,
                    signature=DECODE_TAIL,
                    metric="tpot_tail_ratio",
                    reason=(
                        f"tpot_p95/p50 ratio {tail:.1f} >= "
                        f"{self.tail_ratio_threshold:.1f}: decode "
                        f"ticks stall behind prefill waves -> {action}"
                    ),
                )

        # 2. skewed buckets: prefill FLOPs burned on pad positions.
        #    Target the bucket wasting the most padded tokens and insert
        #    a new bucket sized to its observed mean prompt length
        #    (rounded up to the bucket quantum) — one more bucket
        #    buys every future admission a tighter pad target.
        hist = serving.get("buckets") or {}
        if SKEWED_BUCKETS not in blocked and hist:
            worst_bucket, worst_padded = None, 0
            for bucket_str, row in hist.items():
                if not row.get("requests") or not row.get("tokens"):
                    continue
                padded = int(bucket_str) * row["requests"] - row["tokens"]
                if padded > worst_padded:
                    worst_bucket, worst_padded = int(bucket_str), padded
            # analyze() computes this once (serving_padding_fraction);
            # reading the field keeps decide and judge on one number
            padding = serving.get("padding_fraction")
            if (worst_bucket is not None and padding is not None
                    and padding >= self.padding_threshold):
                row = hist[str(worst_bucket)]
                mean_len = row["tokens"] / row["requests"]
                q = self.bucket_quantum
                new_bucket = max(q, int(-(-mean_len // q)) * q)
                if new_bucket < worst_bucket and new_bucket <= max_len:
                    proposed = tuple(sorted(set(buckets) | {new_bucket}))
                    if proposed != tuple(sorted(set(buckets))):
                        return Proposal(
                            knob="buckets",
                            value=proposed,
                            signature=SKEWED_BUCKETS,
                            metric="padding_fraction",
                            reason=(
                                f"prefill padding waste {padding:.0%} "
                                f">= {self.padding_threshold:.0%}; bucket "
                                f"{worst_bucket} holds prompts averaging "
                                f"{mean_len:.1f} tokens -> add bucket "
                                f"{new_bucket}"
                            ),
                        )

        # 3. queue pressure: admission repeatedly found no free slot —
        #    concurrency is capped by the slab, not by compute
        ticks = serving.get("prefill_waves", 0) + serving.get(
            "decode_ticks", 0
        )
        stalls = serving.get("queue_stalls", 0)
        if (QUEUE_PRESSURE not in blocked and ticks > 0
                and stalls / ticks >= self.stall_threshold):
            return Proposal(
                knob="slots",
                value=num_slots * 2,
                signature=QUEUE_PRESSURE,
                metric="stall_fraction",
                reason=(
                    f"{stalls} queue stalls over {ticks} engine ticks "
                    f"({stalls / ticks:.0%} >= "
                    f"{self.stall_threshold:.0%}); doubling slots "
                    f"{num_slots} -> {num_slots * 2}"
                ),
            )
        return None

    @staticmethod
    def _tail_ratio(serving: Dict[str, Any]) -> Optional[float]:
        """Per-request TPOT p95/p50 from the serving section, or None
        when the section carries no SLO percentiles (trace-only
        reports) or the p50 is degenerate."""
        p50 = serving.get("tpot_p50_s")
        p95 = serving.get("tpot_p95_s")
        if not p50 or not p95 or p50 <= 0:
            return None
        return float(p95) / float(p50)

    @staticmethod
    def _chunk_proposal(
        buckets: Sequence[int], prefill_chunk: Optional[int],
    ) -> Optional[int]:
        """The next chunked-prefill operating point: enable at the
        largest bucket below the max (chunking at the max bucket is a
        no-op), else shrink to the next smaller bucket; None when
        already at the smallest bucket (or the bucket set offers no
        smaller shape) — the signature has nothing left to actuate."""
        ordered = sorted(set(int(b) for b in buckets))
        if len(ordered) < 2:
            return None
        if prefill_chunk is None:
            return ordered[-2]
        smaller = [b for b in ordered if b < int(prefill_chunk)]
        return smaller[-1] if smaller else None


__all__ = [
    "DECODE_TAIL",
    "MICROBATCH_COUNT",
    "PIPELINE_SCHEDULE",
    "Proposal",
    "QUEUE_PRESSURE",
    "SKEWED_BUCKETS",
    "STRAGGLER",
    "TuningAdvisor",
]
