"""The act half of the closed loop: apply, verify, and roll back (the
port of ``skycomputing_tpu/tuning/autotune.py``).

``TuningAdvisor`` (pure stdlib) decides; this module acts.  Shared
contract for both actuation surfaces (the Runner's ``AutotuneHook`` and
:class:`ServingAutotuner` here):

1. **verify-then-apply** — every proposal passes a pre-flight verifier
   BEFORE it takes effect: knob proposals through
   ``analysis/plan_check.verify_tuning_knobs``, allocation proposals
   through the full ``verify_plan`` (units built and run on ``meta``)
   against the re-solved partition.  A rejected proposal leaves the system
   untouched and its signature blocked.
2. **measure-then-commit** — an applied proposal is provisional: the
   NEXT analysis window must show its promised metric improving by at
   least ``min_improvement``, or the change is rolled back (partition
   AND calibration for allocation proposals) and the signature blocked.
3. **everything visible** — each attempt is an async ``autotune`` arc
   on the trace (opened at apply, closed with the outcome), with
   ``autotune.analyze`` / ``autotune.apply`` / ``autotune.rollback``
   spans inside, so a Perfetto timeline shows the control loop acting
   on the same timeline it read.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..telemetry import get_tracer
from ..telemetry.analysis import TraceError, analyze
from ..utils import Logger
from .advisor import Proposal, TuningAdvisor

# outcome strings recorded in events lists and trace args (stable ids)
APPLIED = "applied"
COMMITTED = "committed"
NO_OP = "no_op"
REJECTED = "rejected"
ROLLED_BACK = "rolled_back"


def window_events(tracer, t0_us: float) -> List[Dict[str, Any]]:
    """Chrome events recorded at/after ``t0_us`` (lane metadata always
    included — analysis needs the process-name map regardless of when a
    lane registered).  The filter happens inside the export so a full
    ring buffer is never materialized just to be discarded."""
    return tracer.to_chrome(since_us=t0_us)["traceEvents"]


def snapshot_partition(worker_manager) -> List[tuple]:
    """Per-worker (id, layer slice, order, mesh chips) — everything
    :func:`restore_partition` needs to undo a re-allocation, including a
    mesh reshape (``mesh_chips`` is the sub-mesh width
    ``Allocator.mesh_allocate`` wrote, None for MPMD partitions)."""
    return [
        (w.id, list(w.model_config or []), w.order,
         w.extra_config.get("mesh_chips"))
        for w in worker_manager.worker_pool
    ]


def restore_partition(worker_manager, snapshot: List[tuple]) -> None:
    for worker_id, model_config, order, mesh_chips in snapshot:
        worker = worker_manager.get_by_id(worker_id)
        worker.model_config = model_config
        worker.order = order
        if mesh_chips is None:
            worker.extra_config.pop("mesh_chips", None)
        else:
            worker.extra_config["mesh_chips"] = mesh_chips
    worker_manager.reset_rank_by_order()


def improved(base: float, new: float, min_improvement: float) -> bool:
    """Did the metric move down by at least ``min_improvement``
    (relative, with a small absolute floor so near-zero baselines don't
    demand sub-noise deltas)?"""
    return new <= base - max(abs(base) * min_improvement, 1e-9)


class ServingAutotuner:
    """Closed-loop tuner for a live :class:`~..serving.ServingEngine`.

    Attaches itself as ``engine.autotuner``: every ``engine.step()``
    ends with :meth:`on_step`, and every ``tune_every`` steps the tuner
    analyzes the trace window since its last decision, asks the advisor
    for a proposal over the serving knobs (bucket set, slot count), and
    applies it through ``engine.reconfigure`` — which runs the
    pre-flight knob verifier and the live-request feasibility check
    before touching anything.  The next window then has to prove the
    change (padding waste down for a bucket change, stall share down
    for a slot change) or it is rolled back by reconfiguring straight
    back.

    Requires tracing to be enabled (the trace IS the sensor); steps
    taken while tracing is off are counted but never analyzed.
    """

    def __init__(
        self,
        engine,
        advisor: Optional[TuningAdvisor] = None,
        tune_every: int = 32,
        max_tunes: int = 3,
        min_improvement: float = 0.05,
        settle_windows: int = 2,
        logger: Optional[Logger] = None,
    ):
        if tune_every < 1:
            raise ValueError(f"tune_every must be >= 1, got {tune_every}")
        self.engine = engine
        self.advisor = advisor or TuningAdvisor()
        self.tune_every = int(tune_every)
        self.max_tunes = int(max_tunes)
        self.min_improvement = float(min_improvement)
        self.settle_windows = int(settle_windows)
        self.tunes = 0
        self.events: List[Dict[str, Any]] = []
        self.blocked: set = set()
        self._logger = logger or Logger()
        self._steps = 0
        self._window_t0: Optional[float] = None
        self._pending: Optional[Dict[str, Any]] = None
        self._arc_id = 0
        # window-scoped SLO sampling: TPOT samples appended since the
        # window opened (the decode-tail signature needs per-request
        # percentiles, which the trace alone does not carry)
        self._tpot_mark = 0
        engine.autotuner = self

    # --- trace plumbing ----------------------------------------------------
    def _lane(self, tracer):
        return tracer.lane("autotune", "serving")

    def _record(self, outcome: str, **extra) -> None:
        self.events.append(dict(outcome=outcome, step=self._steps, **extra))

    # --- the loop ----------------------------------------------------------
    def on_step(self, engine) -> None:
        self._steps += 1
        tracer = get_tracer()
        if tracer is None:
            return
        if self._window_t0 is None:
            self._window_t0 = tracer.now()
            self._window_start_step = self._steps
            self._tpot_mark = len(engine.stats.tpot_s)
            return
        if self._steps - self._window_start_step < self.tune_every:
            return
        t0 = tracer.now()
        with tracer.span("autotune.analyze", self._lane(tracer),
                         {"window_ms": (t0 - self._window_t0) / 1e3}):
            try:
                report = analyze(window_events(tracer, self._window_t0))
            except TraceError:
                report = None
        self._merge_window_slo(report, engine)
        self._window_t0 = tracer.now()
        self._window_start_step = self._steps
        self._tpot_mark = len(engine.stats.tpot_s)
        if report is None:
            return
        if self._pending is not None:
            self._settle(tracer, report)
            return
        if self.tunes >= self.max_tunes:
            return
        blocked = set(self.blocked)
        if not getattr(engine, "_paged", False):
            # prefill_chunk is a paged-only knob: a slot engine would
            # reject the proposal and burn the signature forever —
            # mask it instead of spending a blocked slot on it
            from .advisor import DECODE_TAIL

            blocked.add(DECODE_TAIL)
        proposal = self.advisor.propose_serving(
            report,
            buckets=engine.bucketer.buckets,
            num_slots=engine.num_slots,
            max_len=engine.max_len,
            prefill_chunk=getattr(engine, "prefill_chunk", None),
            blocked=blocked,
        )
        if proposal is None:
            self._record(NO_OP)
            return
        self._apply(tracer, report, proposal)

    def _merge_window_slo(self, report: Optional[Dict[str, Any]],
                          engine) -> None:
        """Fold the WINDOW's per-request TPOT percentiles into the
        report's serving section (the decode-tail signature's input —
        one merge site, so decide and judge read the same numbers).
        Windows with too few finished requests carry no percentiles:
        two samples cannot distinguish a tail from noise."""
        if report is None or not report.get("serving"):
            return
        samples = engine.stats.tpot_s
        window = [s for s in samples[self._tpot_mark:] if s is not None]
        if len(window) < 4:
            return
        ordered = sorted(window)

        def pct(q):
            i = min(len(ordered) - 1,
                    max(0, int(round(q / 100.0 * (len(ordered) - 1)))))
            return float(ordered[i])

        report["serving"]["tpot_p50_s"] = pct(50)
        report["serving"]["tpot_p95_s"] = pct(95)

    def _metric(self, report: Dict[str, Any], name: str) -> Optional[float]:
        serving = report.get("serving") or {}
        if name == "padding_fraction":
            # the field analyze() computed — same number the advisor
            # thresholded on when it proposed the change
            return serving.get("padding_fraction")
        if name == "stall_fraction":
            ticks = serving.get("prefill_waves", 0) + serving.get(
                "decode_ticks", 0
            )
            if ticks <= 0:
                return None
            return serving.get("queue_stalls", 0) / ticks
        if name == "tpot_tail_ratio":
            p50 = serving.get("tpot_p50_s")
            p95 = serving.get("tpot_p95_s")
            if not p50 or not p95 or p50 <= 0:
                return None
            return float(p95) / float(p50)
        return None

    def _apply(self, tracer, report: Dict[str, Any],
               proposal: Proposal) -> None:
        base = self._metric(report, proposal.metric)
        if base is None:
            self._record(NO_OP, note=f"metric {proposal.metric} "
                                     f"unavailable in window")
            return
        engine = self.engine
        revert = dict(buckets=list(engine.bucketer.buckets),
                      num_slots=engine.num_slots,
                      prefill_batch=engine.prefill_batch)
        if getattr(engine, "_paged", False):
            # 0 = "chunking off" in reconfigure's knob language; slot
            # engines never see the key (they would reject it)
            revert["prefill_chunk"] = engine.prefill_chunk or 0
        self._arc_id += 1
        tracer.async_begin("autotune", self._lane(tracer), self._arc_id,
                           proposal.describe())
        try:
            with tracer.span("autotune.apply", self._lane(tracer),
                             proposal.describe()):
                if proposal.knob == "buckets":
                    engine.reconfigure(buckets=proposal.value)
                elif proposal.knob == "slots":
                    engine.reconfigure(num_slots=proposal.value)
                elif proposal.knob == "prefill_chunk":
                    engine.reconfigure(prefill_chunk=proposal.value)
                else:
                    raise ValueError(
                        f"serving tuner cannot actuate knob "
                        f"{proposal.knob!r}"
                    )
        except Exception as exc:
            # verify_tuning_knobs rejection (PlanError), infeasible live
            # requests (ValueError): the engine is untouched — block the
            # signature and close the arc
            self.blocked.add(proposal.signature)
            self._record(REJECTED, proposal=proposal.describe(),
                         error=str(exc))
            tracer.async_end("autotune", self._lane(tracer), self._arc_id,
                             {"outcome": REJECTED})
            self._logger.warning(
                f"ServingAutotuner: rejected {proposal.signature}: {exc}"
            )
            return
        self._pending = dict(proposal=proposal, base=base, revert=revert,
                             waited=0, arc_id=self._arc_id)
        self._record(APPLIED, proposal=proposal.describe(), base=base)
        self._logger.info(
            f"ServingAutotuner: applied {proposal.signature} "
            f"({proposal.reason}); verifying next window"
        )

    def _settle(self, tracer, report: Dict[str, Any]) -> None:
        pending = self._pending
        proposal: Proposal = pending["proposal"]
        new = self._metric(report, proposal.metric)
        if new is None:
            # the window carried no evidence (e.g. no prefill waves for
            # a padding metric): wait, bounded — then judge on what the
            # proposal was for, which without evidence means rollback
            pending["waited"] += 1
            if pending["waited"] < self.settle_windows:
                return
            new = float("inf")
        if improved(pending["base"], new, self.min_improvement):
            self.tunes += 1
            self._pending = None
            self._record(COMMITTED, proposal=proposal.describe(),
                         base=pending["base"], new=new)
            tracer.async_end("autotune", self._lane(tracer),
                             pending["arc_id"], {"outcome": COMMITTED})
            self._logger.info(
                f"ServingAutotuner: committed {proposal.signature} "
                f"({proposal.metric} {pending['base']:.4f} -> {new:.4f})"
            )
            return
        self.blocked.add(proposal.signature)
        self._pending = None
        try:
            with tracer.span("autotune.rollback", self._lane(tracer),
                             proposal.describe()):
                self.engine.reconfigure(**pending["revert"])
        except Exception as exc:
            # a request may have grown past the OLD operating point
            # (e.g. beyond a removed bucket) — the revert is infeasible,
            # so the new point stays; the signature is blocked either
            # way and the engine keeps serving
            self._record("rollback_infeasible",
                         proposal=proposal.describe(), error=str(exc))
            tracer.async_end("autotune", self._lane(tracer),
                             pending["arc_id"],
                             {"outcome": "rollback_infeasible"})
            self._logger.warning(
                f"ServingAutotuner: rollback of {proposal.signature} "
                f"infeasible ({exc}); keeping the new operating point"
            )
            return
        self._record(ROLLED_BACK, proposal=proposal.describe(),
                     base=pending["base"], new=new)
        tracer.async_end("autotune", self._lane(tracer),
                         pending["arc_id"], {"outcome": ROLLED_BACK})
        self._logger.warning(
            f"ServingAutotuner: rolled back {proposal.signature} "
            f"({proposal.metric} {pending['base']:.4f} -> {new:.4f}, "
            f"no improvement)"
        )


__all__ = [
    "APPLIED",
    "COMMITTED",
    "NO_OP",
    "REJECTED",
    "ROLLED_BACK",
    "ServingAutotuner",
    "improved",
    "restore_partition",
    "snapshot_partition",
    "window_events",
]
